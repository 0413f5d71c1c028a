"""LM serving on a CUDA card with the PyTorch port (``repro_torch``).

    PYTHONPATH=src python examples/serve_lm_torch.py --arch smollm-135m \
        --batch 4 --prompt-len 8 --tokens 24 --prefill-len 2048
    PYTHONPATH=src python examples/serve_lm_torch.py --arch olmoe-1b-7b \
        --prefill-len 2048 --tokens 8 --draw-on-device
    PYTHONPATH=src python examples/serve_lm_torch.py --arch jamba-v0.1-52b \
        --layers 8 --batch 1 --prefill-len 2048 --tokens 0 --draw-on-device
    PYTHONPATH=src python examples/serve_lm_torch.py --device cpu --reduced \
        --arch olmoe-1b-7b --prefill-len 64

The counterpart of ``examples/serve_lm.py``, at full width unless
``--reduced``; ``--layers n`` keeps the first n layers (whole periods of
the block pattern: Jamba's full width fits one 80 GB card as one 8-layer
period). Weights come from the port's init (``--seed``), drawn on the CPU,
so every device serves the same weights, or with ``--draw-on-device`` on
the serving device (other numbers; seconds instead of minutes for the
billions of parameters of OLMoE or a Jamba period). ``--batch``
requests of ``--prompt-len`` random tokens are served greedily through
``repro_torch.serve.BatchedServer`` (prefill-by-decode over the KV cache,
then ``--tokens`` new tokens each); with ``--prefill-len`` S, the
full-sequence prefill (``ArchSpec.make_prefill``, the flash-attention
kernel) runs on ``--batch`` x S tokens from ``default_rng(seed)``,
``PREFILL_REPS`` timed calls after one warm-up. ``--device cpu`` runs the
plain PyTorch path instead; without it a machine with no CUDA raises.
"""
from __future__ import annotations

import argparse
import statistics
import time

import numpy as np
import torch

from repro_torch.configs import PORTED_ARCH_IDS, get_arch
from repro_torch.device import resolve_device
from repro_torch.serve import BatchedServer, ServeConfig

PREFILL_REPS = 5  # timed prefill forwards, after one warm-up


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="smollm-135m", choices=PORTED_ARCH_IDS)
    ap.add_argument("--reduced", action="store_true", help="the smoke config")
    ap.add_argument("--layers", type=int, default=0,
                    help="keep the first n layers, whole periods (0: all)")
    ap.add_argument("--draw-on-device", action="store_true",
                    help="draw the weights on the serving device instead of the CPU")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--tokens", type=int, default=24, help="new tokens per request (0: none)")
    ap.add_argument("--prefill-len", type=int, default=0, help="prefill S tokens (0: none)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(args: argparse.Namespace, device=None) -> dict:
    """Serve the requests, then time the prefill; returns the results,
    the model and the rates (tokens per second of the host clock around
    work that ends in a synchronize)."""
    dev = resolve_device(device if device is not None else args.device)
    spec = get_arch(args.arch, reduced=args.reduced)
    if args.layers:
        spec = spec.with_layers(args.layers)
    cfg = spec.lm
    gen = torch.Generator(device=dev if args.draw_on_device else "cpu").manual_seed(args.seed)
    model = spec.init_params(gen, dev)
    res = {"arch": spec.arch_id, "device": str(dev), "model": model, "spec": spec}

    if args.tokens > 0:
        prompts = np.random.default_rng([args.seed, 1]).integers(
            0, cfg.vocab, size=(args.batch, args.prompt_len))
        server = BatchedServer(spec, model, ServeConfig(
            batch_size=args.batch, max_new_tokens=args.tokens,
            cache_len=args.prompt_len + args.tokens))
        _sync(dev)
        t0 = time.perf_counter()
        res["tokens"] = server.generate(prompts.tolist())
        _sync(dev)
        res["decode_s"] = time.perf_counter() - t0
        # every decode step, the prompt's included, makes one token per row
        steps = args.prompt_len + args.tokens - 1
        res["decode_tokens_per_s"] = args.batch * steps / res["decode_s"]

    if args.prefill_len > 0:
        toks = torch.from_numpy(np.random.default_rng(args.seed).integers(
            0, cfg.vocab, size=(args.batch, args.prefill_len))).to(dev)
        prefill = spec.make_prefill()
        logits = prefill(model, {"tokens": toks})  # warm-up
        times = []
        for _ in range(PREFILL_REPS):
            _sync(dev)
            t0 = time.perf_counter()
            logits = prefill(model, {"tokens": toks})
            _sync(dev)
            times.append(time.perf_counter() - t0)
        res["prefill_forwards"] = 1 + PREFILL_REPS
        res["prefill_s"] = times
        res["prefill_tokens_per_s"] = args.batch * args.prefill_len / statistics.median(times)
        res["prefill_last_logits"] = logits.float().cpu()
    return res


def main() -> None:
    args = parser().parse_args()
    res = run(args)
    print(f"{res['arch']} on {res['device']}")
    if "tokens" in res:
        print(f"decode: {res['decode_tokens_per_s']:.1f} tokens/s "
              f"({args.batch} requests, prompt {args.prompt_len}, {args.tokens} new)")
        for b, toks in enumerate(res["tokens"]):
            print(f"  req{b}: {toks}")
    if "prefill_s" in res:
        lg = res["prefill_last_logits"]
        print(f"prefill: {res['prefill_tokens_per_s']:.1f} tokens/s ({args.batch} x "
              f"{args.prefill_len}); last logits {tuple(lg.shape)}, argmax "
              f"{lg.argmax(-1).tolist()}")


if __name__ == "__main__":
    main()

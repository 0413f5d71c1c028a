"""LM serving on a CUDA card with the PyTorch port (``repro_torch``).

    PYTHONPATH=src python examples/serve_lm_torch.py --arch smollm-135m \
        --batch 4 --prompt-len 8 --tokens 24 --prefill-len 2048
    PYTHONPATH=src python examples/serve_lm_torch.py --arch olmoe-1b-7b \
        --prefill-len 2048 --tokens 8 --draw-on-device
    PYTHONPATH=src python examples/serve_lm_torch.py --arch jamba-v0.1-52b \
        --layers 8 --batch 1 --prefill-len 2048 --tokens 0 --draw-on-device
    PYTHONPATH=src python examples/serve_lm_torch.py --arch qwen2-vl-7b \
        --prefill-len 2048 --tokens 8 --draw-on-device
    PYTHONPATH=src python examples/serve_lm_torch.py --arch whisper-tiny \
        --batch 8 --prompt-len 4 --tokens 64 --prefill-len 448
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
``PREFILL_REPS`` timed calls after one warm-up. Qwen2-VL (``vlm``) serves
text through the same server and prefills with its ``n_patches`` patch
embeddings (N(0, 0.02^2), drawn after the tokens from the same generator)
over the span after BOS. Whisper serves each request's ``--audio-frames``
frame embeddings (0: the config's) and prompt greedily through
``whisper.init_cache`` (the audio encoded once) and the serve step
(``whisper_greedy``), and prefills on the audio plus S tokens (S at most
the 448 trained positions, past which the positions clamp). The reduced
Whisper's head_dim is 24, which the flash kernel does not take: it runs
with ``--device cpu`` only. ``--device cpu`` runs the plain PyTorch path;
without it a machine with no CUDA raises.
"""
from __future__ import annotations

import argparse
import statistics
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.device import resolve_device
from repro_torch.models import whisper as W
from repro_torch.serve import BatchedServer, ServeConfig

PREFILL_REPS = 5  # timed prefill forwards, after one warm-up


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="smollm-135m", choices=ARCH_IDS)
    ap.add_argument("--reduced", action="store_true", help="the smoke config")
    ap.add_argument("--layers", type=int, default=0,
                    help="keep the first n layers, whole periods (0: all)")
    ap.add_argument("--draw-on-device", action="store_true",
                    help="draw the weights on the serving device instead of the CPU")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--tokens", type=int, default=24, help="new tokens per request (0: none)")
    ap.add_argument("--prefill-len", type=int, default=0, help="prefill S tokens (0: none)")
    ap.add_argument("--audio-frames", type=int, default=0,
                    help="Whisper: frame embeddings a request (0: the config's)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _embeds(rng: np.random.Generator, batch: int, n: int, d: int, dtype,
            dev: torch.device) -> torch.Tensor:
    """N(0, 0.02^2) embeddings (batch, n, d), rounded to f32, then ``dtype``."""
    x = rng.normal(size=(batch, n, d)) * 0.02
    return torch.from_numpy(x.astype(np.float32)).to(device=dev, dtype=dtype)


def whisper_greedy(spec, model, audio: torch.Tensor, prompts: np.ndarray, new_tokens: int,
                   cache_len: int) -> list:
    """Greedy decoding of a batch of requests: ``audio`` (B, frames, d)
    encoded once into the cache, each prompt (B, P) stepped through it,
    then ``new_tokens`` (at least one) argmax tokens a row, the lower id
    on ties."""
    dev = audio.device
    step = spec.make_serve_step()
    cache = W.init_cache(model, spec.whisper, audio, cache_len)
    toks = torch.from_numpy(np.ascontiguousarray(prompts, np.int64)).to(dev)
    for i in range(toks.shape[1]):
        logits, cache = step(model, cache, {"token": toks[:, i:i + 1]})
    outs = []
    for _ in range(new_tokens):
        nxt = torch.argmax(logits, dim=-1)
        outs.append(nxt)
        logits, cache = step(model, cache, {"token": nxt[:, None]})
    return torch.stack(outs, dim=1).cpu().tolist()


def run(args: argparse.Namespace, device=None) -> dict:
    """Serve the requests, then time the prefill; returns the results,
    the model and the rates (tokens per second of the host clock around
    work that ends in a synchronize)."""
    dev = resolve_device(device if device is not None else args.device)
    spec = get_arch(args.arch, reduced=args.reduced)
    if args.layers:
        spec = spec.with_layers(args.layers)
    whisper = spec.kind == "whisper"
    cfg = spec.whisper if whisper else spec.lm
    frames = args.audio_frames or (cfg.n_audio_frames if whisper else 0)
    gen = torch.Generator(device=dev if args.draw_on_device else "cpu").manual_seed(args.seed)
    model = spec.init_params(gen, dev)
    res = {"arch": spec.arch_id, "device": str(dev), "model": model, "spec": spec}

    if args.tokens > 0:
        rng = np.random.default_rng([args.seed, 1])
        prompts = rng.integers(0, cfg.vocab, size=(args.batch, args.prompt_len))
        cache_len = args.prompt_len + args.tokens
        if whisper:
            audio = _embeds(rng, args.batch, frames, cfg.d_model, spec.dtype, dev)
            _sync(dev)
            t0 = time.perf_counter()
            res["tokens"] = whisper_greedy(spec, model, audio, prompts, args.tokens, cache_len)
        else:
            server = BatchedServer(spec, model, ServeConfig(
                batch_size=args.batch, max_new_tokens=args.tokens, cache_len=cache_len))
            _sync(dev)
            t0 = time.perf_counter()
            res["tokens"] = server.generate(prompts.tolist())
        _sync(dev)
        res["decode_s"] = time.perf_counter() - t0
        # every decode step, the prompt's included, makes one token per row
        steps = args.prompt_len + args.tokens - 1
        res["decode_tokens_per_s"] = args.batch * steps / res["decode_s"]

    if args.prefill_len > 0:
        rng = np.random.default_rng(args.seed)
        batch = {"tokens": torch.from_numpy(rng.integers(
            0, cfg.vocab, size=(args.batch, args.prefill_len))).to(dev)}
        if spec.kind == "vlm":
            batch["patch_embeds"] = _embeds(rng, args.batch, spec.n_patches, cfg.d_model,
                                            spec.dtype, dev)
        elif whisper:
            batch["audio_embeds"] = _embeds(rng, args.batch, frames, cfg.d_model, spec.dtype,
                                            dev)
        prefill = spec.make_prefill()
        logits = prefill(model, batch)  # warm-up
        times = []
        for _ in range(PREFILL_REPS):
            _sync(dev)
            t0 = time.perf_counter()
            logits = prefill(model, batch)
            _sync(dev)
            times.append(time.perf_counter() - t0)
        res["prefill_forwards"] = 1 + PREFILL_REPS
        res["prefill_s"] = times
        res["prefill_tokens_per_s"] = args.batch * args.prefill_len / statistics.median(times)
        res["prefill_last_logits"] = logits.float().cpu()
        res["prefill_batch"] = batch
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

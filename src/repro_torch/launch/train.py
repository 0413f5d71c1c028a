"""LM training with the PyTorch port: the counterpart of
``repro/launch/train.py``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
        --steps 20 --batch 4 --seq 2048
    PYTHONPATH=src python -m repro_torch.launch.train --arch olmoe-1b-7b \\
        --layers 2 --steps 10 --batch 4 --seq 2048
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-vl-7b \\
        --layers 2 --steps 10 --batch 4 --seq 2048
    PYTHONPATH=src python -m repro_torch.launch.train --arch whisper-tiny \\
        --steps 20 --batch 8 --seq 448
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --reduced

Trains any of the ten archs on synthetic token streams (``synth_batch``:
the same numpy stream as ``repro``'s, so tokens, labels and Qwen2-VL's patch
or Whisper's frame embeddings are bitwise its own)
with ``ArchSpec.make_train_step(adam(lr))``, from the port's seeded init
(``--seed``; ``repro`` draws from ``jax.random``, so the weights differ).
``--reduced`` takes the smoke config and turns microbatching off, as
``repro`` does; ``--layers n`` keeps the first n layers of the full width
(whole periods of the block pattern), for a model whose Adam state does
not fit the card. On CUDA the attention's forward and backward are the
flash kernels; ``--device cpu`` runs the plain PyTorch path instead, and
without it a machine with no CUDA raises.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.configs.base import ArchSpec
from repro_torch.device import resolve_device
from repro_torch.train import optimizer as opt_lib
from repro_torch.utils.log import get_logger

log = get_logger("repro_torch.launch.train")


def synth_batch(rng: np.random.Generator, spec: ArchSpec, batch: int, seq: int,
                device=None) -> dict:
    """A markov-ish stream (the next token correlated with the current),
    labels the tokens shifted left with -1 at the last position:
    ``{"tokens", "labels"}``, (batch, seq) int64 on ``device``; then, drawn
    after them from ``rng``, N(0, 0.02^2) ``patch_embeds`` (batch,
    n_patches, d) for ``vlm`` or ``audio_embeds`` (batch, n_audio_frames,
    d) for ``whisper``, in the spec's dtype (rounded from the f64 draw to
    f32 first)."""
    vocab = spec.whisper.vocab if spec.kind == "whisper" else spec.lm.vocab
    base = rng.integers(0, vocab, size=(batch, seq + 1))
    drift = (base[:, :-1] + rng.integers(0, 7, size=(batch, seq))) % vocab
    tokens = np.where(rng.random((batch, seq)) < 0.7, drift, base[:, :-1])
    labels = np.roll(tokens, -1, axis=1).copy()
    labels[:, -1] = -1  # no target for the last position
    out = {"tokens": torch.from_numpy(tokens.astype(np.int64)).to(device),
           "labels": torch.from_numpy(labels.astype(np.int64)).to(device)}
    if spec.kind == "lm":
        return out
    name, n = (("patch_embeds", spec.n_patches) if spec.kind == "vlm"
               else ("audio_embeds", spec.whisper.n_audio_frames))
    x = rng.normal(size=(batch, n, spec.d_model)) * 0.02
    out[name] = torch.from_numpy(x.astype(np.float32)).to(device=device, dtype=spec.dtype)
    return out


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="smollm-135m", choices=ARCH_IDS)
    ap.add_argument("--reduced", action="store_true", help="the smoke config")
    ap.add_argument("--layers", type=int, default=0,
                    help="keep the first n layers, whole periods (0: all)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(args: argparse.Namespace,
        after_step: Optional[Callable[[int, torch.nn.Module, float], None]] = None) -> dict:
    """Train ``args.steps`` steps; returns the losses, each step's seconds
    (host clock around a step that ends in a synchronize; the batch is
    drawn outside it), tokens/s over the steps' total, the parameters'
    dtypes before the first step, and the spec, model, optimizer state,
    step function and batch stream to go on with.
    ``after_step(step, model, loss)`` runs after each step, outside its
    time."""
    dev = resolve_device(args.device)
    spec = get_arch(args.arch, reduced=args.reduced)
    if args.reduced:  # smoke scale: no microbatching
        spec = dataclasses.replace(spec, microbatches=1)
    if args.layers:
        spec = spec.with_layers(args.layers)
    opt = opt_lib.adam(args.lr)
    model = spec.init_params(torch.Generator().manual_seed(args.seed), dev)
    init_dtypes = {n: p.dtype for n, p in model.named_parameters()}
    opt_state = opt.init(dict(model.named_parameters()))
    step_fn = spec.make_train_step(opt)
    rng = np.random.default_rng(args.seed)
    losses, step_s = [], []
    for step in range(args.steps):
        batch = synth_batch(rng, spec, args.batch, args.seq, dev)
        _sync(dev)
        t0 = time.perf_counter()
        model, opt_state, loss = step_fn(model, opt_state, batch)
        losses.append(float(loss))
        _sync(dev)
        step_s.append(time.perf_counter() - t0)
        if after_step is not None:
            after_step(step, model, losses[-1])
        if (step + 1) % 10 == 0:
            log.info("step %d loss %.4f", step + 1, losses[-1])
    return {"arch": spec.arch_id, "device": str(dev), "spec": spec, "model": model,
            "opt_state": opt_state, "step_fn": step_fn, "rng": rng, "losses": losses,
            "step_s": step_s, "init_dtypes": init_dtypes,
            "tokens_per_s": args.steps * args.batch * args.seq / max(sum(step_s), 1e-12)}


def main() -> None:
    args = parser().parse_args()
    res = run(args)
    losses = res["losses"]
    print(f"{res['arch']}: loss {losses[0]:.4f} -> {losses[-1]:.4f} "
          f"({args.steps} steps, {res['tokens_per_s']:.0f} tok/s on {res['device']})")
    assert losses[-1] < losses[0], "training must reduce loss"


if __name__ == "__main__":
    main()

"""Architecture and shape specs of the LM substrate: the counterpart of
``repro/configs/base.py``, limited to ``kind == "lm"``.

Every arch module provides ``full()`` (the published config) and
``reduced()`` (a smoke variant: two layers, or Jamba's one 8-layer period),
each an ``ArchSpec``. The spec builds parameters (``init_params``), the
serve-step cache (``init_cache``: KV caches and Mamba2 states, layer by
layer) and the step functions: the loss, the training step (loss,
gradients and an optimizer step), prefill (the full-sequence forward,
last-position logits) and the one-token serve step. ``with_layers`` cuts
the depth to whole periods of the block pattern, for a card that cannot
hold the whole model. ``repro``'s abstract shapes, sharding
specs, depth probes and support table serve its TPU dry-run (ROADMAP Queue
1 item 8f) and are left out, with the VLM and Whisper fields. A ``vlm`` or
``whisper`` spec raises (items 8d, 8e).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import transformer as T

_UNPORTED_KIND = {
    "vlm": "Qwen2-VL is not ported yet (ROADMAP Queue 1 item 8d)",
    "whisper": "Whisper is not ported yet (ROADMAP Queue 1 item 8e)",
}


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def resolve_shape(shape) -> ShapeSpec:
    """A shape name or an explicit ``ShapeSpec``."""
    return SHAPES[shape] if isinstance(shape, str) else shape


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    kind: str  # "lm" here; "vlm" and "whisper" raise
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    citation: str
    lm: Optional[T.LMConfig] = None
    sub_quadratic: bool = False  # may run long_500k
    microbatches: int = 1  # repro's train_4k gradient accumulation
    notes: str = ""

    def _lm(self) -> T.LMConfig:
        if self.kind != "lm":
            raise NotImplementedError(_UNPORTED_KIND.get(self.kind, f"kind {self.kind!r}"))
        return self.lm

    def with_layers(self, n_layers: int) -> "ArchSpec":
        """The same arch at full width with its first ``n_layers`` layers,
        a whole number of periods of the block pattern."""
        cfg = self._lm()
        p = cfg.period()
        if not 0 < n_layers <= cfg.n_layers or n_layers % p:
            raise ValueError(f"{n_layers} layers: a multiple of the period {p} "
                             f"up to {cfg.n_layers}")
        lm = dataclasses.replace(cfg, n_layers=n_layers,
                                 blocks=cfg.blocks[:n_layers] if cfg.blocks else ())
        return dataclasses.replace(self, lm=lm)

    # ----------------------------------------------------------- parameters
    def init_params(self, generator: torch.Generator, device: DeviceLike = None) -> T.LM:
        """Fresh weights from ``generator`` (``T.init_lm``) on ``device``
        (None means CUDA)."""
        return T.init_lm(generator, self._lm(), resolve_device(device))

    def init_cache(self, params: T.LM, shape) -> dict:
        """The serve-step cache of ``shape`` on the parameters' device."""
        s = resolve_shape(shape)
        return T.init_cache(self._lm(), s.global_batch, s.seq_len, params.embed.device)

    # ------------------------------------------------------- step functions
    def make_train_loss(self) -> Callable:
        cfg = self._lm()

        def loss(params, batch):
            return T.lm_loss(params, cfg, batch["tokens"], batch["labels"])

        return loss

    def make_train_step(self, optimizer) -> Callable:
        """``train_step(model, opt_state, batch) -> (model, opt_state, loss)``
        with ``optimizer`` from ``repro_torch.train.optimizer`` and
        ``opt_state = optimizer.init(dict(model.named_parameters()))``.

        The loss and its gradient in every parameter
        (``torch.autograd.grad`` over ``dict(model.named_parameters())``),
        then ``optimizer.update`` and ``apply_updates``. With
        ``microbatches`` k > 1 the batch axis splits into k equal parts
        whose losses and gradients are summed from zeros, in order, and
        divided by k, as ``repro`` does.

        The parameters are updated IN PLACE and the same model is returned
        (``repro`` returns a new tree): each parameter takes its new value
        by a copy, or, where the update changed its dtype (``adam`` turns a
        bf16 parameter f32 at the first step, as ``repro``'s does: ROADMAP
        C6), by replacing its ``data``. The loss comes back detached.
        """
        from repro_torch.train import optimizer as opt_lib

        loss_fn = self.make_train_loss()
        k = self.microbatches

        def train_step(model, opt_state, batch):
            params = dict(model.named_parameters())
            leaves = list(params.values())
            if k == 1:
                loss = loss_fn(model, batch)
                grads = torch.autograd.grad(loss, leaves)
            else:  # gradient accumulation over k microbatches (batch dim split)
                loss = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
                grads = [torch.zeros_like(p) for p in leaves]
                for i in range(k):
                    mb = {n: x.reshape((k, x.shape[0] // k) + x.shape[1:])[i]
                          for n, x in batch.items()}
                    lk = loss_fn(model, mb)
                    gk = torch.autograd.grad(lk, leaves)
                    loss = loss + lk.detach()
                    grads = [g + d for g, d in zip(grads, gk)]
                loss = loss / k
                grads = [g / k for g in grads]
            with torch.no_grad():
                updates, opt_state = optimizer.update(dict(zip(params, grads)), opt_state,
                                                      params)
                new = opt_lib.apply_updates(params, updates)
                for name, p in params.items():
                    if new[name].dtype == p.dtype:
                        p.copy_(new[name])
                    else:
                        p.data = new[name]
            return model, opt_state, loss.detach()

        return train_step

    def make_prefill(self) -> Callable:
        """Prefill: the full-sequence forward, last-position logits
        (B, vocab_padded). The head multiplies only the last position's
        hidden state; ``repro`` computes every position's logits and keeps
        the last row, the same values."""
        cfg = self._lm()

        @torch.no_grad()
        def prefill(params, batch):
            x, _ = T.hidden_states(params, cfg, batch["tokens"])
            return T._mask_padded_vocab(cfg, x[:, -1, :] @ params.head())

        return prefill

    def make_serve_step(self) -> Callable:
        cfg = self._lm()

        def serve_step(params, cache, batch):
            return T.decode_step(params, cfg, cache, batch["token"])

        return serve_step

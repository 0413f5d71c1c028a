"""Architecture and shape specs of the LM substrate: the counterpart of
``repro/configs/base.py``, limited to ``kind == "lm"``.

Every arch module provides ``full()`` (the published config) and
``reduced()`` (a 2-layer smoke variant), each an ``ArchSpec``. The spec
builds parameters (``init_params``), the serve-step cache (``init_cache``)
and the step functions: prefill (the full-sequence forward, last-position
logits), the one-token serve step and the loss (forward only).
``repro``'s abstract shapes, sharding specs, depth probes and support
table serve its TPU dry-run (ROADMAP Queue 1 item 8f) and are left out,
with the VLM and Whisper fields; the training step needs the attention
backward (item 8a). A ``vlm`` or ``whisper`` spec raises (items 8d, 8e).
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
        raise NotImplementedError(
            "LM training is not ported yet: it needs the attention backward "
            "(ROADMAP Queue 1 item 8a)")

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

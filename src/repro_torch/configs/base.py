"""Architecture and shape specs of the LM substrate: the counterpart of
``repro/configs/base.py``.

Every arch module provides ``full()`` (the published config) and
``reduced()`` (a smoke variant: two layers, or Jamba's one 8-layer period),
each an ``ArchSpec`` of one of three kinds: ``lm`` (``models/transformer.py``),
``vlm`` (Qwen2-VL: the transformer on merged patch embeddings at M-RoPE
positions, ``models/qwen2_vl.py``) and ``whisper`` (the encoder-decoder,
``models/whisper.py``). The spec builds parameters (``init_params``), the
serve-step cache (``init_cache``: KV caches and Mamba2 states, layer by
layer; Whisper's encodes zero audio, as ``repro``'s does) and the step
functions: the loss, the training step (loss, gradients and an optimizer
step), prefill (the full-sequence forward, last-position logits) and the
one-token serve step. ``with_layers`` cuts the depth to whole periods of
the block pattern (Whisper: n encoder and n decoder layers), for a card
that cannot hold the whole model. ``repro``'s abstract shapes, sharding
specs, depth probes and support table serve its TPU dry-run (ROADMAP Queue
1 item 8f) and are left out.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple, Union

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import qwen2_vl as VLM
from repro_torch.models import transformer as T
from repro_torch.models import whisper as W

KINDS = ("lm", "vlm", "whisper")


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
    kind: str  # "lm" | "vlm" | "whisper"
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    citation: str
    lm: Optional[T.LMConfig] = None
    whisper: Optional[W.WhisperConfig] = None
    # vlm extras
    n_patches: int = 0
    grid_hw: Tuple[int, int] = (0, 0)
    sub_quadratic: bool = False  # may run long_500k
    microbatches: int = 1  # repro's train_4k gradient accumulation
    notes: str = ""

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"arch kind {self.kind!r}: one of {KINDS}")

    @property
    def d_model(self) -> int:
        return self.whisper.d_model if self.kind == "whisper" else self.lm.d_model

    @property
    def dtype(self) -> torch.dtype:
        return T.torch_dtype(self.whisper.dtype if self.kind == "whisper" else self.lm.dtype)

    def with_layers(self, n_layers: int) -> "ArchSpec":
        """The same arch at full width with its first ``n_layers`` layers,
        a whole number of periods of the block pattern (Whisper: that many
        encoder and decoder layers)."""
        cfg = self.whisper if self.kind == "whisper" else self.lm
        p = 1 if self.kind == "whisper" else cfg.period()
        if not 0 < n_layers <= cfg.n_layers or n_layers % p:
            raise ValueError(f"{n_layers} layers: a multiple of the period {p} "
                             f"up to {cfg.n_layers}")
        if self.kind == "whisper":
            return dataclasses.replace(self, whisper=dataclasses.replace(cfg, n_layers=n_layers))
        lm = dataclasses.replace(cfg, n_layers=n_layers,
                                 blocks=cfg.blocks[:n_layers] if cfg.blocks else ())
        return dataclasses.replace(self, lm=lm)

    # ----------------------------------------------------------- parameters
    def init_params(self, generator: torch.Generator,
                    device: DeviceLike = None) -> Union[T.LM, W.Whisper]:
        """Fresh weights from ``generator`` (``T.init_lm`` or
        ``W.init_whisper``) on ``device`` (None means CUDA)."""
        if self.kind == "whisper":
            return W.init_whisper(generator, self.whisper, resolve_device(device))
        return T.init_lm(generator, self.lm, resolve_device(device))

    def init_cache(self, params, shape) -> dict:
        """The serve-step cache of ``shape`` on the parameters' device.
        Whisper's encodes zero audio of ``n_audio_frames``, as ``repro``'s."""
        s = resolve_shape(shape)
        dev = params.embed.device
        if self.kind == "whisper":
            cfg = self.whisper
            audio = torch.zeros((s.global_batch, cfg.n_audio_frames, cfg.d_model),
                                dtype=self.dtype, device=dev)
            return W.init_cache(params, cfg, audio, s.seq_len)
        return T.init_cache(self.lm, s.global_batch, s.seq_len, dev)

    # ------------------------------------------------------- step functions
    def make_train_loss(self) -> Callable:
        if self.kind == "lm":
            cfg = self.lm

            def loss(params, batch):
                return T.lm_loss(params, cfg, batch["tokens"], batch["labels"])

            return loss
        if self.kind == "vlm":
            cfg, grid = self.lm, self.grid_hw

            def loss(params, batch):
                return VLM.vlm_loss(params, cfg, batch["tokens"], batch["labels"],
                                    batch["patch_embeds"], grid)

            return loss
        cfg = self.whisper

        def loss(params, batch):
            return W.loss(params, cfg, batch["audio_embeds"], batch["tokens"], batch["labels"])

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
        the last row, the same values. ``vlm`` feeds the merged patch
        embeddings at M-RoPE positions, ``whisper`` encodes the audio and
        decodes the tokens over it."""
        if self.kind == "whisper":
            wcfg = self.whisper

            @torch.no_grad()
            def prefill(params, batch):
                enc = W.encode(params, wcfg, batch["audio_embeds"])
                x = W.decode_hidden(params, wcfg, enc, batch["tokens"])
                return W.tied_logits(params, wcfg, x[:, -1, :])

            return prefill
        cfg = self.lm
        grid = self.grid_hw

        @torch.no_grad()
        def prefill(params, batch):
            if self.kind == "vlm":
                x, pos = VLM.vlm_forward_inputs(params, cfg, batch["tokens"],
                                                batch["patch_embeds"], grid)
                x, _ = T.hidden_states(params, cfg, inputs_embeds=x, positions=pos)
            else:
                x, _ = T.hidden_states(params, cfg, batch["tokens"])
            return T._mask_padded_vocab(cfg, x[:, -1, :] @ params.head())

        return prefill

    def make_serve_step(self) -> Callable:
        if self.kind == "whisper":
            wcfg = self.whisper

            def serve_step(params, cache, batch):
                return W.decode_step(params, wcfg, cache, batch["token"])

            return serve_step
        cfg = self.lm

        def serve_step(params, cache, batch):
            return T.decode_step(params, cfg, cache, batch["token"])

        return serve_step

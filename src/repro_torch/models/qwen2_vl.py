"""Qwen2-VL's language backbone (arXiv:2409.12191): the counterpart of
``repro/models/qwen2_vl.py``.

The vision encoder (ViT and merger) is a stub, as in ``repro``: the caller
supplies precomputed patch embeddings (B, n_patches, d_model). What is the
LM's job is here:

- ``merge_vision_embeds`` writes the patch embeddings over the token
  embeddings of the image span, a fixed span right after BOS;
- ``mrope_positions`` gives the 3-D M-RoPE ids: text (t, t, t), the vision
  span one temporal index with (h, w) walking the patch grid.

Everything else (GQA attention with M-RoPE, SwiGLU, the decode step) is
``models/transformer.py`` with ``mrope_sections`` set.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.models import transformer as T
from repro_torch.models.sharding import constrain, like


def merge_vision_embeds(
    model: T.LM,
    cfg: T.LMConfig,
    tokens: torch.Tensor,  # (B, S)
    patch_embeds: torch.Tensor,  # (B, Np, d): the stub ViT's output
    image_start: int = 1,  # patches occupy [image_start, image_start + Np)
) -> torch.Tensor:
    """Token embeddings with the image span replaced by ``patch_embeds``
    (cast to the embeddings' dtype). As ``jax.lax.dynamic_update_slice``,
    the span's start is clamped so that it fits: at S = Np it starts at 0.
    S < Np raises, as there."""
    x = T.embed_tokens(model, cfg, tokens)
    S, Np = x.shape[1], patch_embeds.shape[1]
    if Np > S or patch_embeds.shape[0] != x.shape[0] or patch_embeds.shape[2] != x.shape[2]:
        raise ValueError(f"patch embeddings {tuple(patch_embeds.shape)} do not fit into "
                         f"token embeddings {tuple(x.shape)}")
    start = min(max(image_start, 0), S - Np)
    x = torch.cat([x[:, :start], patch_embeds.to(x.dtype), x[:, start + Np:]], dim=1)
    return constrain(x, "batch", None, None)


def mrope_positions(
    batch: int,
    seq_len: int,
    n_patches: int,
    grid_hw: Tuple[int, int],
    image_start: int = 1,
    device=None,
) -> torch.Tensor:
    """(B, S, 3) int32 position ids: (temporal, height, width).

    Text: (i, i, i). The vision span: temporal frozen at ``image_start``,
    height and width walking the patch grid row by row. Text after the
    image resumes at ``image_start + max(H, W)``, so the ids may step
    backwards there (the full config's 1,024 patches on a 32 x 32 grid put
    position 33 at index 1,025), as in ``repro``.
    """
    H, W = grid_hw
    if H * W < n_patches:
        raise ValueError(f"a {H} x {W} grid holds fewer than {n_patches} patches")
    i = torch.arange(seq_len, dtype=torch.int32, device=device)
    in_img = (i >= image_start) & (i < image_start + n_patches)
    after = i >= image_start + n_patches
    pi = i - image_start  # patch index within the span
    ph = torch.div(pi, W, rounding_mode="floor")
    pw = pi - ph * W  # floor modulo, as jnp's %
    resume = image_start + max(H, W)  # temporal id where post-image text resumes
    shift = resume - (image_start + n_patches)  # applied to the trailing text
    t_pos = torch.where(in_img, image_start, torch.where(after, i + shift, i))
    h_pos = torch.where(in_img, image_start + ph, t_pos)
    w_pos = torch.where(in_img, image_start + pw, t_pos)
    pos = torch.stack([t_pos, h_pos, w_pos], dim=-1).to(torch.int32)
    return pos[None].expand(batch, seq_len, 3)


def vlm_forward_inputs(model: T.LM, cfg: T.LMConfig, tokens: torch.Tensor,
                       patch_embeds: torch.Tensor, grid_hw: Tuple[int, int],
                       image_start: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """The merged embeddings and the M-RoPE ids of one batch."""
    B, S = tokens.shape
    x = merge_vision_embeds(model, cfg, tokens, patch_embeds, image_start)
    pos = mrope_positions(B, S, patch_embeds.shape[1], grid_hw, image_start, tokens.device)
    return x, like(pos, x)


def vlm_loss(
    model: T.LM,
    cfg: T.LMConfig,
    tokens: torch.Tensor,
    labels: torch.Tensor,
    patch_embeds: torch.Tensor,
    grid_hw: Tuple[int, int],
) -> torch.Tensor:
    """``transformer.lm_loss`` on the merged embeddings at M-RoPE positions."""
    x, pos = vlm_forward_inputs(model, cfg, tokens, patch_embeds, grid_hw)
    return T.lm_loss(model, cfg, tokens, labels, positions=pos, inputs_embeds=x)

"""Qwen2-VL-7B's language backbone [arXiv:2409.12191].

28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064, M-RoPE, dynamic
resolution. The vision encoder is a stub: the caller supplies 1,024 patch
embeddings on a 32 x 32 grid.
"""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.transformer import LMConfig

ARCH_ID = "qwen2-vl-7b"


def full() -> ArchSpec:
    return ArchSpec(
        arch_id=ARCH_ID, kind="vlm", family="vlm", citation="arXiv:2409.12191",
        lm=LMConfig(
            name=ARCH_ID, vocab=152064, d_model=3584, n_layers=28,
            n_heads=28, n_kv=4, d_ff=18944, head_dim=128,
            qkv_bias=True, rope_theta=1e6, mrope_sections=(16, 24, 24),
            mlp_kind="swiglu", norm="rms",
        ),
        n_patches=1024, grid_hw=(32, 32),
        sub_quadratic=False,
        microbatches=2,
        notes="M-RoPE sections (t,h,w)=(16,24,24); image span after BOS.",
    )


def reduced() -> ArchSpec:
    return ArchSpec(
        arch_id=ARCH_ID + "-smoke", kind="vlm", family="vlm",
        citation="arXiv:2409.12191",
        lm=LMConfig(
            name=ARCH_ID + "-smoke", vocab=512, d_model=128, n_layers=2,
            n_heads=4, n_kv=2, d_ff=256, head_dim=32,
            qkv_bias=True, rope_theta=1e6, mrope_sections=(4, 6, 6),
            mlp_kind="swiglu", norm="rms", dtype="float32", remat=False,
        ),
        n_patches=16, grid_hw=(4, 4), sub_quadratic=False,
    )

"""Qwen2-0.5B [arXiv:2407.10671].

24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151936 — GQA with QKV bias,
tied embeddings.
"""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.transformer import LMConfig

ARCH_ID = "qwen2-0.5b"


def full() -> ArchSpec:
    return ArchSpec(
        arch_id=ARCH_ID, kind="lm", family="dense", citation="arXiv:2407.10671",
        lm=LMConfig(
            name=ARCH_ID, vocab=151936, d_model=896, n_layers=24,
            n_heads=14, n_kv=2, d_ff=4864, head_dim=64,
            qkv_bias=True, rope_theta=1e6, tie_embeddings=True,
        ),
        sub_quadratic=False,
    )


def reduced() -> ArchSpec:
    return ArchSpec(
        arch_id=ARCH_ID + "-smoke", kind="lm", family="dense",
        citation="arXiv:2407.10671",
        lm=LMConfig(
            name=ARCH_ID + "-smoke", vocab=512, d_model=128, n_layers=2,
            n_heads=4, n_kv=2, d_ff=256, head_dim=32,
            qkv_bias=True, tie_embeddings=True, dtype="float32", remat=False,
        ),
        sub_quadratic=False,
    )

"""StarCoder2-7B [arXiv:2402.19173].

32L d_model=4608 36H (GQA kv=4) d_ff=18432 vocab=49152 — GQA, RoPE,
LayerNorm + GELU MLP, QKV bias, sliding-window attention (4096) -> long_500k
runs with the ring cache.
"""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.transformer import LMConfig

ARCH_ID = "starcoder2-7b"


def full() -> ArchSpec:
    return ArchSpec(
        arch_id=ARCH_ID, kind="lm", family="dense", citation="arXiv:2402.19173",
        lm=LMConfig(
            name=ARCH_ID, vocab=49152, d_model=4608, n_layers=32,
            n_heads=36, n_kv=4, d_ff=18432, head_dim=128,
            qkv_bias=True, rope_theta=1e5, sliding_window=4096,
            mlp_kind="gelu", norm="ln",
        ),
        sub_quadratic=True,
        microbatches=2,
        notes="SWA 4096 per the StarCoder2 paper; ring cache enables long_500k.",
    )


def reduced() -> ArchSpec:
    return ArchSpec(
        arch_id=ARCH_ID + "-smoke", kind="lm", family="dense",
        citation="arXiv:2402.19173",
        lm=LMConfig(
            name=ARCH_ID + "-smoke", vocab=512, d_model=128, n_layers=2,
            n_heads=4, n_kv=2, d_ff=256, head_dim=32,
            qkv_bias=True, sliding_window=16, mlp_kind="gelu", norm="ln",
            dtype="float32", remat=False,
        ),
        sub_quadratic=True,
    )

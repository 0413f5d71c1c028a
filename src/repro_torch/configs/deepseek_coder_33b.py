"""DeepSeek-Coder-33B [arXiv:2401.14196].

62L d_model=7168 56H (GQA kv=8) d_ff=19200 vocab=32256 — llama-arch.
"""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.transformer import LMConfig

ARCH_ID = "deepseek-coder-33b"


def full() -> ArchSpec:
    return ArchSpec(
        arch_id=ARCH_ID, kind="lm", family="dense", citation="arXiv:2401.14196",
        lm=LMConfig(
            name=ARCH_ID, vocab=32256, d_model=7168, n_layers=62,
            n_heads=56, n_kv=8, d_ff=19200, head_dim=128,
            rope_theta=100000.0,
        ),
        sub_quadratic=False,
        microbatches=4,
    )


def reduced() -> ArchSpec:
    return ArchSpec(
        arch_id=ARCH_ID + "-smoke", kind="lm", family="dense",
        citation="arXiv:2401.14196",
        lm=LMConfig(
            name=ARCH_ID + "-smoke", vocab=512, d_model=128, n_layers=2,
            n_heads=4, n_kv=2, d_ff=256, head_dim=32,
            dtype="float32", remat=False,
        ),
        sub_quadratic=False,
    )

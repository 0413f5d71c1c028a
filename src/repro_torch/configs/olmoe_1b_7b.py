"""OLMoE-1B-7B [arXiv:2409.02060].

16L d_model=2048 16H (kv=16, MHA) d_ff=1024 per expert vocab=50304,
MoE 64 experts top-8, routing groups of 512 tokens. ``shard="ep"`` is
``repro``'s mesh placement and selects nothing here.
"""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import LMConfig

ARCH_ID = "olmoe-1b-7b"


def full() -> ArchSpec:
    return ArchSpec(
        arch_id=ARCH_ID, kind="lm", family="moe", citation="arXiv:2409.02060",
        lm=LMConfig(
            name=ARCH_ID, vocab=50304, d_model=2048, n_layers=16,
            n_heads=16, n_kv=16, d_ff=1024, head_dim=128,
            rope_theta=10000.0,
            blocks=tuple([("attn", "moe")] * 16),
            moe=MoEConfig(d_model=2048, d_ff=1024, num_experts=64, top_k=8,
                          group_size=512, shard="ep"),
        ),
        sub_quadratic=False,
    )


def reduced() -> ArchSpec:
    return ArchSpec(
        arch_id=ARCH_ID + "-smoke", kind="lm", family="moe",
        citation="arXiv:2409.02060",
        lm=LMConfig(
            name=ARCH_ID + "-smoke", vocab=512, d_model=128, n_layers=2,
            n_heads=4, n_kv=4, d_ff=64, head_dim=32,
            blocks=tuple([("attn", "moe")] * 2),
            moe=MoEConfig(d_model=128, d_ff=64, num_experts=4, top_k=2,
                          group_size=64, shard="ep"),
            dtype="float32", remat=False,
        ),
        sub_quadratic=False,
    )

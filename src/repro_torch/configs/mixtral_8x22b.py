"""Mixtral-8x22B [arXiv:2401.04088].

56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768, MoE 8 experts top-2,
sliding-window attention. ``shard="tp"`` is ``repro``'s mesh placement (8
experts do not divide its 16-way model axis) and selects nothing here.
SWA (window 4096) bounds the decode cache -> long_500k runs. At 141 B
parameters it does not fit one 80 GB card; the reduced config is its
sliding-window MoE case.
"""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import LMConfig

ARCH_ID = "mixtral-8x22b"


def full() -> ArchSpec:
    return ArchSpec(
        arch_id=ARCH_ID, kind="lm", family="moe", citation="arXiv:2401.04088",
        lm=LMConfig(
            name=ARCH_ID, vocab=32768, d_model=6144, n_layers=56,
            n_heads=48, n_kv=8, d_ff=16384, head_dim=128,
            rope_theta=1e6, sliding_window=4096,
            blocks=tuple([("attn", "moe")] * 56),
            moe=MoEConfig(d_model=6144, d_ff=16384, num_experts=8, top_k=2,
                          shard="tp"),
        ),
        sub_quadratic=True,
        microbatches=4,
        notes="SWA ring cache (4096) => long_500k decodes with O(window) state.",
    )


def reduced() -> ArchSpec:
    return ArchSpec(
        arch_id=ARCH_ID + "-smoke", kind="lm", family="moe",
        citation="arXiv:2401.04088",
        lm=LMConfig(
            name=ARCH_ID + "-smoke", vocab=512, d_model=128, n_layers=2,
            n_heads=4, n_kv=2, d_ff=256, head_dim=32,
            sliding_window=16, blocks=tuple([("attn", "moe")] * 2),
            moe=MoEConfig(d_model=128, d_ff=256, num_experts=4, top_k=2,
                          group_size=64, shard="tp"),
            dtype="float32", remat=False,
        ),
        sub_quadratic=True,
    )

"""Jamba-v0.1 (52B) [arXiv:2403.19887].

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536, MoE 16 experts top-2.
Mamba : attention interleave 1:7 (one attention layer per 8-layer period, at
offset 4 — the paper's block layout), MoE replacing the dense MLP every
other layer. Only 4 attention layers total -> a full 500k KV cache is small
(the arch's design point), so long_500k runs WITHOUT sliding window.

The paper uses Mamba-1 internally; ``repro`` substitutes its Mamba2/SSD
mixer with the paper's state size (N=16), and so does the port. The whole
model is about 52 B parameters (104 GB in bf16): one 80 GB card holds one
8-layer period at full width.
"""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.mamba2 import Mamba2Config
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import LMConfig

ARCH_ID = "jamba-v0.1-52b"


def _blocks(n_layers: int):
    out = []
    for i in range(n_layers):
        mixer = "attn" if i % 8 == 4 else "mamba"
        ffn = "moe" if i % 2 == 1 else "dense"
        out.append((mixer, ffn))
    return tuple(out)


def full() -> ArchSpec:
    return ArchSpec(
        arch_id=ARCH_ID, kind="lm", family="hybrid", citation="arXiv:2403.19887",
        lm=LMConfig(
            name=ARCH_ID, vocab=65536, d_model=4096, n_layers=32,
            n_heads=32, n_kv=8, d_ff=14336, head_dim=128,
            blocks=_blocks(32),
            moe=MoEConfig(d_model=4096, d_ff=14336, num_experts=16, top_k=2,
                          shard="ep"),
            mamba=Mamba2Config(d_model=4096, d_state=16, headdim=64, expand=2),
        ),
        sub_quadratic=True,
        microbatches=2,  # mb=4 triggers pathological XLA while-loop compile times
        notes="1:7 attn:mamba, MoE every other layer; 4 attn layers -> "
              "full-cache long_500k is feasible by design.",
    )


def reduced() -> ArchSpec:
    return ArchSpec(
        arch_id=ARCH_ID + "-smoke", kind="lm", family="hybrid",
        citation="arXiv:2403.19887",
        lm=LMConfig(
            name=ARCH_ID + "-smoke", vocab=512, d_model=128, n_layers=8,
            n_heads=4, n_kv=2, d_ff=256, head_dim=32,
            blocks=_blocks(8),
            moe=MoEConfig(d_model=128, d_ff=256, num_experts=4, top_k=2,
                          group_size=64, shard="ep"),
            mamba=Mamba2Config(d_model=128, d_state=16, headdim=32, expand=2,
                               chunk=32),
            dtype="float32", remat=False,
        ),
        sub_quadratic=True,
    )

"""SmolLM-135M [hf:HuggingFaceTB/SmolLM-135M].

30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152 — llama-arch small.
"""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.transformer import LMConfig

ARCH_ID = "smollm-135m"


def full() -> ArchSpec:
    return ArchSpec(
        arch_id=ARCH_ID, kind="lm", family="dense",
        citation="hf:HuggingFaceTB/SmolLM-135M",
        lm=LMConfig(
            name=ARCH_ID, vocab=49152, d_model=576, n_layers=30,
            n_heads=9, n_kv=3, d_ff=1536, head_dim=64,
            rope_theta=10000.0, tie_embeddings=True,
        ),
        sub_quadratic=False,
    )


def reduced() -> ArchSpec:
    return ArchSpec(
        arch_id=ARCH_ID + "-smoke", kind="lm", family="dense",
        citation="hf:HuggingFaceTB/SmolLM-135M",
        lm=LMConfig(
            name=ARCH_ID + "-smoke", vocab=512, d_model=96, n_layers=2,
            n_heads=3, n_kv=3, d_ff=192, head_dim=32,
            tie_embeddings=True, dtype="float32", remat=False,
        ),
        sub_quadratic=False,
    )

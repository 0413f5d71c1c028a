"""Mamba2-1.3B [arXiv:2405.21060].

48L d_model=2048 attn-free d_ff=0 vocab=50280, ssm_state=128 — SSD
(state-space duality). Pure (mamba, none) blocks; decode is O(1) state
update, so every decode shape including long_500k runs. The attention
fields are unused.
"""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.mamba2 import Mamba2Config
from repro_torch.models.transformer import LMConfig

ARCH_ID = "mamba2-1.3b"


def full() -> ArchSpec:
    return ArchSpec(
        arch_id=ARCH_ID, kind="lm", family="ssm", citation="arXiv:2405.21060",
        lm=LMConfig(
            name=ARCH_ID, vocab=50280, d_model=2048, n_layers=48,
            n_heads=1, n_kv=1, d_ff=0, head_dim=64,  # attn fields unused
            blocks=tuple([("mamba", "none")] * 48),
            mamba=Mamba2Config(d_model=2048, d_state=128, headdim=64, expand=2),
        ),
        sub_quadratic=True,
        notes="attention-free: Graph4Rec's sampling techniques inapplicable; "
              "shares the PS-sharded vocab table.",
    )


def reduced() -> ArchSpec:
    return ArchSpec(
        arch_id=ARCH_ID + "-smoke", kind="lm", family="ssm",
        citation="arXiv:2405.21060",
        lm=LMConfig(
            name=ARCH_ID + "-smoke", vocab=512, d_model=128, n_layers=2,
            n_heads=1, n_kv=1, d_ff=0, head_dim=32,
            blocks=tuple([("mamba", "none")] * 2),
            mamba=Mamba2Config(d_model=128, d_state=32, headdim=32, expand=2,
                               chunk=32),
            dtype="float32", remat=False,
        ),
        sub_quadratic=True,
    )

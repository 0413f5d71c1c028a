"""Architecture registry: ``--arch <id>`` resolution.

``ARCH_IDS`` lists all ten of ``repro``'s archs in its order: the eight
``kind == "lm"`` ones (dense attention, MoE, Mamba2 and the Jamba hybrid),
Qwen2-VL (``vlm``) and Whisper (``whisper``).
"""
from __future__ import annotations

from typing import List

from repro_torch.configs import (
    deepseek_coder_33b,
    jamba_v0_1_52b,
    mamba2_1_3b,
    mixtral_8x22b,
    olmoe_1b_7b,
    qwen2_0_5b,
    qwen2_vl_7b,
    smollm_135m,
    starcoder2_7b,
    whisper_tiny,
)
from repro_torch.configs.base import ArchSpec

_MODULES = {
    "qwen2-vl-7b": qwen2_vl_7b,
    "whisper-tiny": whisper_tiny,
    "mixtral-8x22b": mixtral_8x22b,
    "qwen2-0.5b": qwen2_0_5b,
    "smollm-135m": smollm_135m,
    "starcoder2-7b": starcoder2_7b,
    "olmoe-1b-7b": olmoe_1b_7b,
    "deepseek-coder-33b": deepseek_coder_33b,
    "jamba-v0.1-52b": jamba_v0_1_52b,
    "mamba2-1.3b": mamba2_1_3b,
}

ARCH_IDS: List[str] = list(_MODULES)


def get_arch(arch_id: str, reduced: bool = False) -> ArchSpec:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    mod = _MODULES[arch_id]
    return mod.reduced() if reduced else mod.full()

"""Architecture registry: ``--arch <id>`` resolution.

``ARCH_IDS`` lists all ten of ``repro``'s archs in its order; the four
dense-attention ones are ported, and ``get_arch`` of any other raises
``NotImplementedError`` naming its ROADMAP item.
"""
from __future__ import annotations

from typing import List

from repro_torch.configs import deepseek_coder_33b, qwen2_0_5b, smollm_135m, starcoder2_7b
from repro_torch.configs.base import ArchSpec

_MOE = "ROADMAP Queue 1 item 8b, MoE"
_SSM = "ROADMAP Queue 1 item 8c, Mamba2 and Jamba"
_ARCHS = {
    "qwen2-vl-7b": "ROADMAP Queue 1 item 8d, Qwen2-VL",
    "whisper-tiny": "ROADMAP Queue 1 item 8e, Whisper",
    "mixtral-8x22b": _MOE,
    "qwen2-0.5b": qwen2_0_5b,
    "smollm-135m": smollm_135m,
    "starcoder2-7b": starcoder2_7b,
    "olmoe-1b-7b": _MOE,
    "deepseek-coder-33b": deepseek_coder_33b,
    "jamba-v0.1-52b": _SSM,
    "mamba2-1.3b": _SSM,
}

ARCH_IDS: List[str] = list(_ARCHS)
PORTED_ARCH_IDS: List[str] = [a for a, m in _ARCHS.items() if not isinstance(m, str)]


def get_arch(arch_id: str, reduced: bool = False) -> ArchSpec:
    if arch_id not in _ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    mod = _ARCHS[arch_id]
    if isinstance(mod, str):
        raise NotImplementedError(f"arch {arch_id!r} is not ported yet ({mod})")
    return mod.reduced() if reduced else mod.full()

"""The LM substrate: norms, attention and MLPs (``layers``), the MoE and
Mamba2 block kinds (``moe``, ``mamba2``), the decoder (``transformer``),
Qwen2-VL and Whisper (``qwen2_vl``, ``whisper``) and the mesh placement
rules (``sharding``)."""
from repro_torch.models import (  # noqa: F401
    layers, mamba2, moe, qwen2_vl, sharding, transformer, whisper,
)

"""The LM substrate: norms, attention and MLPs (``layers``), the MoE and
Mamba2 block kinds (``moe``, ``mamba2``) and the decoder (``transformer``)."""
from repro_torch.models import layers, mamba2, moe, transformer  # noqa: F401

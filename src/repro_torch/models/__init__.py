"""The LM substrate, dense-attention blocks (``layers``, ``transformer``)."""
from repro_torch.models import layers, transformer  # noqa: F401

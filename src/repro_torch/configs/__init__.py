"""Architecture specs of the LM substrate; the four dense-attention archs
are ported, the others raise naming their ROADMAP item."""
from repro_torch.configs.base import ArchSpec, SHAPES, ShapeSpec  # noqa: F401
from repro_torch.configs.registry import ARCH_IDS, PORTED_ARCH_IDS, get_arch  # noqa: F401

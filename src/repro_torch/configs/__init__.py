"""Architecture specs of the LM substrate: all ten of ``repro``'s archs."""
from repro_torch.configs.base import ArchSpec, SHAPES, ShapeSpec  # noqa: F401
from repro_torch.configs.registry import ARCH_IDS, get_arch  # noqa: F401

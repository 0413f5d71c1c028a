"""Architecture specs of the LM substrate; the eight ``lm`` archs are
ported, Qwen2-VL and Whisper raise naming their ROADMAP items."""
from repro_torch.configs.base import ArchSpec, SHAPES, ShapeSpec  # noqa: F401
from repro_torch.configs.registry import ARCH_IDS, PORTED_ARCH_IDS, get_arch  # noqa: F401

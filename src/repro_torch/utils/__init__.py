from repro_torch.utils.log import get_logger
from repro_torch.utils.ragged import ragged_row_offsets

# The tree helpers import torch. They are exported lazily (PEP 562), as
# ``repro`` exports its pytree helpers, so that the numpy-only graph service
# workers, whose imports reach this package, never load torch.
_PYTREE_EXPORTS = ("tree_leaves", "tree_num_params", "tree_size_bytes")


def __getattr__(name):
    if name in _PYTREE_EXPORTS:
        from repro_torch.utils import pytree

        return getattr(pytree, name)
    raise AttributeError(f"module 'repro_torch.utils' has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_PYTREE_EXPORTS))

from repro_torch.walk.metapath import (
    WalkConfig, MetapathWalker, parse_metapath, walk_from_bits, walk_multi_from_bits,
)

from repro_torch.walk.metapath import WalkConfig, MetapathWalker, parse_metapath

from repro_torch.sampling.ego import EgoConfig, EgoBatch, sample_ego_batch, PAD

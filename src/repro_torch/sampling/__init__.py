from repro_torch.sampling.ego import EgoConfig, EgoBatch, sample_ego_batch, PAD
from repro_torch.sampling.pairs import (
    PairConfig, window_pairs, window_positions, pairs_to_nodes,
    sample_random_negatives,
)
from repro_torch.sampling.pipeline import (
    PipelineConfig, SamplePipeline, TrainBatch, make_train_sampler,
)

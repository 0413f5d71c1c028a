from repro_torch.core.gnn import GNN_TYPES, init_layer, apply_layer, masked_mean, masked_sum
from repro_torch.core.hetero import HeteroGNNConfig, init_hetero_params, hetero_forward, relation_mix
from repro_torch.core.model import (
    Graph4RecConfig, Graph4RecModel, init_model_params, encode, encode_ids,
    encode_ego,
)
from repro_torch.core.recall import evaluate_recall

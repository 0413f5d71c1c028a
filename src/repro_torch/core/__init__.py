from repro_torch.core.gnn import GNN_TYPES, init_layer, apply_layer, masked_mean, masked_sum
from repro_torch.core.hetero import HeteroGNNConfig, init_hetero_params, hetero_forward, relation_mix
from repro_torch.core.loss import neg_sampling_loss, inbatch_softmax_loss, inbatch_sigmoid_loss
from repro_torch.core.model import (
    Graph4RecConfig, Graph4RecModel, init_model_params, loss_fn, encode, encode_ids,
    encode_ego, device_batch, host_batch, sparse_device_batch, sparse_host_batch,
    encode_all_nodes, split_params, sparse_dense_split,
)
from repro_torch.core.recall import evaluate_recall

from repro_torch.embedding.table import (
    EmbeddingConfig, SlotSpec, init_params, lookup, embed_nodes,
    embed_nodes_bag, embed_nodes_mixed, pad_slot_values, slot_count_matrix,
)

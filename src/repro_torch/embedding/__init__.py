from repro_torch.embedding.table import (
    EmbeddingConfig, SlotSpec, init_params, lookup, embed_nodes,
    embed_nodes_bag, embed_nodes_mixed, pad_slot_values, slot_count_matrix,
    unique_pad_ids, remap_ids, gather_rows, scatter_rows,
    save_table, load_table, warm_start,
)
from repro_torch.embedding.optimizer import (
    RowAdagradState, rowwise_adagrad_init, rowwise_adagrad_update,
    rowwise_adagrad_scatter_update,
)

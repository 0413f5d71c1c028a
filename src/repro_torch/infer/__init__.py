"""Full-graph inference on the card: every node -> its embedding."""
from repro_torch.infer.embed import (
    embed_all_nodes, export_embeddings, load_embeddings,
)

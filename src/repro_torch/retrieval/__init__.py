"""Exact top-k retrieval: the numpy oracle and the streaming device path."""
from repro_torch.retrieval.topk import (
    brute_force_topk, chunked_topk, pad_id_rows,
)

"""Retrieval: exact top-k (the numpy oracle and the streaming device path)
and the IVF index (int8 inverted lists, exact re-rank)."""
from repro_torch.retrieval.ivf import IVFConfig, IVFIndex
from repro_torch.retrieval.topk import (
    brute_force_topk, chunked_topk, pad_id_rows,
)

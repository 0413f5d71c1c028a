"""Batched LM serving (prefill-by-decode over the KV cache)."""
from repro_torch.serve.engine import BatchedServer, ServeConfig  # noqa: F401

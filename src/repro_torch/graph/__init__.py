"""The numpy graph layer of the port (copies of ``repro.graph``), the
multi-process shared-memory engine (``graph.service``) included.

Nothing here imports torch: a spawned graph-service worker imports this
package and must stay numpy-only.
"""
from repro_torch.graph.hetero_graph import HeteroGraph, Relation, CSR, SlotFeature
from repro_torch.graph.generator import (
    DatasetSpec, RecsysDataset, generate, SPECS,
    RETAILROCKET, REC15, TMALL, UB, TOY,
)
from repro_torch.graph.engine import (
    DistributedGraphEngine, EngineStats, engine_sample_many,
)
from repro_torch.graph.service import EngineWorkerError, GraphClient

"""The numpy graph layer of the port (copies of ``repro.graph``).

The multi-process shared-memory engine (``repro.graph.service``) is not
ported yet: the in-process ``DistributedGraphEngine`` draws the same stream.
"""
from repro_torch.graph.hetero_graph import HeteroGraph, Relation, CSR, SlotFeature
from repro_torch.graph.generator import (
    DatasetSpec, RecsysDataset, generate, SPECS,
    RETAILROCKET, REC15, TMALL, UB, TOY,
)
from repro_torch.graph.engine import (
    DistributedGraphEngine, EngineStats, engine_sample_many,
)

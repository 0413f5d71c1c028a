"""Multi-process shared-memory graph engine (Graph4Rec §3.1 at host scale).

The paper's distributed graph engine stores partitioned adjacency on
dedicated servers so samplers never contend with training for cores. This
package is that subsystem for a single host:

- ``shm``     — partition CSR shards packed into POSIX shared memory by the
                parent, attached zero-copy by workers.
- ``worker``  — the per-process partition server loop (NumPy-only imports).
- ``client``  — ``GraphClient``: the async, pipelined, API-compatible face
                the walker / ego sampler / pipeline / trainer consume.

Select it with ``TrainerConfig(engine_backend="mp", num_engine_workers=N)``
or construct ``GraphClient`` directly (it is a context manager). With a
fixed seed both backends produce bitwise-identical walks, ego graphs, and
training losses (see ``graph/engine.py`` for the randomness contract).

The port's copy of ``repro.graph.service``: numpy and ``multiprocessing``
only, so a spawned worker imports neither torch nor JAX.
"""
from repro_torch.graph.service.client import EngineWorkerError, GraphClient, PendingRequest
from repro_torch.graph.service.shm import ArraySpec, ShardManifest, attach_shard, build_shard
from repro_torch.graph.service.worker import worker_main

__all__ = [
    "ArraySpec",
    "EngineWorkerError",
    "GraphClient",
    "PendingRequest",
    "ShardManifest",
    "attach_shard",
    "build_shard",
    "worker_main",
]

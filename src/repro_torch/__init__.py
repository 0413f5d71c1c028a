"""Graph4Rec in PyTorch for NVIDIA Hopper: the port of ``repro``.

The package mirrors ``repro``'s layout, so the counterpart of
``repro/<path>.py`` is ``repro_torch/<path>.py``. It imports nothing of
``repro`` and nothing of JAX: the numpy host layer (graph, engine, ego
sampling, slot helpers) is copied in and draws the same
``np.random.Generator`` stream, so both packages see bitwise-identical host
batches from one seed.

Ported: serving (full-graph inference in ``infer``; exact top-k and
IVF recall in ``retrieval`` and ``core.recall``), training on host or
fused device sampling (``train``, ``sampling``) over the in-process or the
multi-process shared-memory graph engine (``graph``, ``graph.service``)
with warm start (``embedding.warm_start``), the LM substrate's serving side
(``models``, ``configs``, ``serve``) and the observability layer (``obs``,
``train.attribution``). This module and ``graph`` import no torch, so a
spawned graph-service worker never loads it. The kernels (``seg_aggr``
and its backward, ``topk``, ``inbatch_loss``, ``row_adagrad``,
``window_pairs`` and ``window_pair_draw``, ``ivf_list_topk``) are CUDA C++ for ``sm_90a`` under
``kernels/csrc``; ``kernels/ops`` runs them for CUDA tensors and their plain
PyTorch versions (``kernels/ref``) for CPU tensors.

Every entry point takes a ``device``. ``None`` means CUDA, and raises where
there is none (``device.resolve_device``); the CPU runs only when asked for.
"""

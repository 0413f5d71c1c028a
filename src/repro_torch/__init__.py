"""Graph4Rec in PyTorch for NVIDIA Hopper: the port of ``repro``.

The package mirrors ``repro``'s layout, so the counterpart of
``repro/<path>.py`` is ``repro_torch/<path>.py``. It imports nothing of
``repro`` and nothing of JAX: the numpy host layer (graph, engine, ego
sampling, slot helpers) is copied in and draws the same
``np.random.Generator`` stream, so both packages see bitwise-identical host
batches from one seed.

This slice is the serving path: full-graph inference (``infer``) and exact
streaming top-k recall (``retrieval``, ``core.recall``). Its two kernels,
``seg_aggr`` and ``topk``, are CUDA C++ for ``sm_90a`` under
``kernels/csrc``; ``kernels/ops`` runs them for CUDA tensors and their plain
PyTorch versions (``kernels/ref``) for CPU tensors.

Every entry point takes a ``device``. ``None`` means CUDA, and raises where
there is none (``device.resolve_device``); the CPU runs only when asked for.
"""

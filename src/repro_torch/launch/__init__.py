"""Launch-side entry points of the port: ``recall_report`` (a copy of
``repro``'s), ``train`` (LM training) and the launch tools (``dryrun``,
``roofline``, ``mesh``, ``perf``, ``report``, ``logparse``)."""
from repro_torch.launch.mesh import make_production_mesh, make_host_mesh  # noqa: F401

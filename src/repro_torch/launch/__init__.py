"""Launch-side entry points of the port: ``recall_report`` (a copy of
``repro``'s), ``train`` (LM training) and the launch tools (``dryrun``,
``roofline``, ``mesh``, ``perf``, ``report``, ``logparse``)."""

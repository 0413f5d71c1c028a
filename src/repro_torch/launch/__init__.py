"""Launch-side entry points of the port: ``recall_report`` (a copy of ``repro``'s) and ``train`` (LM training)."""

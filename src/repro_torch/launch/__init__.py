"""Launch-side helpers of the port: ``recall_report`` (a copy of ``repro``'s)."""

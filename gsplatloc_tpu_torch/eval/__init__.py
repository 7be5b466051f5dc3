"""Evaluation: pose-error metrics and the experiment logger (JSONL, res.json,
markdown tables)."""

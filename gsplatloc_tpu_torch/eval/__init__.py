"""Evaluation: pose-error metrics, the experiment logger (JSONL, res.json,
markdown tables), the fixture and render records' comparisons, figures and
the depth colormap, image metrics (LPIPS) and the live viewer."""

#!/usr/bin/env python3
"""Build gsplatloc_tpu_torch/eval/render_reference.json: the JAX package's
`cli render` at its defaults, run on the CPU, summarized per view.

    python3 tools/build_render_reference.py

Runs `gsplatloc_tpu.cli.main(["--platform", "cpu", "render", ...])` with
the command's defaults (Synthetic, 320x240, --path spline, --n-views 24,
--backend pallas: the Pallas kernels in interpret mode on the CPU) into a
temporary directory, and records every view's render as the JAX
package's rasterizer returned it: the summaries of
gsplatloc_tpu_torch/eval/render_compare.py (per view the means of R, G,
B, alpha and ED; block means for the first, middle and last views), the
command, the numpy and JAX versions and the machine. A few minutes on a
CPU.
"""

from __future__ import annotations

import json
import os
import platform
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def main():
    import importlib

    import jax

    jax.config.update("jax_platforms", "cpu")
    from gsplatloc_tpu.cli import main as jmain

    # the module (gsplatloc_tpu.ops re-exports a function of its name)
    jrast = importlib.import_module("gsplatloc_tpu.ops.rasterize")
    from gsplatloc_tpu_torch.eval import render_compare

    captured = []
    rasterize = jrast.rasterize

    def recording(*a, **kw):
        render, alpha = rasterize(*a, **kw)
        captured.append(render_compare.summarize(np.asarray(render),
                                                 np.asarray(alpha)))
        return render, alpha

    cmd = ["render", "--dataset", "Synthetic", "--path", "spline",
           "--n-views", "24", "--height", "240", "--width", "320",
           "--backend", "pallas"]
    t0 = time.perf_counter()
    jrast.rasterize = recording
    try:
        with tempfile.TemporaryDirectory() as tmp:
            jmain(["--platform", "cpu"] + cmd + ["--out", tmp])
            written = len(list(Path(tmp).glob("view_*.png")))
    finally:
        jrast.rasterize = rasterize
    if written != len(captured):
        raise RuntimeError(f"{written} panels written, {len(captured)} "
                           "renders recorded")
    n = len(captured)
    record = {
        "command": "python -m gsplatloc_tpu.cli --platform cpu "
                   + " ".join(cmd),
        "machine": f"{platform.machine()} CPU, {os.cpu_count()} cores, "
                   f"JAX platform {jax.devices()[0].platform}",
        "numpy": np.__version__,
        "jax": jax.__version__,
        "seconds": round(time.perf_counter() - t0, 1),
        "height": 240, "width": 320, "block": render_compare.BLOCK,
        "views": n,
        "per_view": [{k: v for k, v in s.items() if k != "blocks"}
                     for s in captured],
        "blocks": {str(i): captured[i]["blocks"]
                   for i in render_compare.block_views(n)},
    }
    out = render_compare.REFERENCE
    out.write_text(json.dumps(record) + "\n")
    print(f"wrote {out}: {n} views, {out.stat().st_size} bytes, "
          f"{record['seconds']} s")


if __name__ == "__main__":
    main()

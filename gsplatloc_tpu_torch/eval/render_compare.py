"""Per-view summaries of a fly-through render (`cli render`) and their
comparison with the JAX package's record of the same command.

The record, eval/render_reference.json, is written by
tools/build_render_reference.py: the JAX package's `cli render` on the
CPU at its defaults (Synthetic, 320x240, --path spline, 24 views asked).
Per view it holds the means of R, G, B and alpha over the image and of the
expected depth (ED) over the pixels with alpha > 0.5; for the first,
middle and last views also the 16x16-pixel block means of the same five
(a block's ED over its alpha > 0.5 pixels, null where it has none).

Gate: every recorded number within TOL, absolute for colour and alpha,
relative for ED. The same f32 arithmetic in another order moves a mean by
~1e-6; a gate flip at one pixel (a splat admitted in one package and not
the other) moves its block's mean by up to 1/256 of the pixel's value,
~4e-3, which TOL does not allow.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

REFERENCE = Path(__file__).with_name("render_reference.json")
BLOCK = 16
TOL = 1e-3
CHANNELS = ("r", "g", "b", "alpha", "ed")


def block_views(n_views: int) -> list[int]:
    """The views whose block means are recorded."""
    return sorted({0, n_views // 2, n_views - 1})


def summarize(render, alpha, blocks: bool = True) -> dict:
    """render (H, W, 4) RGB+ED, alpha (H, W) -> the view's summary: the
    five means, and with blocks=True their (H//16, W//16) block means."""
    render = np.asarray(render, np.float64)
    alpha = np.asarray(alpha, np.float64)
    solid = alpha > 0.5
    ed = np.where(solid, render[..., 3], 0.0)
    out = {"r": float(render[..., 0].mean()),
           "g": float(render[..., 1].mean()),
           "b": float(render[..., 2].mean()),
           "alpha": float(alpha.mean()),
           "ed": float(ed.sum() / solid.sum()) if solid.any() else None}
    if blocks:
        hb, wb = alpha.shape[0] // BLOCK, alpha.shape[1] // BLOCK

        def bsum(x):
            return x[:hb * BLOCK, :wb * BLOCK].reshape(
                hb, BLOCK, wb, BLOCK).sum(axis=(1, 3))

        n = float(BLOCK * BLOCK)
        cnt = bsum(solid.astype(np.float64))
        ed_b = np.where(cnt > 0, bsum(ed) / np.maximum(cnt, 1.0), np.nan)
        out["blocks"] = {
            "r": (bsum(render[..., 0]) / n).tolist(),
            "g": (bsum(render[..., 1]) / n).tolist(),
            "b": (bsum(render[..., 2]) / n).tolist(),
            "alpha": (bsum(alpha) / n).tolist(),
            "ed": [[None if np.isnan(v) else float(v) for v in row]
                   for row in ed_b],
        }
    return out


def load_reference(path=REFERENCE) -> dict:
    return json.loads(Path(path).read_text())


def _diff(ch, got, ref):
    """The distance the gate reads: absolute, or relative for ED; a value
    present on one side only, or a non-finite one, is an infinite
    distance."""
    if got is None or ref is None:
        return 0.0 if got is None and ref is None else float("inf")
    d = abs(got - ref)
    d = d / max(abs(ref), 1e-30) if ch == "ed" else d
    return d if np.isfinite(d) else float("inf")


def compare(record: dict, summaries: list[dict]) -> dict:
    """Hold a run's per-view summaries against the record. Returns the
    largest distance per channel (absolute; ED relative), where the
    largest one was found, and whether every number is within TOL."""
    worst = {ch: 0.0 for ch in CHANNELS}
    where = {}
    if len(summaries) != record["views"]:
        return {"ok": False, "views": len(summaries),
                "reason": f"{len(summaries)} views, the record has "
                          f"{record['views']}"}

    def see(ch, d, at):
        if d > worst[ch]:
            worst[ch] = d
            where[ch] = at

    for i, (got, ref) in enumerate(zip(summaries, record["per_view"])):
        for ch in CHANNELS:
            see(ch, _diff(ch, got[ch], ref[ch]), f"view {i} mean")
    for key, ref_b in record["blocks"].items():
        got_b = summaries[int(key)]["blocks"]
        for ch in CHANNELS:
            if np.shape(got_b[ch]) != np.shape(ref_b[ch]):
                see(ch, float("inf"), f"view {key} block grid")
            for y, (g_row, r_row) in enumerate(zip(got_b[ch], ref_b[ch])):
                for x, (g, r) in enumerate(zip(g_row, r_row)):
                    see(ch, _diff(ch, g, r), f"view {key} block ({y}, {x})")
    return {"ok": all(v <= TOL for v in worst.values()),
            "views": len(summaries), "max_diff": worst, "where": where}

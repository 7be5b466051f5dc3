#!/usr/bin/env python3
"""Hold the port's HYBRID dense odometry against the JAX package's on the
CPU, at full size, pair by pair, beside the reference's room0 records.

    JAX_PLATFORMS=cpu python3 tools/hybrid_odometry_check.py [--pairs 3]
        [--files DIR]

For each of the first --pairs pairs of the Replica fixture room0
(1200x680) it runs `rgbd_odometry_multi_scale` as `cli icp`'s HYBRID
method calls it (GT-init protocol: est = gt_i @ T_rel, so a perfect registration reports
the one-frame motion) through

  jax       the JAX package on the CPU (f32 products);
  jax-bf16  the same, with every product that the JAX package leaves at
            the default precision given bfloat16 inputs and f32
            accumulation, the way XLA computes an f32 dot at the default
            precision on a TPU (the g6 products, `se3_exp(dx) @ T` and
            the products inside `se3_exp`; H6 stays at HIGHEST);
  port      the port's `tracking/odometry.py` on the CPU;

and prints each one's eT (cm), eR (deg) and trace(R_rel) - 3 beside the
reference's record (`eval/fixture_reference.json`, HYBRID, room0) and
the true one-frame motion, and the largest |T_rel| difference between
jax and port.

The frames are the port's `ReplicaFixture` (depth bit for bit the files',
colour before the JPEG encoding); with --files DIR they are read from a
folder that `PYTHONPATH=. python3 scripts/make_replica_fixture.py
--rooms room0 --out DIR` wrote (JPEG
colour, the records' own input) by the JAX package's loader. Imports JAX
and both packages: a comparison tool, not part of the port.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
ROOM = "room0"  # the room of the reference's HYBRID records
sys.path.insert(0, str(REPO))


@contextlib.contextmanager
def tpu_default_precision():
    """Give every f32 dot at the default precision bfloat16 inputs and f32
    accumulation while the context is open (products asked for at HIGHEST
    keep f32). Clears JAX's caches on entry and exit, so no trace made
    under one rule is reused under the other."""
    import jax
    import jax.numpy as jnp
    from jax._src.lax import lax as lax_impl

    orig = lax_impl.dot_general

    def is_default(precision):
        if precision is None:
            return True
        ps = precision if isinstance(precision, tuple) else (precision,)
        return all(p in (None, jax.lax.Precision.DEFAULT) for p in ps)

    def dot_general(lhs, rhs, dimension_numbers, precision=None,
                    preferred_element_type=None, **kw):
        if (is_default(precision) and jnp.result_type(lhs) == jnp.float32
                and jnp.result_type(rhs) == jnp.float32):
            return orig(lhs.astype(jnp.bfloat16), rhs.astype(jnp.bfloat16),
                        dimension_numbers, precision=precision,
                        preferred_element_type=jnp.float32, **kw)
        return orig(lhs, rhs, dimension_numbers, precision=precision,
                    preferred_element_type=preferred_element_type, **kw)

    jax.clear_caches()
    lax_impl.dot_general = dot_general
    try:
        yield
    finally:
        lax_impl.dot_general = orig
        jax.clear_caches()


def frames_of(args):
    if args.files:
        from gsplatloc_tpu.data.datasets import Replica

        return Replica(ROOM, root=args.files)
    from gsplatloc_tpu_torch.data.fixtures import ReplicaFixture

    return ReplicaFixture(ROOM, frames=args.pairs + 1)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--files", default=None,
                    help="a make_replica_fixture.py folder (JPEG colour)")
    args = ap.parse_args(argv)

    import torch

    from gsplatloc_tpu.tracking import odometry as jodo
    from gsplatloc_tpu_torch.eval.metrics import (rotation_error_deg,
                                                  translation_error)
    from gsplatloc_tpu_torch.tracking import odometry as todo

    torch.set_num_threads(4)
    ref = json.loads((REPO / "gsplatloc_tpu_torch" / "eval"
                      / "fixture_reference.json").read_text())
    rec = ref["icp"][f"{ROOM}_HYBRID"]["pairs"]
    ds = frames_of(args)
    print(f"frames: {ds} ({'JPEG colour' if args.files else 'pre-JPEG'})")

    def errors(est, gt):
        eT = float(translation_error(torch.as_tensor(est, dtype=torch.float32),
                                     torch.as_tensor(gt, dtype=torch.float32)))
        return eT * 100, float(rotation_error_deg(est, gt))

    prev = None
    for i in range(args.pairs + 1):
        f = ds[i]
        cur = (np.asarray(f.rgb, np.float64) / 255.0,
               np.asarray(f.depth, np.float64), f.K)
        gt_i = f.c2w.astype(np.float64)
        if prev is None:
            prev, gt_prev = cur, gt_i
            continue
        rgb, depth, K = cur
        call = (rgb, depth, prev[0], prev[1], K)
        rel = {
            "jax": jodo.rgbd_odometry_multi_scale(*call, init_T=np.eye(4)),
            "port": todo.rgbd_odometry_multi_scale(*call, init_T=np.eye(4),
                                                   device="cpu"),
        }
        with tpu_default_precision():
            rel["jax-bf16"] = jodo.rgbd_odometry_multi_scale(
                *call, init_T=np.eye(4))
        true_rel = np.linalg.inv(gt_prev) @ gt_i
        j = i - 1
        print(f"pair {j}: one-frame motion {errors(gt_i @ true_rel, gt_i)}"
              f"  reference record eT {rec[j]['eT'] * 100:.5f} cm, eR "
              f"{rec[j]['eR']:.5f} deg")
        for name in ("jax", "jax-bf16", "port"):
            eT, eR = errors(gt_i @ rel[name].astype(np.float64), gt_i)
            tr = float(np.trace(rel[name][:3, :3].astype(np.float64)))
            print(f"  {name:8s} eT {eT:.5f} cm  eR {eR:.5f} deg  "
                  f"trace(R_rel) - 3 {tr - 3:.3e}")
        print(f"  max |T_rel jax - port| "
              f"{np.abs(rel['jax'] - rel['port']).max():.3e}")
        prev, gt_prev = cur, gt_i
    if hasattr(ds, "close"):
        ds.close()


if __name__ == "__main__":
    main()

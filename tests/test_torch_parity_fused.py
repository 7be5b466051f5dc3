"""Port vs reference: the on-device parity gates of the two fused tracking
families, `subtile_parity` and `kcover_parity` (ops/parity.py), against
the full-tile path. Both packages run them on the CPU at 64x128: the port
through its plain PyTorch versions, the reference through its interpreted
Pallas kernels. kcover_parity at k_cover=12 takes the index select in
both (K * 5 % 8 != 0)."""

import numpy as np
import pytest
import torch

from gsplatloc_tpu.ops import parity as jpar
from gsplatloc_tpu_torch import kernels
from gsplatloc_tpu_torch.ops import parity as tpar
from torch_port_helpers import assert_rel

H, W = 64, 128
CASES = {
    "subtile": lambda mod, **kw: mod.subtile_parity(H, W, **kw),
    "kcover16": lambda mod, **kw: mod.kcover_parity(H, W, k_cover=16, **kw),
    "kcover12": lambda mod, **kw: mod.kcover_parity(H, W, k_cover=12, **kw),
}


@pytest.fixture(scope="module")
def results():
    """Each gate once per package (the reference's calls dominate)."""
    return {}


def _run(results, name):
    if name not in results:
        kernels.reset_launch_counts()
        port = CASES[name](tpar, device="cpu")
        assert all(v == 0 for v in kernels.launch_counts().values())
        results[name] = (port, CASES[name](jpar))
    return results[name]


@pytest.mark.parametrize("name", list(CASES))
def test_parity_gate_matches_reference(results, name):
    """Losses within 1e-5 relative, the (3, 4) viewmat gradients of both
    sides within 1e-4 of their scale, the same keys and the same verdict
    (kcover_parity at k_cover=12 fails in both: K=12 truncates the cover
    lists of some pixels of this scene)."""
    port, ref = _run(results, name)
    assert set(port) == set(ref)
    for key in ("loss_full", "loss_sub"):
        np.testing.assert_allclose(port[key], ref[key], rtol=1e-5)
    for key in ("grad_full", "grad_sub"):
        assert port[key].shape == (3, 4)
        assert_rel(port[key], ref[key], 1e-4, key)
    assert port["ok"] == ref["ok"]
    assert port["ok"] is (name != "kcover12")


@pytest.mark.parametrize("name", list(CASES))
def test_parity_gate_forward_errors_match_reference(results, name):
    """The forward errors against the full-tile path agree: far below the
    gate where the gate passes, the same truncation error where it fails."""
    port, ref = _run(results, name)
    for key in ("d_err", "a_err"):
        np.testing.assert_allclose(port[key], ref[key], atol=1e-4)


@pytest.mark.parametrize("fn", ["subtile_parity", "kcover_parity"])
def test_parity_gate_default_device_raises_without_a_card(fn):
    """The gates run on the card unless the caller asks for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="cuda"):
        getattr(tpar, fn)(H, W)

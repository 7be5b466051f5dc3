"""Port vs reference: Sobel stencil, tracking loss (value and gradient)
and the Adam / exponential-lr step. Tolerance 1e-6: elementwise f32
algebra on O(1) values and means over a few thousand terms."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsplatloc_tpu import losses as jlosses
from gsplatloc_tpu.ops import filters as jfilters
from gsplatloc_tpu.opt import adam as jadam
from gsplatloc_tpu_torch import losses as tlosses
from gsplatloc_tpu_torch.ops import filters as tfilters
from gsplatloc_tpu_torch.opt import adam as tadam
from torch_port_helpers import to_np, tt

ATOL = 1e-6


def _depth_pair(seed=0, h=40, w=56):
    rng = np.random.default_rng(seed)
    rendered = (1.0 + rng.random((h, w))).astype(np.float32)
    rendered[rng.random((h, w)) < 0.15] = 0.0  # uncovered pixels
    gt = (1.0 + rng.random((h, w))).astype(np.float32)
    return rendered, gt


def test_sobel_matches_reference_stencil_and_conv():
    img = _depth_pair(1)[1]
    ours = to_np(tfilters.sobel_magnitude(tt(img)))
    np.testing.assert_allclose(
        ours, to_np(jfilters.sobel_magnitude(jnp.asarray(img))), atol=ATOL)
    np.testing.assert_allclose(
        ours, to_np(jfilters._sobel_magnitude_conv(jnp.asarray(img))),
        atol=2e-6)


def test_sobel_constant_image_is_sqrt_eps():
    out = tfilters.sobel_magnitude(torch.full((8, 9), 3.0))
    np.testing.assert_allclose(to_np(out), np.sqrt(1e-6), rtol=1e-6)


@pytest.mark.parametrize("loss_type", ["l1", "mse"])
def test_depth_and_silhouette_losses_match_reference(loss_type):
    a, b = _depth_pair(2)
    for name in ("depth_loss", "silhouette_loss"):
        ref = getattr(jlosses, name)(jnp.asarray(a), jnp.asarray(b), loss_type)
        got = getattr(tlosses, name)(tt(a), tt(b), loss_type)
        np.testing.assert_allclose(float(got), float(ref), atol=ATOL)


@pytest.mark.parametrize("lambdas", [(0.8, 0.0), (1.0, 0.0), (0.6, 0.1)])
def test_tracking_loss_value_and_gradient_match_reference(lambdas):
    dl, nl = lambdas
    rendered, gt = _depth_pair(3)
    ref = jlosses.tracking_loss(jnp.asarray(rendered), jnp.asarray(gt), dl, nl)
    x = tt(rendered).requires_grad_(True)
    got = tlosses.tracking_loss(x, tt(gt), dl, nl)
    for f in ("total", "depth", "silhouette"):
        np.testing.assert_allclose(float(getattr(got, f).detach()),
                                   float(getattr(ref, f)), atol=ATOL)
    got.total.backward()
    g_ref = jax.grad(lambda r: jlosses.tracking_loss(
        r, jnp.asarray(gt), dl, nl).total)(jnp.asarray(rendered))
    # d(mean)/d(pixel) ~ 1/(h*w) = 4e-4: 1e-6 absolute is 0.25 % of it;
    # compare relative to the gradient's scale instead
    np.testing.assert_allclose(to_np(x.grad), to_np(g_ref),
                               atol=1e-5 * float(np.abs(g_ref).max()))
    # no gradient through the mask: uncovered pixels get what their
    # neighbours' stencils give them, never a mask derivative
    if dl == 1.0:
        assert float(x.grad[tt(rendered) == 0].abs().max()) == 0.0


def test_tracking_loss_numpy_lambda_skips_sobel():
    """A zero silhouette weight (python float or numpy scalar) skips the
    Sobel stencils and reports the silhouette diagnostic as 0."""
    rendered, gt = _depth_pair(4)
    for dl in (1.0, np.float32(1.0)):
        got = tlosses.tracking_loss(tt(rendered), tt(gt), dl, 0.0)
        assert float(got.silhouette) == 0.0
        assert float(got.total) == float(got.depth)


def test_invalid_loss_type_raises():
    with pytest.raises(ValueError):
        tlosses.depth_loss(torch.zeros(2, 2), torch.zeros(2, 2), "huber")


def test_twenty_adam_steps_with_decay_match_reference():
    """20 steps on a quaternion-sized and a translation-sized parameter
    with L2 decay, the step-indexed bias correction and the decayed lr."""
    rng = np.random.default_rng(5)
    gamma = 0.2 ** (1.0 / 50)
    for size, lr0, wd in ((4, 5e-4, 1e-3), (3, 1e-3, 1e-3)):
        p0 = rng.normal(size=size).astype(np.float32)
        grads = rng.normal(size=(20, size)).astype(np.float32)
        pj, sj = jnp.asarray(p0), jadam.adam_init(jnp.asarray(p0))
        pt, st = tt(p0), tadam.adam_init(tt(p0))
        for i in range(20):
            lr_j = jadam.exponential_lr(lr0, gamma, jnp.int32(i))
            lr_t = tadam.exponential_lr(lr0, gamma,
                                        torch.tensor(i, dtype=torch.int32))
            np.testing.assert_allclose(float(lr_t), float(lr_j), rtol=1e-6)
            pj, sj = jadam.adam_step(pj, jnp.asarray(grads[i]), sj,
                                     jnp.int32(i), lr_j, wd)
            pt, st = tadam.adam_step(pt, tt(grads[i]), st,
                                     torch.tensor(i, dtype=torch.int32),
                                     lr_t, wd)
        np.testing.assert_allclose(to_np(pt), to_np(pj), atol=ATOL)
        np.testing.assert_allclose(to_np(st.m), to_np(sj.m), atol=ATOL)
        np.testing.assert_allclose(to_np(st.v), to_np(sj.v), atol=ATOL)


def test_adam_step_accepts_python_step_index():
    p = torch.tensor([1.0, -2.0])
    g = torch.tensor([0.5, 0.25])
    a, _ = tadam.adam_step(p, g, tadam.adam_init(p), 0, 1e-3)
    b, _ = tadam.adam_step(p, g, tadam.adam_init(p), torch.tensor(0), 1e-3)
    assert torch.equal(a, b)
    # first step moves every coordinate by ~lr against its gradient
    np.testing.assert_allclose(to_np(p - a), [1e-3, 1e-3], rtol=1e-4)

"""LPIPS perceptual distance (PyTorch, AlexNet backbone).

The architecture of lpips.LPIPS(net='alex'): five convolution stages with
a 3x3 stride-2 max-pool before convs 2 and 3, each stage's features tapped
after its ReLU and unit-normalized over channels, a calibrated 1x1 linear
head per stage, a mean over space and a sum over stages. The convolutions
are library calls (cuDNN on the card, with TF32 off at package import).

Pretrained weights need a network to fetch: `export_lpips_npz` writes them
to an .npz on a machine that has them, `load_lpips_params` reads it, and
`random_lpips_params(seed)` draws He-initialized weights with the same
numpy draws as the JAX package, so a seed gives the same weights in both.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .._device import DEFAULT_DEVICE, as_f32, resolve_device

# AlexNet feature config: (out_ch, kernel, stride, pad) per conv
_ALEX_CONVS = (
    (64, 11, 4, 2),
    (192, 5, 1, 2),
    (384, 3, 1, 1),
    (256, 3, 1, 1),
    (256, 3, 1, 1),
)
# max-pool (3x3 stride 2) applied BEFORE convs 2 and 3 (torchvision alexnet)
_POOL_BEFORE = (1, 2)

# lpips input scaling (imagenet-ish shift/scale on [-1, 1] inputs)
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


def params_from_numpy(params, device=DEFAULT_DEVICE) -> dict:
    """{'convs': [(w OIHW, b), ...], 'lins': [w (1, C, 1, 1), ...]} of
    array-likes (the JAX package's parameters among them) -> the same
    dict of tensors on `device`."""
    dev = resolve_device(device)
    return {"convs": [(as_f32(np.asarray(w, np.float32), dev),
                       as_f32(np.asarray(b, np.float32), dev))
                      for w, b in params["convs"]],
            "lins": [as_f32(np.asarray(w, np.float32), dev)
                     for w in params["lins"]]}


def random_lpips_params(seed: int = 0, device=DEFAULT_DEVICE) -> dict:
    """He-initialized parameters with the pretrained weights' structure."""
    rng = np.random.default_rng(seed)
    convs, lins = [], []
    in_ch = 3
    for out_ch, k, _s, _p in _ALEX_CONVS:
        fan_in = in_ch * k * k
        w = rng.standard_normal((out_ch, in_ch, k, k)).astype(np.float32)
        w *= np.sqrt(2.0 / fan_in)
        convs.append((w, np.zeros((out_ch,), np.float32)))
        lins.append(
            np.abs(rng.standard_normal((1, out_ch, 1, 1))).astype(np.float32))
        in_ch = out_ch
    return params_from_numpy({"convs": convs, "lins": lins}, device)


def export_lpips_npz(out_path: str) -> str:
    """Export pretrained lpips(net='alex') weights to the .npz layout
    `load_lpips_params` reads (keys conv{i}_w OIHW, conv{i}_b, lin{i}_w
    (1, C, 1, 1)). Needs the `lpips` package and its weights, which are
    fetched over a network once:

        python -c "from gsplatloc_tpu_torch.eval.lpips import \\
                   export_lpips_npz; export_lpips_npz('lpips_alex.npz')"
    """
    import lpips as lpips_pkg

    net = lpips_pkg.LPIPS(net="alex", verbose=False)
    convs = [m for m in net.net.modules()
             if m.__class__.__name__ == "Conv2d"]
    lins = [lin.model[-1] for lin in net.lins]
    out = {}
    for i, conv in enumerate(convs):
        out[f"conv{i}_w"] = conv.weight.detach().cpu().numpy()
        out[f"conv{i}_b"] = conv.bias.detach().cpu().numpy()
    for i, lin in enumerate(lins):
        out[f"lin{i}_w"] = lin.weight.detach().cpu().numpy()
    np.savez(out_path, **out)
    return out_path


def load_lpips_params(path: str, device=DEFAULT_DEVICE) -> dict:
    """Load params from an .npz with keys conv{i}_w, conv{i}_b, lin{i}_w."""
    n = len(_ALEX_CONVS)
    with np.load(path) as z:
        return params_from_numpy(
            {"convs": [(z[f"conv{i}_w"], z[f"conv{i}_b"]) for i in range(n)],
             "lins": [z[f"lin{i}_w"] for i in range(n)]}, device)


def _features(x: torch.Tensor, params: dict) -> list[torch.Tensor]:
    """x: (N, 3, H, W) in [-1, 1] -> the 5 feature maps (N, C, h, w)."""
    shift = torch.as_tensor(_SHIFT, device=x.device)[None, :, None, None]
    scale = torch.as_tensor(_SCALE, device=x.device)[None, :, None, None]
    x = (x - shift) / scale
    feats = []
    for i, ((w, b), (_c, _k, s, p)) in enumerate(
            zip(params["convs"], _ALEX_CONVS)):
        if i in _POOL_BEFORE:
            x = F.max_pool2d(x, 3, 2)
        x = F.relu(F.conv2d(x, w, b, stride=s, padding=p))
        feats.append(x)
    return feats


def lpips(img_a: torch.Tensor, img_b: torch.Tensor,
          params: dict) -> torch.Tensor:
    """LPIPS(a, b) of (H, W, 3) or (N, H, W, 3) images in [0, 1]: a scalar,
    or (N,) for a batch."""
    squeeze = img_a.ndim == 3
    if squeeze:
        img_a, img_b = img_a[None], img_b[None]
    xa = img_a.permute(0, 3, 1, 2) * 2.0 - 1.0
    xb = img_b.permute(0, 3, 1, 2) * 2.0 - 1.0
    total = 0.0
    for fa, fb, lin in zip(_features(xa, params), _features(xb, params),
                           params["lins"]):
        na = fa * torch.rsqrt(torch.sum(fa * fa, 1, keepdim=True) + 1e-10)
        nb = fb * torch.rsqrt(torch.sum(fb * fb, 1, keepdim=True) + 1e-10)
        d = (na - nb) ** 2
        total = total + torch.mean(torch.sum(d * lin, dim=1), dim=(1, 2))
    return total[0] if squeeze else total

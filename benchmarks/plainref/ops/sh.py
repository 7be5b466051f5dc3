"""Real spherical-harmonics colour evaluation (degrees 0-3), plain PyTorch.

gsplat's SH path: SH coefficients colors[N, (deg+1)^2, 3] are evaluated
along each Gaussian's view direction, then shifted by +0.5 and clamped at
0. With the scene init (sh0 = (rgb-0.5)/C0, higher bands 0) the result is
exactly `rgb`.
"""

from __future__ import annotations

C0 = 0.28209479177387814
C1 = 0.4886025119029199
C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
      -1.0925484305920792, 0.5462742152960396)
C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
      0.3731763325901154, -0.4570457994644658, 1.445305721320277,
      -0.5900435899266435)


def rgb_to_sh(rgb):
    """DC coefficient from RGB."""
    return (rgb - 0.5) / C0



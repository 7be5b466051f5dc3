"""Spherical-harmonics colour helpers (DC band only in this slice)."""

from __future__ import annotations

C0 = 0.28209479177387814


def rgb_to_sh(rgb):
    """DC coefficient from RGB."""
    return (rgb - 0.5) / C0


def sh_to_rgb(sh):
    return sh * C0 + 0.5

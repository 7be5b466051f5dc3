"""Adam with per-parameter lr / weight decay and a step-indexed bias
correction (own implementation — the loop keeps the step index in a
device tensor and may mask a step out, which torch.optim.Adam's internal
counter cannot follow).

Semantics: L2 weight decay folded into the gradient (NOT AdamW),
bias-corrected moments, eps added after the vhat sqrt; ExponentialLR
gamma stepped once per iteration.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class AdamState(NamedTuple):
    m: torch.Tensor
    v: torch.Tensor


def adam_init(param: torch.Tensor) -> AdamState:
    return AdamState(m=torch.zeros_like(param), v=torch.zeros_like(param))


def adam_step(
    param: torch.Tensor,
    grad: torch.Tensor,
    state: AdamState,
    step,  # 0-based iteration index (int or 0-dim tensor)
    lr,  # already-decayed learning rate for this step
    weight_decay: float = 0.0,
    beta1: float = 0.9,
    beta2: float = 0.999,
    eps: float = 1e-8,
):
    """One Adam step. Returns (new_param, new_state)."""
    g = grad + weight_decay * param
    m = beta1 * state.m + (1.0 - beta1) * g
    v = beta2 * state.v + (1.0 - beta2) * g * g
    t = torch.as_tensor(step, device=param.device).to(param.dtype) + 1.0
    mhat = m / (1.0 - beta1 ** t)
    vhat = v / (1.0 - beta2 ** t)
    new_param = param - lr * mhat / (torch.sqrt(vhat) + eps)
    return new_param, AdamState(m=m, v=v)


def exponential_lr(base_lr: float, gamma: float, step) -> torch.Tensor:
    """lr at iteration `step` (0-based) = base * gamma^step."""
    return base_lr * gamma ** torch.as_tensor(step).to(torch.float32)

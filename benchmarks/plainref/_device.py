"""Device / precision helper shared by every entry point of the port."""

from __future__ import annotations

import numpy as np
import torch

F32 = torch.float32
DEFAULT_DEVICE = "cuda"


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """torch.device for `device`; raises when a CUDA device is asked for and
    none is present — entry points never carry on on the CPU by themselves
    (callers that want the CPU pass device="cpu")."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path"
        )
    return dev


def as_f32(x, device) -> torch.Tensor:
    """numpy array / tensor / scalar -> contiguous float32 tensor on device."""
    if isinstance(x, np.ndarray) and not x.flags.writeable:
        x = x.copy()  # torch refuses to alias a read-only array
    return torch.as_tensor(x, dtype=F32).to(device).contiguous()

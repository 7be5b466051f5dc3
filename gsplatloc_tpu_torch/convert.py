"""State carried across from the reference package.

The reference's GaussianScene, PoseState, AdamState, TrackingConfig and
LPIPS parameters arrive as numpy arrays / plain values (the caller
converts; this module imports nothing of the reference) and come out as
the port's types on the requested device.
"""

from __future__ import annotations

import numpy as np

from ._device import DEFAULT_DEVICE, as_f32, resolve_device
# the reference's LPIPS parameters {'convs': [(w, b), ...], 'lins': [w, ...]}
# as numpy arrays -> the port's (eval/lpips.py) on `device`
from .eval.lpips import params_from_numpy as lpips_params_from_numpy  # noqa: F401
from .models.gaussians import GaussianScene
from .models.pose import PoseState
from .opt.adam import AdamState
from .opt.tracking import TrackingConfig


def _np(x):
    return np.asarray(x, dtype=np.float32)


def scene_from_numpy(scene, device=DEFAULT_DEVICE) -> GaussianScene:
    """Any object/mapping with means, quats, scales, opacities, sh_coeffs
    (array-likes) -> GaussianScene on `device`."""
    dev = resolve_device(device)
    get = (scene.__getitem__ if isinstance(scene, dict)
           else lambda k: getattr(scene, k))
    return GaussianScene(*(as_f32(_np(get(k)), dev)
                           for k in GaussianScene._fields))


def pose_from_numpy(quat, trans, device=DEFAULT_DEVICE) -> PoseState:
    dev = resolve_device(device)
    return PoseState(quat=as_f32(_np(quat), dev), trans=as_f32(_np(trans), dev))


def adam_from_numpy(m, v, device=DEFAULT_DEVICE) -> AdamState:
    dev = resolve_device(device)
    return AdamState(m=as_f32(_np(m), dev), v=as_f32(_np(v), dev))


def config_from_reference(config) -> TrackingConfig:
    """The reference's TrackingConfig (a NamedTuple, a mapping or anything
    with `_asdict`) -> the port's, field for field. An unknown field
    raises: the two configs must not drift apart silently."""
    values = dict(config._asdict()) if hasattr(config, "_asdict") else dict(config)
    unknown = set(values) - set(TrackingConfig._fields)
    if unknown:
        raise ValueError(f"fields without a counterpart in the port: "
                         f"{sorted(unknown)}")
    return TrackingConfig(**values)

"""Camera pose parameterization: quaternion + translation.

Pose stored as (wxyz quaternion, translation); to_c2w() rebuilds the 4x4
camera-to-world from the normalized quaternion; constant-velocity
prediction extrapolates the next frame's init. The optimizer lives in
opt/adam.py.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.lie import construct_pose, quat_to_rotmat, rotmat_to_quat


class PoseState(NamedTuple):
    quat: torch.Tensor  # (4,) wxyz (not necessarily unit — normalized on use)
    trans: torch.Tensor  # (3,)

    def to_c2w(self) -> torch.Tensor:
        """(4, 4) camera-to-world."""
        return construct_pose(quat_to_rotmat(self.quat), self.trans)

    @staticmethod
    def from_c2w(c2w: torch.Tensor) -> "PoseState":
        return PoseState(quat=rotmat_to_quat(c2w[:3, :3]), trans=c2w[:3, 3])



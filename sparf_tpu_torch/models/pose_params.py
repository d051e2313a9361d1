"""Learnable camera-pose parametrizations (torch port of
sparf_tpu/models/pose_params.py).

  - 'two_columns' (default): 9D = translation + first two ROWS of R, Gram-Schmidt r6d2mat;
  - 'axis_angle': 6D se(3) correction composed with the initial poses;
  - 'quaternion': 4D quaternion (renormalized) + 3D translation.

A pose "module" is (PoseConfig, params dict, constants dict).
`get_w2c_poses(cfg, params, constants)` is differentiable w.r.t. params; the
optimizer only sees `params`. Fixed-first-N poses come from the constants.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from sparf_tpu_torch.utils import camera


@dataclass(frozen=True)
class PoseConfig:
    parametrization: str = "two_columns"  # 'two_columns' | 'axis_angle' | 'quaternion'
    optimize_c2w: bool = False
    optimize_trans: bool = True
    optimize_rot: bool = True
    optimize_relative_poses: bool = False
    n_first_fixed_poses: int = 0
    nbr_poses: int = 0

    @classmethod
    def from_config(cls, cfg, nbr_poses: int) -> "PoseConfig":
        cam = cfg.camera
        return cls(
            parametrization=cam.get("pose_parametrization", "two_columns"),
            optimize_c2w=bool(cam.get("optimize_c2w", False)),
            optimize_trans=bool(cam.get("optimize_trans", True)),
            optimize_rot=bool(cam.get("optimize_rot", True)),
            optimize_relative_poses=bool(cam.get("optimize_relative_poses", False)),
            n_first_fixed_poses=int(cam.get("n_first_fixed_poses", 0)),
            nbr_poses=nbr_poses,
        )

    @property
    def n_fixed(self) -> int:
        return self.n_first_fixed_poses if self.optimize_relative_poses else 0


def pose_to_d9(pose: torch.Tensor) -> torch.Tensor:
    """(N,3,4) -> (N,9): translation + first two rows of R."""
    return torch.cat([pose[:, :3, -1], pose[:, :2, :3].reshape(pose.shape[0], -1)], dim=-1)


def r6d2mat(d6: torch.Tensor) -> torch.Tensor:
    """Zhou et al. 6D -> rotation via Gram-Schmidt; rows b1, b2, b3."""
    a1, a2 = d6[..., :3], d6[..., 3:]
    b1 = a1 / (torch.linalg.norm(a1, dim=-1, keepdim=True) + 1e-12)
    b2 = a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1
    b2 = b2 / (torch.linalg.norm(b2, dim=-1, keepdim=True) + 1e-12)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-2)


def init_pose_params(cfg: PoseConfig, initial_poses_w2c: torch.Tensor
                     ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """(trainable params, constants); constants always hold initial_poses_w2c (N,3,4)."""
    initial_poses_w2c = initial_poses_w2c.to(torch.float32)
    constants: Dict[str, torch.Tensor] = {"initial_poses_w2c": initial_poses_w2c}
    params: Dict[str, torch.Tensor] = {}
    n_fixed = cfg.n_fixed

    if cfg.parametrization == "axis_angle":
        params["se3_embedding"] = torch.zeros((cfg.nbr_poses - n_fixed, 6),
                                              device=initial_poses_w2c.device)
        return params, constants

    base = camera.pose_invert(initial_poses_w2c) if cfg.optimize_c2w else initial_poses_w2c
    base_opt = base[n_fixed:]

    if cfg.parametrization == "two_columns":
        embed = pose_to_d9(base_opt)
        if cfg.optimize_rot and cfg.optimize_trans:
            params["pose_embedding"] = embed
        elif cfg.optimize_rot:
            params["rot_embedding"] = embed[:, 3:].contiguous()
            constants["trans_embedding"] = embed[:, :3].contiguous()
        elif cfg.optimize_trans:
            params["trans_embedding"] = embed[:, :3].contiguous()
            constants["rot_embedding"] = embed[:, 3:].contiguous()
        else:
            raise ValueError("either trans or rot must be optimized")
        return params, constants

    if cfg.parametrization == "quaternion":
        q = camera.R_to_quaternion(base_opt[:, :3, :3])
        t = base_opt[:, :3, -1].contiguous()
        (params if cfg.optimize_rot else constants)["rot_embedding"] = q
        (params if cfg.optimize_trans else constants)["trans_embedding"] = t
        return params, constants

    raise ValueError(f"unknown pose parametrization {cfg.parametrization}")


def _poses_from_embeddings(cfg: PoseConfig, params: Dict, constants: Dict) -> torch.Tensor:
    """Decode the optimized (non-fixed) poses in their native frame (w2c or c2w)."""
    if cfg.parametrization == "axis_angle":
        refine = camera.se3_to_SE3(params["se3_embedding"])
        return camera.pose_compose([refine, constants["initial_poses_w2c"][cfg.n_fixed:]])
    if cfg.parametrization == "two_columns":
        if cfg.optimize_rot and cfg.optimize_trans:
            t = params["pose_embedding"][:, :3]
            r = params["pose_embedding"][:, 3:]
        else:
            t = (params if cfg.optimize_trans else constants)["trans_embedding"]
            r = (params if cfg.optimize_rot else constants)["rot_embedding"]
        return torch.cat([r6d2mat(r), t[..., None]], dim=-1)
    if cfg.parametrization == "quaternion":
        t = (params if cfg.optimize_trans else constants)["trans_embedding"]
        q = (params if cfg.optimize_rot else constants)["rot_embedding"]
        q = q / (torch.linalg.norm(q, dim=-1, keepdim=True) + 1e-12)
        return torch.cat([camera.quaternion_to_R(q), t[..., None]], dim=-1)
    raise ValueError(cfg.parametrization)


def get_w2c_poses(cfg: PoseConfig, params: Dict, constants: Dict) -> torch.Tensor:
    """Current w2c pose estimates (N,3,4); differentiable w.r.t. params."""
    decoded = _poses_from_embeddings(cfg, params, constants)
    if cfg.optimize_c2w and cfg.parametrization != "axis_angle":
        decoded = camera.pose_invert(decoded)
    if cfg.n_fixed > 0:
        decoded = torch.cat([constants["initial_poses_w2c"][: cfg.n_fixed], decoded], dim=0)
    return decoded


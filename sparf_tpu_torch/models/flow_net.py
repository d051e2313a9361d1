"""Dense correspondences for the correspondence loss, `gt_depth` backend only
(torch port of the GT-depth part of sparf_tpu/models/flow_net.py).

Correspondences come from GT depth and GT poses. All functions return numpy
maps with the JAX package's contract:
  corres_maps (P, 2, H, W) float32, conf_maps (P, 1, H, W) float32
for a combi list (2, P) with row 0 = target indices, row 1 = source indices.
The learned and classical matchers (PDC-Net, ZNCC, SPSG) are not ported yet.
"""
from __future__ import annotations

from itertools import permutations
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from sparf_tpu_torch.utils import geometry


def get_combi_list(num_views: int, method: str = "all") -> np.ndarray:
    """(2, P) pair indices; row 0 target, row 1 source. 'all' = permutations."""
    if method != "all":
        raise ValueError(method)
    combi = np.array(list(permutations(range(num_views), 2)), np.int32).T
    return combi.reshape(2, num_views * (num_views - 1))


def generate_pair_list(n_views: int) -> np.ndarray:
    """Unordered exhaustive pairs (2, P): (0,1),(0,2)... (i<j)."""
    pairs = [[i, j] for i in range(n_views) for j in range(i + 1, n_views)]
    return np.array(pairs, np.int32).T


def image_pair_candidates_with_angular_distance(extrinsics_w2c: np.ndarray,
                                                pairing_angle_threshold: float = 60.0
                                                ) -> np.ndarray:
    """Pairs whose relative rotation angle is below the threshold (2, P)."""
    n = extrinsics_w2c.shape[0]
    pairs = []
    for i in range(n):
        for j in range(i + 1, n):
            R_ij = extrinsics_w2c[i, :3, :3] @ extrinsics_w2c[j, :3, :3].T
            cos = np.clip((np.trace(R_ij) - 1) / 2, -1 + 1e-7, 1 - 1e-7)
            if abs(np.degrees(np.arccos(cos))) < pairing_angle_threshold:
                pairs.append([i, j])
    return np.array(pairs, np.int32).T if pairs else np.zeros((2, 0), np.int32)


def get_mask_valid_from_conf_map(conf_maps: np.ndarray, corres_maps: np.ndarray,
                                 min_confidence: float,
                                 max_confidence: Optional[float] = None) -> np.ndarray:
    """(P,1,H,W) bool: confident AND in-bounds matches."""
    H, W = corres_maps.shape[-2:]
    x, y = corres_maps[:, 0], corres_maps[:, 1]
    valid = (x >= 0) & (x <= W - 1) & (y >= 0) & (y <= H - 1)
    mask = conf_maps[:, 0] >= min_confidence
    if max_confidence is not None:
        mask &= conf_maps[:, 0] <= max_confidence
    return (mask & valid)[:, None]


def gt_correspondences_for_pair(scene: Dict[str, np.ndarray], idx_target: int,
                                idx_source: int, rth: float = 0.05
                                ) -> Tuple[np.ndarray, np.ndarray]:
    """corres (2,H,W) + valid (H,W) from GT depth and poses (computed on the CPU)."""
    depth_t = np.asarray(scene["depth_gt"][idx_target])
    valid_t = np.asarray(scene["valid_depth_gt"][idx_target])
    depth_s = np.asarray(scene["depth_gt"][idx_source])
    H, W = depth_t.shape
    xx, yy = np.meshgrid(np.arange(W), np.arange(H))
    pixels = np.stack([xx, yy], -1).reshape(1, -1, 2).astype(np.float32)

    def t(a):
        return torch.as_tensor(np.asarray(a))

    T = geometry.relative_transform_i_to_j(t(scene["pose"][idx_target]),
                                           t(scene["pose"][idx_source]))[None]
    kpj, vis = geometry.batch_project_to_other_img_and_check_depth(
        t(pixels), t(depth_t.reshape(1, -1)), t(depth_s[None]),
        t(scene["intr"][idx_target: idx_target + 1]),
        t(scene["intr"][idx_source: idx_source + 1]), T, t(valid_t.reshape(1, -1)), rth=rth)
    corres = kpj.numpy().reshape(H, W, 2).transpose(2, 0, 1)
    return corres.astype(np.float32), vis.numpy().reshape(H, W)


def compute_gt_flow_of_combi_list(scene, combi_list: np.ndarray):
    corres, conf = [], []
    for t, s in combi_list.T:
        cmap, mask = gt_correspondences_for_pair(scene, int(t), int(s))
        corres.append(cmap)
        conf.append(mask[None].astype(np.float32))
    return np.stack(corres), np.stack(conf)


class FlowSelectionWrapper:
    """Matcher facade; only the `gt_depth` backend is ported."""

    def __init__(self, backend: str = "gt_depth"):
        if backend != "gt_depth":
            raise NotImplementedError(
                f"matcher backend {backend!r} is not ported yet; set use_gt_correspondences=True")
        self.backend = backend

    def compute_flow_and_confidence_map_of_combi_list(self, scene, combi_list: np.ndarray,
                                                      return_cc: bool = False):
        if "depth_gt" not in scene:
            raise ValueError("the gt_depth backend needs GT depth")
        corres, conf = compute_gt_flow_of_combi_list(scene, combi_list)
        return (corres, conf, np.ones_like(conf)) if return_cc else (corres, conf)

    def compute_flow_and_confidence_map_and_cc_of_combi_list(self, scene, combi_list):
        return self.compute_flow_and_confidence_map_of_combi_list(scene, combi_list,
                                                                  return_cc=True)

"""DS-NeRF's sparse COLMAP depth loss (torch port of
sparf_tpu/training/losses/colmap_depth.py).

Renders at pixels where a (triangulated) COLMAP depth exists and penalizes
the squared difference weighted by the COLMAP confidence, x0.1 as in
DS-NeRF. Needs scene['colmap_depth'] (B,H,W) and scene['colmap_conf']
(B,H,W), from colmap_init/triangulation.py or the SfM with
load_colmap_depth; with GT poses (`nerf_gt_poses`) and no such maps the
builder triangulates the matches itself.

Per-image valid-pixel pools padded to one fixed size, sampled modulo the
true count, as the JAX package does. These rays use integer pixel
coordinates (no +0.5), as the reference does.
"""
from __future__ import annotations

import numpy as np
import torch

from sparf_tpu_torch.models import renderer as renderer_mod
from sparf_tpu_torch.parallel import mesh as mesh_mod


def make_colmap_depth_loss_builder(trainer):
    cfg = trainer.cfg
    scene = trainer.train_scene
    scene_np = trainer.train_scene_np
    device = trainer.device

    if "colmap_depth" not in scene and cfg.model == "nerf_gt_poses":
        # DS-NeRF use case: triangulate matches with the (ground-truth) poses
        from sparf_tpu_torch.colmap_init.triangulation import compute_triangulation_from_matches

        trainer.logger.info("triangulating matches with known poses for SparseCOLMAPDepthLoss")
        out = mesh_mod.on_rank0(
            lambda: compute_triangulation_from_matches(cfg, scene_np, device=device),
            trainer.mesh)
        scene["colmap_depth"] = torch.as_tensor(out["colmap_depth"], dtype=torch.float32,
                                                device=device)
        scene["colmap_conf"] = torch.as_tensor(out["colmap_conf"], dtype=torch.float32,
                                               device=device)

    if "colmap_depth" not in scene:
        trainer.logger.warning(
            "SparseCOLMAPDepthLoss requested but scene has no colmap_depth; loss is 0")

        def make_empty(fine_enabled):
            def builder(nerf_params, poses_w2c, draws, iteration, progress):
                return {"colmap_depth": torch.zeros((), device=device)}, {}
                yield  # a generator that renders nothing

            return builder

        return make_empty

    colmap_depth = scene["colmap_depth"].detach().cpu().numpy()  # (B,H,W)
    B, H, W = colmap_depth.shape
    pools, counts = [], []
    for b in range(B):
        ys, xs = np.where(colmap_depth[b] > 1e-6)
        pools.append(np.stack([xs, ys], -1).astype(np.int64))
        counts.append(len(ys))
    pool = np.zeros((B, max(max(counts), 1), 2), np.int64)
    for b in range(B):
        pool[b, : counts[b]] = pools[b]
    pool_t = torch.as_tensor(pool, device=device)
    counts_t = torch.as_tensor(np.maximum(np.asarray(counts, np.int64), 1), device=device)
    depth_t = scene["colmap_depth"].reshape(B, -1)
    conf_t = scene["colmap_conf"].reshape(B, -1)
    have_any = torch.as_tensor((np.asarray(counts) > 0).astype(np.float32), device=device)
    N = max(int(cfg.nerf.rand_rays) // B, 1)
    perc = float(np.mean(colmap_depth > 0))

    def make(fine_enabled: bool):
        def builder(nerf_params, poses_w2c, draws, iteration, progress):
            idx = mesh_mod.shard_rays(draws.randint((B, N), 0, 2**31 - 1) % counts_t[:, None],
                                      axis=1)
            pix = torch.gather(pool_t, 1, idx[..., None].expand(B, N, 2))   # (B,N,2)
            flat = pix[..., 1] * W + pix[..., 0]
            gt_depth = torch.gather(depth_t, 1, flat)
            weight = torch.gather(conf_t, 1, flat) * have_any[:, None]

            (ret,) = yield [renderer_mod.RayBundle(pixels=pix.to(torch.float32),
                                                   pose_w2c=poses_w2c, intr=scene["intr"],
                                                   stratified=True, n_rays=N)]

            def term(key):
                pred = ret[key][..., 0]  # (B,N)
                return torch.sum(mesh_mod.ray_mean(((gt_depth - pred) ** 2) * weight, dim=1))

            loss = term("depth")
            if "depth_fine" in ret:
                loss = loss + term("depth_fine")
            loss = 0.1 * loss / B
            return ({"colmap_depth": loss},
                    {"perc_col_depth": torch.tensor(perc, device=device)})

        return builder

    return make

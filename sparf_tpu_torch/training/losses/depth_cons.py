"""Depth-consistency loss, SPARF Sec. 4.2 (torch port of
sparf_tpu/training/losses/depth_cons.py).

Render depth from a training view, backproject it to pseudo-GT 3D points
(poses detached), project them into a virtual pose interpolated between the
view and its nearest-by-angle neighbour, and make the depth rendered there
agree, weighted by a transmittance visibility from the render-to-max-depth
pass (no grad, thresholded at 0.2, times opacity).

The visibility render runs under torch.no_grad() and so uses the forward
kernel alone; the virtual-view render carries a gradient into its pixels
through the reference depth.
"""
from __future__ import annotations

import torch

from sparf_tpu_torch.models import renderer as renderer_mod
from sparf_tpu_torch.parallel import mesh as mesh_mod
from sparf_tpu_torch.training.losses import base as L
from sparf_tpu_torch.utils import camera, geometry, tracing


def nearest_pose_id_by_angle(poses_c2w: torch.Tensor, id_self) -> torch.Tensor:
    """Angular distance between camera-position vectors, excluding id_self (an
    int, or a scalar tensor); argmin."""
    centers = poses_c2w[:, :3, 3]
    tar = centers[id_self]
    tar_u = tar / (torch.linalg.norm(tar) + 1e-12)
    ref_u = centers / (torch.linalg.norm(centers, dim=-1, keepdim=True) + 1e-12)
    dists = torch.arccos(torch.clamp(ref_u @ tar_u, -1, 1))
    ids = torch.arange(centers.shape[0], device=centers.device)
    dists = torch.where(ids == id_self, torch.full_like(dists, 1e10), dists)
    return torch.argmin(dists)


def make_depth_cons_loss_builder(trainer):
    cfg = trainer.cfg
    scene = trainer.train_scene
    H, W = trainer.train_scene_np["image"].shape[-2:]
    B = trainer.train_scene_np["image"].shape[0]
    N = int(cfg.get("depth_cons_nbr_rays") or max(1024, int(cfg.nerf.rand_rays)))
    max_iter = float(cfg.max_iter)
    frac_center = float(cfg.get("sampled_fraction_in_center", 0.0))
    start_iter = (float(cfg.start_ratio.depth_cons) * max_iter
                  if cfg.start_ratio.get("depth_cons") is not None
                  else float(cfg.start_iter.get("depth_cons", 0) or 0))
    # fine depth supervises only once it has warmed up 5% past its activation
    fine_ratio = cfg.nerf.get("ratio_start_fine_sampling_at_x")
    fine_warm_iter = (fine_ratio + 0.05) * max_iter if fine_ratio is not None else 0.0
    decay = bool(cfg.get("gradually_decrease_depth_cons_loss"))
    reduct_every = float(cfg.get("depth_cons_loss_reduct_at_x_iter", 10000))
    inverse_param = cfg.nerf.depth.param == "inverse"
    inv_depth_min = float(cfg.nerf.depth.range[0]) if inverse_param else None

    def make(fine_enabled: bool):
        def builder(nerf_params, poses_w2c, draws, iteration, progress):
            id_self = draws.randint((), 0, B)
            # the drawn view, read on the host once: indexing by a device scalar
            # would read it at every index
            with tracing.wait("depth_cons.view_index"):
                id_self = int(id_self)
            n_center = int(N * frac_center)
            xs = draws.randint((N,), 0, W).to(torch.float32)
            ys = draws.randint((N,), 0, H).to(torch.float32)
            if n_center > 0:
                dH, dW = H // 4, W // 4
                cx = draws.randint((n_center,), W // 2 - dW, W // 2 + dW)
                cy = draws.randint((n_center,), H // 2 - dH, H // 2 + dH)
                xs = torch.cat([cx.to(torch.float32), xs[n_center:]])
                ys = torch.cat([cy.to(torch.float32), ys[n_center:]])
            pixels_ref = mesh_mod.shard_rays(torch.stack([xs, ys], -1))  # (N,2)

            poses_det = poses_w2c.detach()
            poses_c2w_4 = camera.pose_inverse_4x4(geometry.pose_to_T4x4(poses_det))
            pose_ref = poses_det[id_self][None]          # (1,3,4)
            pose_c2w_ref4 = poses_c2w_4[id_self]
            intr_ref = scene["intr"][id_self][None]      # (1,3,3)
            near = scene["depth_range"][0, 0]

            # the reference view, with gradient to the NeRF (poses detached)
            (ret_ref,) = yield [renderer_mod.RayBundle(
                pixels=pixels_ref[None], pose_w2c=pose_ref, intr=intr_ref, stratified=True,
                n_rays=N)]
            if fine_enabled and "depth_fine" in ret_ref:
                use_fine = 1.0 if iteration >= fine_warm_iter else 0.0
                depth_ref = (use_fine * ret_ref["depth_fine"][0, :, 0]
                             + (1 - use_fine) * ret_ref["depth"][0, :, 0])
            else:
                depth_ref = ret_ref["depth"][0, :, 0]
            pts3d_w = geometry.batch_backproject_to_3d(
                pixels_ref[None], depth_ref[None], intr_ref, pose_c2w_ref4[None])[0]

            # virtual pose: linear interpolation of the c2w matrices
            id_other = nearest_pose_id_by_angle(poses_c2w_4, id_self)
            w = draws.uniform(())
            with tracing.wait("depth_cons.view_index"):
                id_other = int(id_other)
            c2w_unseen = w * pose_c2w_ref4 + (1 - w) * poses_c2w_4[id_other]
            w2c_unseen = camera.pose_inverse_4x4(c2w_unseen)[:3][None]  # (1,3,4)
            pts_cam = camera.world2cam(pts3d_w[None], w2c_unseen)
            pseudo_depth = pts_cam[0, :, 2]
            uv_hom = camera.cam2img(pts_cam, intr_ref)
            pts2d = (uv_hom[..., :2] / (uv_hom[..., 2:] + 1e-6))[0]
            valid = ((pts2d[:, 0] >= 0) & (pts2d[:, 1] >= 0) & (pts2d[:, 0] <= W - 1)
                     & (pts2d[:, 1] <= H - 1) & (pseudo_depth >= near))
            pts2d_safe = torch.stack([torch.clamp(pts2d[:, 0], 0, W - 1),
                                      torch.clamp(pts2d[:, 1], 0, H - 1)], -1)
            if inverse_param:
                with tracing.wait("depth_cons.near"):
                    vis_depth_min = torch.as_tensor(inv_depth_min, device=near.device)
            else:
                vis_depth_min = near
            depth_max_safe = torch.maximum(pseudo_depth, vis_depth_min + 1e-3)

            ret_vis, ret_unseen = yield [
                renderer_mod.RayBundle(pixels=pts2d_safe[None], pose_w2c=w2c_unseen,
                                       intr=intr_ref, kind="tomax", depth_min=vis_depth_min,
                                       depth_max=depth_max_safe[None], no_grad=True),
                renderer_mod.RayBundle(pixels=pts2d_safe[None], pose_w2c=w2c_unseen,
                                       intr=intr_ref, stratified=True, n_rays=N),
            ]
            ac_key = "all_cumulated_fine" if "all_cumulated_fine" in ret_vis else "all_cumulated"
            visibility = ret_vis[ac_key][0].detach()  # (N,)
            mask = (valid & (visibility >= 0.2))[:, None].to(torch.float32)

            def term(depth_key, opacity_key):
                d = ret_unseen[depth_key][0, :, 0]
                wgt = visibility * ret_unseen[opacity_key][0, :, 0].detach()
                return L.compute_diff_loss(cfg.get("diff_loss_type", "huber"),
                                           (pseudo_depth - d)[:, None], weights=wgt[:, None],
                                           mask=mask), wgt

            loss, wgt = term("depth", "opacity")
            if "depth_fine" in ret_unseen:
                loss = loss + term("depth_fine", "opacity_fine")[0]
            # zero when no point survives on any rank (the reference returns early)
            n_mask = mesh_mod.global_sum(torch.sum(mask))
            gate = L.iteration_gate(iteration, start_iter) * (n_mask > 0).to(torch.float32)
            if decay:
                loss = loss / 2.0 ** (iteration // reduct_every)
            stats = {"avg_vis_weight": mesh_mod.global_sum(torch.sum(wgt * mask[:, 0]))
                     / (n_mask + 1e-6),
                     "nbr_px_sampling": n_mask}
            return {"depth_cons": loss * gate}, stats

        return builder

    return make

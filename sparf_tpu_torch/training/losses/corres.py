"""Multi-view correspondence loss, SPARF Sec. 4.1 (torch port of
sparf_tpu/training/losses/corres.py).

For a sampled image pair (self, other): render depth at matched pixels in
both views, reproject self's pixels into other with the rendered depth and
the current relative pose, and penalize the distance to the matched pixel
(huber, confidence-weighted), symmetrized over both directions and averaged
over coarse+fine (/4).

Correspondences are precomputed once on the host into per-pair pixel pools of
one fixed size (padded, sampled modulo the true count). These rays use
integer pixel coordinates (no +0.5), as the reference does.
"""
from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from sparf_tpu_torch.models import flow_net as flow_mod
from sparf_tpu_torch.models import renderer as renderer_mod
from sparf_tpu_torch.parallel import mesh as mesh_mod
from sparf_tpu_torch.training.losses import base as L
from sparf_tpu_torch.utils import camera, geometry, imgproc

# ---------------------------------------------------------------------------
# host-side precompute
# ---------------------------------------------------------------------------


def build_correspondence_pools(cfg, scene_np, logger=None, init_poses_w2c=None,
                               device="cuda") -> Dict[str, np.ndarray]:
    """Run the matcher over the pair list and build fixed-size pixel pools.

    Matcher backends keep pixels with confidence >= min_conf_valid_corr
    (GT depth: 1); then, unless geometric_verification is off, an epipolar
    RANSAC per pair (`imgproc.find_fundamental_ransac`, 1 px, 0.999, a
    generator seeded by cfg.seed) keeps its inliers: a pair with fewer than
    16 pixels stays as it is, one without a model is emptied. Pairs with
    more than min_nbr_matches pixels are kept.

    Returns pool_pix_self/other (n,Pmax,2), pool_conf (n,Pmax), pool_count
    (n,), pair_ids (n,2), the maps, the backend that ran, the seconds of
    each part (`seconds`: matching, verification, pools) and the geometry
    stage's report (`geom`, empty when the stage did not run: its route,
    each round's winner, score, views and seconds), or n_pairs=0 when no
    pair survives. The stage's RANSAC generators are seeded by cfg.seed.
    """
    n_views = scene_np["image"].shape[0]
    method = cfg.get("matching_pair_generation", "all_to_all")
    if method == "all":
        combi_list = flow_mod.generate_pair_list(n_views)
    elif method == "all_to_all":
        combi_list = flow_mod.get_combi_list(n_views, "all")
    elif method == "angle":
        combi_list = flow_mod.image_pair_candidates_with_angular_distance(
            scene_np["pose"], cfg.get("pairing_angle_threshold", 45))
    else:
        raise ValueError(method)

    backend = "gt_depth" if cfg.get("use_gt_correspondences") else cfg.get("flow_backbone", "zncc")
    wrapper = flow_mod.FlowSelectionWrapper(
        backend=backend, ckpt_path=cfg.get("flow_ckpt_path"),
        adapt_steps=int(cfg.get("pdcnet_adapt_steps", 0) or 0),
        init_poses_w2c=None if init_poses_w2c is None else np.asarray(init_poses_w2c),
        use_homography=bool(cfg.get("use_homography_flow")),
        geometry_refine=bool(cfg.get("pdcnet_geometry_refine", True)),
        multiscale_factors=cfg.get("pdcnet_multiscale") or (), seed=int(cfg.get("seed", 0)),
        device=device)
    seconds = {}
    t0 = time.perf_counter()
    cc_maps = None
    if cfg.get("filter_corr_w_cc"):
        corres_maps, conf_maps, cc_maps = (
            wrapper.compute_flow_and_confidence_map_and_cc_of_combi_list(scene_np, combi_list))
    else:
        corres_maps, conf_maps = wrapper.compute_flow_and_confidence_map_of_combi_list(
            scene_np, combi_list)
    seconds["matching"] = time.perf_counter() - t0
    if cfg.get("use_gt_correspondences") and cfg.get("use_dummy_all_one_confidence"):
        conf_maps = np.ones_like(conf_maps)

    min_conf = 1.0 if backend == "gt_depth" else float(cfg.get("min_conf_valid_corr", 0.95))
    mask_valid = flow_mod.get_mask_valid_from_conf_map(conf_maps, corres_maps, min_conf)
    if cc_maps is not None:
        mask_valid &= cc_maps >= float(cfg.get("min_conf_cc_valid_corr", 1 / 2.5))

    t0 = time.perf_counter()
    if backend != "gt_depth" and cfg.get("geometric_verification", True):
        generator = torch.Generator().manual_seed(int(cfg.get("seed", 0)))
        for p in range(mask_valid.shape[0]):
            ys, xs = np.where(mask_valid[p, 0])
            if len(ys) < 16:
                continue
            pts1 = np.stack([xs, ys], -1).astype(np.float64)
            pts2 = corres_maps[p, :, ys, xs].astype(np.float64)
            F, inliers = imgproc.find_fundamental_ransac(pts1, pts2, 1.0, 0.999,
                                                         generator=generator, device=device)
            new_mask = np.zeros_like(mask_valid[p, 0])
            if F is not None:
                new_mask[ys[inliers], xs[inliers]] = True
            mask_valid[p, 0] = new_mask
    seconds["verification"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    min_nbr_matches = int(cfg.get("min_nbr_matches", 500))
    kept = [i for i in range(combi_list.shape[1]) if mask_valid[i].sum() > min_nbr_matches]
    resolved = wrapper._resolve_backend()
    geom = wrapper.last_geom
    if logger:
        logger.info(f"correspondence precompute [{resolved}]: {combi_list.shape[1]} pairs, "
                    f"{len(kept)} kept (>{min_nbr_matches} confident px)")
        if geom:
            logger.info("geometry stage: " + describe_geometry_route(geom))
    if not kept:
        return dict(n_pairs=0, backend=resolved, seconds=seconds, geom=geom)

    counts = [int(mask_valid[i].sum()) for i in kept]
    n, Pmax = len(kept), max(counts)
    pool_pix_self = np.zeros((n, Pmax, 2), np.float32)
    pool_pix_other = np.zeros((n, Pmax, 2), np.float32)
    pool_conf = np.zeros((n, Pmax), np.float32)
    pool_count = np.zeros((n,), np.int32)
    pair_ids = np.zeros((n, 2), np.int32)
    for k, i in enumerate(kept):
        ys, xs = np.where(mask_valid[i, 0])
        c = len(ys)
        pool_pix_self[k, :c] = np.stack([xs, ys], -1)
        pool_pix_other[k, :c] = corres_maps[i, :, ys, xs]
        pool_conf[k, :c] = conf_maps[i, 0, ys, xs]
        pool_count[k] = c
        pair_ids[k] = combi_list[:, i]
    seconds["pools"] = time.perf_counter() - t0
    return dict(n_pairs=n, pool_pix_self=pool_pix_self, pool_pix_other=pool_pix_other,
                pool_conf=pool_conf, pool_count=pool_count, pair_ids=pair_ids,
                corres_maps=corres_maps, conf_maps=conf_maps, mask_valid=mask_valid,
                combi_list=combi_list, backend=resolved, seconds=seconds, geom=geom)


def describe_geometry_route(geom: dict) -> str:
    """One line of the geometry stage's report (FlowSelectionWrapper.last_geom):
    the bootstrap size, each round's winner, score and registered views, the
    flows emitted and the seconds of each part."""
    boot = geom.get("bootstrap")
    parts = [f"route {geom.get('route', '?')}",
             "bootstrap " + ("off" if boot is None else f"{boot[0]}x{boot[1]}")]
    for r in geom.get("rounds", []):
        score = "-" if r["score"] is None else f"{r['score']:.4f}"
        parts.append(f"round {r['round']}: {r['winner']} (score {score}, {r['views']} views, "
                     f"{r['seconds']:.2f} s)")
    parts.append(f"output {geom.get('output')}")
    parts.append("seconds " + ", ".join(f"{k} {v:.2f}" for k, v in geom.get("seconds", {}).items()))
    return "; ".join(parts)


def compute_flow_metrics(pools_np: Dict[str, np.ndarray], scene_np) -> Dict[str, float]:
    """EPE/PCK of the precomputed correspondences vs GT-depth correspondences."""
    if pools_np.get("n_pairs", 0) == 0 or "depth_gt" not in scene_np:
        return {}
    gt_corres, gt_conf = flow_mod.compute_gt_flow_of_combi_list(scene_np,
                                                                pools_np["combi_list"])
    pred_valid = pools_np["mask_valid"][:, 0].astype(bool)
    gt_valid = gt_conf[:, 0] > 0.5
    err = np.linalg.norm(pools_np["corres_maps"] - gt_corres, axis=1)
    out = {}
    for suffix, m in (("all", gt_valid), ("in_conf", gt_valid & pred_valid)):
        if m.any():
            e = err[m]
            out[f"avg_epe_{suffix}"] = float(e.mean())
            out[f"avg_pck_1_{suffix}"] = float((e <= 1).mean())
            out[f"avg_pck_3_{suffix}"] = float((e <= 3).mean())
    return out


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------


def compute_render_and_repro_loss_w_repro_thres(cfg, pixels_in_self, depth_rendered_self,
                                                intr_self, pixels_in_other,
                                                depth_rendered_other, intr_other, T_self2other,
                                                conf_values) -> torch.Tensor:
    """All args have leading dim N; intr (1,3,3); T (1,4,4)."""
    pts_repr, depth_repr = geometry.batch_project_to_other_img(
        pixels_in_self[None], depth_rendered_self[None], intr_self, intr_other, T_self2other,
        return_depth=True)
    diff = pts_repr[0] - pixels_in_other  # (N,2)
    depth_repr = depth_repr[0]
    valid = torch.ones((diff.shape[0], 1), dtype=torch.bool, device=diff.device)
    if cfg.get("renderrepro_do_pixel_reprojection_check"):
        dist = torch.linalg.norm(diff.detach(), dim=-1, keepdim=True)
        valid &= dist <= cfg.renderrepro_pixel_reprojection_thresh
    if cfg.get("renderrepro_do_depth_reprojection_check"):
        rel = torch.abs(depth_rendered_other - depth_repr) / (depth_rendered_other + 1e-6)
        valid &= (rel.detach() <= cfg.renderrepro_depth_reprojection_thresh)[..., None]
    return L.compute_diff_loss(cfg.get("diff_loss_type", "huber"), diff,
                               weights=conf_values[..., None], mask=valid)


def make_corres_loss_builder(trainer):
    """Returns make(fine_enabled) -> builder. Precomputes the pools now."""
    cfg = trainer.cfg
    # the matcher's pose prior: the current estimates after a mid-training
    # rematch (rematch_at_ratio), else the initial poses
    prior = getattr(trainer, "matcher_prior_poses_w2c", None)
    if prior is None:
        prior = getattr(trainer, "initial_poses_w2c", None)
    if torch.is_tensor(prior):
        prior = prior.detach().cpu().numpy()
    # on rank 0 alone under ray sharding, so that every rank trains on its pools
    pools_np = mesh_mod.on_rank0(
        lambda: build_correspondence_pools(cfg, trainer.train_scene_np, trainer.logger,
                                           init_poses_w2c=prior, device=trainer.device),
        trainer.mesh)
    trainer.corres_pools = pools_np
    flow_stats = compute_flow_metrics(pools_np, trainer.train_scene_np)
    if flow_stats:
        trainer.logger.info("flow quality vs GT: "
                            + " ".join(f"{k}={v:.3f}" for k, v in sorted(flow_stats.items())))
        trainer.writer.write_event("train", flow_stats, 0)
    device = trainer.device
    if pools_np["n_pairs"] == 0:
        def make_empty(fine_enabled):
            def builder(nerf_params, poses_w2c, draws, iteration, progress):
                return {"corres": torch.zeros((), device=device)}, {}
                yield  # a generator that renders nothing
            return builder
        return make_empty

    pools = {k: torch.as_tensor(pools_np[k], device=device)
             for k in ("pool_pix_self", "pool_pix_other", "pool_conf", "pool_count", "pair_ids")}
    pools["pool_count"] = pools["pool_count"].to(torch.int64)
    pools["pair_ids"] = pools["pair_ids"].to(torch.int64)
    n_pairs = int(pools_np["n_pairs"])
    p_max = float(pools_np["pool_pix_self"].shape[1])
    scene = trainer.train_scene
    N = int(cfg.nerf.rand_rays) // 2
    max_iter = float(cfg.max_iter)

    start_iter = float(cfg.start_iter.get("corres", 0) or 0)
    if cfg.start_ratio.get("corres") is not None:
        start_iter = max(start_iter, float(cfg.start_ratio.corres) * max_iter)
    stop_at = cfg.get("stop_corres_loss_at")
    decay_start = None
    if cfg.get("gradually_decrease_corres_weight"):
        decay_start = (float(cfg.ratio_start_decrease_corres_weight) * max_iter
                       if cfg.get("ratio_start_decrease_corres_weight") is not None
                       else float(cfg.get("iter_start_decrease_corres_weight", 0)))
    reduct_every = float(cfg.get("corres_weight_reduct_at_x_iter", 10000))
    compute_photo = bool(cfg.get("compute_photo_on_matches", False))
    use_gt_depth = bool(cfg.get("use_gt_depth", False)) and "depth_gt" in scene
    H_img, W_img = trainer.train_scene_np["image"].shape[-2:]
    if use_gt_depth:
        depth_gt_flat = scene["depth_gt"].reshape(trainer.n_train_views, -1)

    def flat_index(pix):
        return torch.clamp(torch.round(pix[:, 1]).to(torch.int64) * W_img
                           + torch.round(pix[:, 0]).to(torch.int64), 0, H_img * W_img - 1)

    def make(fine_enabled: bool):
        def builder(nerf_params, poses_w2c, draws, iteration, progress):
            # the drawn pair and its two views stay on the device: each selection
            # by them is a gather
            p = draws.randint((), 0, n_pairs).reshape(1)
            id_self, id_other = pools["pair_ids"].index_select(0, p)[0].split(1)   # (1,) each
            count = pools["pool_count"].index_select(0, p)[0]
            idx = mesh_mod.shard_rays(draws.randint((N,), 0, 2**31 - 1) % count)
            pix_self = pools["pool_pix_self"][p, idx]      # (N,2)
            pix_other = pools["pool_pix_other"][p, idx]
            conf = pools["pool_conf"][p, idx]              # (N,)
            pose_self = poses_w2c.index_select(0, id_self)   # (1,3,4)
            pose_other = poses_w2c.index_select(0, id_other)
            intr_self = scene["intr"].index_select(0, id_self)
            intr_other = scene["intr"].index_select(0, id_other)

            ret_self, ret_other = yield [
                renderer_mod.RayBundle(pixels=pix_self[None], pose_w2c=pose_self,
                                       intr=intr_self, stratified=True, n_rays=N),
                renderer_mod.RayBundle(pixels=pix_other[None], pose_w2c=pose_other,
                                       intr=intr_other, stratified=True, n_rays=N),
            ]
            T_s2o = geometry.pose_to_T4x4(
                camera.pose_compose_pair(camera.pose_invert(pose_self), pose_other))
            T_o2s = geometry.pose_to_T4x4(
                camera.pose_compose_pair(camera.pose_invert(pose_other), pose_self))

            def both_directions(depth_s, depth_o):
                return (compute_render_and_repro_loss_w_repro_thres(
                            cfg, pix_self, depth_s, intr_self, pix_other, depth_o, intr_other,
                            T_s2o, conf)
                        + compute_render_and_repro_loss_w_repro_thres(
                            cfg, pix_other, depth_o, intr_other, pix_self, depth_s, intr_self,
                            T_o2s, conf))

            if use_gt_depth:
                loss_corres = both_directions(depth_gt_flat[id_self, flat_index(pix_self)],
                                              depth_gt_flat[id_other, flat_index(pix_other)]) / 2.0
            else:
                loss_corres = both_directions(ret_self["depth"][0, :, 0],
                                              ret_other["depth"][0, :, 0])
                has_fine = "depth_fine" in ret_self
                if has_fine:
                    loss_corres = loss_corres + both_directions(
                        ret_self["depth_fine"][0, :, 0], ret_other["depth_fine"][0, :, 0])
                loss_corres = loss_corres / (4.0 if has_fine else 2.0)

            gate = L.iteration_gate(iteration, start_iter)
            if stop_at is not None and not iteration < stop_at:
                gate = 0.0
            if decay_start is not None and iteration >= decay_start:
                loss_corres = loss_corres / 2.0 ** np.floor((iteration - decay_start)
                                                           / reduct_every)
            loss_dict = {"corres": loss_corres * gate}

            if compute_photo:
                images_flat = scene["image"].reshape(scene["image"].shape[0], 3, -1)

                def photo(ret, pix, idx_img):
                    gt = images_flat.index_select(0, idx_img)[0][:, flat_index(pix)].t()  # (N,3)
                    loss = L.mse_loss(ret["rgb"][0], gt)
                    if "rgb_fine" in ret:
                        loss = loss + L.mse_loss(ret["rgb_fine"][0], gt)
                    return loss

                loss_dict["render_matches"] = gate * (photo(ret_self, pix_self, id_self)
                                                      + photo(ret_other, pix_other, id_other)) / 2
            stats = {
                "depth_in_corr_loss": mesh_mod.global_mean(ret_self["depth"]),
                "perc_valid_corr_mask": count.to(torch.float32) / p_max,
            }
            return loss_dict, stats

        return builder

    return make

"""The reference SPARF training step: the photometric, correspondence and
depth-consistency losses over freshly drawn rays, one backward pass, and the
two Adam updates (NeRF, clipped by global norm; poses). Frozen copies of
sparf_tpu_torch/training/{engine,sampling}.py, training/losses/*.py and
models/pose_params.py's arithmetic for the recipes in benchmark/configs/,
in the program's order of draws. Plain float32 torch; imports nothing of
the program."""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List

import torch

from benchmark import counts
from benchmark.reference import geometry as geo
from benchmark.reference import nerf as rn


def leaves(params: Dict) -> List[torch.Tensor]:
    """The leaves of a NeRF tree {"coarse"|"fine": {"feat"|"rgb": [(W, b)]}} or of a
    pose tree {name: tensor}, in the program's order (keys sorted)."""
    if torch.is_tensor(params):
        return [params]
    if isinstance(params, dict):
        return [x for k in sorted(params) for x in leaves(params[k])]
    return [x for v in params for x in leaves(v)]


def unflatten(like, flat: List[torch.Tensor]):
    it = iter(flat)

    def build(node):
        if torch.is_tensor(node):
            return next(it)
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return type(node)(build(v) for v in node)

    return build(like)


@dataclass
class AdamState:
    count: torch.Tensor
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


def adam_init(xs: List[torch.Tensor]) -> AdamState:
    return AdamState(torch.zeros((), dtype=torch.int32, device=xs[0].device),
                     [torch.zeros_like(x) for x in xs], [torch.zeros_like(x) for x in xs])


def exponential_lr(lr_init: float, lr_end, max_iter: int):
    gamma = (lr_end / lr_init) ** (1.0 / max_iter)

    def lr(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        return lr_init * torch.pow(torch.tensor(gamma, dtype=torch.float32, device=step.device),
                                   step)

    return lr


def adam_update(grads, state: AdamState, lr_fn, clip, b1=0.9, b2=0.999, eps=1e-8):
    """clip_by_global_norm -> Adam -> scale by -lr(count), as optax chains them."""
    if clip:
        g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        keep = g_norm < clip
        grads = [torch.where(keep, g, g / g_norm * clip) for g in grads]
    mu = [(1 - b1) * g + b1 * m for g, m in zip(grads, state.mu)]
    nu = [(1 - b2) * (g * g) + b2 * v for g, v in zip(grads, state.nu)]
    count = state.count + 1
    c = count.to(torch.float32)
    bc1 = 1 - torch.pow(torch.tensor(b1, device=c.device), c)
    bc2 = 1 - torch.pow(torch.tensor(b2, device=c.device), c)
    lr = lr_fn(state.count.to(torch.float32))
    return ([-lr * ((m / bc1) / (torch.sqrt(v / bc2) + eps)) for m, v in zip(mu, nu)],
            AdamState(count, mu, nu))


def r6d2mat(d6: torch.Tensor) -> torch.Tensor:
    a1, a2 = d6[..., :3], d6[..., 3:]
    b1 = a1 / (torch.linalg.norm(a1, dim=-1, keepdim=True) + 1e-12)
    b2 = a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1
    b2 = b2 / (torch.linalg.norm(b2, dim=-1, keepdim=True) + 1e-12)
    return torch.stack([b1, b2, torch.linalg.cross(b1, b2, dim=-1)], dim=-2)


def pose_embedding(poses_w2c: torch.Tensor) -> torch.Tensor:
    """(N,3,4) -> (N,9): translation and the first two rows of R."""
    return torch.cat([poses_w2c[:, :3, -1], poses_w2c[:, :2, :3].reshape(-1, 6)], dim=-1)


def huber(diff: torch.Tensor, delta: float) -> torch.Tensor:
    a = torch.abs(diff)
    return torch.where(a < delta, 0.5 * diff**2, delta * (a - 0.5 * delta))


def masked_huber(diff, weights, mask) -> torch.Tensor:
    loss = huber(diff, 1.0) * weights
    mask = mask.to(loss.dtype)
    return torch.sum(loss * mask) / (torch.sum(mask) + 1e-6)


@dataclass
class Recipe:
    """What the step reads of a configuration file's `run` section."""

    run: Dict

    def __getitem__(self, key):
        return self.run[key]

    @property
    def max_iter(self) -> float:
        return float(self.run["max_iter"])

    def poses_at(self, it: int) -> bool:
        return it < int(self.max_iter * self.run["ratio_end_joint_nerf_pose_refinement"])


class ReferenceTrainer:
    """The scene, pools, sampler pool and optimizers of one recipe; `step`
    takes (nerf, nerf Adam, pose embedding, pose Adam, iteration) and a draws
    object and returns the next state and the loss."""

    def __init__(self, run: Dict, scene_np: Dict, pools_np: Dict, init_poses_w2c, device):
        self.r = Recipe(run)
        self.spec = rn.init_spec(run)
        self.device = device
        t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
        self.scene = {k: t(v) for k, v in scene_np.items()}
        self.pools = {k: t(v) for k, v in pools_np.items()}
        self.init_poses = t(init_poses_w2c)
        B, _, H, W = scene_np["image"].shape
        self.B, self.H, self.W = B, H, W
        ys, xs = torch.meshgrid(torch.arange(H), torch.arange(W), indexing="ij")
        self.all_pixels = torch.stack([xs.reshape(-1), ys.reshape(-1)], -1).to(device)
        self.lr_nerf = exponential_lr(run["optim.lr"], run["optim.lr_end"], run["max_iter"])
        self.lr_pose = exponential_lr(run["optim.lr_pose"], run["optim.lr_pose_end"],
                                      run["max_iter"])
        self.depth_range = rn.depth_range(run, scene_np, device)

    # -------------------------------------------------------------- losses

    def _render(self, params, pose, intr, pixels, draws, progress, fine):
        return rn.render_pixels(params, self.spec, pose, intr, pixels, self.depth_range,
                                progress, draws, fine)

    def losses(self, params, poses_w2c, draws, it: int, progress: float, fine: bool):
        r, sc, B, H, W = self.r, self.scene, self.B, self.H, self.W
        # the three builders draw their rays first, in this order
        n_rand = r["nerf.rand_rays"] // B
        pix = self.all_pixels[draws.randint((n_rand,), 0, self.all_pixels.shape[0])]
        ray_idx = pix[..., 1] * W + pix[..., 0]
        pixels = torch.stack([(ray_idx % W).to(torch.float32) + 0.5,
                              (ray_idx // W).to(torch.float32) + 0.5], dim=-1)
        P = self.pools
        N = r["nerf.rand_rays"] // 2
        p = draws.randint((), 0, P["pair_ids"].shape[0])
        idx = draws.randint((N,), 0, 2**31 - 1) % P["pool_count"][p]
        pix_s, pix_o, conf = (P["pool_pix_self"][p][idx], P["pool_pix_other"][p][idx],
                              P["pool_conf"][p][idx])
        id_s, id_o = P["pair_ids"][p, 0], P["pair_ids"][p, 1]
        Nd = int(r["depth_cons_nbr_rays"] or max(1024, int(r["nerf.rand_rays"])))
        id_ref = draws.randint((), 0, B)
        xs = draws.randint((Nd,), 0, W).to(torch.float32)
        ys = draws.randint((Nd,), 0, H).to(torch.float32)
        px_ref = torch.stack([xs, ys], -1)

        # round 1: photometric, the two views of the pair, the reference view
        out = self._render(params, poses_w2c, sc["intr"], pixels, draws, progress, fine)
        pose_s, pose_o = poses_w2c[id_s][None], poses_w2c[id_o][None]
        K_s, K_o = sc["intr"][id_s][None], sc["intr"][id_o][None]
        ret_s = self._render(params, pose_s, K_s, pix_s[None], draws, progress, fine)
        ret_o = self._render(params, pose_o, K_o, pix_o[None], draws, progress, fine)
        poses_det = poses_w2c.detach()
        c2w4 = geo.pose_inverse_4x4(geo.pose_to_4x4(poses_det))
        pose_ref, c2w_ref, K_ref = poses_det[id_ref][None], c2w4[id_ref], sc["intr"][id_ref][None]
        ret_ref = self._render(params, pose_ref, K_ref, px_ref[None], draws, progress, fine)

        # photometric
        image = sc["image"].reshape(B, 3, -1).transpose(1, 2)[:, ray_idx]
        render = torch.mean(huber(out["rgb"].reshape(B, -1, 3) - image, 0.5)) * 2.0
        if fine:
            render = render + torch.mean(huber(out["rgb_fine"].reshape(B, -1, 3) - image,
                                               0.5)) * 2.0

        # correspondences, both directions, coarse and fine
        T_so = geo.pose_to_4x4(geo.pose_compose_pair(geo.pose_invert(pose_s), pose_o))
        T_os = geo.pose_to_4x4(geo.pose_compose_pair(geo.pose_invert(pose_o), pose_s))
        ones = torch.ones((N, 1), dtype=torch.bool, device=self.device)

        def repro(pa, da, Ka, pb, Kb, T):
            proj, _ = geo.project_to_other_img(pa[None], da[None], Ka, Kb, T)
            return masked_huber(proj[0] - pb, conf[..., None], ones)

        def both(ds, do):
            return repro(pix_s, ds, K_s, pix_o, K_o, T_so) + repro(pix_o, do, K_o, pix_s, K_s,
                                                                  T_os)

        corres = both(ret_s["depth"][0, :, 0], ret_o["depth"][0, :, 0])
        if fine:
            corres = corres + both(ret_s["depth_fine"][0, :, 0], ret_o["depth_fine"][0, :, 0])
        corres = corres / (4.0 if fine else 2.0)
        start = float(r["start_iter.corres"] or 0)
        gate = 1.0 if it >= start else 0.0
        if r["gradually_decrease_corres_weight"]:
            decay_start = float(r["ratio_start_decrease_corres_weight"]) * r.max_iter
            if it >= decay_start:
                corres = corres / 2.0 ** math.floor((it - decay_start)
                                                    / float(r["corres_weight_reduct_at_x_iter"]))
        corres = corres * gate

        # depth consistency from a virtual view between the reference view and its neighbour
        fine_ratio = r["nerf.ratio_start_fine_sampling_at_x"]
        fine_warm = (fine_ratio + 0.05) * r.max_iter if fine_ratio is not None else 0.0
        if fine and "depth_fine" in ret_ref:
            use_fine = 1.0 if it >= fine_warm else 0.0
            depth_ref = (use_fine * ret_ref["depth_fine"][0, :, 0]
                         + (1 - use_fine) * ret_ref["depth"][0, :, 0])
        else:
            depth_ref = ret_ref["depth"][0, :, 0]
        pts_w = geo.backproject_to_3d(px_ref[None], depth_ref[None], K_ref, c2w_ref[None])[0]
        centers = c2w4[:, :3, 3]
        tar = centers[id_ref]
        ang = torch.arccos(torch.clamp(
            (centers / (torch.linalg.norm(centers, dim=-1, keepdim=True) + 1e-12))
            @ (tar / (torch.linalg.norm(tar) + 1e-12)), -1, 1))
        ids = torch.arange(B, device=self.device)
        id_other = torch.argmin(torch.where(ids == id_ref, torch.full_like(ang, 1e10), ang))
        w = draws.uniform(())
        w2c_unseen = geo.pose_inverse_4x4(w * c2w_ref + (1 - w) * c2w4[id_other])[:3][None]
        pts_cam = geo.world2cam(pts_w[None], w2c_unseen)
        pseudo = pts_cam[0, :, 2]
        uv = geo.cam2img(pts_cam, K_ref)
        pts2d = (uv[..., :2] / (uv[..., 2:] + 1e-6))[0]
        near = sc["depth_range"][0, 0]
        valid = ((pts2d[:, 0] >= 0) & (pts2d[:, 1] >= 0) & (pts2d[:, 0] <= W - 1)
                 & (pts2d[:, 1] <= H - 1) & (pseudo >= near))
        safe = torch.stack([torch.clamp(pts2d[:, 0], 0, W - 1),
                            torch.clamp(pts2d[:, 1], 0, H - 1)], -1)
        vis_min = (torch.as_tensor(float(r["nerf.depth.range"][0]), device=near.device)
                   if r["nerf.depth.param"] == "inverse" else near)
        with torch.no_grad():
            ret_vis = rn.render_to_max(params, self.spec, w2c_unseen, K_ref, safe[None], vis_min,
                                       torch.maximum(pseudo, vis_min + 1e-3)[None], progress,
                                       fine)
        ret_un = self._render(params, w2c_unseen, K_ref, safe[None], draws, progress, fine)
        visibility = ret_vis["all_cumulated_fine" if fine else "all_cumulated"][0].detach()
        mask = (valid & (visibility >= 0.2))[:, None].to(torch.float32)

        def term(dk, ok):
            wgt = visibility * ret_un[ok][0, :, 0].detach()
            return masked_huber((pseudo - ret_un[dk][0, :, 0])[:, None], wgt[:, None], mask)

        dc = term("depth", "opacity")
        if fine:
            dc = dc + term("depth_fine", "opacity_fine")
        start = float(r["start_iter.depth_cons"] or 0)
        dc = dc * ((1.0 if it >= start else 0.0) * (torch.sum(mask) > 0).to(torch.float32))

        total = 0.0
        for key, value in (("render", render), ("corres", corres), ("depth_cons", dc)):
            total = total + 10.0 ** float(r[f"loss_weight.{key}"]) * value
        return total

    # ---------------------------------------------------------------- step

    def step(self, nerf_params, opt_nerf: AdamState, pose_emb, opt_pose: AdamState, it: int,
             it_nerf: int, draws):
        r = self.r
        progress = it_nerf / r.max_iter if r["barf_c2f"] is not None else 1.0
        fine, opt_poses = counts.fine_at(r.run, it), r.poses_at(it)
        n_leaves = [x.detach().requires_grad_(True) for x in leaves(nerf_params)]
        p_leaf = pose_emb.detach().requires_grad_(True)
        params = unflatten(nerf_params, n_leaves)
        poses = torch.cat([r6d2mat(p_leaf[:, 3:]), p_leaf[:, :3, None]], dim=-1)
        if not opt_poses:
            poses = poses.detach()
        loss = self.losses(params, poses, draws, it, progress, fine)
        grads = torch.autograd.grad(loss, n_leaves + [p_leaf], allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g
                 for g, x in zip(grads, n_leaves + [p_leaf])]
        with torch.no_grad():
            finite = torch.stack([torch.isfinite(g).all() for g in grads]).all()
            upd, cand = adam_update(grads[:-1], opt_nerf, self.lr_nerf,
                                    r["nerf_gradient_clipping"] if r["clip_by_norm"] else None)
            new_nerf = unflatten(nerf_params, [x + torch.where(finite, u, torch.zeros_like(u))
                                               for x, u in zip(leaves(nerf_params), upd)])
            opt_nerf = _select(finite, cand, opt_nerf)
            if opt_poses:
                upd, cand = adam_update(grads[-1:], opt_pose, self.lr_pose,
                                        r["pose_gradient_clipping"])
                pose_emb = pose_emb + torch.where(finite, upd[0], torch.zeros_like(upd[0]))
                opt_pose = _select(finite, cand, opt_pose)
        return new_nerf, opt_nerf, pose_emb, opt_pose, loss.detach()


def _select(pred, new: AdamState, old: AdamState) -> AdamState:
    return AdamState(torch.where(pred, new.count, old.count),
                     [torch.where(pred, n, o) for n, o in zip(new.mu, old.mu)],
                     [torch.where(pred, n, o) for n, o in zip(new.nu, old.nu)])

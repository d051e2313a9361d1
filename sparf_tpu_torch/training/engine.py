"""Training engine: state, schedules, a functional Adam, the train-step factory
(torch port of sparf_tpu/training/engine.py).

One call of the step runs one iteration: sample rays, render every loss's
bundles, backpropagate once, and update the NeRF and the pose parameters with
two Adam optimizers. The optimizer is written on tensors to match
optax.chain(clip_by_global_norm, scale_by_adam(0.9, 0.999),
scale_by_schedule(-lr)) exactly: its step count starts at 0, so lr(0) is used
first, and an iteration whose gradients are not all finite leaves the
parameters and both optimizer states untouched (torch.optim.Adam would still
advance its step). With grad_acc_steps = k > 1 the NeRF optimizer is wrapped
as optax.MultiSteps wraps the chain (`MultiSteps`): the running mean of k
mini-step gradients goes through the chain on every k-th finite step, and
the other steps update nothing.

The step is the tracer's unit `step` (utils/tracing.py), with the spans
`step.poses`, `step.losses`, `step.backward`, `step.reduce` (with a mesh)
and `step.update`.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from sparf_tpu_torch.models import pose_params as pose_mod
from sparf_tpu_torch.models import renderer as renderer_mod
from sparf_tpu_torch.models.renderer import RenderConfig
from sparf_tpu_torch.parallel import mesh as mesh_mod
from sparf_tpu_torch.training.losses import base as loss_base
from sparf_tpu_torch.training.losses import photometric as photo_mod
from sparf_tpu_torch.utils import tracing

# ---------------------------------------------------------------------------
# parameter trees (dicts / lists / tuples of tensors)
# ---------------------------------------------------------------------------


def tree_leaves(tree) -> List[torch.Tensor]:
    """Leaves in a fixed order: dict keys sorted, sequences in order."""
    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [l for v in tree for l in tree_leaves(v)]
    raise TypeError(f"not a parameter tree: {type(tree)}")


def tree_unflatten(like, leaves: List[torch.Tensor]):
    """A tree shaped like `like` holding `leaves` (in tree_leaves order)."""
    it = iter(leaves)

    def build(node):
        if torch.is_tensor(node):
            return next(it)
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return type(node)(build(v) for v in node)

    return build(like)


def global_norm(leaves: List[torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(l * l) for l in leaves))


# ---------------------------------------------------------------------------
# schedules and the optimizer
# ---------------------------------------------------------------------------


def exponential_lr(lr_init: float, lr_end: Optional[float], max_iter: int) -> Callable:
    """lr(t) = lr_init * gamma^t with gamma = (lr_end/lr_init)^(1/max_iter), in float32."""
    if not lr_end:
        return lambda step: torch.full_like(torch.as_tensor(step, dtype=torch.float32), lr_init)
    gamma = (lr_end / lr_init) ** (1.0 / max_iter)

    def lr(step):
        return lr_init * torch.pow(gamma, torch.as_tensor(step, dtype=torch.float32))

    return lr


def pose_lr_schedule(lr_pose: float, lr_pose_end: Optional[float], max_iter: int,
                     warmup_pose: Optional[int]) -> Callable:
    """Exponential decay x linear warmup."""
    base = exponential_lr(lr_pose, lr_pose_end, max_iter)
    if not warmup_pose:
        return base

    def lr(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        return base(step) * torch.clamp(step / warmup_pose, max=1.0)

    return lr


@dataclass
class AdamState:
    count: torch.Tensor          # int32 scalar: updates applied so far
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


@dataclass(frozen=True)
class Adam:
    """clip_by_global_norm -> Adam(b1, b2, eps) -> scale by -lr(count)."""

    lr_fn: Callable
    clip_norm: Optional[float] = None
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def init(self, leaves: List[torch.Tensor]) -> AdamState:
        device = leaves[0].device if leaves else None
        return AdamState(torch.zeros((), dtype=torch.int32, device=device),
                         [torch.zeros_like(l) for l in leaves],
                         [torch.zeros_like(l) for l in leaves])

    def update(self, grads: List[torch.Tensor], state: AdamState
               ) -> Tuple[List[torch.Tensor], AdamState]:
        if self.clip_norm:
            g_norm = global_norm(grads)
            keep = g_norm < self.clip_norm
            grads = [torch.where(keep, g, g / g_norm * self.clip_norm) for g in grads]
        mu = [(1 - self.b1) * g + self.b1 * m for g, m in zip(grads, state.mu)]
        nu = [(1 - self.b2) * (g * g) + self.b2 * v for g, v in zip(grads, state.nu)]
        count_inc = state.count + 1
        c = count_inc.to(torch.float32)
        bc1 = 1 - torch.pow(self.b1, c)
        bc2 = 1 - torch.pow(self.b2, c)
        lr = self.lr_fn(state.count.to(torch.float32))
        updates = [-lr * ((m / bc1) / (torch.sqrt(v / bc2) + self.eps)) for m, v in zip(mu, nu)]
        return updates, AdamState(count_inc, mu, nu)


@dataclass
class AccumState:
    """optax.MultiStepsState around an Adam. Its skip_state is empty, and its
    gradient_step always equals the inner Adam's count (both advance on the
    k-th mini-step only), so neither is kept."""

    mini_step: torch.Tensor      # int32 scalar: mini-steps accumulated, in [0, k)
    inner: AdamState
    acc: List[torch.Tensor]      # running mean of this round's mini-step gradients


@dataclass(frozen=True)
class MultiSteps:
    """Gradient accumulation, as optax.MultiSteps(inner, every_k_schedule=k)
    with its defaults (mean of the gradients, no skip function).

    Each call folds the gradients into a running mean, acc + (g - acc) / (n + 1),
    and runs the inner chain (clipping, Adam, the schedule) on that mean; on
    the k-th mini-step its updates and state are kept and the mean restarts,
    on the others the updates are zeros and the inner state, and so Adam's
    count and the learning rate, stay as they were."""

    inner: Adam
    k: int

    def init(self, leaves: List[torch.Tensor]) -> AccumState:
        inner = self.inner.init(leaves)
        return AccumState(torch.zeros_like(inner.count), inner,
                          [torch.zeros_like(l) for l in leaves])

    def update(self, grads: List[torch.Tensor], state: AccumState
               ) -> Tuple[List[torch.Tensor], AccumState]:
        n = state.mini_step + 1
        acc = [a + (g - a) / n for g, a in zip(grads, state.acc)]
        updates, inner = self.inner.update(acc, state.inner)
        emit = state.mini_step == self.k - 1
        keep = emit.to(torch.float32)
        return ([keep * u for u in updates],
                AccumState(n % self.k, select_state(emit, inner, state.inner),
                           [(1 - keep) * a for a in acc]))


def make_optimizer(lr_fn: Callable, clip_norm: Optional[float], grad_acc_steps: int = 1):
    """The chain clip -> Adam -> -lr(count), wrapped in MultiSteps when
    grad_acc_steps > 1 (the JAX engine's make_optimizer)."""
    tx = Adam(lr_fn, clip_norm)
    if grad_acc_steps and grad_acc_steps > 1:
        return MultiSteps(tx, int(grad_acc_steps))
    return tx


def apply_updates_if_finite(params: List[torch.Tensor], updates: List[torch.Tensor],
                            is_finite: torch.Tensor) -> List[torch.Tensor]:
    """p + u, or p unchanged when any gradient was non-finite."""
    return [p + torch.where(is_finite, u, torch.zeros_like(u)) for p, u in zip(params, updates)]


def select_state(pred: torch.Tensor, new, old):
    """Elementwise where() over a whole optimizer state (AdamState or AccumState)."""
    if isinstance(new, AccumState):
        return AccumState(torch.where(pred, new.mini_step, old.mini_step),
                          select_state(pred, new.inner, old.inner),
                          [torch.where(pred, n, o) for n, o in zip(new.acc, old.acc)])
    return AdamState(torch.where(pred, new.count, old.count),
                     [torch.where(pred, n, o) for n, o in zip(new.mu, old.mu)],
                     [torch.where(pred, n, o) for n, o in zip(new.nu, old.nu)])


# ---------------------------------------------------------------------------
# state and step
# ---------------------------------------------------------------------------


@dataclass
class TrainState:
    """All mutable training state. The counters are host integers; nan_count
    stays on the device so a step never waits for the card."""

    nerf_params: Any
    pose_params: Dict[str, torch.Tensor]   # {} when poses are not optimized
    opt_state_nerf: Any                    # AdamState, or AccumState with accumulation
    opt_state_pose: Optional[AdamState]
    iteration: int
    iteration_nerf: int
    nan_count: torch.Tensor


def default_photometric_loss_builder(cfg, scene, sampler, *, sample_in_center: bool):
    """Photometric (+mask +regularization) loss over freshly sampled rays."""
    H, W = scene["image"].shape[-2:]
    start_iter_photo = float(cfg.start_iter.get("photometric", 0) or 0)
    if cfg.start_ratio.get("photometric") is not None:
        start_iter_photo = max(start_iter_photo,
                               float(cfg.start_ratio.photometric) * cfg.max_iter)

    def builder(nerf_params, poses_w2c, draws, iteration, progress):
        ray_idx = sampler(draws, cfg.nerf.rand_rays, sample_in_center=sample_in_center)
        n_rays = ray_idx.shape[-1]
        ray_idx = mesh_mod.shard_rays(ray_idx, axis=-1,
                                      unit=sampler.patch_size**2 if sampler.depth_patch else 1)
        pixels = torch.stack([(ray_idx % W).to(torch.float32) + 0.5,
                              (ray_idx // W).to(torch.float32) + 0.5], dim=-1)
        (out,) = yield [renderer_mod.RayBundle(pixels=pixels, pose_w2c=poses_w2c,
                                               intr=scene["intr"], stratified=True,
                                               n_rays=n_rays)]
        image_at_rays = photo_mod.gather_pixels_at_rays(scene["image"], ray_idx)
        fg_at_rays = None
        if cfg.loss_weight.get("fg_mask") is not None and "fg_mask" in scene:
            fg_at_rays = photo_mod.gather_mask_at_rays(scene["fg_mask"], ray_idx)
        loss_dict = photo_mod.photometric_and_regu_loss(
            out, image_at_rays, fg_mask_at_rays=fg_at_rays,
            huber_photometric=bool(cfg.huber_loss_for_photometric),
            loss_weight=cfg.loss_weight,
            depth_regu_patch_size=int(cfg.get("depth_regu_patch_size", 2)),
            gate=loss_base.iteration_gate(iteration, start_iter_photo))
        B = image_at_rays.shape[0]
        stats = {"mse": mesh_mod.global_mean((out["rgb"].reshape(B, -1, 3) - image_at_rays) ** 2),
                 "avg_pred_depth": mesh_mod.global_mean(out["depth"])}
        if "rgb_fine" in out:
            stats["mse_fine"] = mesh_mod.global_mean((out["rgb_fine"].reshape(B, -1, 3)
                                                      - image_at_rays) ** 2)
        return loss_dict, stats

    return builder


def make_train_step(cfg, loss_builder, tx_nerf, tx_pose: Optional[Adam] = None,
                    pose_cfg: Optional[pose_mod.PoseConfig] = None,
                    pose_constants: Optional[Dict] = None, scene=None,
                    optimize_poses: bool = False, update_nerf: bool = True,
                    mesh: Optional[mesh_mod.Mesh] = None
                    ) -> Callable[[TrainState, Any], Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """One training iteration: step(state, draws) -> (state, stats).

    optimize_poses=False freezes the pose branch (GT poses or the frozen-pose
    stage of the joint schedule). With a `mesh` the step is active on it:
    each rank renders its share of the rays, its losses are its share of the
    loss, and the NeRF and pose gradients are summed over the ranks in one
    all-reduce before the clip, the non-finite check and Adam, so every rank
    takes the same update. The logged losses are summed over the ranks.
    """
    max_iter = float(cfg.max_iter)
    apply_c2f = cfg.get("barf_c2f") is not None and cfg.get("apply_cf_pe", True)
    skip_large = cfg.get("skip_large_gradients")

    def step(state: TrainState, draws) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        with tracing.span("step"), mesh_mod.active(mesh):
            return sharded_step(state, draws)

    def sharded_step(state: TrainState, draws) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        with tracing.span("step.poses"):
            progress = state.iteration_nerf / max_iter if apply_c2f else 1.0
            nerf_leaves = [t.detach().requires_grad_(True)
                           for t in tree_leaves(state.nerf_params)]
            pose_leaves = [t.detach().requires_grad_(True)
                           for t in tree_leaves(state.pose_params)]
            nerf_params = tree_unflatten(state.nerf_params, nerf_leaves)
            if pose_cfg is not None:
                poses_w2c = pose_mod.get_w2c_poses(
                    pose_cfg, tree_unflatten(state.pose_params, pose_leaves), pose_constants)
            else:
                poses_w2c = scene["pose"]
            if not optimize_poses:
                poses_w2c = poses_w2c.detach()

        with tracing.span("step.losses"):
            loss_dict, stats = loss_builder(nerf_params, poses_w2c, draws,
                                            float(state.iteration), progress)
            if cfg.loss_weight.get("equalize_losses"):
                summed = loss_base.summarize_loss_w_equal_weights(loss_dict, cfg.loss_weight)
            else:
                summed = loss_base.summarize_loss_w_predefined_weights(
                    loss_dict, cfg.loss_weight,
                    parametrization=cfg.loss_weight.get("parametrization", "exp"))
        leaves = nerf_leaves + pose_leaves
        with tracing.span("step.backward"):
            grads = torch.autograd.grad(summed["all"], leaves, allow_unused=True)
            grads = [torch.zeros_like(l) if g is None else g for g, l in zip(grads, leaves)]
        if mesh is not None:
            # the frozen poses' zero gradients stay out of the all-reduce
            n_reduced = len(grads) if optimize_poses else len(nerf_leaves)
            with tracing.span("step.reduce"):
                grads = mesh_mod.all_reduce_grads(grads[:n_reduced]) + grads[n_reduced:]
        g_nerf, g_pose = grads[: len(nerf_leaves)], grads[len(nerf_leaves):]

        with tracing.span("step.update"), torch.no_grad():
            finite = torch.stack([torch.isfinite(g).all() for g in grads]).all()
            if skip_large:
                finite = finite & (global_norm(g_nerf) <= float(skip_large))
            new_nerf, opt_nerf = state.nerf_params, state.opt_state_nerf
            if update_nerf:
                upd, cand = tx_nerf.update(g_nerf, state.opt_state_nerf)
                new_nerf = tree_unflatten(
                    state.nerf_params,
                    apply_updates_if_finite(tree_leaves(state.nerf_params), upd, finite))
                opt_nerf = select_state(finite, cand, state.opt_state_nerf)
            new_pose, opt_pose = state.pose_params, state.opt_state_pose
            if optimize_poses and tx_pose is not None:
                upd, cand = tx_pose.update(g_pose, state.opt_state_pose)
                new_pose = tree_unflatten(
                    state.pose_params,
                    apply_updates_if_finite(tree_leaves(state.pose_params), upd, finite))
                opt_pose = select_state(finite, cand, state.opt_state_pose)

            stats = dict(stats)
            stats.update(mesh_mod.all_reduce_scalars({k: v.detach() for k, v in summed.items()}))
            stats["grad_norm_nerf"] = global_norm(g_nerf)
            if optimize_poses:
                stats["grad_norm_pose"] = global_norm(g_pose)
            if cfg.get("print_gradients"):
                used = g_nerf + (g_pose if optimize_poses else [])
                stats["grad_max"] = torch.stack([g.abs().max() for g in used]).max()
            new_state = replace(
                state, nerf_params=new_nerf, pose_params=new_pose, opt_state_nerf=opt_nerf,
                opt_state_pose=opt_pose, iteration=state.iteration + 1,
                iteration_nerf=state.iteration_nerf + (1 if update_nerf else 0),
                nan_count=state.nan_count + (~finite).to(torch.int32))
        return new_state, stats

    return step


def init_train_state(gen: torch.Generator, render_cfg: RenderConfig, tx_nerf, device,
                     pose_cfg: Optional[pose_mod.PoseConfig] = None, initial_poses_w2c=None,
                     tx_pose: Optional[Adam] = None) -> Tuple[TrainState, Optional[Dict]]:
    """(state, pose_constants)."""
    nerf_params = renderer_mod.init_graph_params(gen, render_cfg, device)
    pose_parameters: Dict = {}
    pose_constants = None
    if pose_cfg is not None:
        pose_parameters, pose_constants = pose_mod.init_pose_params(pose_cfg, initial_poses_w2c)
    state = TrainState(
        nerf_params=nerf_params,
        pose_params=pose_parameters,
        opt_state_nerf=tx_nerf.init(tree_leaves(nerf_params)),
        opt_state_pose=tx_pose.init(tree_leaves(pose_parameters)) if tx_pose else None,
        iteration=0,
        iteration_nerf=0,
        nan_count=torch.zeros((), dtype=torch.int32, device=device),
    )
    return state, pose_constants

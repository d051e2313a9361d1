"""The training step and the frame without host syncs, on the CPU.

Each piece that used to copy a host number to the device, check a result on
the host or read a drawn index on the host gives the same bits as its old
form, written out here: the coarse-to-fine weights, the learning-rate
schedules, Adam's update, K^-1, the 4x4 pose, and the selections of the
correspondence and depth-consistency losses, driven on ReplayDraws. A tiny
step at both stages (also at the LLFF recipe's inverse depth) and a tiny
frame open no `wait` span.
"""
import copy
import dataclasses
import math
import tempfile
import types

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (two torch threads per worker)

from sparf_tpu_torch.models import embedder
from sparf_tpu_torch.models import renderer as renderer_mod
from sparf_tpu_torch.training import engine
from sparf_tpu_torch.training.losses import corres as corres_mod
from sparf_tpu_torch.training.losses import depth_cons as dc_mod
from sparf_tpu_torch.utils import camera, geometry, tracing
from sparf_tpu_torch.utils.draws import Draws, ReplayDraws


def assert_bits(new, old):
    assert new.dtype == old.dtype and new.shape == old.shape
    if new.dtype == torch.float32:
        new, old = new.view(torch.int32), old.view(torch.int32)
    assert torch.equal(new, old)


# ---------------------------------------------------------------------------
# the constants and K^-1, against their old forms
# ---------------------------------------------------------------------------


def old_c2f_weights(progress, L, c2f):
    start, end = c2f
    alpha = torch.as_tensor((progress - start) / (end - start) * L, dtype=torch.float32)
    k = torch.arange(L, dtype=torch.float32)
    return (1 - torch.cos(torch.clamp(alpha - k, 0.0, 1.0) * math.pi)) / 2


def old_exponential_lr(lr_init, lr_end, max_iter):
    gamma = (lr_end / lr_init) ** (1.0 / max_iter)

    def lr(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        base = torch.tensor(gamma, dtype=torch.float32, device=step.device)
        return lr_init * torch.pow(base, step)

    return lr


def old_adam_update(tx, grads, state):
    if tx.clip_norm:
        g_norm = engine.global_norm(grads)
        keep = g_norm < tx.clip_norm
        grads = [torch.where(keep, g, g / g_norm * tx.clip_norm) for g in grads]
    mu = [(1 - tx.b1) * g + tx.b1 * m for g, m in zip(grads, state.mu)]
    nu = [(1 - tx.b2) * (g * g) + tx.b2 * v for g, v in zip(grads, state.nu)]
    count_inc = state.count + 1
    c = count_inc.to(torch.float32)
    b1 = torch.tensor(tx.b1, device=c.device)
    b2 = torch.tensor(tx.b2, device=c.device)
    bc1 = 1 - torch.pow(b1, c)
    bc2 = 1 - torch.pow(b2, c)
    lr = tx.lr_fn(state.count.to(torch.float32))
    updates = [-lr * ((m / bc1) / (torch.sqrt(v / bc2) + tx.eps)) for m, v in zip(mu, nu)]
    return updates, engine.AdamState(count_inc, mu, nu)


def old_pose_to_4x4(pose):
    bottom = torch.zeros((*pose.shape[:-2], 1, 4), dtype=pose.dtype, device=pose.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([pose, bottom], dim=-2)


def _c2f_pairs():
    out = []
    for L, c2f in ((10, (0.1, 0.5)), (4, (0.3, 0.7)), (6, (0.0, 0.13))):
        for progress in (0.0, 0.123456789, 0.2987, 1 / 3, 0.35, 0.4999, 0.61, 1.0):
            out.append((embedder.c2f_weights(progress, L, c2f), old_c2f_weights(progress, L, c2f)))
    return out


STEPS = (0, 1, 7, 1234, 35000, 99999)


def _lr_pairs():
    out = []
    for lr_init, lr_end, max_iter in ((5e-4, 1e-4, 100000), (1e-3, 1e-5, 1000), (3e-3, 1e-5, 7)):
        new, old = engine.exponential_lr(lr_init, lr_end, max_iter), old_exponential_lr(
            lr_init, lr_end, max_iter)
        for step in STEPS:
            out.append((new(step), old(step)))
            out.append((new(torch.tensor(float(step))), old(torch.tensor(float(step)))))
    return out


def _pose_lr_pairs():
    # the warm-up multiplies the decay: the pose learning rate of the joint stage
    new = engine.pose_lr_schedule(1e-3, 1e-5, 100000, 1000)
    old_base = old_exponential_lr(1e-3, 1e-5, 100000)

    def old(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        return old_base(step) * torch.clamp(step / 1000, max=1.0)

    return [(new(torch.tensor(float(s))), old(torch.tensor(float(s)))) for s in STEPS]


def _adam_pairs():
    rng = np.random.RandomState(3)
    shapes = ((7, 5), (5,), (3, 4, 2))
    out = []
    for clip in (None, 0.1):
        tx = engine.Adam(engine.exponential_lr(5e-4, 1e-4, 100000), clip)
        for count in (0, 4, 35000):
            grads = [torch.as_tensor(rng.normal(size=s).astype(np.float32)) for s in shapes]
            state = engine.AdamState(
                torch.tensor(count, dtype=torch.int32),
                [torch.as_tensor(rng.normal(size=s).astype(np.float32)) * 0.01 for s in shapes],
                [torch.as_tensor(rng.uniform(size=s).astype(np.float32)) * 1e-4 for s in shapes])
            upd_new, st_new = tx.update(grads, state)
            upd_old, st_old = old_adam_update(tx, grads, state)
            out += list(zip(upd_new + st_new.mu + st_new.nu + [st_new.count],
                            upd_old + st_old.mu + st_old.nu + [st_old.count]))
    return out


def _intrinsics(rng, n):
    K = np.zeros((n, 3, 3), np.float32)
    K[:, 0, 0] = rng.uniform(200, 600, n)
    K[:, 1, 1] = rng.uniform(200, 600, n)
    K[:, 0, 2] = rng.uniform(100, 300, n)
    K[:, 1, 2] = rng.uniform(100, 300, n)
    K[:, 0, 1] = rng.uniform(-1, 1, n)
    K[:, 2, 2] = 1
    return torch.as_tensor(K)


def _intr_inverse_pairs():
    rng = np.random.RandomState(5)
    Ks = [_intrinsics(rng, 3), _intrinsics(rng, 1)[0],
          torch.as_tensor(rng.normal(size=(2, 4, 3, 3)).astype(np.float32))]
    return [(camera.intr_inverse(K), torch.linalg.inv(K)) for K in Ks]


def _pose_to_4x4_pairs():
    rng = np.random.RandomState(7)
    poses = [torch.as_tensor(rng.normal(size=s).astype(np.float32))
             for s in ((3, 4), (3, 3, 4), (2, 5, 3, 4))]
    return [(camera.pose_to_4x4(p), old_pose_to_4x4(p)) for p in poses]


PIECES = {"c2f_weights": _c2f_pairs, "exponential_lr": _lr_pairs,
          "pose_lr_schedule": _pose_lr_pairs, "adam_update": _adam_pairs,
          "intr_inverse": _intr_inverse_pairs, "pose_to_4x4": _pose_to_4x4_pairs}


@pytest.mark.parametrize("piece", sorted(PIECES))
def test_rewritten_piece_gives_the_bits_of_its_old_form(piece):
    pairs = PIECES[piece]()
    assert pairs
    for new, old in pairs:
        assert_bits(new, old)


# ---------------------------------------------------------------------------
# the losses' selections by drawn indices, against host indexing
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_trainer():
    from sparf_tpu_torch.scripts import profile_step

    return profile_step.build_trainer(True, "float32", False, "cpu")


@pytest.fixture(scope="module")
def llff_trainer():
    """The LLFF recipe (inverse depth, no fine level) at the tiny shape."""
    from sparf_tpu_torch.parallel.dryrun import TINY_GT
    from sparf_tpu_torch.training.define_trainer import build_config, define_trainer

    over = dict(TINY_GT, dataset="synthetic", scene="spheres", max_iter=1000)
    cfg = build_config("joint_pose_nerf_training/llff", "sparf", over)
    assert cfg.nerf.depth.param == "inverse" and "depth_cons" in cfg.loss_type
    return define_trainer(cfg, workspace=tempfile.mkdtemp(prefix="sparf_llff_"), device="cpu",
                          save_option=False)


def _recorded(seed):
    """Draws from a seeded generator, and the list of what they handed out."""
    kept = []
    src = Draws(seed, "cpu")

    class Recording:
        def uniform(self, shape):
            kept.append(src.uniform(shape).numpy())
            return torch.as_tensor(kept[-1])

        def randint(self, shape, low, high):
            kept.append(src.randint(shape, low, high).numpy())
            return torch.as_tensor(kept[-1])

        def normal(self, shape):
            kept.append(src.normal(shape).numpy())
            return torch.as_tensor(kept[-1])

    return Recording(), kept


def _fake_render(bundle, fine):
    """Outputs of a render that depend on the bundle's pixels, pose and intrinsics."""
    px = bundle.pixels[0]
    shift = bundle.pose_w2c[0, :, 3].sum() + 1e-3 * bundle.intr[0, 0, 0]
    d = 2.0 + 0.01 * px[:, 0] + 0.02 * px[:, 1] + 0.1 * torch.tanh(shift)
    out = {"depth": d[None, :, None], "opacity": torch.sigmoid(d - 2.2)[None, :, None],
           "all_cumulated": torch.sigmoid(d - 2.1)[None],
           "rgb": torch.sigmoid(torch.stack([d, -d, d * 0.5], -1))[None]}
    if fine:
        out.update({k + "_fine": v * 1.01 for k, v in list(out.items())})
    return out


ITERATION = 400.0


def _drive(builder, poses, draws, fine, iteration=ITERATION, progress=0.4):
    """Run a loss builder to its end: every bundle it asked for and its result."""
    gen = builder(None, poses, draws, iteration, progress)
    asked, sent = [], None
    try:
        while True:
            bundles = gen.send(sent)
            asked.append(bundles)
            sent = [_fake_render(b, fine) for b in bundles]
    except StopIteration as e:
        return asked, e.value


def _trainer_like(tr, **cfg_over):
    cfg = copy.deepcopy(tr.cfg)
    for k, v in cfg_over.items():
        *path, last = k.split(".")
        target = cfg
        for key in path:
            target = target[key]
        target[last] = v
    return types.SimpleNamespace(
        cfg=cfg, train_scene=tr.train_scene, train_scene_np=tr.train_scene_np,
        logger=tr.logger, writer=tr.writer, device=tr.device, mesh=None,
        n_train_views=tr.n_train_views, initial_poses_w2c=getattr(tr, "initial_poses_w2c", None))


def _noisy_poses(tr, seed):
    rng = np.random.RandomState(seed)
    poses = tr.train_scene["pose"].detach().clone()
    poses = poses + torch.as_tensor(rng.normal(size=poses.shape).astype(np.float32)) * 0.02
    return poses.requires_grad_(True)


@pytest.mark.parametrize("use_gt_depth,photo,seed", [(False, False, 11), (True, True, 12)])
def test_corres_selects_by_device_gathers_as_by_host_indices(tiny_trainer, use_gt_depth, photo,
                                                            seed):
    tr = tiny_trainer
    ns = _trainer_like(tr, use_gt_depth=use_gt_depth, compute_photo_on_matches=photo,
                       gradually_decrease_corres_weight=False)
    builder = corres_mod.make_corres_loss_builder(ns)(False)
    pools_np, scene, cfg = ns.corres_pools, tr.train_scene, ns.cfg
    assert pools_np["n_pairs"] > 1
    recorder, kept = _recorded(seed)
    _drive(builder, _noisy_poses(tr, seed), recorder, False)
    poses = _noisy_poses(tr, seed)
    asked, (loss_dict, stats) = _drive(builder, poses, ReplayDraws(list(kept)), False)
    grad = torch.autograd.grad(sum(loss_dict.values()), poses)[0]

    # the old form: the pair and its views read on the host, indexing by them
    pools = {k: torch.as_tensor(pools_np[k]) for k in
             ("pool_pix_self", "pool_pix_other", "pool_conf", "pool_count", "pair_ids")}
    p = int(kept[0])
    id_self, id_other = pools["pair_ids"][p].to(torch.int64).tolist()
    count = pools["pool_count"][p].to(torch.int64)
    idx = torch.as_tensor(kept[1]) % count
    pix_self, pix_other = pools["pool_pix_self"][p][idx], pools["pool_pix_other"][p][idx]
    conf = pools["pool_conf"][p][idx]
    poses_old = _noisy_poses(tr, seed)
    pose_self, pose_other = poses_old[id_self][None], poses_old[id_other][None]
    intr_self, intr_other = scene["intr"][id_self][None], scene["intr"][id_other][None]

    (b_self, b_other), = asked
    for b, pix, pose, intr in ((b_self, pix_self, pose_self, intr_self),
                               (b_other, pix_other, pose_other, intr_other)):
        assert_bits(b.pixels, pix[None])
        assert_bits(b.pose_w2c, pose)
        assert_bits(b.intr, intr)
    ret_self, ret_other = (
        _fake_render(renderer_mod.RayBundle(pixels=pix[None], pose_w2c=pose, intr=intr), False)
        for pix, pose, intr in ((pix_self, pose_self, intr_self),
                                (pix_other, pose_other, intr_other)))
    T_s2o = geometry.pose_to_T4x4(camera.pose_compose_pair(camera.pose_invert(pose_self),
                                                           pose_other))
    T_o2s = geometry.pose_to_T4x4(camera.pose_compose_pair(camera.pose_invert(pose_other),
                                                           pose_self))

    def both(d_s, d_o):
        return (corres_mod.compute_render_and_repro_loss_w_repro_thres(
                    cfg, pix_self, d_s, intr_self, pix_other, d_o, intr_other, T_s2o, conf)
                + corres_mod.compute_render_and_repro_loss_w_repro_thres(
                    cfg, pix_other, d_o, intr_other, pix_self, d_s, intr_self, T_o2s, conf))

    H, W = tr.train_scene_np["image"].shape[-2:]

    def flat(pix):
        return torch.clamp(torch.round(pix[:, 1]).to(torch.int64) * W
                           + torch.round(pix[:, 0]).to(torch.int64), 0, H * W - 1)

    if use_gt_depth:
        depth_gt = scene["depth_gt"].reshape(tr.n_train_views, -1)
        old = both(depth_gt[id_self][flat(pix_self)], depth_gt[id_other][flat(pix_other)]) / 2.0
    else:
        old = both(ret_self["depth"][0, :, 0], ret_other["depth"][0, :, 0]) / 2.0
    old = old * corres_mod.L.iteration_gate(ITERATION, float(cfg.start_iter.get("corres", 0) or 0))
    assert_bits(loss_dict["corres"], old)
    old_total = old
    if photo:
        images = scene["image"].reshape(scene["image"].shape[0], 3, -1)
        gate = corres_mod.L.iteration_gate(ITERATION, float(cfg.start_iter.get("corres", 0) or 0))
        photo_old = gate * (corres_mod.L.mse_loss(ret_self["rgb"][0],
                                                  images[id_self][:, flat(pix_self)].t())
                            + corres_mod.L.mse_loss(ret_other["rgb"][0],
                                                    images[id_other][:, flat(pix_other)].t())) / 2
        assert_bits(loss_dict["render_matches"], photo_old)
        old_total = old_total + photo_old
    assert_bits(stats["perc_valid_corr_mask"],
                count.to(torch.float32) / float(pools_np["pool_pix_self"].shape[1]))
    assert_bits(grad, torch.autograd.grad(old_total, poses_old)[0])


@pytest.mark.parametrize("param,fine,seed", [("metric", True, 21), ("metric", False, 22),
                                             ("inverse", False, 23)])
def test_depth_cons_selects_by_device_gathers_as_by_host_indices(tiny_trainer, param, fine, seed):
    tr = tiny_trainer
    over = {"nerf.depth.param": param, "sampled_fraction_in_center": 0.25}
    if param == "inverse":
        over["nerf.depth.range"] = [1, 0]
    ns = _trainer_like(tr, **over)
    builder = dc_mod.make_depth_cons_loss_builder(ns)(fine)
    recorder, kept = _recorded(seed)
    _drive(builder, _noisy_poses(tr, seed), recorder, fine)
    asked, (loss_dict, stats) = _drive(builder, _noisy_poses(tr, seed), ReplayDraws(list(kept)),
                                       fine)
    assert torch.isfinite(loss_dict["depth_cons"])

    # the old form: the drawn view and its nearest neighbour read on the host
    scene, cfg = tr.train_scene, ns.cfg
    poses_det = _noisy_poses(tr, seed).detach()
    poses_c2w_4 = camera.pose_inverse_4x4(geometry.pose_to_T4x4(poses_det))
    id_self = int(kept[0])
    id_other = int(dc_mod.nearest_pose_id_by_angle(poses_c2w_4, id_self))
    assert id_other == int(dc_mod.nearest_pose_id_by_angle(poses_c2w_4, torch.tensor(id_self)))
    w = torch.as_tensor(kept[-1])
    c2w_unseen = w * poses_c2w_4[id_self] + (1 - w) * poses_c2w_4[id_other]
    w2c_unseen = camera.pose_inverse_4x4(c2w_unseen)[:3][None]

    (b_ref,), (b_vis, b_unseen) = asked
    assert_bits(b_ref.pose_w2c, poses_det[id_self][None])
    assert_bits(b_ref.intr, scene["intr"][id_self][None])
    for b in (b_vis, b_unseen):
        assert_bits(b.pose_w2c, w2c_unseen)
        assert_bits(b.intr, scene["intr"][id_self][None])
    assert_bits(b_unseen.pixels, b_vis.pixels)
    depth_min = (torch.as_tensor(1.0) if param == "inverse" else scene["depth_range"][0, 0])
    assert_bits(b_vis.depth_min, depth_min)
    # the pseudo depths of the reference view's points, seen from the virtual pose
    ret_ref = _fake_render(b_ref, fine)
    depth_ref = ret_ref["depth"][0, :, 0]
    if fine:
        fine_warm = (cfg.nerf.ratio_start_fine_sampling_at_x + 0.05) * cfg.max_iter
        use_fine = 1.0 if ITERATION >= fine_warm else 0.0
        depth_ref = use_fine * ret_ref["depth_fine"][0, :, 0] + (1 - use_fine) * depth_ref
    pts3d = geometry.batch_backproject_to_3d(
        b_ref.pixels, depth_ref[None], scene["intr"][id_self][None],
        poses_c2w_4[id_self][None])[0]
    pseudo = camera.world2cam(pts3d[None], w2c_unseen)[0, :, 2]
    assert_bits(b_vis.depth_max, torch.maximum(pseudo, depth_min + 1e-3)[None])
    assert stats["nbr_px_sampling"].dtype == torch.float32


# ---------------------------------------------------------------------------
# no wait span in a step or a frame
# ---------------------------------------------------------------------------


def _waits():
    return [r.site for r in tracing.report().records if r.name == "wait"]


@pytest.mark.parametrize("stage", ["coarse", "fine"])
def test_profile_step_opens_no_wait(stage, capsys):
    from sparf_tpu_torch.scripts import profile_step

    res = profile_step.main(["--tiny", "--stage", stage, "--steps", "2", "--warmup", "1",
                             "--device", "cpu"])
    capsys.readouterr()
    assert not [name for name in res["spans"] if name.startswith("wait")]
    assert res["spans"]["step"]["calls_per_step"] == 1.0


def test_llff_step_at_inverse_depth_opens_no_wait(llff_trainer):
    tr = llff_trainer
    # the inverse parametrization's range: made once, with the bits of the config's
    assert tr.depth_range(tr.train_scene) is tr.depth_range(tr.val_scene)
    assert_bits(tr.depth_range(tr.val_scene),
                renderer_mod.render_depth_range(tr.cfg, tr.val_scene))
    state = dataclasses.replace(tr.state, iteration=50, iteration_nerf=50)
    step = tr.get_step(50)
    step(state, tr.draws)
    tracing.enable()
    try:
        state, stats = step(state, tr.draws)
        assert tracing.report().units == {"step": 1}
        assert _waits() == []
    finally:
        tracing.disable()
    assert torch.isfinite(stats["all"])


@pytest.mark.parametrize("recipe", ["dtu", "llff"])
def test_a_frame_opens_no_wait(recipe, request):
    tr = request.getfixturevalue(f"{'tiny' if recipe == 'dtu' else 'llff'}_trainer")
    tracing.enable()
    try:
        out = tr.render_full_image(tr.train_scene, 0, tr.train_scene["pose"][:1], True)
        assert tracing.report().units == {"frame": 1}
        assert _waits() == []
    finally:
        tracing.disable()
    assert out["rgb"].shape == (1, tr.H * tr.W, 3)

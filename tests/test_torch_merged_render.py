"""Merged multi-bundle rendering of sparf_tpu_torch (renderer.render_bundles
with merge=True) against the JAX package's merged render and against the
port's own per-bundle render, and the trainer's loss on the merged path.

Shapes: tests/test_merged_render.py's bundles (a 4x32 MLP, 16 + 8 samples,
four bundles: two pixel batches, one no-grad render-to-max-depth batch and
one more pixel batch). Tolerances are that test's: outputs rtol 2e-5 / atol
2e-6, gradients rtol 3e-4 / atol 1e-6; the trainer's merged loss against
its per-bundle loss rtol 1e-4, gradients rtol 5e-4 / atol 1e-6.

The per-bundle path takes a bundle's coarse and fine draws together, the
merged path every coarse draw and then every fine draw. The comparisons on
the port feed both paths through `KeyedDraws`, which hands out the numbers
by the draw's kind and shape in order of request: within a shape the
requests come in bundle order on both paths, so each bundle gets the same
numbers."""
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_close, patch_jax_draws, to_np

from sparf_tpu.models import nerf_mlp as jmlp
from sparf_tpu.models import renderer as jren
from sparf_tpu_torch.configs.config import load_options, save_options_file
from sparf_tpu_torch.convert import nerf_params_from_jax
from sparf_tpu_torch.models import nerf_mlp as tmlp
from sparf_tpu_torch.models import renderer as tren
from sparf_tpu_torch.ops import fused_mlp
from sparf_tpu_torch.parallel import dryrun
from sparf_tpu_torch.training import engine as teng
from sparf_tpu_torch.training import trainer as ttrainer
from sparf_tpu_torch.training.define_trainer import define_trainer
from sparf_tpu_torch.utils.draws import KeyedDraws, ReplayDraws

MLP = dict(layers_feat=(32, 32, 32, 32), layers_rgb=(16, 3), skip=(2,), L_3D=4, L_view=2,
           barf_c2f=None)


def _setup(fine: bool):
    cfg_j = jren.RenderConfig(mlp=jmlp.MLPConfig(**MLP), sample_intvs=16, sample_intvs_fine=8,
                              fine_sampling=fine)
    cfg_t = tren.RenderConfig(mlp=tmlp.MLPConfig(**MLP), sample_intvs=16, sample_intvs_fine=8,
                              fine_sampling=fine)
    params_j = jren.init_graph_params(jax.random.PRNGKey(0), cfg_j)
    rng = np.random.RandomState(1)
    poses = []
    for _ in range(3):
        aa = 0.1 * rng.randn(3)
        th = np.linalg.norm(aa)
        K_ = np.array([[0, -aa[2], aa[1]], [aa[2], 0, -aa[0]], [-aa[1], aa[0], 0]])
        R = np.eye(3) + np.sinc(th / np.pi) * K_ + 0.5 * np.sinc(th / (2 * np.pi)) ** 2 * (K_ @ K_)
        tr = np.array([0.05, -0.02, 4.0]) + 0.1 * rng.randn(3)
        poses.append(np.concatenate([R, tr[:, None]], 1))
    poses = np.stack(poses).astype(np.float32)
    intr = np.tile(np.array([[40.0, 0, 26], [0, 40, 20], [0, 0, 1]], np.float32), (3, 1, 1))
    return cfg_j, cfg_t, params_j, poses, intr, np.array([2.0, 6.0], np.float32)


def _arrays():
    rng = np.random.RandomState(2)
    return dict(a=(rng.rand(8, 2) * np.array([50, 38])).astype(np.float32),
                b=(rng.rand(1, 12, 2) * np.array([50, 38])).astype(np.float32),
                c=(rng.rand(1, 8, 2) * np.array([50, 38])).astype(np.float32),
                dmax=(2.5 + 2.0 * rng.rand(1, 8)).astype(np.float32))


def _bundles_j(poses, intr, key):
    k1, k2, k3 = jax.random.split(key, 3)
    a = _arrays()
    poses, intr = jnp.asarray(poses), jnp.asarray(intr)
    return [
        jren.RayBundle(pixels=jnp.asarray(a["a"]), pose_w2c=poses, intr=intr, key=k1),
        jren.RayBundle(pixels=jnp.asarray(a["b"]), pose_w2c=poses[:1], intr=intr[:1], key=k2),
        jren.RayBundle(pixels=jnp.asarray(a["c"]), pose_w2c=poses[1:2], intr=intr[1:2],
                       kind="tomax", depth_min=jnp.asarray(2.0),
                       depth_max=jnp.asarray(a["dmax"]), no_grad=True),
        jren.RayBundle(pixels=jnp.asarray(a["c"]), pose_w2c=poses[2:], intr=intr[2:], key=k3),
    ]


def _bundles_t(poses, intr):
    a = {k: torch.as_tensor(v) for k, v in _arrays().items()}
    poses, intr = torch.as_tensor(poses), torch.as_tensor(intr)
    return [
        tren.RayBundle(pixels=a["a"], pose_w2c=poses, intr=intr),
        tren.RayBundle(pixels=a["b"], pose_w2c=poses[:1], intr=intr[:1]),
        tren.RayBundle(pixels=a["c"], pose_w2c=poses[1:2], intr=intr[1:2], kind="tomax",
                       depth_min=torch.tensor(2.0), depth_max=a["dmax"], no_grad=True),
        tren.RayBundle(pixels=a["c"], pose_w2c=poses[2:], intr=intr[2:]),
    ]


def _loss(outs, fine, xp):
    tot = 0.0
    for i, o in enumerate(outs):
        w = 1.0
        if i == 2:
            w = (jax.lax.stop_gradient(jnp.mean(o["all_cumulated"])) if xp is jnp
                 else torch.mean(o["all_cumulated"]).detach())
        tot = tot + w * (xp.mean(o["rgb"] ** 2) + xp.mean(o["depth"]))
        if fine and "rgb_fine" in o:
            tot = tot + w * xp.mean(o["rgb_fine"] ** 2)
    return tot


def _torch_params(params_j):
    params = nerf_params_from_jax(to_np(params_j))
    leaves = teng.tree_leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    return params, leaves


def _render_t(cfg_t, params, poses, intr, dr, draws, fine, merge):
    return tren.render_bundles(params, cfg_t, _bundles_t(poses, intr), torch.as_tensor(dr), 1.0,
                               draws=draws, fine_enabled=fine, merge=merge)


@pytest.mark.parametrize("fine", [False, True])
def test_merged_render_matches_jax(monkeypatch, fine):
    """The port's merged render against the JAX package's, on the draws JAX
    takes (recorded in its merged order: every coarse draw, then every fine
    draw): outputs and gradients, the no-grad bundle included."""
    cfg_j, cfg_t, params_j, poses, intr, dr = _setup(fine)
    shim = patch_jax_draws(monkeypatch, [jren], seed=11)

    def loss_j(p):
        outs = jren.render_bundles(p, cfg_j, _bundles_j(poses, intr, jax.random.PRNGKey(7)),
                                   jnp.asarray(dr), jnp.asarray(1.0), fine_enabled=fine,
                                   merge=True)
        return _loss(outs, fine, jnp), outs

    (l_j, outs_j), g_j = jax.value_and_grad(loss_j, has_aux=True)(params_j)
    # stratified coarse draws of the three pixel bundles, then their fine draws
    assert [a.shape for a in shim.recorded] == (
        [(3, 8, 16, 1), (1, 12, 16, 1), (1, 8, 16, 1)] + ([(9,)] * 3 if fine else []))
    params, leaves = _torch_params(params_j)
    outs_t = _render_t(cfg_t, params, poses, intr, dr, ReplayDraws(shim.recorded), fine, True)
    for o_t, o_j in zip(outs_t, outs_j):
        assert set(o_t) == set(o_j), set(o_t) ^ set(o_j)
        for k in o_j:
            assert_close(o_t[k], o_j[k], atol=2e-6, rtol=2e-5, what=f"{k} fine={fine}")
    assert not outs_t[2]["rgb"].requires_grad
    g_t = torch.autograd.grad(_loss(outs_t, fine, torch), leaves, allow_unused=True)
    g_j = teng.tree_leaves(nerf_params_from_jax(to_np(g_j)))
    for a, b in zip(g_t, g_j):
        a = torch.zeros_like(b) if a is None else a
        assert_close(a, b, atol=1e-6, rtol=3e-4, what="gradient")


@pytest.mark.parametrize("fine", [False, True])
def test_merged_render_matches_per_bundle(fine):
    """The port's merged render against its per-bundle render on the same
    draws per bundle, with one MLP call per level and gradient group: one
    forward with autograd (K1's path) for the pixel bundles and one without
    (K3's path) for the no-grad bundle."""
    _, cfg_t, params_j, poses, intr, dr = _setup(fine)
    outs, grads, calls = {}, {}, {}
    for merge in (False, True):
        params, leaves = _torch_params(params_j)
        seen = []
        apply = fused_mlp.nerf_apply_fused

        def counted(p, cfg, pts, *a, **k):
            seen.append((tuple(pts.shape), torch.is_grad_enabled()))
            return apply(p, cfg, pts, *a, **k)

        fused_mlp.nerf_apply_fused = counted
        try:
            outs[merge] = _render_t(cfg_t, params, poses, intr, dr, KeyedDraws(3), fine, merge)
        finally:
            fused_mlp.nerf_apply_fused = apply
        calls[merge] = seen
        grads[merge] = torch.autograd.grad(_loss(outs[merge], fine, torch), leaves,
                                           allow_unused=True)
    levels = 2 if fine else 1
    assert len(calls[False]) == 4 * levels
    T = (3 * 8 + 12 + 8) * 16
    assert calls[True][:2] == [((1, T, 1, 3), True), ((1, 8 * 16, 1, 3), False)]
    if fine:
        assert calls[True][2:] == [((1, (3 * 8 + 12 + 8) * 24, 1, 3), True),
                                   ((1, 8 * 16, 1, 3), False)]
    for o_m, o_b in zip(outs[True], outs[False]):
        assert set(o_m) == set(o_b)
        for k in o_b:
            assert_close(o_m[k], o_b[k], atol=2e-6, rtol=2e-5, what=f"{k} fine={fine}")
    for a, b in zip(grads[True], grads[False]):
        if b is None:
            assert a is None or float(a.abs().max()) == 0.0
            continue
        assert_close(a, b, atol=1e-6, rtol=3e-4, what="gradient")


def _tiny_trainer(merged, cfg=None):
    cfg = cfg or dryrun.tiny_config(4, mesh=False, use_gt_correspondences=True)
    cfg.tpu.merged_render = merged
    return define_trainer(cfg, workspace=tempfile.mkdtemp(prefix="sparf_merged_"), device="cpu")


@pytest.mark.parametrize("iteration", [0, 350])
def test_trainer_loss_merged_matches_per_bundle(iteration):
    """The full SPARF loss stack (photometric + corres + depth_cons, 64 rays
    each) through the trainer's combined builder: the merged path's losses
    and NeRF gradients against the per-bundle path's, on the same draws
    per bundle."""
    trainer = _tiny_trainer(False)
    poses = trainer.current_poses_w2c().detach()
    res = {}
    for merge in (False, True):
        trainer.cfg.tpu.merged_render = merge
        builder = trainer.make_loss_builder(sample_in_center=False,
                                            fine_enabled=trainer.fine_enabled_at(iteration))
        leaves = [t.detach().requires_grad_(True)
                  for t in teng.tree_leaves(trainer.state.nerf_params)]
        params = teng.tree_unflatten(trainer.state.nerf_params, leaves)
        ld, _ = builder(params, poses, KeyedDraws(iteration), float(iteration), 1.0)
        total = sum(torch.sum(v) for v in ld.values())
        res[merge] = (ld, total, torch.autograd.grad(total, leaves, allow_unused=True))
    (ld_b, l_b, g_b), (ld_m, l_m, g_m) = res[False], res[True]
    assert set(ld_b) == set(ld_m) >= {"render", "corres", "depth_cons"}
    for k in ld_b:
        assert_close(ld_m[k], ld_b[k], atol=1e-7, rtol=1e-4, what=k)
    assert_close(l_m, l_b, atol=0.0, rtol=1e-4, what="total")
    for a, b in zip(g_m, g_b):
        if b is not None:
            assert_close(a, b, atol=1e-6, rtol=5e-4, what="gradient")


def test_config_without_merged_render_key_renders_merged(tmp_path, monkeypatch):
    """A config saved without cfg.tpu.merged_render (an older options file)
    trains on the merged path, as the JAX trainer defaults the missing key
    to True; the presets keep it False."""
    cfg = dryrun.tiny_config(1, mesh=False, use_gt_correspondences=True)
    assert cfg.tpu.merged_render is False and not ttrainer.merged_render(cfg)
    del cfg.tpu["merged_render"]
    path = save_options_file(cfg, str(tmp_path))
    loaded = load_options(path)
    assert "merged_render" not in loaded.tpu
    trainer = define_trainer(loaded, workspace=str(tmp_path / "ws"), device="cpu")
    merges = []
    render = tren.render_bundles

    def spy(*a, merge, **k):
        merges.append(merge)
        return render(*a, merge=merge, **k)

    monkeypatch.setattr(tren, "render_bundles", spy)
    new, stats = trainer.get_step(0)(trainer.state, trainer.draws)
    assert merges and all(merges)
    assert np.isfinite(float(stats["all"]))

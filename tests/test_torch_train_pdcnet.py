"""The port's PDC-Net trainer (sparf_tpu_torch/scripts/train_pdcnet_synth.py)
against the JAX script (scripts/train_pdcnet_synth.py, imported by path) at
32x40 with batch 2: the generated pairs, the zoom and photometric
augmentations on JAX's draws, the loss and every parameter's gradient, three
clipped-Adam steps on a cosine schedule against optax, the ladder eval of the
bundled weights, and a CLI run whose npz the JAX package loads.

Tolerances (float32, other summation orders): the generated images 1e-4 and
GT correspondences 1e-3 px (each package's rays, an ulp apart, through the
procedural texture and the depth); the photometric augmentation 1e-6, the
zoomed images 1e-5 (a sample coordinate an ulp apart, ~4e-6 px at 40 px,
times the image's gradient) and their correspondences 1e-6 relative where
both zoomed validities are 1; the loss 1e-5
relative, gradients within 1e-4 of each tensor's largest magnitude;
parameters after three steps within 1e-6 outside the Adam holdout
(tests/traced_draws.py::assert_one_step_matches's rule: elements whose JAX
gradient, after the clip, is below 1e-6 at some step); the npz's forward in the JAX package
within 1e-5 (relative for the mapping's pixel coordinates); the ladder eval's median EPE within 0.01 px and confident
fractions within 1e-3.
"""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_parity  # noqa: F401  (thread cap)
from torch_parity import assert_close, assert_close_scaled, to_np
from sparf_tpu.models import pdcnet_jax as pj
from sparf_tpu_torch.models import pdcnet as pt
from sparf_tpu_torch.scripts import train_pdcnet_synth as tr
from sparf_tpu_torch.training.engine import Adam
from sparf_tpu_torch.utils.draws import ReplayDraws

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, B = 32, 40, 2


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_train_pdcnet_synth", os.path.join(REPO, "scripts", "train_pdcnet_synth.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JS = _jax_script()


@pytest.fixture(scope="module")
def pairs():
    return (JS.generate_pairs(np.random.RandomState(0), 3, H, W),
            tr.generate_pairs(np.random.RandomState(0), 3, H, W))


def _jax_params(model):
    params = {}
    for k, v in model.state_dict().items():
        name, i = k.rsplit("__", 1)
        params.setdefault(name, [None, None])[int(i)] = jnp.asarray(v.numpy())
    return params


# --- the JAX script's draws, as unit numbers the port replays ---------------

def _photometric_draws(key, shape):
    k1, k2, k3, k4 = jax.random.split(key, 4)
    Bn = shape[0]
    return [jax.random.uniform(k1, (Bn, 3, 1, 1)), jax.random.uniform(k2, (Bn, 1, 1, 1)),
            jax.random.normal(k3, shape), jax.random.uniform(k4, (Bn, 1, 1, 1))]


def _zoom_draws(key, Bn):
    out = []
    for k in jax.random.split(key, Bn):
        kt, ks = jax.random.split(k)
        out.append([jax.random.uniform(kt, ()), jax.random.uniform(ks, ())])
    return [np.array(out, np.float32)]


def _aug_draws(key, Bn):
    """The port's draws for augmented_loss from the JAX loss's key."""
    k_t, k_s, k_z = jax.random.split(key, 3)
    return (_zoom_draws(k_z, Bn) + _photometric_draws(k_t, (Bn, 3, H, W))
            + _photometric_draws(k_s, (Bn, 3, H, W)))


def _jax_loss_fn(bias_weight=0.7, zoom_min=0.72, zoom_max=1.35):
    """A copy of scripts/train_pdcnet_synth.py:227-273 (its loss_fn), from
    the script's module-level functions and pdcnet_jax.forward."""
    zoom_aug = JS.make_zoom_aug(H, W, zoom_min, zoom_max)

    def loss_fn(params, batch_tgt, batch_src, batch_corres, batch_valid, key):
        k_t, k_s, k_z = jax.random.split(key, 3)
        tgt, src, batch_corres, batch_valid = zoom_aug(
            jax.random.split(k_z, batch_tgt.shape[0]), batch_tgt, batch_src, batch_corres,
            batch_valid)
        tgt = JS.photometric_aug(k_t, tgt)
        src = JS.photometric_aug(k_s, src)
        out = pj.forward(params, tgt, src)
        total = 0.0
        logs = {}
        for lev, w_lev in ((8, 1.0), (4, 0.5), (2, 0.5)):
            m = out["mapping"] if lev == 2 else out[f"mapping{lev}"]
            Bn, _, h, w = m.shape
            gt = jax.image.resize(batch_corres / lev, (Bn, 2, h, w), "bilinear")
            v = jax.image.resize(batch_valid[:, None], (Bn, 1, h, w), "bilinear")
            v = (v > 0.99).astype(jnp.float32)
            err = jnp.linalg.norm(m - gt, axis=1, keepdims=True)
            huber = jnp.where(err < 1.0, 0.5 * err**2, err - 0.5)
            total = total + w_lev * jnp.sum(huber * v) / (jnp.sum(v) + 1.0)
            if lev == 2:
                logs["epe2"] = jnp.sum(err * v) / (jnp.sum(v) + 1.0)
                bias_vec = (jnp.sum((m - gt) * v, axis=(2, 3)) / (jnp.sum(v, axis=(2, 3)) + 1.0))
                bias_mag = jnp.sqrt(jnp.sum(bias_vec**2, axis=1) + 1e-8)
                logs["bias2"] = jnp.mean(bias_mag) * 2.0
                total = total + bias_weight * jnp.mean(bias_mag)

                def nll(var):
                    b = jnp.sqrt(jnp.maximum(var, 1e-6) / 2)
                    return err / b + 2 * jnp.log(b)

                m_nll = -jnp.log(
                    out["alpha"] * jnp.exp(-nll(jnp.exp(out["log_var_s"])))
                    + (1 - out["alpha"]) * jnp.exp(-nll(jnp.exp(out["log_var_l"])))
                    + 1e-9)
                total = total + 0.1 * jnp.sum(m_nll * v) / (jnp.sum(v) + 1.0)
        return total, logs

    return loss_fn


def test_generate_pairs_match_jax(pairs):
    (ij, cj, vj), (it, ct, vt) = pairs
    # the same RandomState numbers; the renders' rays come from each
    # package's camera math, a float32 ulp apart, which the procedural
    # texture carries into the pixels
    np.testing.assert_allclose(it, ij, atol=1e-4)
    valid = vj & vt
    assert (vj != vt).mean() < 1e-3, "validity differs beyond border pixels"
    valid2 = np.broadcast_to(valid[:, :, None], ct.shape)
    np.testing.assert_allclose(ct[valid2], cj[valid2], atol=1e-3)


def test_augmentations_on_jax_draws(pairs):
    imgs, corres, valid = pairs[0]
    tgt, src = imgs[:2, 0], imgs[:2, 1]
    c, v = corres[:2, 0], valid[:2, 0].astype(np.float32)
    key = jax.random.PRNGKey(5)
    k_p, k_z = jax.random.split(key)
    photo_j = JS.photometric_aug(k_p, jnp.asarray(tgt))
    photo_t = tr.photometric_aug(ReplayDraws(_photometric_draws(k_p, tgt.shape)),
                                 torch.as_tensor(tgt))
    assert_close(photo_t, photo_j, atol=1e-6)
    zj = JS.make_zoom_aug(H, W)(jax.random.split(k_z, 2), jnp.asarray(tgt), jnp.asarray(src),
                                jnp.asarray(c), jnp.asarray(v))
    draws = ReplayDraws(_zoom_draws(k_z, 2))
    zt = tr.zoom_aug(draws, *(torch.as_tensor(a) for a in (tgt, src, c, v)))
    assert not draws.arrays
    for i, what in ((0, "tgt"), (1, "src"), (3, "valid")):
        assert_close(zt[i], zj[i], atol=1e-5, what=what)
    # the correspondences where both packages' zoomed validity is 1 (the
    # loss's pixels): elsewhere a map that jumps at an occlusion border is
    # sampled at coordinates an ulp apart
    both = (to_np(zt[3]) == 1) & (np.asarray(zj[3]) == 1)
    assert both.mean() > 0.1
    assert_close(to_np(zt[2]).transpose(1, 0, 2, 3)[:, both],
                 np.asarray(zj[2]).transpose(1, 0, 2, 3)[:, both], atol=0, rtol=1e-6, what="corres")


def _batch(pairs, idx, dr):
    imgs, corres, valid = pairs[0]
    u8 = np.clip(imgs * 255.0 + 0.5, 0, 255).astype(np.uint8)[idx].astype(np.float32) / 255.0
    ar = np.arange(len(idx))
    return (u8[ar, dr], u8[ar, 1 - dr], corres[idx][ar, dr],
            valid[idx][ar, dr].astype(np.float32))


def test_loss_and_gradients_match_jax(pairs):
    model = pt.PDCNet(generator=torch.Generator().manual_seed(3))
    params_j = _jax_params(model)
    tgt, src, c, v = _batch(pairs, np.array([0, 2]), np.array([1, 0]))
    key = jax.random.PRNGKey(11)
    (loss_j, logs_j), g_j = jax.jit(jax.value_and_grad(_jax_loss_fn(), has_aux=True))(
        params_j, jnp.asarray(tgt), jnp.asarray(src), jnp.asarray(c), jnp.asarray(v), key)
    draws = ReplayDraws(_aug_draws(key, B))
    loss_t, logs_t = tr.augmented_loss(model, *(torch.as_tensor(a) for a in (tgt, src, c, v)),
                                       draws)
    assert not draws.arrays
    assert_close(loss_t, loss_j, atol=0, rtol=1e-5, what="loss")
    for k in ("epe2", "bias2"):
        assert_close(logs_t[k], logs_j[k], atol=0, rtol=1e-5, what=k)
    loss_t.backward()
    for name, p in model.named_parameters():
        layer, i = name.rsplit("__", 1)
        assert_close_scaled(p.grad, g_j[layer][int(i)], 1e-4, name)


def test_three_steps_match_optax(pairs):
    """Three training steps (pair indices, pair orders and augmentations from
    JAX's keys, as the script's run_chunk draws them) through clip 1.0 ->
    Adam(cosine_decay(2e-4, 3, alpha 0.05)) against optax."""
    steps, lr = 3, 2e-4
    model = pt.PDCNet(generator=torch.Generator().manual_seed(4))
    params_j = _jax_params(model)
    imgs, corres, valid = pairs[0]
    n_pairs = imgs.shape[0]
    tx_j = optax.chain(optax.clip_by_global_norm(1.0),
                       optax.adam(optax.cosine_decay_schedule(lr, steps, alpha=0.05)))
    opt_j = tx_j.init(params_j)
    grad_fn = jax.jit(jax.value_and_grad(_jax_loss_fn(), has_aux=True))
    base_key = jax.random.PRNGKey(1)
    pool = (torch.as_tensor(np.clip(imgs * 255.0 + 0.5, 0, 255).astype(np.uint8)),
            torch.as_tensor(corres), torch.as_tensor(valid))
    tx_t = Adam(tr.cosine_lr(lr, steps), clip_norm=1.0)
    opt_t = tx_t.init(list(model.parameters()))
    small, kept = {}, []
    for it in range(steps):
        k_idx, k_dir, k_aug = jax.random.split(jax.random.fold_in(base_key, it), 3)
        idx = np.asarray(jax.random.randint(k_idx, (B,), 0, n_pairs))
        dr = np.asarray(jax.random.randint(k_dir, (B,), 0, 2))
        (loss_j, _), g = grad_fn(params_j, *(jnp.asarray(a) for a in _batch(pairs, idx, dr)),
                                 k_aug)
        upd, opt_j = tx_j.update(g, opt_j, params_j)
        params_j = optax.apply_updates(params_j, upd)
        # the holdout is on the gradient Adam sees, after the clip
        clip = min(1.0, 1.0 / float(optax.global_norm(g)))
        for layer, wb in g.items():
            for i, a in enumerate(wb):
                key = f"{layer}__{i}"
                small[key] = small.get(key, False) | (np.abs(np.asarray(a)) * clip < 1e-6)
        draws = ReplayDraws([idx, dr] + _aug_draws(k_aug, B))
        loss_t, _, grads_t, opt_t = tr.train_step(model, tx_t, opt_t, pool, draws, B)
        assert not draws.arrays
        assert_close(loss_t, loss_j, atol=0, rtol=1e-5, what=f"loss, step {it}")
        for (name, _), g_t in zip(model.named_parameters(), grads_t):
            layer, i = name.rsplit("__", 1)
            assert_close_scaled(g_t, g[layer][int(i)], 1e-4, f"{name}, step {it}")
    for name, p in model.named_parameters():
        layer, i = name.rsplit("__", 1)
        keep = ~small[name]
        kept.append(keep.mean())
        assert_close(to_np(p)[keep], np.asarray(params_j[layer][int(i)])[keep], atol=1e-6,
                     what=name)
    assert np.mean(kept) > 0.8


def test_ladder_eval_of_the_bundled_weights_matches_jax():
    """--eval-only's readings (the port's ladder_eval) against the JAX
    script's eval loop (a copy of :338-370) on the bundled weights, at 64x80."""
    from sparf_tpu.datasets.synthetic import load_synthetic_scene
    from sparf_tpu.models import flow_net as F

    ours = tr.ladder_eval(pt.load_weights_npz(pt.BUNDLED_WEIGHTS), 64, 80, "cpu")
    params = pj.load_weights_npz(pt.BUNDLED_WEIGHTS)
    for span in (0.35, 1.0):
        sc = load_synthetic_scene(split="train", H=64, W=80, n_train=3, n_test=1,
                                  angular_span=span, texture_octaves=2)
        combi = F.get_combi_list(3, "all")
        gt_corres, gt_conf = F.compute_gt_flow_of_combi_list(sc, combi)
        c, conf = pj.compute_pdcnet_flow_of_combi_list(np.asarray(sc["image"]), combi,
                                                       params=params)
        for p in range(combi.shape[1]):
            m = (conf[p, 0] > 0.95) & (gt_conf[p, 0] > 0.5)
            row = {k: v[p] for k, v in ours[str(span)].items()}
            if m.sum() < 10:
                assert row["median_epe"] == np.inf
                continue
            diff = (c[p] - gt_corres[p])[:, m]
            assert abs(row["median_epe"] - float(np.median(np.linalg.norm(diff, axis=0)))) < 0.01
            assert abs(row["conf_frac"] - float(m.mean())) < 1e-3
            assert abs(row["mean_signed_err"] - float(np.linalg.norm(diff.mean(axis=1)))) < 0.01


def test_cli_run_writes_weights_the_jax_package_loads(tmp_path):
    cache, out = str(tmp_path / "pairs.npz"), str(tmp_path / "w.npz")
    res = tr.main(["--steps", "2", "--pairs", "2", "--H", "32", "--W", "40", "--device", "cpu",
                   "--data_cache", cache, "--out", out])
    assert len(res["train"]["losses"]) == 2 and np.isfinite(res["train"]["losses"]).all()
    assert os.path.exists(cache) and set(res["eval"]) == {"0.35", "1.0"}
    with np.load(out) as data:
        assert "provenance" in data.files and "steps=2" in str(data["provenance"])
    params = pj.load_weights_npz(out)
    model = pt.load_weights_npz(out)
    rng = np.random.RandomState(6)
    a, b = (rng.uniform(size=(1, 3, 32, 40)).astype(np.float32) for _ in range(2))
    oj = pj.forward(params, jnp.asarray(a), jnp.asarray(b))
    with torch.no_grad():
        ot = model(torch.as_tensor(a), torch.as_tensor(b))
    for k in ("mapping", "p_r", "mapping8"):
        assert_close(ot[k], oj[k], atol=1e-5, rtol=1e-5, what=k)
    # the cache is read back; --gen_only stops after it
    assert tr.main(["--pairs", "2", "--H", "32", "--W", "40", "--device", "cpu", "--data_cache",
                    cache, "--gen_only", "--out", out])["train"] is None
    with pytest.raises(SystemExit, match="sparf_tpu"):
        tr.main(["--steps", "1", "--device", "cpu", "--out",
                 os.path.join(REPO, "sparf_tpu", "data", "never.npz")])


def test_cli_run_checkpoints_into_a_directory_that_does_not_exist_yet(tmp_path, monkeypatch):
    # the checkpoint cadence lowered from 100/400 steps to every step; the
    # output directory is made before the loop writes the first checkpoint
    monkeypatch.setattr(tr, "LOG_EVERY", 1)
    monkeypatch.setattr(tr, "CHECKPOINT_EVERY", 1)
    out = tmp_path / "new" / "dir" / "w.npz"
    res = tr.main(["--steps", "3", "--pairs", "2", "--H", "32", "--W", "40", "--device", "cpu",
                   "--out", str(out)])
    assert len(res["train"]["losses"]) == 3
    assert out.exists()
    ckpts = sorted(p.name for p in out.parent.iterdir() if ".step" in p.name)
    assert [c.split(".step")[1].split(".")[0] for c in ckpts] == ["1", "2"]
    model = pt.load_weights_npz(str(out.parent / ckpts[0]))
    assert all(torch.isfinite(p).all() for p in model.parameters())

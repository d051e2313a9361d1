"""The port's functional Adam against the JAX engine's optax chain
(clip_by_global_norm -> scale_by_adam(0.9, 0.999) -> scale_by_schedule(-lr))
over 10 steps, one of which has a non-finite gradient and must leave the
parameters and the optimizer state untouched.

Tolerance: float32; parameters within 1e-6 after 10 steps of lr <= 1e-2.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_close, t

from sparf_tpu.training import engine as jeng
from sparf_tpu_torch.training import engine as teng


@pytest.mark.parametrize("clip,warmup", [(0.1, None), (None, 4)])
def test_adam_matches_optax_with_skipped_step(clip, warmup):
    rng = np.random.RandomState(0)
    params_np = {"a": rng.normal(size=(4, 3)).astype(np.float32),
                 "b": rng.normal(size=(5,)).astype(np.float32)}
    lr_j = jeng.pose_lr_schedule(1e-2, 1e-4, 100, warmup)
    lr_t = teng.pose_lr_schedule(1e-2, 1e-4, 100, warmup)
    tx = jeng.make_optimizer(lr_j, clip)
    adam = teng.Adam(lr_t, clip)

    p_j = {k: jnp.asarray(v) for k, v in params_np.items()}
    s_j = tx.init(p_j)
    leaves_t = [t(params_np[k]) for k in sorted(params_np)]
    s_t = adam.init(leaves_t)
    for step in range(10):
        g = {k: rng.normal(size=v.shape).astype(np.float32) * 0.3 for k, v in params_np.items()}
        if step == 4:
            g["a"][1, 2] = np.nan
        g_j = {k: jnp.asarray(v) for k, v in g.items()}
        finite = jeng.tree_all_finite(g_j)
        upd, cand = tx.update(g_j, s_j, p_j)
        p_j = jeng.apply_updates_if_finite(p_j, upd, finite)
        s_j = jeng.select_tree(finite, cand, s_j)

        g_t = [t(g[k]) for k in sorted(g)]
        fin_t = torch.stack([torch.isfinite(x).all() for x in g_t]).all()
        upd_t, cand_t = adam.update(g_t, s_t)
        leaves_t = teng.apply_updates_if_finite(leaves_t, upd_t, fin_t)
        s_t = teng.select_state(fin_t, cand_t, s_t)
        for k, x in zip(sorted(params_np), leaves_t):
            assert_close(x, p_j[k], atol=1e-6, what=f"step {step} {k}")
    adam_state = s_j[-2] if clip else s_j[0]
    assert int(s_t.count) == int(adam_state.count) == 9  # the NaN step was skipped
    for k, m, v in zip(sorted(params_np), s_t.mu, s_t.nu):
        assert_close(m, adam_state.mu[k], atol=1e-7)
        assert_close(v, adam_state.nu[k], atol=1e-7)


def test_first_pose_update_is_zero_under_warmup():
    """optax evaluates the schedule at count 0 first, so with a linear warm-up
    the first pose update is zero."""
    lr = teng.pose_lr_schedule(1e-3, 1e-5, 1000, 10)
    adam = teng.Adam(lr)
    p = [torch.ones(3)]
    upd, _ = adam.update([torch.ones(3)], adam.init(p))
    assert float(upd[0].abs().max()) == 0.0
    assert_close(teng.exponential_lr(1e-3, 1e-5, 1000)(250),
                 jeng.exponential_lr(1e-3, 1e-5, 1000)(jnp.asarray(250)), atol=0,
                 rtol=1e-5)  # float32 pow: XLA and torch round differently by an ulp or two


def test_tree_flatten_roundtrip():
    tree = {"coarse": {"feat": [(torch.ones(2), torch.zeros(1))], "rgb": []},
            "fine": {"feat": [(torch.full((3,), 2.0), torch.ones(1))], "rgb": []}}
    leaves = teng.tree_leaves(tree)
    assert len(leaves) == 4 and float(leaves[2][0]) == 2.0
    back = teng.tree_unflatten(tree, [x + 1 for x in leaves])
    assert float(back["fine"]["feat"][0][0][0]) == 3.0

"""sparf_tpu_torch camera / geometry / pose parametrizations vs the JAX package.

Tolerances: float32 on both sides; values within 1e-5 (pose algebra of
O(1) entries), gradients within 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_close, t, to_np

from sparf_tpu.models import pose_params as jpose
from sparf_tpu.utils import camera as jcam
from sparf_tpu.utils import geometry as jgeo
from sparf_tpu_torch.convert import pose_params_from_jax, pose_params_to_numpy
from sparf_tpu_torch.models import pose_params as tpose
from sparf_tpu_torch.utils import camera as tcam
from sparf_tpu_torch.utils import geometry as tgeo


def _random_poses(rng, n, scale=0.5):
    twists = rng.normal(size=(n, 6)).astype(np.float32) * scale
    return np.array(jcam.se3_to_SE3(jnp.asarray(twists)))


@pytest.mark.parametrize("scale", [0.0, 1e-4, 0.3, 1.5])
def test_lie_maps_values_and_gradients(scale):
    """exp/log maps incl. theta -> 0, where the Taylor-in-theta^2 form keeps
    the gradient finite."""
    rng = np.random.RandomState(0)
    wu = (rng.normal(size=(5, 6)) * scale).astype(np.float32)

    assert_close(tcam.se3_to_SE3(t(wu)), jcam.se3_to_SE3(jnp.asarray(wu)), atol=1e-5)
    assert_close(tcam.so3_to_SO3(t(wu[:, :3])), jcam.so3_to_SO3(jnp.asarray(wu[:, :3])),
                 atol=1e-5)
    pose = np.asarray(jcam.se3_to_SE3(jnp.asarray(wu)))
    if scale > 1e-3:  # the log map's arccos is flat to float32 below that
        assert_close(tcam.SE3_to_se3(t(pose)), jcam.SE3_to_se3(jnp.asarray(pose)), atol=1e-4)
        assert_close(tcam.SO3_to_so3(t(pose[:, :, :3])),
                     jcam.SO3_to_so3(jnp.asarray(pose[:, :, :3])), atol=1e-4)

    weights = rng.normal(size=(5, 3, 4)).astype(np.float32)
    g_j = jax.grad(lambda x: jnp.sum(jcam.se3_to_SE3(x) * weights))(jnp.asarray(wu))
    x = t(wu, requires_grad=True)
    torch.sum(tcam.se3_to_SE3(x) * t(weights)).backward()
    assert np.isfinite(to_np(x.grad)).all()
    assert_close(x.grad, g_j, atol=1e-4)


def test_pose_compose_invert_quaternion():
    rng = np.random.RandomState(1)
    a, b = _random_poses(rng, 4), _random_poses(rng, 4)
    assert_close(tcam.pose_compose([t(a), t(b)]), jcam.pose_compose([a, b]), atol=1e-5)
    assert_close(tcam.pose_invert(t(a)), jcam.pose_invert(a), atol=1e-5)
    assert_close(tcam.pose_inverse_4x4(tcam.pose_to_4x4(t(a))),
                 jcam.pose_inverse_4x4(jcam.pose_to_4x4(a)), atol=1e-5)
    q = np.asarray(jcam.R_to_quaternion(jnp.asarray(a[:, :, :3])))
    assert_close(tcam.R_to_quaternion(t(a[:, :, :3])), q, atol=1e-5)
    assert_close(tcam.quaternion_to_R(t(q)), jcam.quaternion_to_R(q), atol=1e-5)


@pytest.mark.parametrize("ndc", [False, True])
def test_rays_at_pixel_centers_and_points(ndc):
    rng = np.random.RandomState(2)
    pose = _random_poses(rng, 2)
    intr = np.array([[[30.0, 0, 16], [0, 30.0, 12], [0, 0, 1]]] * 2, np.float32)
    pixels = np.asarray(jcam.get_pixel_grid(6, 8))
    assert_close(tcam.get_pixel_grid(6, 8), pixels, atol=0)
    cj, rj = jcam.get_center_and_ray_at_pixels(pose, pixels, intr)
    ct, rt = tcam.get_center_and_ray_at_pixels(t(pose), t(pixels), t(intr))
    if ndc:
        cj, rj = jcam.convert_NDC(cj + 5.0 * rj, rj, intr)
        ct, rt = tcam.convert_NDC(ct + 5.0 * rt, rt, t(intr))
    assert_close(ct, cj, atol=1e-5)
    assert_close(rt, rj, atol=1e-5)
    depth = rng.uniform(1, 3, size=(2, 48, 5, 1)).astype(np.float32)
    assert_close(tcam.get_3d_points_from_depth(ct, rt, t(depth), multi_samples=True),
                 jcam.get_3d_points_from_depth(cj, rj, depth, multi_samples=True), atol=1e-4)


def test_geometry_projection_and_depth_lookup():
    rng = np.random.RandomState(3)
    pi, pj = _random_poses(rng, 1, 0.1), _random_poses(rng, 1, 0.1)
    pi[:, 2, 3] += 3.0
    pj[:, 2, 3] += 3.0
    K = np.array([[[20.0, 0, 10], [0, 20.0, 8], [0, 0, 1]]], np.float32)
    kp = rng.uniform(0, 16, size=(1, 30, 2)).astype(np.float32)
    d = rng.uniform(2, 4, size=(1, 30)).astype(np.float32)
    depth_map = rng.uniform(2, 4, size=(1, 16, 20)).astype(np.float32)
    depth_map[0, 3:6, 4:9] = 0.0  # holes take the nearest-neighbour fallback
    valid = np.ones((1, 30), bool)
    T_j = np.asarray(jgeo.relative_transform_i_to_j(pi[0], pj[0]))[None]
    assert_close(tgeo.relative_transform_i_to_j(t(pi[0]), t(pj[0]))[None], T_j, atol=1e-5)
    assert_close(tgeo.batch_backproject_to_3d(t(kp), t(d), t(K), t(T_j)),
                 jgeo.batch_backproject_to_3d(kp, d, K, T_j), atol=1e-4)
    kj_t, vis_t = tgeo.batch_project_to_other_img_and_check_depth(
        t(kp), t(d), t(depth_map), t(K), t(K), t(T_j), torch.as_tensor(valid), rth=0.5)
    kj_j, vis_j = jgeo.batch_project_to_other_img_and_check_depth(
        kp, d, depth_map, K, K, T_j, valid, rth=0.5)
    assert_close(kj_t, kj_j, atol=1e-4)
    np.testing.assert_array_equal(to_np(vis_t), np.asarray(vis_j))
    interp_t, v_t = tgeo.sample_depth_at(t(kp), t(depth_map))
    interp_j, v_j = jgeo.sample_depth_at(kp, depth_map)
    assert_close(interp_t, interp_j, atol=1e-5)
    np.testing.assert_array_equal(to_np(v_t), np.asarray(v_j))


@pytest.mark.parametrize("param,extra", [
    ("two_columns", {}),
    ("two_columns", {"optimize_trans": False}),
    ("axis_angle", {}),
    ("quaternion", {}),
    ("two_columns", {"optimize_relative_poses": True, "n_first_fixed_poses": 1}),
])
def test_pose_parametrizations(param, extra):
    rng = np.random.RandomState(4)
    init = _random_poses(rng, 3)
    kw = dict(parametrization=param, nbr_poses=3, **extra)
    cj, ct = jpose.PoseConfig(**kw), tpose.PoseConfig(**kw)
    pj, constj = jpose.init_pose_params(cj, init)
    pt, constt = tpose.init_pose_params(ct, t(init))
    for k in pj:
        assert_close(pt[k], pj[k], atol=1e-5, what=k)
    # perturb the parameters, compare poses and gradients
    pj = {k: v + 0.05 * rng.normal(size=v.shape).astype(np.float32) for k, v in pj.items()}
    weights = rng.normal(size=(3, 3, 4)).astype(np.float32)
    assert_close(tpose.get_w2c_poses(ct, pose_params_from_jax(pj), constt),
                 jpose.get_w2c_poses(cj, pj, constj), atol=1e-5)
    for k, v in pose_params_to_numpy(pose_params_from_jax(pj)).items():
        np.testing.assert_array_equal(v, pj[k])
    g_j = jax.grad(lambda p: jnp.sum(jpose.get_w2c_poses(cj, p, constj) * weights))(pj)
    pt = {k: t(v, requires_grad=True) for k, v in pj.items()}
    torch.sum(tpose.get_w2c_poses(ct, pt, constt) * t(weights)).backward()
    for k in pj:
        assert_close(pt[k].grad, g_j[k], atol=1e-4, what=k)


def test_taylor_quaternion_rotation_distance_procrustes():
    """The helpers the JAX package's own tests exercise: taylor_C, the
    quaternion product, the geodesic rotation distance (values and
    gradients) and the Procrustes sim3 (host float64, so to 1e-6)."""
    rng = np.random.RandomState(7)
    x = (rng.uniform(-3, 3, size=(64,))).astype(np.float32)
    assert_close(tcam.taylor_C(t(x)), jcam.taylor_C(jnp.asarray(x)), atol=1e-6)
    q1, q2 = (rng.normal(size=(5, 4)).astype(np.float32) for _ in range(2))
    assert_close(tcam.quaternion_product(t(q1), t(q2)),
                 jcam.quaternion_product(jnp.asarray(q1), jnp.asarray(q2)), atol=1e-6)
    R1 = _random_poses(rng, 6)[..., :3]
    R2 = _random_poses(rng, 6)[..., :3]
    assert_close(tcam.rotation_distance(t(R1), t(R2)),
                 jcam.rotation_distance(jnp.asarray(R1), jnp.asarray(R2)), atol=1e-5)
    g_j = jax.grad(lambda r: jnp.sum(jcam.rotation_distance(r, jnp.asarray(R2))))(jnp.asarray(R1))
    r = t(R1, requires_grad=True)
    torch.sum(tcam.rotation_distance(r, t(R2))).backward()
    assert_close(r.grad, g_j, atol=1e-4)
    X1 = rng.normal(size=(20, 3))
    for flip in (False, True):
        X0 = 2.5 * X1 @ _random_poses(rng, 1)[0, :, :3].T + 0.3
        if flip:
            X0[:, 2] *= -1      # a reflection: det < 0 branch
        out_t, out_j = tcam.procrustes_analysis(X0, X1), jcam.procrustes_analysis(X0, X1)
        for k in out_j:
            np.testing.assert_allclose(out_t[k], out_j[k], atol=1e-6, err_msg=k)


def test_batch_project_and_c2w_poses():
    rng = np.random.RandomState(8)
    pts = (rng.normal(size=(2, 30, 3)) + np.array([0, 0, 4.0])).astype(np.float32)
    T = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    T[:, :3] = _random_poses(rng, 2, scale=0.1)
    K = np.tile(np.array([[50.0, 0, 20], [0, 50.0, 16], [0, 0, 1]], np.float32), (2, 1, 1))
    assert_close(tgeo.batch_project(t(pts), t(T), t(K)),
                 jgeo.batch_project(jnp.asarray(pts), jnp.asarray(T), jnp.asarray(K)),
                 atol=1e-4)
    cfg_kw = dict(parametrization="two_columns", nbr_poses=3)
    init = _random_poses(rng, 3)
    pj, constj = jpose.init_pose_params(jpose.PoseConfig(**cfg_kw), init)
    pt, constt = tpose.init_pose_params(tpose.PoseConfig(**cfg_kw), t(init))
    assert_close(tpose.get_c2w_poses(tpose.PoseConfig(**cfg_kw), pt, constt),
                 jpose.get_c2w_poses(jpose.PoseConfig(**cfg_kw), pj, constj), atol=1e-5)

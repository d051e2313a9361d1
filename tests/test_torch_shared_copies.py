"""The port's own copies of the JAX package's host modules (configs, admin,
alignment, logging utilities, the DTU/LLFF loaders, the synthetic scene's
numpy helpers, the novel-view paths) against the originals, on the same inputs. The loaders resize,
crop and decompose projection matrices through the port's OpenCV-free
utils/imgproc.py and must still give the JAX package's scenes bit for bit
(area and nearest resizing in OpenCV's arithmetic); so must the ray
sampler's dilated foreground-mask pools."""
import math

import numpy as np
import pytest
import yaml

import torch_parity  # noqa: F401  (thread cap)
from sparf_tpu import admin as admin_j
from sparf_tpu.configs import config as config_j
from sparf_tpu.configs import presets as presets_j
from sparf_tpu.datasets import create_dataset as create_dataset_j
from sparf_tpu.datasets import synthetic as synthetic_j
from sparf_tpu.training import logging_utils as logging_j
from sparf_tpu.utils import alignment as alignment_j
from sparf_tpu.utils import camera as camera_j
from sparf_tpu.utils import rendering_paths as paths_j
from sparf_tpu_torch import admin as admin_t
from sparf_tpu_torch import datasets as datasets_t
from sparf_tpu_torch.configs import config as config_t
from sparf_tpu_torch.configs import presets as presets_t
from sparf_tpu_torch.datasets import synthetic as synthetic_t
from sparf_tpu_torch.training import logging_utils as logging_t
from sparf_tpu_torch.utils import alignment as alignment_t
from sparf_tpu_torch.utils import camera as camera_t
from sparf_tpu_torch.utils import rendering_paths as paths_t

PRESET_NAMES = sorted(presets_j.PRESETS)


def _split(path):
    module, name = path.rsplit("/", 1)
    return module, name


def _assert_scene_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


def test_same_preset_names():
    assert sorted(presets_t.PRESETS) == PRESET_NAMES and len(PRESET_NAMES) >= 20


@pytest.mark.parametrize("path", PRESET_NAMES)
def test_get_config_equal(path):
    a = config_t.to_plain(presets_t.get_config(*_split(path)))
    b = config_j.to_plain(presets_j.get_config(*_split(path)))
    assert a == b
    assert "tpu" in a  # the TPU keys stay, so saved configs load in either package


@pytest.mark.parametrize("path", PRESET_NAMES)
def test_apply_max_iter_schedule_equal(path):
    for sub, scene in ((None, "scan40"), (2, "scan21"), (3, "scan8"), (6, "scan114"), (9, None)):
        over = dict(train_sub=sub, scene=scene)
        a = presets_t.get_config(*_split(path))
        b = presets_j.get_config(*_split(path))
        a = presets_t.apply_max_iter_schedule(config_t.override_options(a, config_t.ConfigDict(over)))
        b = presets_j.apply_max_iter_schedule(config_j.override_options(b, config_j.ConfigDict(over)))
        assert config_t.to_plain(a) == config_j.to_plain(b), over


def test_parse_dotted_args_equal():
    args = ["--max_iter=1000", "--nerf.rand_rays=16", "--arch.layers_feat=[null,64,64]",
            "--optim.lr=1.e-3", "--debug", "--scene=scan82", "--a.b.c={x: 1}", "--s=text here"]
    a = config_t.parse_dotted_args(args, base=presets_t.get_config("joint_pose_nerf_training/dtu",
                                                                   "sparf"))
    b = config_j.parse_dotted_args(args, base=presets_j.get_config("joint_pose_nerf_training/dtu",
                                                                   "sparf"))
    assert config_t.to_plain(a) == config_j.to_plain(b)
    assert config_t.to_plain(config_t.parse_dotted_args(args)) == config_j.to_plain(
        config_j.parse_dotted_args(args))
    with pytest.raises(ValueError):
        config_t.parse_dotted_args(["max_iter=3"])


def test_load_options_equal(tmp_path):
    cfg = presets_j.get_config("joint_pose_nerf_training/llff", "sparf")
    parent = config_j.save_options_file(cfg, str(tmp_path), "parent.yaml")
    child = tmp_path / "child.yaml"
    child.write_text(yaml.safe_dump({"_parent_": parent, "max_iter": 7,
                                     "nerf": {"rand_rays": 99}}))
    a, b = config_t.load_options(str(child)), config_j.load_options(str(child))
    assert config_t.to_plain(a) == config_j.to_plain(b)
    assert a.max_iter == 7 and a.nerf.rand_rays == 99
    # a config saved by the port loads in the JAX package as the same tree
    saved = config_t.save_options_file(a, str(tmp_path / "port"))
    assert config_j.to_plain(config_j.load_options(saved)) == config_t.to_plain(a)


def test_env_settings_equal(monkeypatch):
    monkeypatch.setenv("SPARF_DTU", "/data/dtu")
    monkeypatch.setenv("SPARF_WORKSPACE_DIR", "ws")
    a, b = admin_t.env_settings(), admin_j.env_settings()
    assert dict(a) == dict(b) and a.dtu == "/data/dtu"


def test_create_default_local_file_equal(tmp_path):
    pa = admin_t.create_default_local_file(str(tmp_path / "a.py"), dtu="/d")
    pb = admin_j.create_default_local_file(str(tmp_path / "b.py"), dtu="/d")
    assert open(pa).read() == open(pb).read()


# ---------------------------------------------------------------------------
# alignment
# ---------------------------------------------------------------------------


def _random_w2c(rng, n):
    from scipy.spatial.transform import Rotation

    R = Rotation.from_rotvec(rng.randn(n, 3) * 0.4).as_matrix()
    t = rng.randn(n, 3, 1) * 2.0
    return np.concatenate([R, t], -1).astype(np.float32)


@pytest.mark.parametrize("n", [3, 6, 14])
def test_alignment_equal(n):
    rng = np.random.RandomState(n)
    gt = _random_w2c(rng, n)
    est = _random_w2c(rng, n)
    for fn in ("pad_poses", "invert_poses"):
        np.testing.assert_array_equal(getattr(alignment_t, fn)(est), getattr(alignment_j, fn)(est))
    np.testing.assert_array_equal(alignment_t.rotation_distance_np(est[:, :, :3], gt[:, :, :3]),
                                  alignment_j.rotation_distance_np(est[:, :, :3], gt[:, :, :3]))
    assert alignment_t.evaluate_any_poses(est, gt) == alignment_j.evaluate_any_poses(est, gt)
    for fn in ("prealign_w2c_large_camera_systems", "prealign_w2c_small_camera_systems"):
        (pa, sa), (pb, sb) = getattr(alignment_t, fn)(est, gt), getattr(alignment_j, fn)(est, gt)
        np.testing.assert_array_equal(pa, pb)
        assert sa.as_dict() == sb.as_dict()
        np.testing.assert_array_equal(alignment_t.backtrack_gt_through_sim3(gt, sa),
                                      alignment_j.backtrack_gt_through_sim3(gt, sb))
    (ta, sa), (tb, sb) = alignment_t.align_translations(gt, est), alignment_j.align_translations(gt, est)
    np.testing.assert_array_equal(ta, tb)
    assert sa == sb
    assert alignment_t.identity_sim3().as_dict() == alignment_j.identity_sim3().as_dict()


# ---------------------------------------------------------------------------
# logging utilities
# ---------------------------------------------------------------------------


def test_summary_board_equal():
    values = np.random.RandomState(0).randn(20)
    boards = [logging_t.SummaryBoard(last_n=5), logging_j.SummaryBoard(last_n=5)]
    for board in boards:
        for i, v in enumerate(values):
            board.update_from_dict({"loss": float(v), "psnr": float(v) * 2 + i})
    assert boards[0].summary() == boards[1].summary()
    meters = [logging_t.AverageMeter(), logging_j.AverageMeter()]
    for m in meters:
        for v in values:
            m.update(float(v))
    assert (meters[0].mean(), meters[0].max(), meters[0].last()) == (
        meters[1].mean(), meters[1].max(), meters[1].last())


# ---------------------------------------------------------------------------
# datasets: the fixtures of tests/test_datasets.py, rebuilt here
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def llff_fixture(tmp_path_factory):
    """An LLFF scene dir: images_8/*.png + poses_bounds.npy."""
    import imageio.v2 as imageio
    from scipy.spatial.transform import Rotation as R_scipy

    root = tmp_path_factory.mktemp("llff")
    img_dir = root / "fern" / "images_8"
    img_dir.mkdir(parents=True)
    rng = np.random.RandomState(0)
    rows = []
    for i in range(10):
        R = R_scipy.from_rotvec(rng.randn(3) * 0.1).as_matrix()
        t = rng.randn(3) * 0.2 + np.array([0, 0, 4.0])
        hwf = np.array([3024.0, 4032.0, 3260.0])[:, None]
        row = np.concatenate([np.concatenate([R, t[:, None]], 1), hwf], axis=1).reshape(-1)
        rows.append(np.concatenate([row, [2.0 + 0.1 * i, 8.0 - 0.1 * i]]))
        imageio.imwrite(str(img_dir / f"img{i:03d}.png"),
                        (rng.rand(378, 504, 3) * 255).astype(np.uint8))
    np.save(str(root / "fern" / "poses_bounds.npy"), np.stack(rows))
    return str(root)


@pytest.fixture(scope="module")
def dtu_fixture(tmp_path_factory):
    """A DTU scan dir: image/*.png + cameras.npz."""
    import imageio.v2 as imageio
    from scipy.spatial.transform import Rotation as R_scipy

    root = tmp_path_factory.mktemp("dtu")
    img_dir = root / "scan82" / "image"
    img_dir.mkdir(parents=True)
    rng = np.random.RandomState(1)
    cams = {}
    K = np.array([[360.0, 0, 200.0], [0, 360.0, 150.0], [0, 0, 1]])
    for i in range(49):
        R = R_scipy.from_rotvec(rng.randn(3) * 0.2).as_matrix()
        t = rng.randn(3) * 50 + np.array([0, 0, 600.0])
        cams[f"world_mat_{i}"] = np.concatenate([K @ np.concatenate([R, t[:, None]], 1),
                                                 [[0, 0, 0, 1]]], 0)
        cams[f"scale_mat_{i}"] = np.diag([300.0, 300.0, 300.0, 1.0])
        imageio.imwrite(str(img_dir / f"{i:06d}.png"),
                        (rng.rand(300, 400, 3) * 255).astype(np.uint8))
    np.savez(str(root / "scan82" / "cameras.npz"), **cams)
    return str(root)


@pytest.mark.parametrize("split", ["train", "test"])
@pytest.mark.parametrize("over", [dict(), dict(resize=[60, 80], increase_depth_range_by_x_percent=0.1)])
def test_llff_loader_equal(llff_fixture, split, over):
    kw = dict(dataset="llff", scene="fern", train_sub=3, llff_img_factor=8, **over)
    a = datasets_t.create_dataset(config_t.ConfigDict(kw, env=config_t.ConfigDict(llff=llff_fixture)),
                                  split)
    b = create_dataset_j(config_j.ConfigDict(kw, env=config_j.ConfigDict(llff=llff_fixture)), split)
    _assert_scene_equal(a, b)


@pytest.mark.parametrize("split", ["train", "test"])
def test_dtu_loader_equal(dtu_fixture, split):
    kw = dict(dataset="dtu", scene="scan82", train_sub=3)
    a = datasets_t.create_dataset(config_t.ConfigDict(kw, env=config_t.ConfigDict(dtu=dtu_fixture)),
                                  split)
    b = create_dataset_j(config_j.ConfigDict(kw, env=config_j.ConfigDict(dtu=dtu_fixture)), split)
    _assert_scene_equal(a, b)


@pytest.fixture(scope="module")
def dtu_mask_fixture(dtu_fixture, tmp_path_factory):
    """IDR-layout-free foreground masks (a disc per view) for the DTU fixture."""
    import imageio.v2 as imageio

    root = tmp_path_factory.mktemp("dtu_masks")
    (root / "scan82").mkdir()
    yy, xx = np.mgrid[0:300, 0:400]
    for i in range(49):
        disc = (xx - 200 - i) ** 2 + (yy - 150) ** 2 < (80 + i) ** 2
        imageio.imwrite(str(root / "scan82" / f"{i:03d}.png"), (disc * 255).astype(np.uint8))
    return str(root)


@pytest.mark.parametrize("over", [dict(resize=[150, 200]),
                                  dict(resize=[100, 130], crop_ratio=0.8),
                                  dict(resize=[76, 100], mask_img=True)])
def test_dtu_loader_equal_resized(dtu_fixture, dtu_mask_fixture, over):
    """Integer and non-integer area resizing, a centre crop, and fg masks
    resized by nearest neighbour (and painted into the image)."""
    kw = dict(dataset="dtu", scene="scan82", train_sub=3, **over)
    env = dict(dtu=dtu_fixture, dtu_mask=dtu_mask_fixture)
    a = datasets_t.create_dataset(config_t.ConfigDict(kw, env=config_t.ConfigDict(env)), "train")
    b = create_dataset_j(config_j.ConfigDict(kw, env=config_j.ConfigDict(env)), "train")
    _assert_scene_equal(a, b)
    assert "fg_mask" in a and a["image"].shape[-2:] == tuple(over["resize"])


def test_fg_mask_sampler_pools_equal(dtu_fixture, dtu_mask_fixture):
    """The ray sampler's foreground pools: masks dilated 10 times by a 3x3 box."""
    from sparf_tpu.training.sampling import make_ray_sampler as sampler_j
    from sparf_tpu_torch.training.sampling import make_ray_sampler as sampler_t

    kw = dict(dataset="dtu", scene="scan82", train_sub=3, resize=[76, 100])
    env = dict(dtu=dtu_fixture, dtu_mask=dtu_mask_fixture)
    scene = create_dataset_j(config_j.ConfigDict(kw, env=config_j.ConfigDict(env)), "train")
    cfg = dict(sample_fraction_in_fg_mask=0.5, loss_weight={})
    a = sampler_t(config_t.ConfigDict(cfg), scene, "cpu")
    b = sampler_j(config_j.ConfigDict(cfg), scene)
    np.testing.assert_array_equal(a.mask_counts.numpy(), np.asarray(b.mask_counts))
    np.testing.assert_array_equal(a.mask_pixels.numpy(), np.asarray(b.mask_pixels))
    assert a.min_nbr_in_mask == b.min_nbr_in_mask > 0


def test_replica_names_its_queue_item():
    """replica's queue item is done: the registry loads it with the port's own
    loader (tests/test_torch_replica.py), which fails on a root without
    frames as the JAX loader does."""
    cfg = config_t.ConfigDict(dataset="replica", scene="room0", env=config_t.ConfigDict(replica=""))
    with pytest.raises(AssertionError, match="no frames under room0/results"):
        datasets_t.create_dataset(cfg, "train")
    cfg_j = config_j.ConfigDict(dataset="replica", scene="room0",
                                env=config_j.ConfigDict(replica=""))
    with pytest.raises(AssertionError, match="no frames under room0/results"):
        create_dataset_j(cfg_j, "train")


@pytest.mark.parametrize("octaves,specular", [(1, 0.0), (3, 0.4)])
def test_synthetic_helpers_equal(octaves, specular):
    rng = np.random.RandomState(octaves)
    eye = np.array([math.sin(0.3) * 3.0, 0.4, -math.cos(0.3) * 3.0])
    np.testing.assert_array_equal(synthetic_t.look_at_pose_w2c(eye), synthetic_j.look_at_pose_w2c(eye))
    centers = np.tile(eye.astype(np.float32), (64, 1))
    dirs = (-eye[None] + rng.randn(64, 3) * 0.3).astype(np.float32)
    for a, b in zip(synthetic_t.ray_trace(centers, dirs, octaves, specular),
                    synthetic_j.ray_trace(centers, dirs, octaves, specular)):
        np.testing.assert_array_equal(a, b)
    img = rng.rand(8, 10, 3).astype(np.float32)
    kw = dict(exposure_jitter=0.3, wb_jitter=0.1, noise_sigma=0.02, vignette=0.5)
    np.testing.assert_array_equal(
        synthetic_t.apply_photometric_perturbation(img, np.random.RandomState(5), **kw),
        synthetic_j.apply_photometric_perturbation(img, np.random.RandomState(5), **kw))
    for name in ("CAM_RADIUS", "NEAR", "FAR"):
        assert getattr(synthetic_t, name) == getattr(synthetic_j, name)
    np.testing.assert_array_equal(synthetic_t.SPHERES, synthetic_j.SPHERES)


def test_rendering_paths_equal():
    sc = synthetic_j.load_synthetic_scene(split="train", H=24, W=32, n_train=4, n_test=1)
    c2w = alignment_j.invert_poses(sc["pose"])
    np.testing.assert_array_equal(paths_t.generate_spiral_path(c2w, sc["depth_range"], 20),
                                  paths_j.generate_spiral_path(c2w, sc["depth_range"], 20))
    np.testing.assert_array_equal(paths_t.generate_spiral_path_dtu(c2w, 15, perc=50),
                                  paths_j.generate_spiral_path_dtu(c2w, 15, perc=50))
    np.testing.assert_array_equal(paths_t.focus_pt_fn(c2w), paths_j.focus_pt_fn(c2w))
    # the oscillation path (camera.get_novel_view_poses), torch against jax
    import torch

    osc_t = camera_t.get_novel_view_poses(torch.as_tensor(sc["pose"][2]), N=30, scale=1.3)
    osc_j = camera_j.get_novel_view_poses(sc["pose"][2], N=30, scale=1.3)
    np.testing.assert_allclose(osc_t.numpy(), np.asarray(osc_j), atol=2e-6)


def test_port_modules_are_copies_not_imports():
    """The copies are their own modules: nothing of the JAX package is
    reachable from them."""
    for mod in (config_t, presets_t, admin_t, alignment_t, logging_t, synthetic_t, datasets_t,
                paths_t):
        assert mod.__name__.startswith("sparf_tpu_torch."), mod
        for value in vars(mod).values():
            owner = getattr(value, "__module__", None) or ""
            assert not (owner == "sparf_tpu" or owner.startswith("sparf_tpu.")), (mod, value)

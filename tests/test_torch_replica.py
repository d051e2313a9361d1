"""The port's replica loader (datasets/replica.py) against the JAX package's
on a scene this test writes (no Replica data is in the repo): 100 JPEG
frames encoded by PIL, 16-bit depth PNGs and a traj.txt of c2w poses, in
the NICE-SLAM layout (`results/frame*.jpg`, `results/depth*.png`). The JAX
loader decodes with OpenCV; the port with utils/imgproc.py.

With depth at the frames' size (as in Replica) the scenes are equal bit for
bit, except the poses: their recentring subtracts the centre of the
far-plane bound, which each package computes from float32 rays through its
own camera (XLA's and torch's sums), so they are held to atol 1e-6. With
depth at half the size the colour frames are resized to it: OpenCV's
INTER_LINEAR on uint8 in 11-bit fixed point against the port's float resize
rounded to uint8, so the images are held within one level (1/255)."""
import cv2
import numpy as np
import pytest
from PIL import Image
from scipy.spatial.transform import Rotation

import torch_parity  # noqa: F401  (thread cap)
from sparf_tpu.configs import config as config_j
from sparf_tpu.datasets import create_dataset as create_dataset_j
from sparf_tpu_torch import datasets as datasets_t
from sparf_tpu_torch.configs import config as config_t

H, W = 34, 60
N_FRAMES = 100


def _write_scene(root, depth_scale: int):
    res = root / "office0" / "results"
    res.mkdir(parents=True)
    rng = np.random.RandomState(0)
    yy, xx = np.mgrid[0:H, 0:W]
    lines = []
    for i in range(N_FRAMES):
        img = np.stack([np.sin(xx / (4.0 + c) + i * 0.1) * 90 + np.cos(yy / 3.0) * 50 + 128
                        for c in range(3)], -1) + rng.randn(H, W, 3) * 15
        Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
            res / f"frame{i:06d}.jpg", quality=95)
        depth = (rng.rand(H // depth_scale, W // depth_scale) * 4.0 + 0.5) * 6553.5
        cv2.imwrite(str(res / f"depth{i:06d}.png"), depth.astype(np.uint16))
        c2w = np.eye(4)
        c2w[:3, :3] = Rotation.from_rotvec(rng.randn(3) * 0.3).as_matrix()
        c2w[:3, 3] = rng.randn(3) * 0.5 + np.array([0.0, 0.0, 0.02 * i])
        lines.append(" ".join(f"{v:.8f}" for v in c2w.reshape(-1)))
    (root / "office0" / "traj.txt").write_text("\n".join(lines) + "\n")
    return str(root)


@pytest.fixture(scope="module")
def replica_root(tmp_path_factory):
    return _write_scene(tmp_path_factory.mktemp("replica"), depth_scale=1)


def _assert_equal(a, b, skip=()):
    for k in a:
        if k in skip:
            continue
        if k == "pose":
            np.testing.assert_allclose(a[k], b[k], atol=1e-6, rtol=0, err_msg=k)
        elif isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


def _both(root, split, **over):
    kw = dict(dataset="replica", scene="office0", **over)
    a = datasets_t.create_dataset(config_t.ConfigDict(kw, env=config_t.ConfigDict(replica=root)),
                                  split)
    b = create_dataset_j(config_j.ConfigDict(kw, env=config_j.ConfigDict(replica=root)), split)
    assert sorted(a) == sorted(b)
    return a, b


@pytest.mark.parametrize("split,over", [("train", {}), ("test", dict(val_sub=3)),
                                        ("train", dict(resize=[17, 30],
                                                       increase_depth_range_by_x_percent=0.2))])
def test_replica_loader_equals_jax(replica_root, split, over):
    a, b = _both(replica_root, split, **over)
    # office0 without train_sub: every 80th frame trains, every 10th of the rest tests
    assert a["image"].shape[0] == (2 if split == "train" else 3)
    _assert_equal(a, b)


def test_replica_loader_resizes_frames_to_the_depth(tmp_path):
    root = _write_scene(tmp_path, depth_scale=2)
    a, b = _both(root, "train")
    assert a["image"].shape[-2:] == (H // 2, W // 2)
    np.testing.assert_allclose(a["image"], b["image"], atol=1.0 / 255 + 1e-7, rtol=0)
    print(f"{int((a['image'] != b['image']).sum())} of {a['image'].size} samples one level off")
    _assert_equal(a, b, skip=("image",))


def test_fixed_pose_replica_preset_builds(replica_root, tmp_path):
    """nerf_fixed_noisy_poses/replica/sparf on the written scene, at a tiny
    width, with GT-depth correspondences and noisy-GT initial poses (the
    scene's random depth gives no SfM): it builds and takes one step."""
    from sparf_tpu_torch.training.define_trainer import build_config, define_trainer

    over = dict(env=dict(replica=replica_root), scene="office0", resize=None, max_iter=100,
                use_gt_correspondences=True, min_nbr_matches=10,
                camera=dict(initial_pose="noisy_gt", noise=0.1),
                arch=dict(layers_feat=[None, 32, 32, 32], layers_rgb=[None, 16, 3], skip=[1]),
                nerf=dict(sample_intvs=16, sample_intvs_fine=8, rand_rays=32),
                depth_cons_nbr_rays=16)
    trainer = define_trainer(build_config("nerf_fixed_noisy_poses/replica", "sparf", over),
                             workspace=str(tmp_path), device="cpu", save_option=False)
    assert type(trainer).__name__ == "NerfTrainerPerSceneWColmapFixedPoses"
    assert trainer.train_scene["image"].shape == (2, 3, H, W)
    state, stats = trainer.get_step(0)(trainer.state, trainer.draws)
    assert np.isfinite(float(stats["all"])) and int(state.nan_count) == 0

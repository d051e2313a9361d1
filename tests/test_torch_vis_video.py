"""The port's visualization and video modules (utils/{vis,video,
rendering_paths}.py, utils/imgproc.write_apng / read_apng), twins of
tests/test_sfm_and_vis.py's vis tests. Each runs the port with matplotlib,
OpenCV, imageio and PIL blocked (none is on the card's machine); matplotlib
and PIL, where the tests run, are the references: `colorize` against
matplotlib's jet and gray within 1/255, the videos decoded by PIL against
the frames given."""
import contextlib
import os
import sys

import matplotlib
import numpy as np
import pytest
import torch
from PIL import Image

import torch_parity  # noqa: F401  (thread cap)
from sparf_tpu_torch.datasets.synthetic import load_synthetic_scene
from sparf_tpu_torch.utils import alignment, camera, imgproc, rendering_paths, vis

BLOCKED = ("matplotlib", "cv2", "imageio", "PIL")


@contextlib.contextmanager
def blocked():
    """matplotlib, cv2, imageio and PIL (and their submodules) unimportable."""
    saved = {k: v for k, v in sys.modules.items() if k.split(".")[0] in BLOCKED}
    for name in saved:
        sys.modules[name] = None
    for name in BLOCKED:
        sys.modules[name] = None
    try:
        yield
    finally:
        for name in BLOCKED:
            sys.modules.pop(name, None)
        for name in list(sys.modules):
            if name.split(".")[0] in BLOCKED and sys.modules[name] is None:
                del sys.modules[name]
        sys.modules.update(saved)


@pytest.fixture(scope="module")
def scene():
    return load_synthetic_scene(split="train", H=64, W=80, n_train=4, n_test=1)


def test_spiral_paths(scene):
    with blocked():
        c2w = alignment.invert_poses(scene["pose"])
        path = rendering_paths.generate_spiral_path(c2w, scene["depth_range"], n_frames=20)
        path_dtu = rendering_paths.generate_spiral_path_dtu(c2w, n_frames=15)
        osc = camera.get_novel_view_poses(torch.as_tensor(scene["pose"][1]), N=12).numpy()
    assert path.shape == (20, 3, 4) and path_dtu.shape == (15, 3, 4) and osc.shape == (12, 3, 4)
    for p in (path, path_dtu, osc):
        R = p[:, :, :3]
        RtR = np.swapaxes(R, -1, -2) @ R
        np.testing.assert_allclose(RtR, np.broadcast_to(np.eye(3), RtR.shape), atol=1e-4)
    # the oscillation stays within asin(0.1) of the anchor's orientation
    rel = osc[:, :, :3] @ scene["pose"][1][:, :3].T
    angles = np.degrees(np.arccos(np.clip((np.trace(rel, axis1=1, axis2=2) - 1) / 2, -1, 1)))
    assert 0 < angles.max() <= np.degrees(np.arcsin(0.1)) * np.sqrt(2) + 1e-3


@pytest.mark.parametrize("cmap", ["jet", "gray"])
def test_vis_colorize_and_panels(scene, cmap):
    depth = scene["depth_gt"][0]
    ramp = np.linspace(-0.1, 1.1, 4001, dtype=np.float32).reshape(1, -1)
    with blocked():
        img = vis.colorize(depth, invalid_mask=depth <= 0, cmap=cmap)
        ours = vis.colorize(ramp, 0.0, 1.0, cmap=cmap)
        gt = scene["image"][0].transpose(1, 2, 0)
        panel = vis.render_panel(gt, gt * 0.9, depth, opacity=(depth > 0).astype(np.float32),
                                 gt_depth=depth)
    assert img.shape == (*depth.shape, 3) and img.min() >= 0 and img.max() <= 1
    assert (img[depth <= 0] == 0).all()
    ref = matplotlib.colormaps[cmap](np.clip(ramp, 0, 1))[..., :3]
    assert np.abs(ours - ref).max() <= 1 / 255
    norm = (depth - depth[depth > 0].min()) / (depth[depth > 0].max() - depth[depth > 0].min())
    ref_d = matplotlib.colormaps[cmap](np.clip(norm, 0, 1))[..., :3]
    assert np.abs(img - ref_d)[depth > 0].max() <= 1 / 255
    # GT, render, error, GT depth, depth, opacity
    assert panel.shape == (64, 6 * 80, 3)
    np.testing.assert_array_equal(panel[:, :80], np.clip(gt, 0, 1))


def test_frusta_plot(scene):
    poses = np.asarray(scene["pose"])
    with blocked():
        img = vis.plot_camera_frusta([("gt", poses, "tab:blue")])
        axlim = vis.frusta_axlim([("gt", poses, "tab:blue")])
        centers = alignment.invert_poses(poses)[:, :3, 3]
        xy = np.rint(vis.frusta_canvas_xy(centers, axlim, img.shape[0])).astype(int)
    assert img.shape == (600, 600, 3)
    blue = np.array(vis.COLORS["tab:blue"], np.float32)
    for x, y in xy:  # a frustum at every projected camera centre
        assert 0 <= x < 600 and 0 <= y < 600
        np.testing.assert_array_equal(img[y - 2: y + 3, x - 2: x + 3],
                                      np.broadcast_to(blue, (5, 5, 3)))
    assert len({(x, y) for x, y in xy}) == len(poses)
    drawn = (img != 1).any(-1)
    assert 0.001 < drawn.mean() < 0.2 and (img[drawn] == blue).all()


def test_plot_matches_draws_lines():
    rng = np.random.RandomState(0)
    img1, img2 = rng.rand(40, 50, 3).astype(np.float32), rng.rand(40, 60, 3).astype(np.float32)
    kp1 = np.array([[3.0, 5.0], [40.0, 30.0]])
    kp2 = np.array([[10.0, 35.0], [2.0, 1.0]])
    with blocked():
        out = vis.plot_matches(img1, img2, kp1, kp2)
    assert out.shape == (40, 110, 3)
    for i in range(2):  # both ends and the middle of each line carry its color
        c = np.array(vis.match_color(i), np.float32)
        a, b = kp1[i].astype(int), kp2[i].astype(int) + [50, 0]
        for x, y in (a, b, np.rint((a + b) / 2).astype(int)):
            np.testing.assert_allclose(out[y, x], c, atol=1e-6)


def test_write_video(tmp_path):
    from sparf_tpu_torch.utils.video import write_video

    frames = [np.random.RandomState(i).rand(32, 40, 3).astype(np.float32) for i in range(5)]
    with blocked():
        path = write_video(frames, str(tmp_path / "test.mp4"), fps=5)
        back = imgproc.read_apng(path)
    assert path == str(tmp_path / "test.png") and os.path.getsize(path) > 0
    want = [(np.clip(f, 0, 1) * 255).astype(np.uint8) for f in frames]
    with Image.open(path) as im:
        assert im.n_frames == 5 and im.info.get("loop") == 0
        for i, w in enumerate(want):
            im.seek(i)
            np.testing.assert_array_equal(np.asarray(im.convert("RGB")), w)
            np.testing.assert_array_equal(back[i], w)
    # a still PNG from write_png reads back the same way
    still = imgproc.write_png(tmp_path / "still.png", frames[0])
    np.testing.assert_array_equal(imgproc.read_png(still), want[0])
    np.testing.assert_array_equal(imgproc.read_apng(still)[0], want[0])


def test_logged_images_decode(scene, tmp_path):
    """TensorboardWriter.write_image (visualize_train_view's panels) encodes
    the PNG itself: the image summary in the event file decodes to the panel."""
    import struct

    from tensorboardX.proto.event_pb2 import Event

    from sparf_tpu_torch.training.logging_utils import TensorboardWriter

    gt = scene["image"][0].transpose(1, 2, 0)
    with blocked():
        panel = vis.render_panel(gt, gt * 0.5, scene["depth_gt"][0])
        writer = TensorboardWriter(str(tmp_path / "tb"))
        writer.write_image("train", {"render_view0": panel}, 7)
        writer.close()
    (name,) = os.listdir(tmp_path / "tb")
    data, pos, images = (tmp_path / "tb" / name).read_bytes(), 0, []
    while pos < len(data):  # TFRecords: length, its crc, the event, its crc
        (n,) = struct.unpack("<Q", data[pos: pos + 8])
        event = Event.FromString(data[pos + 12: pos + 12 + n])
        pos += 16 + n
        images += [(v.tag, event.step, v.image) for v in event.summary.value]
    ((tag, step, image),) = images
    # GT, render, error, depth
    assert (tag, step, image.height, image.width) == ("train/render_view0", 7, 64, 4 * 80)
    png = tmp_path / "panel.png"
    png.write_bytes(image.encoded_image_string)
    np.testing.assert_array_equal(imgproc.read_png(png),
                                  (np.clip(panel, 0, 1) * 255).astype(np.uint8))


def test_pose_history_video_animates_trajectory(scene, tmp_path):
    """record_pose_history + generate_videos_pose: poses stored at val steps
    become an animated frusta trajectory whose frames move."""
    from types import SimpleNamespace

    from sparf_tpu_torch.training.trainer import NerfTrainerPerScene
    from sparf_tpu_torch.utils.video import generate_videos_pose

    gt = np.asarray(scene["pose"])

    def noisy(it):
        out = gt.copy()
        out[:, :, 3] += 0.3 * (1 - min(it, 100) / 100.0)
        return torch.as_tensor(out)

    trainer = SimpleNamespace(pose_cfg=object(), workspace=str(tmp_path), iteration=100,
                              train_scene_np={"pose": gt},
                              current_poses_w2c=lambda: noisy(trainer.iteration))
    with blocked():
        for it in (0, 50, 100):
            trainer.iteration = it
            NerfTrainerPerScene.record_pose_history(trainer, it)
        NerfTrainerPerScene.record_pose_history(trainer, 100)  # same iteration: no-op
        z = np.load(os.path.join(str(tmp_path), "pose_history.npz"))
        assert list(z["iters"]) == [0, 50, 100] and z["poses"].shape == (3, *gt.shape)
        path = generate_videos_pose(trainer, out_dir=str(tmp_path))
        frames = imgproc.read_apng(path)
    # 3 history entries + the current poses, then ~1 s (10 frames) of the last
    assert len(frames) == 4 + 10
    assert not np.array_equal(frames[0], frames[2]) and np.array_equal(frames[2], frames[3])
    assert all(np.array_equal(f, frames[3]) for f in frames[4:])

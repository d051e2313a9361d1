"""Novel-view video synthesis (the port's counterpart of sparf_tpu/utils/video.py;
reference nerf_trainer.py:487-571 + joint :664-705), without OpenCV, imageio
or matplotlib.

Videos are animated PNGs (lossless; `utils/imgproc.write_apng`, read back by
`read_apng`), where the JAX package writes mp4 through OpenCV or a GIF
through imageio. The renders go through renderer.render_image_chunked, so
through K3 on the card.
"""
from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch

from sparf_tpu_torch.models import renderer as renderer_mod
from sparf_tpu_torch.utils import alignment, camera, imgproc, rendering_paths, vis


def write_video(frames: List[np.ndarray], path: str, fps: int = 30) -> str:
    """frames: list of (H,W,3) float [0,1]. Writes an animated PNG at `path`
    with its extension replaced by .png; returns the path written."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    return imgproc.write_apng(os.path.splitext(path)[0] + ".png", frames, fps)


def novel_view_poses_w2c(trainer, n_frames: int = 60) -> np.ndarray:
    """Pick the path family by dataset (LLFF spiral / DTU spiral / oscillation)."""
    dataset = trainer.cfg.get("dataset") or ""
    poses_w2c = trainer.current_poses_w2c().detach().cpu().numpy()
    poses_c2w = alignment.invert_poses(poses_w2c)
    if "llff" in dataset:
        bounds = np.asarray(trainer.train_scene_np["depth_range"])
        c2w_path = rendering_paths.generate_spiral_path(poses_c2w, bounds, n_frames=n_frames)
        return alignment.invert_poses(c2w_path)
    if "dtu" in dataset:
        c2w_path = rendering_paths.generate_spiral_path_dtu(poses_c2w, n_frames=n_frames)
        return alignment.invert_poses(c2w_path)
    # oscillation around the central camera (replica/synthetic)
    anchor = torch.as_tensor(poses_w2c[len(poses_w2c) // 2], dtype=torch.float32)
    return camera.get_novel_view_poses(anchor, N=n_frames).numpy()


def generate_videos_synthesis(trainer, out_dir: Optional[str] = None,
                              n_frames: int = 60, fps: int = 15) -> List[str]:
    """Render rgb+depth along the novel-view path; write videos. Under ray
    sharding every rank renders its share of each frame and rank 0 writes."""
    out_dir = out_dir or os.path.join(trainer.workspace, "videos")
    H, W = trainer.train_scene_np["image"].shape[-2:]
    poses = torch.as_tensor(novel_view_poses_w2c(trainer, n_frames), dtype=torch.float32,
                            device=trainer.device)
    intr = trainer.train_scene["intr"][:1]
    depth_range = renderer_mod.render_depth_range(trainer.cfg, trainer.train_scene)
    fine_enabled = trainer.fine_enabled_at(trainer.iteration)

    rgb_frames, depth_frames = [], []
    with torch.no_grad():
        for i in range(len(poses)):
            out = renderer_mod.render_image_chunked(
                trainer.state.nerf_params, trainer.render_cfg, poses[i: i + 1], intr, H, W,
                depth_range, 1.0, fine_enabled=fine_enabled, chunk=trainer.cfg.nerf.rand_rays,
                mesh=trainer.mesh)
            key = "rgb_fine" if "rgb_fine" in out else "rgb"
            dkey = "depth_fine" if "depth_fine" in out else "depth"
            rgb_frames.append(out[key].reshape(H, W, 3).cpu().numpy())
            depth_frames.append(vis.colorize(out[dkey].reshape(H, W).cpu().numpy()))

    if not trainer.is_main:
        return []
    os.makedirs(out_dir, exist_ok=True)
    paths = [
        write_video(rgb_frames, os.path.join(out_dir, "rgb_novel_view.mp4"), fps),
        write_video(depth_frames, os.path.join(out_dir, "depth_novel_view.mp4"), fps),
    ]
    trainer.logger.info(f"wrote videos: {paths}")
    return paths


def generate_videos_pose(trainer, out_dir: Optional[str] = None, n_frames: int = 60,
                         fps: int = 10) -> Optional[str]:
    """Frusta-plot video of optimized-vs-GT poses over the optimization
    trajectory (joint_pose_nerf_trainer.py:664-705 analog).

    The trainer records poses at every val step into
    workspace/pose_history.npz (trainer.record_pose_history); the animation
    walks that history with axes pinned to the union bounding box so the
    camera cloud visibly converges onto GT. Falls back to a still of the
    final poses when no history exists (e.g. video-only on a foreign run)."""
    if not hasattr(trainer, "pose_cfg"):
        return None
    out_dir = out_dir or os.path.join(trainer.workspace, "videos")
    os.makedirs(out_dir, exist_ok=True)
    pose_gt = np.asarray(trainer.train_scene_np["pose"])

    entries = []
    hist_path = os.path.join(trainer.workspace, "pose_history.npz")
    if os.path.exists(hist_path):
        with np.load(hist_path) as z:
            entries = [(int(i), np.asarray(p)) for i, p in zip(z["iters"], z["poses"])]
    current = trainer.current_poses_w2c()
    current = current.detach().cpu().numpy() if torch.is_tensor(current) else np.asarray(current)
    entries.append((int(trainer.iteration), current))
    if len(entries) > n_frames:  # subsample evenly, always keeping first + last
        sel = np.unique(np.round(np.linspace(0, len(entries) - 1, n_frames)).astype(int))
        entries = [entries[i] for i in sel]

    # fixed axes across frames: union bbox of GT + every history entry
    axlim = vis.frusta_axlim([("GT", pose_gt, "")] + [("", p, "") for _, p in entries])
    frames = [
        vis.plot_camera_frusta(
            [("optimized", p, "tab:red"), ("GT", pose_gt, "tab:blue")],
            title=f"iter {it}", axlim=axlim,
        )
        for it, p in entries
    ]
    frames += [frames[-1]] * max(fps, 1)  # hold the converged state ~1s
    return write_video(frames, os.path.join(out_dir, "poses.mp4"), fps)

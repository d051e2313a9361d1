"""Visualization without matplotlib or OpenCV (the port's counterpart of
sparf_tpu/utils/vis.py): depth/error colorization, image panels, pose-frusta
and match plots, all host-side numpy producing (H, W, 3) float [0, 1] images.

  - `colorize` maps through the 256-entry lookup tables of matplotlib's `jet`
    and `gray` (the only colormaps the JAX package uses), built from their
    segment data as matplotlib builds them (colors._create_lookup_table) and
    indexed as matplotlib indexes them (int(x * 256), 1.0 to the last entry);
    tests/test_torch_vis_video.py holds them to matplotlib.
  - `error_map`, `make_image_grid` and `render_panel` are the JAX package's.
  - `plot_camera_frusta` and `plot_matches` draw with a small line
    rasteriser (`draw_line`): their images are not matplotlib's 3D plot or
    OpenCV's lines, but show the same things: each camera's frustum at its
    projected centre (a fixed oblique view, `frusta_canvas_xy`), and a line
    between each pair of matched points.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from sparf_tpu_torch.utils import alignment

LUT_N = 256
# matplotlib's segment data (x, y0, y1) per channel (matplotlib/_cm.py)
_SEGMENTS = {
    "jet": {"red": ((0.0, 0, 0), (0.35, 0, 0), (0.66, 1, 1), (0.89, 1, 1), (1.0, 0.5, 0.5)),
            "green": ((0.0, 0, 0), (0.125, 0, 0), (0.375, 1, 1), (0.64, 1, 1), (0.91, 0, 0),
                      (1.0, 0, 0)),
            "blue": ((0.0, 0.5, 0.5), (0.11, 1, 1), (0.34, 1, 1), (0.65, 0, 0), (1.0, 0, 0))},
    "gray": {c: ((0.0, 0, 0), (1.0, 1, 1)) for c in ("red", "green", "blue")},
}
# the named colors the trainers and videos pass (matplotlib's tab10 entries)
COLORS = {"tab:blue": (0.12156862745098039, 0.4666666666666667, 0.7058823529411765),
          "tab:red": (0.8392156862745098, 0.15294117647058825, 0.1568627450980392)}


def _lookup_table(segments, N: int = LUT_N) -> np.ndarray:
    """One channel's N-entry table from its (x, y0, y1) segments, as
    matplotlib.colors._create_lookup_table computes it (gamma 1)."""
    adata = np.array(segments, dtype=np.float64)
    x, y0, y1 = adata[:, 0] * (N - 1), adata[:, 1], adata[:, 2]
    xind = (N - 1) * np.linspace(0, 1, N)
    ind = np.searchsorted(x, xind)[1:-1]
    distance = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
    lut = np.concatenate([[y1[0]], distance * (y0[ind] - y1[ind - 1]) + y1[ind - 1], [y0[-1]]])
    return np.clip(lut, 0.0, 1.0)


LUTS: Dict[str, np.ndarray] = {
    name: np.stack([_lookup_table(seg[c]) for c in ("red", "green", "blue")], -1)
    for name, seg in _SEGMENTS.items()}


def colorize(value: np.ndarray, vmin: Optional[float] = None, vmax: Optional[float] = None,
             cmap: str = "jet", invalid_mask: Optional[np.ndarray] = None) -> np.ndarray:
    """(H,W) scalar map -> (H,W,3) float [0,1] colormapped ("jet" or "gray")."""
    if cmap not in LUTS:
        raise ValueError(f"colorize: colormap {cmap!r} not ported (have {sorted(LUTS)})")
    value = np.asarray(value, np.float32)
    if invalid_mask is None:
        invalid_mask = ~np.isfinite(value)
    valid = ~invalid_mask
    vmin = float(value[valid].min()) if vmin is None and valid.any() else (vmin or 0.0)
    vmax = float(value[valid].max()) if vmax is None and valid.any() else (vmax or 1.0)
    if vmax - vmin < 1e-10:
        vmax = vmin + 1e-10
    norm = np.clip((value - vmin) / (vmax - vmin), 0, 1) * LUT_N
    norm[norm == LUT_N] = LUT_N - 1
    bad = np.isnan(norm)
    idx = np.where(bad, 0, norm).astype(int)
    colored = LUTS[cmap][idx].astype(np.float32)
    colored[bad | invalid_mask] = 0.0
    return colored


def error_map(pred: np.ndarray, gt: np.ndarray, vmax: Optional[float] = None) -> np.ndarray:
    """Per-pixel L2 rgb error -> colormap."""
    err = np.linalg.norm(pred - gt, axis=-1)
    return colorize(err, vmin=0.0, vmax=vmax or max(float(err.max()), 1e-6), cmap="jet")


def make_image_grid(images: List[np.ndarray], ncol: Optional[int] = None) -> np.ndarray:
    """List of (H,W,3) float [0,1] -> one grid image (reference panel septych)."""
    ncol = ncol or len(images)
    H, W = images[0].shape[:2]
    imgs = [np.clip(np.asarray(im, np.float32), 0, 1) for im in images]
    rows = []
    for r in range(0, len(imgs), ncol):
        row = imgs[r: r + ncol]
        while len(row) < ncol:
            row.append(np.zeros((H, W, 3), np.float32))
        rows.append(np.concatenate(row, axis=1))
    return np.concatenate(rows, axis=0)


def render_panel(gt_rgb: np.ndarray, pred_rgb: np.ndarray, pred_depth: np.ndarray,
                 opacity: Optional[np.ndarray] = None, depth_var: Optional[np.ndarray] = None,
                 gt_depth: Optional[np.ndarray] = None, rgb_var: Optional[np.ndarray] = None,
                 fine_row: Optional[dict] = None) -> np.ndarray:
    """Full septych (reference base.py:600-726): GT / render / error /
    [GT depth] / depth / opacity / [rgb_var] / [depth_var], with an optional
    second row for the fine head. `fine_row`: dict with pred_rgb, pred_depth
    and optionally opacity, depth_var, rgb_var of the fine samples."""
    vmin, vmax = None, None
    if gt_depth is not None:
        m = gt_depth > 0
        if m.any():
            vmin, vmax = float(gt_depth[m].min()), float(gt_depth[m].max())

    def row(pred_rgb, pred_depth, opacity=None, depth_var=None, rgb_var=None):
        imgs = [gt_rgb, pred_rgb, error_map(pred_rgb, gt_rgb)]
        if gt_depth is not None:
            imgs.append(colorize(gt_depth, vmin, vmax, invalid_mask=~(gt_depth > 0)))
        imgs.append(colorize(pred_depth, vmin, vmax))
        if opacity is not None:
            imgs.append(colorize(opacity, 0.0, 1.0, cmap="gray"))
        if rgb_var is not None:
            imgs.append(colorize(rgb_var, 0.0))
        if depth_var is not None:
            imgs.append(colorize(depth_var, 0.0))
        return imgs

    imgs = row(pred_rgb, pred_depth, opacity, depth_var, rgb_var)
    ncol = len(imgs)
    if fine_row is not None:
        extra = row(**fine_row)
        extra += [np.zeros_like(imgs[0])] * (ncol - len(extra))
        imgs += extra
    return make_image_grid(imgs, ncol=ncol)


def draw_line(canvas: np.ndarray, p0, p1, color) -> None:
    """Colors the pixels of the segment p0 -> p1 ((x, y), float) in place:
    one sample per pixel step along the longer axis, rounded; pixels off the
    canvas are skipped."""
    (x0, y0), (x1, y1) = p0, p1
    n = int(np.ceil(max(abs(x1 - x0), abs(y1 - y0)))) + 1
    xs = np.rint(np.linspace(x0, x1, n)).astype(int)
    ys = np.rint(np.linspace(y0, y1, n)).astype(int)
    on = (xs >= 0) & (xs < canvas.shape[1]) & (ys >= 0) & (ys < canvas.shape[0])
    canvas[ys[on], xs[on]] = color


# the frusta plot's view: matplotlib's default 3D view angles (elev 30, azim -60)
_ELEV, _AZIM = np.radians(30.0), np.radians(-60.0)
_BOX = np.array([[x, y, z] for x in (-0.5, 0.5) for y in (-0.5, 0.5) for z in (-0.5, 0.5)])


def _view(u: np.ndarray) -> np.ndarray:
    """(N,3) points of the unit cube -> (N,2) screen (right, up), orthographic
    from elevation _ELEV and azimuth _AZIM, z up."""
    ca, sa, ce, se = np.cos(_AZIM), np.sin(_AZIM), np.cos(_ELEV), np.sin(_ELEV)
    return np.stack([-sa * u[:, 0] + ca * u[:, 1],
                     -se * ca * u[:, 0] - se * sa * u[:, 1] + ce * u[:, 2]], -1)


def frusta_canvas_xy(points: np.ndarray, axlim: np.ndarray, size: int) -> np.ndarray:
    """(N,3) world points -> (N,2) pixel (x, y) on a size x size canvas: the
    axis box `axlim` (3, 2) scaled to a unit cube and seen from a fixed
    oblique view (_view), the box's projection fitted to the canvas with a
    5% margin."""
    lo, hi = axlim[:, 0], axlim[:, 1]
    s = _view((np.asarray(points, np.float64) - lo) / np.maximum(hi - lo, 1e-9) - 0.5)
    half = 1.05 * float(np.abs(_view(_BOX)).max())
    return np.stack([(s[:, 0] / half + 1) * 0.5 * (size - 1),
                     (1 - s[:, 1] / half) * 0.5 * (size - 1)], -1)


def frusta_axlim(poses_w2c_list: List[Tuple[str, np.ndarray, str]]) -> np.ndarray:
    """(3, 2) axis box around every camera centre, padded by 15% of its extent."""
    centers = np.concatenate([alignment.invert_poses(np.asarray(p))[:, :3, 3]
                              for _, p, _ in poses_w2c_list], 0)
    lo, hi = centers.min(0), centers.max(0)
    pad = 0.15 * float((hi - lo).max()) + 1e-3
    return np.stack([lo - pad, hi + pad], -1)


def plot_camera_frusta(poses_w2c_list: List[Tuple[str, np.ndarray, str]], depth: float = 0.3,
                       title: str = "", axlim: Optional[np.ndarray] = None,
                       size: int = 600) -> np.ndarray:
    """Frusta plot -> (size, size, 3) float image on white: per camera its
    centre (a 5x5 square) and a frustum of four rays to a small image plane
    at `depth` along +z, in the named color (COLORS), seen from a fixed
    oblique view (frusta_canvas_xy); `axlim` (3, 2) pins the box across the
    frames of an animation. The title and legend of the JAX package's
    matplotlib figure are not drawn."""
    del title
    axlim = frusta_axlim(poses_w2c_list) if axlim is None else np.asarray(axlim, np.float64)
    canvas = np.ones((size, size, 3), np.float32)
    corners = np.array([[-0.5, -0.5, 1], [0.5, -0.5, 1], [0.5, 0.5, 1], [-0.5, 0.5, 1]]) * depth
    for _, poses_w2c, color in poses_w2c_list:
        rgb = COLORS[color]
        c2w = alignment.invert_poses(np.asarray(poses_w2c, np.float64))
        for R, t in zip(c2w[:, :3, :3], c2w[:, :3, 3]):
            xy = frusta_canvas_xy(np.concatenate([t[None], corners @ R.T + t]), axlim, size)
            for j in range(4):
                draw_line(canvas, xy[1 + j], xy[1 + (j + 1) % 4], rgb)
                draw_line(canvas, xy[0], xy[1 + j], rgb)
            cx, cy = np.rint(xy[0]).astype(int)
            canvas[max(cy - 2, 0): cy + 3, max(cx - 2, 0): cx + 3] = rgb
    return canvas


def match_color(i: int) -> Tuple[float, float, float]:
    """The color of match i in plot_matches (the JAX package's draw)."""
    return tuple(float(c) / 255.0 for c in np.random.RandomState(i).randint(64, 255, 3))


def plot_matches(img1: np.ndarray, img2: np.ndarray, kp1: np.ndarray, kp2: np.ndarray,
                 max_matches: int = 100) -> np.ndarray:
    """Side-by-side match visualization: the two (H,W,3) float images, and a
    line from each of up to max_matches (evenly chosen) keypoints kp1 (x, y)
    to its match kp2 in the right image, in match_color(i)."""
    H = max(img1.shape[0], img2.shape[0])
    W1, W2 = img1.shape[1], img2.shape[1]
    canvas = np.zeros((H, W1 + W2, 3), np.float32)
    canvas[: img1.shape[0], :W1] = img1
    canvas[: img2.shape[0], W1:] = img2
    canvas = np.floor(canvas * 255) / 255  # the 8-bit canvas of the JAX package's draw
    sel = np.linspace(0, len(kp1) - 1, min(max_matches, len(kp1))).astype(int)
    for i in sel:
        p1 = (int(kp1[i, 0]), int(kp1[i, 1]))
        p2 = (int(kp2[i, 0]) + W1, int(kp2[i, 1]))
        draw_line(canvas, p1, p2, match_color(i))
    return canvas.astype(np.float32)

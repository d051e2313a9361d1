"""The work a SPARF step or render needs, counted from a configuration
file's `run` section and never from the program: the MLP's operations per
point, the points per training step and per frame, the bytes the MLP op
must move, and the peaks they are held to.

One forward of the MLP over one point is 2 x sum(in x out) over the chain's
layers. A point that carries a gradient counts three forwards (its forward,
and its backward to the inputs and to the weights); a point without one
(the visibility pass of the depth-consistency loss, a render) counts one.
Nothing the implementation adds counts: no recomputed forward, no second or
third product of a split-precision scheme.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

# NVIDIA H100 SXM data sheet, dense: TF32 tensor cores (the fastest way the
# card multiplies fp32 inputs) and bf16; HBM3 bandwidth
PEAK_FLOPS = {"float32": 495e12, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12


def chain(run: Dict) -> List[Tuple[int, int]]:
    """(in, out) of every layer of the MLP: the trunk with the encoded point
    re-entering at the skip layers and the density unit on its last layer,
    then the view head on the trunk's features and the encoded direction."""
    d3 = 3 + 6 * run["arch.posenc.L_3D"]
    dv = 3 + 6 * run["arch.posenc.L_view"]
    feat = [w for w in run["arch.layers_feat"] if w is not None]
    skip = set(run["arch.skip"])
    layers, k_in = [], d3
    for li, k_out in enumerate(feat):
        if li in skip:
            k_in += d3
        layers.append((k_in, k_out + 1 if li == len(feat) - 1 else k_out))
        k_in = k_out
    k_in = feat[-1] + dv
    for k_out in (w for w in run["arch.layers_rgb"] if w is not None):
        layers.append((k_in, k_out))
        k_in = k_out
    return layers


def flops_per_point(run: Dict) -> int:
    return 2 * sum(i * o for i, o in chain(run))


def bytes_per_point(run: Dict, grad: bool) -> int:
    """float32 bytes in and out of the op per point: the encoded point and
    direction in, density and rgb out; with a gradient also the output
    gradient in and the input gradients out."""
    d3 = 3 + 6 * run["arch.posenc.L_3D"]
    dv = 3 + 6 * run["arch.posenc.L_view"]
    fwd = d3 + dv + 4
    return 4 * (2 * fwd if grad else fwd)


def fine_at(run: Dict, iteration: int) -> bool:
    r = run["nerf.ratio_start_fine_sampling_at_x"]
    return bool(run["nerf.fine_sampling"]) and not (r is not None
                                                    and iteration < run["max_iter"] * r)


def step_points(run: Dict, iteration: int) -> Dict[str, int]:
    """MLP points of one training step at `iteration`, with and without a
    gradient. Rays: the photometric rays (rand_rays // views pixels, shared
    by every view), the correspondence pair (2 x rand_rays // 2), and the
    depth-consistency loss's reference and virtual views (N each, with a
    gradient) and its visibility pass (N, without), N =
    depth_cons_nbr_rays or max(1024, rand_rays). A ray of a pixel render
    takes the coarse samples, and with the fine level also coarse + fine
    samples; the visibility pass takes the coarse samples at each level."""
    views = run["synthetic.n_train"]
    rr = run["nerf.rand_rays"]
    n_dc = int(run["depth_cons_nbr_rays"] or max(1024, rr))
    loss_type = run["loss_type"]
    grad_rays = (rr // views) * views
    nograd_rays = 0
    if "corres" in loss_type:
        grad_rays += 2 * (rr // 2)
    if "depth_cons" in loss_type:
        grad_rays += 2 * n_dc
        nograd_rays += n_dc
    S, Sf = run["nerf.sample_intvs"], run["nerf.sample_intvs_fine"]
    fine = fine_at(run, iteration)
    return dict(grad=grad_rays * (S + (S + Sf if fine else 0)),
                nograd=nograd_rays * (S + (S if fine else 0)))


def frame_points(run: Dict, iteration: int) -> int:
    """MLP points of one full-image render: every pixel, coarse + fine."""
    S, Sf = run["nerf.sample_intvs"], run["nerf.sample_intvs_fine"]
    return (run["synthetic.H"] * run["synthetic.W"]
            * (S + (S + Sf if fine_at(run, iteration) else 0)))


def step_work(run: Dict, iteration: int) -> Dict[str, float]:
    """Counted operations and bytes of the MLP op in one training step."""
    pts, f = step_points(run, iteration), flops_per_point(run)
    return dict(flops=3.0 * pts["grad"] * f + 1.0 * pts["nograd"] * f,
                bytes=float(pts["grad"] * bytes_per_point(run, True)
                            + pts["nograd"] * bytes_per_point(run, False)))


def frame_work(run: Dict, iteration: int) -> Dict[str, float]:
    pts = frame_points(run, iteration)
    return dict(flops=float(pts * flops_per_point(run)),
                bytes=float(pts * bytes_per_point(run, False)))


def bound_seconds(work: Dict[str, float], dtype: str) -> Tuple[float, str]:
    """The least time the card could take for `work`, and which bound sets it."""
    t_ops, t_bytes = work["flops"] / PEAK_FLOPS[dtype], work["bytes"] / PEAK_BYTES
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")

#!/usr/bin/env python
"""Train the port's PDC-Net-style dense matcher on synthetic multi-view GT flow
(the port of scripts/train_pdcnet_synth.py).

  1. generates a pool of randomized two-view rigs over the analytic scene
     (camera ring position, baseline angle, focal, texture octaves) with GT
     correspondences from analytic depth in both pair orders, host numpy
     drawing the JAX script's numbers from the same RandomState;
  2. trains models/pdcnet.py::PDCNet with deep supervision at /8, /4 and /2
     (Huber on the flow, validity eroded by resizing and thresholding at
     0.99), a per-sample mean-signed-error penalty (--bias_weight) and the
     Laplace-mixture NLL at weight 0.1, under per-view zoom and photometric
     augmentation, with clip-by-global-norm 1.0 and Adam on a cosine
     schedule (alpha 0.05);
  3. evaluates the median EPE over confident px (p_r > 0.95) against GT on
     the ladder rungs (angular span 0.35 and 1.0, 3 views, texture octaves 2);
  4. writes an npz with `<layer>__<i>` keys and a `provenance` string, which
     both packages' `load_weights_npz` read.

    python -m sparf_tpu_torch.scripts.train_pdcnet_synth [--steps 3000] [--pairs 240]
        [--H 300 --W 400] [--out workspace/pdcnet_synth/pdcnet_synth.npz]
        [--data_cache pairs.npz] [--gen_only] [--init_from w.npz]
        [--eval-only sparf_tpu/data/pdcnet_synth.npz] [--device cuda|cpu] [--cpu]

It runs on the card unless --device cpu (or --cpu) is given, and exits with
an error when there is no card. It never writes into sparf_tpu/data/ (the
JAX package's bundled weights): --out must lie elsewhere.

Differences from the JAX script: the step draws its pair indices, pair
orders and augmentation numbers from a `utils/draws.Draws` generator on the
device (the JAX script folds the step into a PRNG key), so a run follows the
JAX run's data but not its draws; --steps is the number of steps (the JAX
script runs whole chunks of 100); each step is a plain loop iteration under
`ieee_fp32()`, since cuDNN's TF32 convolutions move PDC-Net's coordinates by
~0.2 px.
"""
from __future__ import annotations

import argparse
import math
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from sparf_tpu_torch.models import pdcnet as P

# the JAX package's data directory, which no run of this script writes into
DATA_DIR = os.path.dirname(P.BUNDLED_WEIGHTS)
DEFAULT_OUT = os.path.join("workspace", "pdcnet_synth", "pdcnet_synth.npz")
# the JAX script logs once per 100-step scan chunk and checkpoints after the
# chunk that starts at a multiple of 400
LOG_EVERY = 100
CHECKPOINT_EVERY = 400


def generate_pairs(rng: np.random.RandomState, n_pairs: int, H: int, W: int):
    """Randomized two-view rigs over the analytic scene, with GT corres in
    both pair orders (dir 0: view0->view1, dir 1: view1->view0): imgs
    (n,2,3,H,W) float32, corres (n,2dirs,2,H,W), valid (n,2dirs,H,W)."""
    from sparf_tpu_torch.datasets import synthetic as syn
    from sparf_tpu_torch.models.flow_net import gt_correspondences_for_pair

    imgs = np.zeros((n_pairs, 2, 3, H, W), np.float32)
    corres = np.zeros((n_pairs, 2, 2, H, W), np.float32)
    valid = np.zeros((n_pairs, 2, H, W), bool)
    for i in range(n_pairs):
        a0 = rng.uniform(-1.3, 1.3)
        da = rng.uniform(0.06, 1.0) * rng.choice([-1.0, 1.0])
        rad = syn.CAM_RADIUS * rng.uniform(0.85, 1.15)
        focal = W * rng.uniform(0.75, 1.05)
        octaves = rng.randint(1, 5)
        intr = np.array([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1]], np.float32)
        views = []
        for a, h in ((a0, rng.uniform(-0.3, 0.3)), (a0 + da, rng.uniform(-0.3, 0.3))):
            eye = np.array([np.sin(a) * rad, h, -np.cos(a) * rad], np.float32)
            pose = syn.look_at_pose_w2c(eye)
            img, depth, fg = syn.render_view(pose, intr, H, W, octaves)
            views.append((img, depth, fg, pose))
        scene = dict(
            image=np.stack([v[0].transpose(2, 0, 1) for v in views]),
            depth_gt=np.stack([v[1] for v in views]),
            valid_depth_gt=np.stack([v[2] for v in views]),
            pose=np.stack([v[3] for v in views]),
            intr=np.stack([intr, intr]),
        )
        imgs[i] = scene["image"]
        for d, (a, b) in enumerate(((0, 1), (1, 0))):
            corres[i, d], valid[i, d] = gt_correspondences_for_pair(scene, a, b)
        if (i + 1) % 40 == 0:
            print(f"  generated {i + 1}/{n_pairs} pairs")
    return imgs, corres, valid


def photometric_aug(draws, img: torch.Tensor) -> torch.Tensor:
    """Per-view exposure/colour gain, bias, sensor noise and vignetting; the
    draws in the order gain (B,3,1,1), bias (B,1,1,1), noise (img.shape),
    vignetting (B,1,1,1)."""
    B, C, H, W = img.shape
    gain = torch.exp(P._uniform(draws, (B, 3, 1, 1), -0.25, 0.25, img.device))
    bias = P._uniform(draws, (B, 1, 1, 1), -0.06, 0.06, img.device)
    noise = 0.012 * draws.normal(img.shape)
    yy = (torch.arange(H, device=img.device) / (H - 1) - 0.5)[None, None, :, None]
    xx = (torch.arange(W, device=img.device) / (W - 1) - 0.5)[None, None, None, :]
    r2 = (xx**2 + yy**2) / 0.5
    vig_k = P._uniform(draws, (B, 1, 1, 1), 0.0, 0.35, img.device)
    return torch.clamp(img * gain * (1 - vig_k * r2) + bias + noise, 0.0, 1.0)


def map_coordinates(img: torch.Tensor, yy: torch.Tensor, xx: torch.Tensor) -> torch.Tensor:
    """jax.scipy.ndimage.map_coordinates(ch, [yy, xx], order=1, mode="constant")
    for every channel of img (..., C, H, W) at (..., H', W') coordinates:
    bilinear, each out-of-range corner contributing 0 (F.grid_sample with
    align_corners=True and zero padding computes the same), the four corners
    weighted and summed in the JAX function's order."""
    H, W = img.shape[-2:]
    y0, x0 = torch.floor(yy), torch.floor(xx)
    wy1, wx1 = yy - y0, xx - x0
    flat = img.reshape(*img.shape[:-2], H * W)
    out = None
    for iy, wy in ((y0, 1 - wy1), (y0 + 1, wy1)):
        for ix, wx in ((x0, 1 - wx1), (x0 + 1, wx1)):
            ok = (iy >= 0) & (iy < H) & (ix >= 0) & (ix < W)
            idx = (torch.clamp(iy, 0, H - 1) * W + torch.clamp(ix, 0, W - 1)).long()
            v = torch.gather(flat, -1, idx.reshape(*idx.shape[:-2], 1, -1)
                             .expand(*flat.shape[:-1], -1)).reshape(img.shape[:-2] + yy.shape[-2:])
            term = (wy * wx)[..., None, :, :] * torch.where(ok[..., None, :, :], v,
                                                            torch.zeros_like(v))
            out = term if out is None else out + term
    return out


def zoom_aug(draws, tgt, src, gt, v, zoom_min: float = 0.72, zoom_max: float = 1.35):
    """Per-sample independent centre zoom of target and source with the exact
    GT-correspondence transform. With per-view factors f_t, f_s and
    S_f(u) = c + f (u - c): tgt'(u) = tgt(S_ft(u)), src'(u) = src(S_fs(u)),
    m'(u) = S_fs^-1(m(S_ft(u))); the validity is resampled through S_ft and
    zeroed outside the image. Draws: (B, 2) unit uniforms, f_t then f_s."""
    B, _, H, W = tgt.shape
    f = P._uniform(draws, (B, 2), zoom_min, zoom_max, tgt.device)
    ft, fs = f[:, 0, None, None], f[:, 1, None, None]
    cx, cy = (W - 1) / 2.0, (H - 1) / 2.0
    vv, uu = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=tgt.device),
                            torch.arange(W, dtype=torch.float32, device=tgt.device), indexing="ij")
    xt, yt = cx + ft * (uu - cx), cy + ft * (vv - cy)
    xs, ys = cx + fs * (uu - cx), cy + fs * (vv - cy)
    tgt2 = map_coordinates(tgt, yt, xt)
    src2 = map_coordinates(src, ys, xs)
    m_at = map_coordinates(gt, yt, xt)
    gt2 = torch.stack([cx + (m_at[:, 0] - cx) / fs, cy + (m_at[:, 1] - cy) / fs], 1)
    v_at = map_coordinates(v[:, None], yt, xt)[:, 0]
    inb = (xt >= 0) & (xt <= W - 1) & (yt >= 0) & (yt <= H - 1)
    return tgt2, src2, gt2, torch.where(inb, v_at, torch.zeros_like(v_at))


def pdcnet_loss(model, tgt, src, corres, valid, bias_weight: float = 0.7):
    """The training loss on an augmented batch: Huber on the flow at /8 (w 1),
    /4 and /2 (w 0.5 each) over the eroded validity, bias_weight x the mean
    per-sample |masked mean residual| at /2, and 0.1 x the mixture NLL.
    Returns (loss, {'epe2', 'bias2'})."""
    from sparf_tpu_torch.utils.imgproc import resize_bilinear

    out = model(tgt, src)
    total = torch.zeros((), device=tgt.device)
    logs = {}
    for lev, w_lev in ((8, 1.0), (4, 0.5), (2, 0.5)):
        m = out["mapping"] if lev == 2 else out[f"mapping{lev}"]
        h, w = m.shape[-2:]
        # jax.image.resize's bilinear antialiases when it downsamples
        gt = resize_bilinear(corres / lev, (h, w), antialias=True)
        v = (resize_bilinear(valid[:, None], (h, w), antialias=True) > 0.99).float()
        err = torch.linalg.norm(m - gt, dim=1, keepdim=True)
        huber = torch.where(err < 1.0, 0.5 * err**2, err - 0.5)
        total = total + w_lev * torch.sum(huber * v) / (torch.sum(v) + 1.0)
        if lev == 2:
            logs["epe2"] = torch.sum(err * v) / (torch.sum(v) + 1.0)
            bias_vec = torch.sum((m - gt) * v, dim=(2, 3)) / (torch.sum(v, dim=(2, 3)) + 1.0)
            bias_mag = torch.sqrt(torch.sum(bias_vec**2, dim=1) + 1e-8)
            logs["bias2"] = torch.mean(bias_mag) * 2.0
            total = total + bias_weight * torch.mean(bias_mag)

            def nll(var):
                b = torch.sqrt(torch.clamp(var, min=1e-6) / 2)
                return err / b + 2 * torch.log(b)

            m_nll = -torch.log(out["alpha"] * torch.exp(-nll(torch.exp(out["log_var_s"])))
                               + (1 - out["alpha"]) * torch.exp(-nll(torch.exp(out["log_var_l"])))
                               + 1e-9)
            total = total + 0.1 * torch.sum(m_nll * v) / (torch.sum(v) + 1.0)
    return total, logs


def augmented_loss(model, tgt, src, corres, valid, draws, bias_weight: float = 0.7,
                   zoom_min: float = 0.72, zoom_max: float = 1.35):
    """Zoom, then photometric augmentation of target and source (in that
    order of draws), then `pdcnet_loss`."""
    tgt, src, corres, valid = zoom_aug(draws, tgt, src, corres, valid, zoom_min, zoom_max)
    tgt = photometric_aug(draws, tgt)
    src = photometric_aug(draws, src)
    return pdcnet_loss(model, tgt, src, corres, valid, bias_weight)


def cosine_lr(lr: float, steps: int, alpha: float = 0.05):
    """optax.cosine_decay_schedule(lr, steps, alpha) as an engine.Adam lr_fn."""
    def fn(count: torch.Tensor) -> torch.Tensor:
        c = torch.clamp(count, max=float(steps))
        return lr * ((1 - alpha) * (0.5 * (1 + torch.cos(math.pi * c / steps))) + alpha)
    return fn


def sample_batch(pool, draws, batch: int):
    """Pair indices and random pair orders from `draws`, then the batch:
    (tgt, src) images in [0,1] from the uint8 pool, corres and validity."""
    imgs, corres, valid = pool
    idx = draws.randint((batch,), 0, imgs.shape[0])
    dr = draws.randint((batch,), 0, 2)
    ar = torch.arange(batch, device=idx.device)
    batch_imgs = imgs[idx].float() / 255.0
    return (batch_imgs[ar, dr], batch_imgs[ar, 1 - dr], corres[idx][ar, dr],
            valid[idx][ar, dr].float())


def train_step(model, tx, opt_state, pool, draws, batch: int, bias_weight: float = 0.7,
               zoom_min: float = 0.72, zoom_max: float = 1.35):
    """One step: batch, augmented loss, gradients, clipped Adam update in
    place on `model`; everything in full float32, the convolutions in
    PyTorch's own kernels rather than cuDNN's. On the H100 (700 W) cuDNN's
    float32 algorithms put the first layers' weight gradients 1e-3 of scale
    from the float64 gradient at 300x400, where PyTorch's kernels and the CPU
    stay at 1.1e-4, at the same time per step and 0.6 instead of 4.4 GiB of
    peak memory (chip_smoke.py's pdcnet-train; PERF.md). Returns
    (loss, logs, grads, opt_state)."""
    from sparf_tpu_torch.utils.precision import ieee_fp32

    params = list(model.parameters())
    cudnn = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = False
    try:
        with ieee_fp32():
            tgt, src, c, v = sample_batch(pool, draws, batch)
            loss, logs = augmented_loss(model, tgt, src, c, v, draws, bias_weight, zoom_min,
                                        zoom_max)
            grads = torch.autograd.grad(loss, params)
    finally:
        torch.backends.cudnn.enabled = cudnn
    updates, opt_state = tx.update(list(grads), opt_state)
    with torch.no_grad():
        for p, u in zip(params, updates):
            p.add_(u)
    return loss.detach(), {k: x.detach() for k, x in logs.items()}, grads, opt_state


def ladder_eval(model, H: int, W: int, device) -> Dict[str, dict]:
    """Median EPE over p_r > 0.95 against GT, confident fraction and
    |mean signed error| per pair, on each ladder rung (angular span 0.35 and
    1.0, 3 views, texture octaves 2)."""
    from sparf_tpu_torch.datasets.synthetic import load_synthetic_scene
    from sparf_tpu_torch.models import flow_net as F
    print("\n== ladder eval (median EPE in p_r>0.95, vs GT flow) ==")
    out = {}
    for span in (0.35, 1.0):
        sc = load_synthetic_scene(split="train", H=H, W=W, n_train=3, n_test=1, angular_span=span,
                                  texture_octaves=2)
        combi = F.get_combi_list(3, "all")
        gt_corres, gt_conf = F.compute_gt_flow_of_combi_list(sc, combi)
        with torch.no_grad():
            c, conf = P.compute_pdcnet_flow_of_combi_list(np.asarray(sc["image"]), combi,
                                                          model=model, device=device)
        meds, fracs, biases = [], [], []
        for p in range(combi.shape[1]):
            m = (conf[p, 0] > 0.95) & (gt_conf[p, 0] > 0.5)
            if m.sum() < 10:
                meds.append(np.inf)
                fracs.append(0.0)
                biases.append(np.inf)
                continue
            diff = (c[p] - gt_corres[p])[:, m]
            meds.append(float(np.median(np.linalg.norm(diff, axis=0))))
            fracs.append(float(m.mean()))
            biases.append(float(np.linalg.norm(diff.mean(axis=1))))
        out[str(span)] = dict(median_epe=meds, conf_frac=fracs, mean_signed_err=biases)
        print(f"  span={span}: median-EPE per pair = {[round(x, 2) for x in meds]}, conf-frac = "
              f"{[round(x, 2) for x in fracs]}, |mean-signed-err| = "
              f"{[round(x, 3) for x in biases]}")
    return out


def _inside_data_dir(path: str) -> bool:
    path = os.path.realpath(os.path.abspath(path))
    data = os.path.realpath(DATA_DIR)
    return os.path.commonpath([path, data]) == data


def load_pair_pool(args):
    """The pair set: from --data_cache when it exists, else generated (and
    cached when --data_cache is given)."""
    if args.data_cache and os.path.exists(args.data_cache):
        print(f"loading pair cache {args.data_cache}")
        with np.load(args.data_cache) as d:
            imgs, corres, valid = d["imgs"], d["corres"], d["valid"]
        if corres.ndim != 5:
            raise SystemExit("stale single-direction pair cache: regenerate (corres must be "
                             "(n,2dirs,2,H,W))")
        if imgs.shape[0] < args.pairs:
            raise SystemExit("pair cache smaller than --pairs")
        return imgs[: args.pairs], corres[: args.pairs], valid[: args.pairs]
    print(f"generating {args.pairs} training pairs at {args.H}x{args.W} ...")
    t0 = time.time()
    imgs, corres, valid = generate_pairs(np.random.RandomState(args.seed), args.pairs, args.H,
                                         args.W)
    print(f"  done in {time.time() - t0:.0f}s")
    if args.data_cache:
        np.savez_compressed(args.data_cache, imgs=imgs, corres=corres, valid=valid)
        print(f"saved pair cache {args.data_cache}")
    return imgs, corres, valid


def save_with_provenance(model, path: str, provenance: str) -> None:
    """`<layer>__<i>` arrays and `provenance` in one compressed npz."""
    flat = {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}
    flat["provenance"] = np.asarray(provenance)
    np.savez_compressed(path, **flat)


def train(args, device) -> Optional[dict]:
    """Generate or load the pairs, train, save; returns the run's summary
    (model, losses, step_seconds: each step's host time to its loss, seconds)
    or None with --gen_only."""
    from sparf_tpu_torch.training.engine import Adam
    from sparf_tpu_torch.utils.draws import Draws

    imgs_np, corres_np, valid_np = load_pair_pool(args)
    if args.gen_only:
        return None
    # the pool lives on the device as uint8, converted per sampled batch
    pool = (torch.as_tensor(np.clip(imgs_np * 255.0 + 0.5, 0, 255).astype(np.uint8), device=device),
            torch.as_tensor(corres_np, device=device), torch.as_tensor(valid_np, device=device))
    if args.init_from:
        print(f"warm-starting from {args.init_from}")
        model = P.load_weights_npz(args.init_from, device)
    else:
        model = P.PDCNet(generator=torch.Generator().manual_seed(args.seed), device=device)
    tx = Adam(cosine_lr(args.lr, args.steps), clip_norm=1.0)
    opt_state = tx.init(list(model.parameters()))
    draws = Draws(args.seed + 1, device)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    losses, step_seconds = [], []
    t0 = time.time()
    for it in range(args.steps):
        ts = time.perf_counter()
        loss, logs, _, opt_state = train_step(model, tx, opt_state, pool, draws, args.batch,
                                              args.bias_weight, args.zoom_min, args.zoom_max)
        losses.append(float(loss))     # waits for the step
        step_seconds.append(time.perf_counter() - ts)
        if (it + 1) % LOG_EVERY == 0 or it == args.steps - 1:
            print(f"step {it}: loss={losses[-1]:.4f} epe@/2={float(logs['epe2']):.3f}px "
                  f"bias={float(logs['bias2']):.3f}px ({time.time() - t0:.0f}s)", flush=True)
        chunk0 = it + 1 - LOG_EVERY
        if (it + 1) % LOG_EVERY == 0 and chunk0 and chunk0 % CHECKPOINT_EVERY == 0:
            P.save_weights_npz(model, args.out + f".step{chunk0}")
    save_with_provenance(
        model, args.out,
        f"trained on {args.pairs} synthetic multi-view pairs "
        f"({args.H}x{args.W}, analytic GT flow, photometric aug, symmetrized pair orders, "
        f"mean-signed-error penalty w={args.bias_weight}, per-view zoom aug "
        f"{args.zoom_min}-{args.zoom_max}), steps={args.steps}, seed={args.seed}"
        + (f", warm-started from {args.init_from}" if args.init_from else "")
        + f", sparf_tpu_torch on {device}")
    print(f"saved {args.out}")
    return dict(model=model, losses=losses, step_seconds=step_seconds, seconds=time.time() - t0)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--pairs", type=int, default=240)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--H", type=int, default=300)
    ap.add_argument("--W", type=int, default=400)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--bias_weight", type=float, default=0.7,
                    help="weight of the per-sample mean-signed-error penalty")
    ap.add_argument("--zoom_min", type=float, default=0.72)
    ap.add_argument("--zoom_max", type=float, default=1.35)
    ap.add_argument("--out", default=DEFAULT_OUT, help="output npz (never in sparf_tpu/data/)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cpu", action="store_true", help="same as --device cpu")
    ap.add_argument("--eval-only", dest="eval_only", default=None,
                    help="npz to evaluate (skip training)")
    ap.add_argument("--data_cache", default=None,
                    help="npz of the generated pair set: loaded if it exists, else generated "
                         "and saved")
    ap.add_argument("--gen_only", action="store_true",
                    help="generate and save the pair cache, then exit")
    ap.add_argument("--init_from", default=None, help="warm-start weights npz")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run the script; returns {'train': train()'s summary or None, 'eval':
    ladder_eval()'s readings or None}."""
    args = parse_args(argv)
    device = torch.device("cpu" if args.cpu else args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("train_pdcnet_synth: no CUDA device; pass --device cpu to run on the CPU")
    if not args.eval_only and _inside_data_dir(args.out):
        raise SystemExit(f"--out {args.out} lies in {DATA_DIR}, the JAX package's bundled "
                         "weights: write elsewhere")
    if args.eval_only:
        model, run = P.load_weights_npz(args.eval_only, device), None
    else:
        run = train(args, device)
        if run is None:
            return dict(train=None, eval=None)
        model = run["model"]
    return dict(train=run, eval=ladder_eval(model, args.H, args.W, device))


if __name__ == "__main__":
    main()

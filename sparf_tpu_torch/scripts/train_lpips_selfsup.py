#!/usr/bin/env python
"""Self-supervised training of the port's LPIPS net (the port of
scripts/train_lpips_selfsup.py): no external data or weights.

The AlexNet-LPIPS architecture of training/lpips.py is trained on a 2AFC
distortion-severity ranking objective: for a clean patch x and one distortion
family at two severities s1 < s2, d(x, D(x, s2)) > d(x, D(x, s1)) + margin;
plus cross-family pairs labelled by an SSIM+PSNR committee where both metrics
agree by a margin, and a small regulariser on the distances. The families
(blur, white noise, block artefacts, contrast, brightness, shift, colour
cast, mixed) and the procedural patches (filtered noise, gradients, random
polygons, crops of the analytic scene) are host numpy, drawn from one
RandomState(--seed) in the JAX script's order, with OpenCV's operations
replaced by utils/imgproc.py's (gaussian_blur, fill_poly,
warp_affine_reflect, resize_area, resize_nearest); the initial weights are
training/lpips.py's RandomState(seed) backbone. So a run follows the JAX
run step by step from the same --seed.

    python -m sparf_tpu_torch.scripts.train_lpips_selfsup [--steps 4000] [--batch 16]
        [--out workspace/lpips_selfsup/lpips_selfsup.npz] [--device cuda|cpu] [--cpu]

It runs on the card unless --device cpu (or --cpu) is given, and exits with
an error when there is no card. It never writes into sparf_tpu/data/ (the
JAX package's bundled weights): --out must lie elsewhere. The network's
convolutions run in full float32 (`ieee_fp32()`).
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from sparf_tpu_torch.utils import imgproc

PATCH = 64
DEFAULT_OUT = os.path.join("workspace", "lpips_selfsup", "lpips_selfsup.npz")


# ---------------------------------------------------------------------------
# procedural clean patches
# ---------------------------------------------------------------------------


def _smooth_noise(rng, scale):
    img = rng.rand(PATCH, PATCH, 3).astype(np.float32)
    k = 2 * int(scale) + 1
    return imgproc.gaussian_blur(img, (k, k), scale)


def _gradient(rng):
    xx, yy = np.meshgrid(np.linspace(0, 1, PATCH), np.linspace(0, 1, PATCH))
    a, b = rng.rand(2)
    base = a * xx + (1 - a) * yy
    img = np.stack([base, base * b, 1 - base], -1).astype(np.float32)
    return np.clip(img + 0.1 * rng.randn(PATCH, PATCH, 3), 0, 1).astype(np.float32)


def _polygons(rng):
    img = np.full((PATCH, PATCH, 3), rng.rand(3), np.float32)
    for _ in range(rng.randint(3, 8)):
        pts = (rng.rand(rng.randint(3, 6), 2) * PATCH).astype(np.int32)
        color = tuple(float(c) for c in rng.rand(3))
        imgproc.fill_poly(img, [pts], color)
    img = imgproc.gaussian_blur(img, (3, 3), 0.8)
    return img.astype(np.float32)


def _scene_crop(scene_imgs, rng):
    i = rng.randint(len(scene_imgs))
    img = scene_imgs[i]
    H, W = img.shape[:2]
    y = rng.randint(0, max(H - PATCH, 1))
    x = rng.randint(0, max(W - PATCH, 1))
    return img[y: y + PATCH, x: x + PATCH].astype(np.float32)


def make_clean(scene_imgs, rng):
    r = rng.rand()
    if r < 0.3:
        return _smooth_noise(rng, rng.choice([1, 2, 3]))
    if r < 0.5:
        return _gradient(rng)
    if r < 0.7:
        return _polygons(rng)
    return _scene_crop(scene_imgs, rng)


# ---------------------------------------------------------------------------
# distortions, monotone in severity s in (0, 1]
# ---------------------------------------------------------------------------


def _blur(img, s, rng):
    return imgproc.gaussian_blur(img, (0, 0), 0.5 + 4.0 * s)


def _noise(img, s, rng):
    return np.clip(img + rng.randn(*img.shape).astype(np.float32) * 0.4 * s, 0, 1)


def _blocks(img, s, rng):
    f = max(int(PATCH * (1.0 - 0.85 * s)), 4)
    small = imgproc.resize_area(img, (f, f))
    return imgproc.resize_nearest(small, (PATCH, PATCH))


def _contrast(img, s, rng):
    return np.clip((img - 0.5) * (1.0 - 0.9 * s) + 0.5, 0, 1)


def _brightness(img, s, rng):
    sign = 1.0 if rng.rand() < 0.5 else -1.0
    return np.clip(img + sign * 0.6 * s, 0, 1)


def _shift(img, s, rng):
    d = 1.0 + 7.0 * s
    ang = rng.rand() * 2 * np.pi
    M = np.float32([[1, 0, d * np.cos(ang)], [0, 1, d * np.sin(ang)]])
    return imgproc.warp_affine_reflect(img, M, (PATCH, PATCH))


def _cast(img, s, rng):
    cast = (rng.rand(3) - 0.5) * 1.2 * s
    return np.clip(img + cast[None, None], 0, 1).astype(np.float32)


def _mixed(img, s, rng):
    return _noise(_blur(img, 0.6 * s, rng), 0.6 * s, rng)


FAMILIES = [_blur, _noise, _blocks, _contrast, _brightness, _shift, _cast, _mixed]


def make_triplet(scene_imgs, rng):
    """(clean, mild, severe) with severities s1 < s2 from one family; the gap
    is kept narrow (0.08-0.35), where trained features must earn their keep."""
    x = make_clean(scene_imgs, rng)
    fam = FAMILIES[rng.randint(len(FAMILIES))]
    s1 = 0.05 + 0.5 * rng.rand()
    s2 = min(s1 + 0.08 + 0.27 * rng.rand(), 0.97)
    return x, fam(x, s1, rng), fam(x, s2, rng)


def _to_nchw(a):
    return np.stack(a).transpose(0, 3, 1, 2) * 2.0 - 1.0  # NCHW [-1,1]


def batch_triplets(scene_imgs, rng, n):
    xs, m, sv = [], [], []
    for _ in range(n):
        x, d1, d2 = make_triplet(scene_imgs, rng)
        xs.append(x)
        m.append(d1)
        sv.append(d2)
    return _to_nchw(xs), _to_nchw(m), _to_nchw(sv)


def batch_cross(scene_imgs, rng, n):
    """(ref, distA, distB) with independent families and severities per side:
    the cross-family 2AFC pairs labelled by the SSIM+PSNR committee."""
    xs, a, b = [], [], []
    for _ in range(n):
        x = make_clean(scene_imgs, rng)
        fa = FAMILIES[rng.randint(len(FAMILIES))]
        fb = FAMILIES[rng.randint(len(FAMILIES))]
        a.append(fa(x, 0.05 + 0.9 * rng.rand(), rng))
        b.append(fb(x, 0.05 + 0.9 * rng.rand(), rng))
        xs.append(x)
    return _to_nchw(xs), _to_nchw(a), _to_nchw(b)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def scene_images():
    """Clean sources: the analytic scene at six views and two resolutions,
    (H, W, 3) float32."""
    from sparf_tpu_torch.datasets.synthetic import load_synthetic_scene

    out = []
    for hw in ((120, 160), (90, 120)):
        sc = load_synthetic_scene(split="train", H=hw[0], W=hw[1], n_train=6, n_test=1)
        out += [im.transpose(1, 2, 0) for im in sc["image"]]
    return out


def dist(p, a, b):
    """Per-sample LPIPS distance (N,), differentiable in the parameters: the
    lin weights pass through relu, as lpips clamps them to >= 0."""
    from sparf_tpu_torch.training import lpips

    shift = torch.as_tensor(lpips._SHIFT, device=a.device)
    scale = torch.as_tensor(lpips._SCALE, device=a.device)
    f1 = lpips.features(p, (a - shift) / scale)
    f2 = lpips.features(p, (b - shift) / scale)
    tot = 0.0
    for i, (u, v) in enumerate(zip(f1, f2)):
        d = (lpips._normalize_tensor(u) - lpips._normalize_tensor(v)) ** 2
        w = torch.relu(p[f"lin{i}_w"]).reshape(1, -1, 1, 1)
        tot = tot + torch.mean(torch.sum(d * w, dim=1), dim=(1, 2))
    return tot


def per_sample_ssim(a, b):
    from sparf_tpu_torch.training import metrics

    return metrics.ssim(a, b, size_average=False)


def per_sample_psnr(a, b):
    mse = torch.mean((a - b) ** 2, dim=(1, 2, 3))
    return -10.0 * torch.log10(torch.clamp(mse, min=1e-12))


def loss_fn(p, x, mild, severe, xc, ca, cb, margin: float = 0.05):
    """(loss, batch accuracy): the same-family severity ranking, the
    cross-family 2AFC term on the pairs the SSIM+PSNR committee labels, and
    0.01 x the mean (d_severe - 0.5)^2."""
    d_m = dist(p, x, mild)
    d_s = dist(p, x, severe)
    rank = torch.mean(torch.relu(margin + d_m - d_s))
    d_a = dist(p, xc, ca)
    d_b = dist(p, xc, cb)
    s_a, s_b = per_sample_ssim(xc, ca), per_sample_ssim(xc, cb)
    q_a, q_b = per_sample_psnr(xc, ca), per_sample_psnr(xc, cb)
    b_worse = ((s_b < s_a - 0.02) & (q_b < q_a - 0.5)).float()
    a_worse = ((s_a < s_b - 0.02) & (q_a < q_b - 0.5)).float()
    cross = torch.sum(b_worse * torch.relu(margin + d_a - d_b)
                      + a_worse * torch.relu(margin + d_b - d_a)
                      ) / torch.clamp(torch.sum(b_worse + a_worse), min=1.0)
    reg = torch.mean((d_s - 0.5) ** 2) * 0.01
    return rank + cross + reg, torch.mean((d_s > d_m).float())


def train_step(params, tx, opt_state, batch, margin: float = 0.05):
    """One Adam step in place on `params` (a dict of leaf tensors) from the
    six NCHW batches; returns (loss, accuracy, gradients in sorted-name
    order, opt_state)."""
    from sparf_tpu_torch.utils.precision import ieee_fp32

    names = sorted(params)
    leaves = [params[k] for k in names]
    with ieee_fp32():
        loss, acc = loss_fn(params, *batch, margin=margin)
        grads = torch.autograd.grad(loss, leaves)
    updates, opt_state = tx.update(list(grads), opt_state)
    with torch.no_grad():
        for leaf, u in zip(leaves, updates):
            leaf.add_(u)
    return loss.detach(), acc.detach(), grads, opt_state


def validate(p, scene_imgs, seed: int, device):
    """Held-out severity-ranking accuracy and agreement with the SSIM+PSNR
    committee on cross-family pairs (40 batches of 8, RandomState(seed +
    1234))."""
    from sparf_tpu_torch.utils.precision import ieee_fp32

    rng_val = np.random.RandomState(seed + 1234)
    n_ok = n_tot = com_agree = com_tot = 0

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    with torch.no_grad(), ieee_fp32():
        for _ in range(40):
            x, m, s = (t(a) for a in batch_triplets(scene_imgs, rng_val, 8))
            d_m, d_s = dist(p, x, m).cpu().numpy(), dist(p, x, s).cpu().numpy()
            n_ok += int((d_s > d_m).sum())
            n_tot += len(d_m)
            xc, ca, cb = (t(a) for a in batch_cross(scene_imgs, rng_val, 8))
            d_a, d_b = dist(p, xc, ca).cpu().numpy(), dist(p, xc, cb).cpu().numpy()
            s_a, s_b = per_sample_ssim(xc, ca).cpu().numpy(), per_sample_ssim(xc, cb).cpu().numpy()
            q_a, q_b = per_sample_psnr(xc, ca).cpu().numpy(), per_sample_psnr(xc, cb).cpu().numpy()
            for i in range(len(d_a)):
                if s_b[i] < s_a[i] - 0.02 and q_b[i] < q_a[i] - 0.5:
                    com_tot += 1
                    com_agree += int(d_b[i] > d_a[i])
                elif s_a[i] < s_b[i] - 0.02 and q_a[i] < q_b[i] - 0.5:
                    com_tot += 1
                    com_agree += int(d_a[i] > d_b[i])
    return n_ok / max(n_tot, 1), com_agree / max(com_tot, 1)


def initial_params(seed: int, device):
    from sparf_tpu_torch.training import lpips

    return {k: torch.as_tensor(v, device=device).requires_grad_(True)
            for k, v in lpips._init_random_params(seed).items()}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=4000)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--margin", type=float, default=0.05)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=DEFAULT_OUT, help="output npz (never in sparf_tpu/data/)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cpu", action="store_true", help="same as --device cpu")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Train, validate against a random backbone, save; returns
    {'losses', 'step_seconds' (each step's host time to its loss, batch
    generation excluded), 'rank_acc', 'agree', 'rand_acc', 'rand_agree',
    'seconds' (the training loop)}."""
    from sparf_tpu_torch.scripts.train_pdcnet_synth import DATA_DIR, _inside_data_dir
    from sparf_tpu_torch.training.engine import Adam

    args = parse_args(argv)
    device = torch.device("cpu" if args.cpu else args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("train_lpips_selfsup: no CUDA device; pass --device cpu to run on the CPU")
    if _inside_data_dir(args.out):
        raise SystemExit(f"--out {args.out} lies in {DATA_DIR}, the JAX package's bundled "
                         "weights: write elsewhere")
    scene_imgs = scene_images()
    rng = np.random.RandomState(args.seed)
    params = initial_params(args.seed, device)
    lr = args.lr
    tx = Adam(lambda count: torch.full((), lr, device=count.device))
    opt_state = tx.init([params[k] for k in sorted(params)])
    losses, step_seconds = [], []
    t0 = time.time()
    for it in range(args.steps):
        batch = [torch.as_tensor(np.asarray(a, np.float32), device=device)
                 for a in batch_triplets(scene_imgs, rng, args.batch)
                 + batch_cross(scene_imgs, rng, args.batch)]
        ts = time.perf_counter()
        loss, acc, _, opt_state = train_step(params, tx, opt_state, batch, args.margin)
        losses.append(float(loss))     # waits for the step
        step_seconds.append(time.perf_counter() - ts)
        if it % 200 == 0 or it == args.steps - 1:
            print(f"step {it}: loss={losses[-1]:.4f} batch_acc={float(acc):.3f}", flush=True)
    seconds = time.time() - t0
    rand = initial_params(args.seed + 7, device)
    rank_acc, agree = validate(params, scene_imgs, args.seed, device)
    rand_acc, rand_agree = validate(rand, scene_imgs, args.seed, device)
    print(f"held-out severity ranking accuracy: trained={rank_acc:.3f} random-baseline="
          f"{rand_acc:.3f}; committee (SSIM+PSNR) cross-pair agreement: trained={agree:.3f} "
          f"random={rand_agree:.3f}")
    out = {k: v.detach().cpu().numpy() for k, v in params.items()}
    for i in range(5):
        out[f"lin{i}_w"] = np.maximum(out[f"lin{i}_w"], 0.0)
    out["provenance"] = np.array(f"self-supervised 2AFC severity ranking, steps={args.steps}, "
                                 f"rank_acc={rank_acc:.3f}, ssim_agree={agree:.3f}")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez(args.out, **out)
    print(f"saved {args.out}")
    return dict(losses=losses, step_seconds=step_seconds, rank_acc=rank_acc, agree=agree,
                rand_acc=rand_acc, rand_agree=rand_agree, seconds=seconds)


if __name__ == "__main__":
    main()

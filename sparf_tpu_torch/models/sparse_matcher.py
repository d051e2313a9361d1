"""Sparse keypoint matcher, the SuperPoint+SuperGlue slot (torch port of
sparf_tpu/models/sparse_matcher.py).

Shi-Tomasi corners (smaller eigenvalue of the structure tensor after a 5-tap
Gaussian blur), 9x9 max-filter NMS, the top K by response (ties to the lower
pixel index, as `lax.top_k`); multi-scale zero-mean unit-norm RGB patch
descriptors; mutual nearest neighbours on the cosine scores with a minimum
score and a distinctiveness margin. Matches are scattered into dense maps
that are zero except at the matched target keypoints, the contract the
correspondence pools take. Geometric verification happens in the pool
builder, as for the dense matchers.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from sparf_tpu_torch.utils.precision import ieee_fp32


def _gauss_blur(img: torch.Tensor, sigma: float = 1.0, radius: int = 2) -> torch.Tensor:
    """Separable Gaussian blur of (H,W), zero padding ("same" convolution)."""
    x = torch.arange(-radius, radius + 1, dtype=torch.float32, device=img.device)
    k = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    k = k / k.sum()
    out = F.conv2d(img[None, None], k.reshape(1, 1, 1, -1), padding=(0, radius))
    return F.conv2d(out, k.reshape(1, 1, -1, 1), padding=(radius, 0))[0, 0]


def shi_tomasi_response(gray: torch.Tensor, window: int = 3) -> torch.Tensor:
    """Min-eigenvalue corner response of the structure tensor, (H,W)."""
    pad = F.pad(gray[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]
    gx = (pad[1:-1, 2:] - pad[1:-1, :-2]) * 0.5
    gy = (pad[2:, 1:-1] - pad[:-2, 1:-1]) * 0.5

    def box(x):
        ones = torch.ones((1, 1, window, window), dtype=x.dtype, device=x.device)
        return F.conv2d(x[None, None], ones, padding=window // 2)[0, 0]

    a, b, c = box(gx * gx), box(gx * gy), box(gy * gy)
    tr = a + c
    det = a * c - b * b
    return tr / 2 - torch.sqrt(torch.clamp(tr * tr / 4 - det, min=0.0))


def detect_keypoints(img: torch.Tensor, max_kp: int = 1024, nms_radius: int = 4,
                     margin: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-K Shi-Tomasi corners after max-filter NMS: img (3,H,W) -> (kps
    (K,2) float32 xy, scores (K,)); unused entries score 0 at (margin, margin)."""
    _, H, W = img.shape
    resp = shi_tomasi_response(_gauss_blur(img.mean(0)))
    k = 2 * nms_radius + 1
    local_max = F.max_pool2d(resp[None, None], k, stride=1, padding=nms_radius)[0, 0]
    is_peak = (resp >= local_max) & (resp > 0)
    yy, xx = torch.meshgrid(torch.arange(H, device=img.device), torch.arange(W, device=img.device),
                            indexing="ij")
    inb = (xx >= margin) & (xx < W - margin) & (yy >= margin) & (yy < H - margin)
    score = torch.where(is_peak & inb, resp, torch.zeros_like(resp)).reshape(-1)
    vals, idx = torch.sort(score, descending=True, stable=True)
    vals, idx = vals[:max_kp], idx[:max_kp]
    kx = torch.where(vals > 0, (idx % W).to(torch.float32), torch.full_like(vals, float(margin)))
    ky = torch.where(vals > 0, (idx // W).to(torch.float32), torch.full_like(vals, float(margin)))
    return torch.stack([kx, ky], -1), vals


def describe_keypoints(img: torch.Tensor, kps: torch.Tensor, patch: int = 11,
                       scales: Tuple[int, ...] = (1, 2)) -> torch.Tensor:
    """Multi-scale zero-mean unit-norm RGB patch descriptors (K, D)."""
    from sparf_tpu_torch.models.flow_net import _bilinear_at

    C = img.shape[0]
    K = kps.shape[0]
    r = patch // 2
    us = torch.arange(-r, r + 1, dtype=torch.float32, device=img.device)
    vv, uu = torch.meshgrid(us, us, indexing="ij")
    uu, vv = uu.reshape(-1), vv.reshape(-1)
    descs = []
    for s in scales:
        tx = kps[:, 0][:, None] + uu[None] * s
        ty = kps[:, 1][:, None] + vv[None] * s
        d = _bilinear_at(img, tx.reshape(-1), ty.reshape(-1)).reshape(C, K, -1)
        d = d.permute(1, 0, 2).reshape(K, -1)
        d = d - d.mean(-1, keepdim=True)
        descs.append(d / (torch.linalg.norm(d, dim=-1, keepdim=True) + 1e-6))
    d = torch.cat(descs, -1)
    return d / (torch.linalg.norm(d, dim=-1, keepdim=True) + 1e-6)


def match_mutual_nn(desc_t: torch.Tensor, desc_s: torch.Tensor, score_t: torch.Tensor,
                    score_s: torch.Tensor, min_cosine: float = 0.7, min_margin: float = 0.02):
    """Mutual nearest neighbours on the cosine scores, with a minimum score
    and a margin over the second best. Returns (idx_s (Kt,), -1 where
    unmatched; conf (Kt,) in [0, 1])."""
    with ieee_fp32():
        S = desc_t @ desc_s.t()
    S = torch.where((score_t[:, None] > 0) & (score_s[None, :] > 0), S, torch.full_like(S, -1.0))
    best_s = torch.argmax(S, dim=1)
    best_t = torch.argmax(S, dim=0)
    top1 = S.max(dim=1).values
    rows = torch.arange(S.shape[0], device=S.device)
    S2 = S.clone()
    S2[rows, best_s] = -1.0
    top2 = S2.max(dim=1).values
    mutual = best_t[best_s] == rows
    ok = mutual & (top1 >= min_cosine) & (top1 - top2 >= min_margin)
    conf = torch.clamp(top1, 0, 1) * torch.clamp((top1 - top2) / 0.05, 0, 1)
    return torch.where(ok, best_s, torch.full_like(best_s, -1)), conf


def compute_spsg_flow_of_combi_list(images: np.ndarray, combi_list: np.ndarray,
                                    max_kp: int = 1024, return_cc: bool = False,
                                    device="cuda"):
    """Sparse matches as dense maps: (P,2,H,W) corres + (P,1,H,W) conf, zero
    except at matched (rounded) target keypoints, plus an all-ones cc map
    when return_cc."""
    imgs = torch.as_tensor(np.asarray(images), dtype=torch.float32, device=device)
    B, _, H, W = imgs.shape
    corres_out = np.zeros((combi_list.shape[1], 2, H, W), np.float32)
    conf_out = np.zeros((combi_list.shape[1], 1, H, W), np.float32)
    with torch.no_grad(), ieee_fp32():
        detected = [detect_keypoints(imgs[i], max_kp=max_kp) for i in range(B)]
        descs = [describe_keypoints(imgs[i], detected[i][0]) for i in range(B)]
        for p, (t, s) in enumerate(combi_list.T):
            t, s = int(t), int(s)
            idx_s, conf = match_mutual_nn(descs[t], descs[s], detected[t][1], detected[s][1])
            idx_s, conf = idx_s.cpu().numpy(), conf.cpu().numpy()
            kt, ks = detected[t][0].cpu().numpy(), detected[s][0].cpu().numpy()
            m = idx_s >= 0
            if not m.any():
                continue
            tgt = np.round(kt[m]).astype(int)
            src = ks[idx_s[m]] + (kt[m] - np.round(kt[m]))
            corres_out[p, :, tgt[:, 1], tgt[:, 0]] = src
            conf_out[p, 0, tgt[:, 1], tgt[:, 0]] = conf[m]
    if return_cc:
        return corres_out, conf_out, np.ones_like(conf_out)
    return corres_out, conf_out

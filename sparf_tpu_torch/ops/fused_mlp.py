"""The fused NeRF-MLP chain: CUDA kernels K1 (forward) and K2 (backward) as
an autograd op, K3 (forward only, packed weights) for renders that need no
gradient; their plain torch versions on CPU tensors.

K1 replaces `_fwd_kernel` and K2 replaces `_bwd_kernel` of
sparf_tpu/ops/fused_mlp_vjp.py (the `pallas_vjp` impl); K3 replaces `_kernel`
of sparf_tpu/ops/fused_mlp.py (the `pallas` impl). The kernels live in
sparf_tpu_torch/csrc/, whose header notes say what bounds them on an H100 and
what their design does about it: every product runs on the tensor cores. For
compute_dtype float32 K1 and K3 run 3xTF32 `mma.sync` on weights laid out
once per call as ready MMA B fragments (fused_mlp.cu), and K2 runs 3xTF32
`wgmma` on TMA-fed tiles of the weights' TF32 hi and lo where it takes the
chain (the bf16 plan M's chains, the presets' among them), else
fused_mlp.cu's `mma.sync` K2; for bfloat16 all three run `wgmma` on bf16
tiles that TMA brings into shared memory, K3 on K1's body
(fused_mlp_wgmma.cu).

The kernels take every chain the Pallas kernels take within one block's
shared memory: 1 to 16 layers of at most 512 features each (a last trunk
layer of up to 513 outputs with its density unit), skips at any trunk layer
after 0, pts_enc and view_enc at most 128 wide. Each dtype picks one of two
tile plans per chain, on the host, before any launch (the csrc header
notes): the presets' 8x256 chain and every chain of the first plan run as
they always have (128-point tiles); the others run 64-point tiles. Past the
domain the C sizes entries refuse the chain and the op raises ValueError
naming cfg.tpu.use_pallas=False (_DESC_ERRORS); the C descriptors own the
limits, and the Python mirrors below follow them bit for bit.

compute_dtype is how the chain computes, not how its tensors are stored:
inputs, weights and outputs are float32 either way. Under bfloat16 each dot
takes its two operands rounded to bf16 (round to nearest even) and sums in
float32, exactly where the TPU kernels round (sparf_tpu/ops/fused_mlp.py
_kernel, fused_mlp_vjp.py _mm): bias, ReLU and its masks, g_x, d_pts_enc,
d_view_enc stay float32, db sums the unrounded g_z, dW = bf16(x)^T bf16(g_z)
and g_x = bf16(g_z) bf16(W)^T. The plain versions compute a bf16 product as
x.to(bf16).float() @ w.to(bf16).float(), which is exact in float32 (never a
bf16 matmul, whose CPU kernel rounds its output to bf16).

  - `fused_mlp_forward_plain` is the eager chain.
  - `fused_mlp_backward_plain` is K2's algorithm in torch, not autograd:
    recompute the forward keeping each layer's input, take the ReLU masks
    from the next layer's input > 0, split the skip and view segments.
  - `pack_fragments_plain` is the 3xTF32 fragment layout (and `k_pack` its
    kernel): per layer, per (k-step of 8, n-tile), per lane, the mma.sync B
    operand as the float4 {hi(b0), hi(b1), lo(b0), lo(b1)}, hi = TF32
    round-to-nearest of the weight, lo = the exact rest; the input dimension
    padded per segment, and the outputs, to 8, zeros in the padding.
  - `wg_layout` is fused_mlp_wgmma.cu's build_wg_desc in Python (its plan,
    layer rows, padded input columns, workspace columns); `wgmma_layout_plain` the
    bf16 weight layouts its TMA maps read (and `k_wg_layout` its kernel),
    `unpack_wgmma_layout` the way back; `bf16_workspace_plain` what K2's
    first pass stores at bf16: every layer's input X and g_z in bf16 (the
    operands of dW), the ReLU masks as each thread's bits
    (`relu_mask_words_plain`), and per 64 points (a warpgroup's rows) the
    column sums of the fp32 g_z (db's partials).
  - `tf32wg_layout` is fused_mlp_wgmma.cu's build_tf_desc in Python (None
    where the float32 wgmma K2 does not take the chain); `tf32wg_weights_plain`
    the weights' hi / lo layouts its TMA maps read (`k_tf_layout` its kernel);
    `tf32wg_workspace_plain` what its first pass stores for the dW pass:
    every layer's input and every g_z as rows, each row point-contiguous,
    and the ReLU mask words.
  - `pack_weights` lays the weights out for K3 once per call
    (`PackedWeights`, the 3xTF32 fragments; `WgPackedWeights`, the bf16
    forward layout); `fused_mlp_forward_packed_plain` is the eager chain on
    them.
  - `FusedMLPFunction` launches K1 in forward (saving only the inputs and the
    weights) and K2 in backward. For a CUDA tensor it launches the kernel or
    raises (a chain past the kernels' widths raises ValueError before any
    launch); the plain versions are taken only for CPU tensors.
  - `nerf_apply_fused` takes K1/K2 when autograd will ask for a gradient,
    K3 otherwise.
  - The tracer's counters `launch.K1` / `launch.K2` / `launch.K3` count kernel
    launches (not plain calls) of the float32 (3xTF32) variants, `launch.pack`
    pack_weights' layout kernel; `launch.<kernel>.bf16` the bf16 variants';
    `launch.K2.tf32wg` the float32 K2's launches on wgmma (also in
    `launch.K2`).
    `reset_launch_counts` / `launch_counts` set them to 0 and read them.
  - Spans (utils/tracing.py): `mlp.forward` over nerf_apply_fused and
    `mlp.backward` over FusedMLPFunction.backward, with `mlp.encode` (the
    encodings), `mlp.pack` (pack_weights) and `mlp.launch` (the kernels'
    host side) inside.

PE, the density activation and the sigmoid stay outside, in torch. The
choice between this op and models/nerf_mlp.nerf_apply (torch ops,
cfg.tpu.use_pallas=False) is the renderer's (RenderConfig.mlp_impl).
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from sparf_tpu_torch.models import nerf_mlp
from sparf_tpu_torch.models.nerf_mlp import MLPConfig
from sparf_tpu_torch.utils import tracing

_KERNELS = ("K1", "K2", "K3", "pack")


def _counter(kernel: str, bf16: bool) -> str:
    return f"launch.{kernel}{'.bf16' if bf16 else ''}"


def _counted(kernel: str, bf16: bool) -> None:
    """One launch of `kernel`'s float32 or bf16 variant."""
    tracing.count(_counter(kernel, bf16))


def reset_launch_counts() -> None:
    tracing.reset_counts("launch.")


def launch_counts(bf16: bool = False) -> Dict[str, int]:
    """{"K1", "K2", "K3", "pack"}: the launches of the float32 or the bf16 variants."""
    counted = tracing.counts()
    return {k: counted.get(_counter(k, bf16), 0) for k in _KERNELS}

K2_TILE = 128  # points per K2 tile (csrc/fused_mlp.cu kTile2)

_DESC_ERRORS = {
    -1: "between 1 and 16 layers with at least one trunk and one RGB layer",
    -2: ("at compute_dtype float32 (3xTF32): every layer at most 512 features (outputs, "
         "less the density unit) and pts_enc and view_enc at most 128 wide"),
    -3: "a chain whose widths match (layer 0 takes pts_enc, no skip at layer 0, 3 RGB outputs)",
    -4: "activations that fit the 227 KB of shared memory of one block",
    -5: "at least one point",
    -6: "TMA tensor maps of its operands (cuTensorMapEncodeTiled failed)",
    -7: ("at compute_dtype bfloat16 (wgmma): every layer at most 512 features (outputs, "
         "less the density unit) and pts_enc and view_enc at most 128 wide"),
}


@dataclass(frozen=True)
class FusedMeta:
    """Static shape of the chain the kernels run."""

    n_feat: int
    n_rgb: int
    skip: Tuple[int, ...]
    view_dep: bool
    d_in: int
    d_view: int
    bf16: bool = False  # compute_dtype bfloat16 (the bf16 variants of the kernels)

    @classmethod
    def from_cfg(cls, cfg: MLPConfig) -> "FusedMeta":
        return cls(len(cfg.layers_feat), len(cfg.layers_rgb), tuple(cfg.skip), cfg.view_dep,
                   cfg.input_3d_dim, cfg.input_view_dim, cfg.compute_dtype == torch.bfloat16)

    @property
    def dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.bf16 else torch.float32

    def dims(self, weights: Sequence[torch.Tensor]) -> List[int]:
        """[n_feat, n_rgb, d_in, d_view, view_dep, (out, in, skip) per layer]."""
        out = [self.n_feat, self.n_rgb, self.d_in, self.d_view, int(self.view_dep)]
        for li in range(self.n_feat + self.n_rgb):
            n_out, n_in = weights[2 * li].shape
            out += [int(n_out), int(n_in), int(li < self.n_feat and li in self.skip)]
        return out


def chain_dims(cfg: MLPConfig) -> List[int]:
    """FusedMeta.dims of the chain that cfg describes, without its weights."""
    feat, rgb = nerf_mlp.layer_dims(cfg)
    out = [len(feat), len(rgb), cfg.input_3d_dim, cfg.input_view_dim, int(cfg.view_dep)]
    for li, (n_out, n_in) in enumerate(feat + rgb):
        out += [n_out, n_in, int(li < len(feat) and li in cfg.skip)]
    return out


def flat_weights(params: Dict[str, Any]) -> List[torch.Tensor]:
    """[W0, b0, W1, b1, ...] over the trunk then the RGB head."""
    return [t for W, b in list(params["feat"]) + list(params["rgb"]) for t in (W, b)]


def _layers(dims: Sequence[int]):
    """Per layer (out, in, w1, w2, k1p, kp, np), as csrc/fused_mlp.cu build_desc:
    the input segments and the outputs padded to the MMA's k-step of 8."""
    n_feat, n_rgb, d_in, d_view, view_dep = dims[:5]
    pad = lambda x: -(-x // 8) * 8  # noqa: E731
    for li in range(n_feat + n_rgb):
        out, n_in, skip = dims[5 + 3 * li: 8 + 3 * li]
        w2 = d_in if skip else (d_view if li == n_feat and view_dep else 0)
        w1 = n_in - w2
        yield out, n_in, w1, w2, pad(w1), pad(w1) + pad(w2), pad(out)


@functools.lru_cache(maxsize=16)
def _fragment_sources(dims: Tuple[int, ...], transposed: bool) -> List[torch.Tensor]:
    """Per layer, for every element of its fragments, the flat index into W
    (out, in) of the weight behind it, or -1 in the padding. Fragment (ks, nt)
    of the B operand, lane (g, t) = (lane // 4, lane % 4), element c holds
    B[ks*8 + t + 4 (c % 2), nt*8 + g] (hi for c < 2, lo for c >= 2); B = W^T
    (rows over the padded input) for the forward, B = W for K2's g_x."""
    out = []
    for n_out, n_in, w1, w2, k1p, kp, n_pad in _layers(dims):
        KS, NT = (n_pad // 8, kp // 8) if transposed else (kp // 8, n_pad // 8)
        ks = torch.arange(KS).view(-1, 1, 1, 1)
        nt = torch.arange(NT).view(1, -1, 1, 1)
        lane = torch.arange(32).view(1, 1, -1, 1)
        c = torch.arange(4).view(1, 1, 1, -1)
        row = ks * 8 + lane % 4 + 4 * (c % 2)
        col = nt * 8 + lane // 4
        n, kpad = (row, col) if transposed else (col, row)
        k = torch.where(kpad < k1p, torch.where(kpad < w1, kpad, -1),
                        torch.where(kpad - k1p < w2, w1 + kpad - k1p, -1))
        out.append(torch.where((n < n_out) & (k >= 0), n * n_in + k, -1).reshape(-1))
    return out


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 -> nearest TF32 (10 mantissa bits, ties away from zero), as
    cvt.rna.tf32.f32: add half a unit of the 13 dropped bits, then mask them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def pack_fragments_plain(dims: Sequence[int], weights: Sequence[torch.Tensor],
                         transposed: bool = False) -> torch.Tensor:
    """The B fragments of every layer, one flat tensor (k_pack's plain
    version): hi = tf32_round(w) at c < 2, lo = w - hi at c >= 2 (exact; the
    tensor core reads its top 19 bits)."""
    parts = []
    for src, W in zip(_fragment_sources(tuple(dims), transposed), weights[::2]):
        src = src.to(W.device)
        w = torch.where(src >= 0, W.detach().reshape(-1)[src.clamp(min=0)], 0.0).view(-1, 4)
        hi = tf32_round(w)
        lo = w - hi
        parts.append(torch.cat([hi[:, :2], lo[:, 2:]], dim=1).reshape(-1))
    return torch.cat(parts)


def unpack_fragments(dims: Sequence[int], frag: torch.Tensor) -> List[torch.Tensor]:
    """Each layer's W (out, in) back from its forward fragments: hi + lo,
    exactly W."""
    Ws, ofs = [], 0
    for src, (n_out, n_in, *_) in zip(_fragment_sources(tuple(dims), False), _layers(dims)):
        f4 = frag[ofs: ofs + src.numel()].view(-1, 4)
        ofs += src.numel()
        src2 = src.to(frag.device).view(-1, 4)[:, :2].reshape(-1)
        vals = (f4[:, :2] + f4[:, 2:]).reshape(-1)
        W = f4.new_zeros(n_out * n_in)
        W[src2[src2 >= 0]] = vals[src2 >= 0]
        Ws.append(W.view(n_out, n_in))
    return Ws


@dataclass
class PackedWeights:
    """K3's operands at float32: the chain's dims, the flat 3xTF32 B
    fragments of every layer (forward) and the biases."""

    dims: Tuple[int, ...]
    frag: torch.Tensor
    biases: List[torch.Tensor]


@dataclass
class WgPackedWeights:
    """K3's operands at bfloat16: the chain's dims, wf (RF, KF) bf16, the
    forward weights the bf16 K3's TMA maps read, and bias_f (RF,) float32 in
    their row order."""

    dims: Tuple[int, ...]
    wf: torch.Tensor
    bias_f: torch.Tensor


def pack_weights(params: Dict[str, Any], meta: FusedMeta):
    """The weights laid out once for K3: at float32 as 3xTF32 fragments
    (PackedWeights; on a CUDA device by k_pack, on the CPU by
    pack_fragments_plain), at bfloat16 in the wgmma forward layout
    (WgPackedWeights; k_wg_layout, or wgmma_layout_plain, which raises
    ValueError for a chain the bf16 kernels do not take); the same bits
    either way."""
    weights = [w.detach().contiguous() for w in flat_weights(params)]
    if len(weights) != 2 * (meta.n_feat + meta.n_rgb):
        raise ValueError(f"pack_weights: {len(weights) // 2} layers, meta says "
                         f"{meta.n_feat} + {meta.n_rgb}")
    dims = tuple(meta.dims(weights))
    dev = weights[0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"pack_weights: no kernel for device {dev}")
    if meta.bf16:
        if dev.type == "cpu":
            wf, _, bias_f = wgmma_layout_plain(dims, weights, transposed=False)
        else:
            _check_operands(weights[0], weights[1], weights)
            wf, _, bias_f = wg_layout_kernel(dims, weights, transposed=False)
            _counted("pack", True)
        return WgPackedWeights(dims, wf, bias_f)
    if dev.type == "cpu":
        frag = pack_fragments_plain(dims, weights)
    else:
        from sparf_tpu_torch.ops._build import entry, load_library

        _check_operands(weights[0], weights[1], weights)
        lib = load_library()
        c_dims = (ctypes.c_int * len(dims))(*dims)
        frag = torch.empty(_sizes(lib, c_dims, "pack_weights")[1], device=dev)
        rc = entry(lib, "pack")(c_dims, _ptrs(weights), frag.data_ptr(), None,
                                torch.cuda.current_stream(dev).cuda_stream)
        _raise_rc(lib, rc, "pack_weights (fragment packing)")
        _counted("pack", False)
    return PackedWeights(dims, frag, weights[1::2])


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _forward_chain(meta: FusedMeta, pts_enc, view_enc, weights):
    """Forward keeping every layer's input (float32, unrounded); returns
    (raw_density, raw_rgb, xs)."""
    xs = []
    feat = pts_enc
    raw_density = raw_rgb = None
    for li in range(meta.n_feat):
        W, b = weights[2 * li], weights[2 * li + 1]
        x = torch.cat([feat, pts_enc], dim=-1) if li in meta.skip else feat
        xs.append(x)
        z = nerf_mlp.linear(x, W, b, meta.dtype)
        if li == meta.n_feat - 1:
            raw_density = z[:, 0]
            feat = F.relu(z[:, 1:])
        else:
            feat = F.relu(z)
    if meta.view_dep:
        feat = torch.cat([feat, view_enc], dim=-1)
    for lr in range(meta.n_rgb):
        li = meta.n_feat + lr
        W, b = weights[2 * li], weights[2 * li + 1]
        xs.append(feat)
        z = nerf_mlp.linear(feat, W, b, meta.dtype)
        if lr == meta.n_rgb - 1:
            raw_rgb = z[:, :3]
        else:
            feat = F.relu(z)
    return raw_density, raw_rgb, xs


def fused_mlp_forward_plain(meta: FusedMeta, pts_enc: torch.Tensor, view_enc: torch.Tensor,
                            weights: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """(raw_density (T,), raw_rgb (T,3)) by the eager chain."""
    raw_density, raw_rgb, _ = _forward_chain(meta, pts_enc, view_enc, weights)
    return raw_density, raw_rgb


def fused_mlp_forward_packed_plain(meta: FusedMeta, pts_enc: torch.Tensor,
                                   view_enc: torch.Tensor, packed
                                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3's plain version: the eager chain on pack_weights' operands (each W
    as the hi + lo of its fragments, or as read back from the bf16 forward
    layout)."""
    if isinstance(packed, WgPackedWeights):
        weights = [t for layer in unpack_wgmma_layout(packed.dims, packed.wf, bias_f=packed.bias_f)
                   for t in layer]
    else:
        Ws = unpack_fragments(packed.dims, packed.frag)
        weights = [t for W, b in zip(Ws, packed.biases) for t in (W, b)]
    raw_density, raw_rgb, _ = _forward_chain(meta, pts_enc, view_enc, weights)
    return raw_density, raw_rgb


def fused_mlp_backward_plain(meta: FusedMeta, pts_enc: torch.Tensor, view_enc: torch.Tensor,
                             weights: Sequence[torch.Tensor], g_density: torch.Tensor,
                             g_rgb: torch.Tensor, g_zs: Optional[List[torch.Tensor]] = None):
    """K2's algorithm in torch: (d_pts (T,d_in), d_view (T,d_view), [dW0, db0, ...]).
    Under bf16 each product rounds its operands (dW = bf16(g_z)^T bf16(x),
    g_x = bf16(g_z) bf16(W)) and db sums the unrounded g_z. `g_zs` (a list)
    receives each layer's g_z (fp32), first layer first."""
    n_layers = meta.n_feat + meta.n_rgb
    rnd = functools.partial(nerf_mlp.round_to, dtype=meta.dtype)
    with torch.no_grad():
        _, _, xs = _forward_chain(meta, pts_enc, view_enc, weights)
        feat_dim = weights[2 * meta.n_feat - 2].shape[0] - 1
        grads: List[Optional[torch.Tensor]] = [None] * (2 * n_layers)
        d_pts = torch.zeros_like(pts_enc)
        d_view = torch.zeros_like(view_enc)

        def mask_into(li):
            """ReLU mask of the previous layer = (feature part of layer li's input) > 0."""
            x = xs[li]
            if li < meta.n_feat and li in meta.skip:
                return x[:, : x.shape[1] - meta.d_in] > 0
            if li == meta.n_feat and meta.view_dep:
                return x[:, :feat_dim] > 0
            return x > 0

        g_z = g_rgb
        per_layer = [None] * n_layers
        for li in range(n_layers - 1, -1, -1):
            per_layer[li] = g_z
            x, W = xs[li], weights[2 * li]
            grads[2 * li] = rnd(g_z).t() @ rnd(x)
            grads[2 * li + 1] = g_z.sum(0)
            g_x = rnd(g_z) @ rnd(W)
            if li == meta.n_feat:
                if meta.view_dep:
                    d_view = g_x[:, feat_dim:]
                g_z = torch.cat([g_density[:, None], g_x[:, :feat_dim] * mask_into(li)], dim=-1)
            elif li > 0 and li in meta.skip and li < meta.n_feat:
                prev = x.shape[1] - meta.d_in
                d_pts = d_pts + g_x[:, prev:]
                g_z = g_x[:, :prev] * mask_into(li)
            elif li > 0:
                g_z = g_x * mask_into(li)
            else:
                d_pts = d_pts + g_x
    if g_zs is not None:
        g_zs.extend(per_layer)
    return d_pts, d_view, grads


# ---------------------------------------------------------------------------
# the bf16 K1 / K2 layouts (csrc/fused_mlp_wgmma.cu), plain
# ---------------------------------------------------------------------------

_WG_BOX = (8, 32, 64, 128, 256)  # plan M's TMA box heights: the forward products' N
WG_TILE = 128  # points per tile of the bf16 K1 / K2 in plan M; the workspace's row multiple
_WG_SMEM = 232448  # a block's shared memory on an H100


@dataclass(frozen=True)
class WgLayer:
    """One layer as fused_mlp_wgmma.cu runs it. Its rows: the outputs, but at
    the last trunk layer (dens) the features first (rows 0 .. out-2) and the
    density unit at row nm; the padded input: segment 1 at 0 .. w1, padded
    to k1p (a multiple of 64), segment 2 at k1p .. k1p + w2, padded to kp.
    nx: a warpgroup's share of g_x over the features (plan M k1p, plan N
    k1p / 2)."""

    out: int
    n_in: int
    w1: int
    w2: int
    k1p: int
    kp: int
    dens: bool
    nm: int  # the forward product's N (rows of the forward weights, + 8 at dens)
    kz: int  # g_z columns: rows padded to 64
    rf: int  # first row in the forward weights
    rt: int  # first row in the transposed weights
    xo: int  # first column of X in the workspace
    go: int  # first column of g_z in the workspace
    nx: int

    def units(self, n_rows: int) -> torch.Tensor:
        """The output unit of each of the first n_rows rows, -1 in padding."""
        r = torch.arange(n_rows)
        if self.dens:
            return torch.where(r < self.out - 1, r + 1,
                               torch.where(r == self.nm, 0, -1))
        return torch.where(r < self.out, r, -1)

    def inputs(self) -> torch.Tensor:
        return _padded_inputs(self.kp, self.k1p, self.w1, self.w2)


def _padded_inputs(kp: int, k1p: int, w1: int, w2: int) -> torch.Tensor:
    """The input index of each of kp padded input columns ([segment 1 | pad
    to k1p | segment 2 | pad]), -1 in padding."""
    k = torch.arange(kp)
    return torch.where(k < k1p, torch.where(k < w1, k, -1),
                       torch.where(k - k1p < w2, w1 + k - k1p, -1))


@dataclass(frozen=True)
class WgLayout:
    layers: Tuple[WgLayer, ...]
    RF: int  # forward weights RF x KF
    KF: int
    RT: int  # transposed weights RT x KT
    KT: int
    KX: int  # workspace columns per point: stored inputs, g_z
    KG: int
    tile: int = WG_TILE  # points per block: 128 (plan M) or 64 (plan N)


def _wg_plan(dims: Tuple[int, ...], split: bool):
    """csrc/fused_mlp_wgmma.cu layout_wg_desc: the layout of plan M (split
    False: 128-point tiles, every product's full width per warpgroup) or
    plan N (64-point tiles, each warpgroup half of every product), "width"
    where the plan does not take the chain, "bad" where its widths do not
    match."""
    n_feat, n_rgb, d_in, d_view, view_dep = dims[:5]
    n_layers = n_feat + n_rgb
    pad = lambda x: -(-x // 64) * 64  # noqa: E731
    max_enc = 128 if split else 64
    if not (1 <= d_in <= max_enc and 0 <= d_view <= max_enc):
        return "width"
    layers, RF, RT, KX, KG, KF, KT = [], 0, 0, 0, 0, 64, 64
    feat_chunks, max_kz = 1, 64
    for li, (out, n_in, w1, w2, *_) in enumerate(_layers(dims)):
        dens = li == n_feat - 1
        skip = dims[7 + 3 * li]
        if (out < 1 + dens or w1 < 1 or (li == 0 and (skip or w1 != d_in))
                or (li > 0 and layers[-1].out - layers[-1].dens != w1)):
            return "bad"
        k1p = pad(w1)
        if split:
            if out - dens > 512 or k1p > 512:
                return "width"
            nm = 2 * (8 if li == n_layers - 1 else pad(out - dens) // 2)
        else:
            # the density row at nm, past the next layer's padded input
            nm = next((h for h in _WG_BOX if h >= max(out - dens, 64 if dens else 1)), None)
            if nm is None or k1p not in (64, 128, 256):
                return "width"
        kz = pad(nm + 8 if dens else out)
        if kz > (576 if split else 320):
            return "width"
        kp = k1p + pad(w2)
        layers.append(WgLayer(out, n_in, w1, w2, k1p, kp, dens, nm, kz, RF, RT, KX, KG,
                              k1p // 2 if split else k1p))
        if li > 0:
            feat_chunks = max(feat_chunks, k1p // 64)
        max_kz = max(max_kz, kz)
        RF += nm + (8 if dens else 0)
        RT += kp
        KX += kp
        KG += kz
        KF, KT = max(KF, kp), max(KT, kz)
    if layers[-1].out != 3:
        return "bad"
    if split:
        n_act = feat_chunks + pad(d_in) // 64 + pad(d_view) // 64
        smem = n_act * 8192 + 3 * (256 + 8) * 128 + 8 * 576 * 4 + 3 * 3 * 8 + 1024
        if max_kz // 64 > n_act or smem > _WG_SMEM:
            return "width"
    return WgLayout(tuple(layers), RF, KF, RT, KT, KX, KG, 64 if split else WG_TILE)


@functools.lru_cache(maxsize=16)
def wg_layout(dims: Tuple[int, ...]) -> WgLayout:
    """csrc/fused_mlp_wgmma.cu build_wg_desc: plan M where it takes the chain,
    else plan N; raises ValueError for a chain its kernels do not take."""
    n_feat, n_rgb = dims[:2]
    if n_feat < 1 or n_rgb < 1 or n_feat + n_rgb > 16:
        raise ValueError(_DESC_ERRORS[-1])
    for split in (False, True):
        lay = _wg_plan(tuple(dims), split)
        if isinstance(lay, WgLayout):
            return lay
        if lay == "bad":
            raise ValueError(_DESC_ERRORS[-3])
    raise ValueError(_DESC_ERRORS[-7])


def _block(W: torch.Tensor, units: torch.Tensor, inputs: torch.Tensor) -> torch.Tensor:
    """W (out, in) at (row, column): W[unit of the row][input of the column],
    zeros where either is -1."""
    u, i = units.to(W.device), inputs.to(W.device)
    block = W.detach()[u.clamp(min=0)][:, i.clamp(min=0)]
    return torch.where((u[:, None] >= 0) & (i[None, :] >= 0), block, torch.zeros_like(block))


def _wg_block(L: WgLayer, W: torch.Tensor, n_rows: int) -> torch.Tensor:
    """W (out, in) at (layer row, padded input column), zeros in padding."""
    return _block(W, L.units(n_rows), L.inputs())


def wgmma_layout_plain(dims: Sequence[int], weights: Sequence[torch.Tensor],
                       transposed: bool = True):
    """The bf16 kernels' weights (k_wg_layout's plain version): (wf (RF, KF)
    bf16, the forward B operands, rows = layer rows, columns = padded inputs;
    wt (RT, KT) bf16, g_x's, rows = padded inputs, columns = layer rows (None
    without `transposed`: K1 and K3 read only wf); bias_f (RF,) fp32 in the
    forward row order); bf16 rounded to nearest even, zeros in the padding."""
    lay = wg_layout(tuple(dims))
    dev = weights[0].device
    wf = torch.zeros((lay.RF, lay.KF), device=dev)
    wt = torch.zeros((lay.RT, lay.KT), device=dev) if transposed else None
    bias = torch.zeros(lay.RF, device=dev)
    for L, W, b in zip(lay.layers, weights[::2], weights[1::2]):
        n_rows = L.nm + (8 if L.dens else 0)
        wf[L.rf: L.rf + n_rows, : L.kp] = _wg_block(L, W, n_rows)
        if transposed:
            wt[L.rt: L.rt + L.kp, : L.kz] = _wg_block(L, W, L.kz).t()
        u = L.units(n_rows).to(dev)
        bias[L.rf: L.rf + n_rows] = torch.where(u >= 0, b.detach()[u.clamp(min=0)], 0.0)
    return wf.to(torch.bfloat16), wt.to(torch.bfloat16) if transposed else None, bias


def unpack_wgmma_layout(dims: Sequence[int], wf: torch.Tensor, wt: Optional[torch.Tensor] = None,
                        bias_f: Optional[torch.Tensor] = None) -> List[List[torch.Tensor]]:
    """Per layer, W (out, in) as float32 read back from wf, from wt (if given)
    and b from bias_f (if given): each an exact copy of the bf16-rounded W
    (and of b) when the layouts are right."""
    lay = wg_layout(tuple(dims))
    outs = []
    for L in lay.layers:
        n_rows = L.nm + (8 if L.dens else 0)
        got = []
        sources = [(wf[L.rf: L.rf + n_rows, : L.kp].float(), n_rows)]
        if wt is not None:
            sources.append((wt[L.rt: L.rt + L.kp, : L.kz].float().t(), L.kz))
        for block, rows in sources:
            u, i = L.units(rows).to(block.device), L.inputs().to(block.device)
            W = block.new_zeros((L.out, L.n_in))
            W[u[u >= 0][:, None], i[i >= 0][None, :]] = block[u >= 0][:, i >= 0]
            got.append(W)
        if bias_f is not None:
            u = L.units(n_rows).to(bias_f.device)
            b = bias_f.new_zeros(L.out)
            b[u[u >= 0]] = bias_f[L.rf: L.rf + n_rows][u >= 0]
            got.append(b)
        outs.append(got)
    return outs


def _fragment_index(n_rows: int, device=None, half: Optional[int] = None):
    """For the bf16 K2's mask words: per row and column, the consumer thread
    that holds it in the wgmma accumulator fragment, and its bit (word,
    position). Plan M (half None; columns < 256): thread = 128 wg + 32 w + 4
    g + t holds rows 64 wg + 16 w + g + 8 h of a 128-point tile and columns 8
    j + 2 t + e at bit 4 (j % 8) + 2 h + e of word j // 8. Plan N (columns <
    2 half): warpgroup wg holds columns wg half + 8 j + 2 t + e of rows 16 w
    + g + 8 h of a 64-point tile."""
    if half is None:
        r = torch.arange(n_rows, device=device)[:, None] % WG_TILE
        c = torch.arange(256, device=device)[None, :]
        wg, cl = r // 64, c
    else:
        r = torch.arange(n_rows, device=device)[:, None] % 64
        c = torch.arange(2 * half, device=device)[None, :]
        wg, cl = c // half, c % half
    w, g, h = (r % 64) // 16, r % 8, (r % 16) // 8
    j, t, e = cl // 8, (cl % 8) // 2, cl % 2
    thread = 128 * wg + 32 * w + 4 * g + t
    return thread, j // 8, 4 * (j % 8) + 2 * h + e


def relu_mask_words_plain(x: torch.Tensor, half: Optional[int] = None) -> torch.Tensor:
    """The bf16 K2's ReLU mask words of one layer's input features x (T,
    width, the float32 ReLU outputs): (T_pad / tile, 256, 4) int32, bit set
    where x > 0 (csrc fused_mlp_wgmma.cu mask_bit); plan M (width <= 256,
    128-point tiles), or plan N with each warpgroup `half` of the columns
    (64-point tiles)."""
    T, width = x.shape
    tile = WG_TILE if half is None else 64
    n_cols = 256 if half is None else 2 * half
    n_tiles = -(-T // tile)
    m = torch.zeros((n_tiles * tile, n_cols), dtype=torch.int64, device=x.device)
    m[:T, :width] = (x > 0).long()
    thread, word, bit = _fragment_index(n_tiles * tile, x.device, half)
    block = torch.arange(n_tiles * tile, device=x.device)[:, None] // tile
    flat = ((block * 256 + thread) * 4 + word).expand(-1, n_cols).reshape(-1)
    words = torch.zeros(n_tiles * 256 * 4, dtype=torch.int64, device=x.device)
    words.index_add_(0, flat, (m << bit).reshape(-1))
    return (words - (words >= 2 ** 31).long() * 2 ** 32).to(torch.int32).view(n_tiles, 256, 4)


def relu_mask_from_words(words: torch.Tensor, T: int, width: int,
                         half: Optional[int] = None) -> torch.Tensor:
    """relu_mask_words_plain's way back: the (T, width) bool mask."""
    tile = WG_TILE if half is None else 64
    n_tiles = words.shape[0]
    thread, word, bit = _fragment_index(n_tiles * tile, words.device, half)
    block = torch.arange(n_tiles * tile, device=words.device)[:, None] // tile
    w = words.long().view(-1)[(block * 256 + thread) * 4 + word] & 0xFFFFFFFF
    return ((w >> bit) & 1).bool()[:T, :width]


def bf16_workspace_plain(meta: FusedMeta, pts_enc: torch.Tensor, view_enc: torch.Tensor,
                         weights: Sequence[torch.Tensor], g_density: torch.Tensor,
                         g_rgb: torch.Tensor):
    """What the bf16 K2's first pass (k2_wg) stores, plain: (X (T_pad, KX)
    bf16: every layer's input, its segments at the layer's padded columns;
    G (T_pad, KG) bf16: every layer's g_z at its rows (WgLayer); masks
    (n_layers, T_pad / tile, 256, 4) int32: per layer the ReLU mask words of
    its input features (relu_mask_words_plain; layer 0's, pts_enc, unused
    and 0); db_part (T_pad / 64, KG) fp32: per 64 points the column sums of
    the unrounded g_z). T_pad = T rounded up to 128 (either plan); the
    padded points hold zeros here (the kernel's X and masks hold their
    activations, whose g_z is 0)."""
    dims = meta.dims(weights)
    lay = wg_layout(tuple(dims))
    T = pts_enc.shape[0]
    n_tiles = -(-T // WG_TILE)
    x_rows = n_tiles * WG_TILE
    split = lay.tile != WG_TILE
    g_zs: List[torch.Tensor] = []
    with torch.no_grad():
        _, _, xs = _forward_chain(meta, pts_enc, view_enc, weights)
        fused_mlp_backward_plain(meta, pts_enc, view_enc, weights, g_density, g_rgb, g_zs=g_zs)
    dev = pts_enc.device
    X = torch.zeros((x_rows, lay.KX), dtype=torch.bfloat16, device=dev)
    G = torch.zeros((x_rows, lay.KG), dtype=torch.bfloat16, device=dev)
    db = torch.zeros((x_rows, lay.KG), device=dev)
    masks = torch.zeros((len(lay.layers), x_rows // lay.tile, 256, 4), dtype=torch.int32,
                        device=dev)
    for li, (L, x, g) in enumerate(zip(lay.layers, xs, g_zs)):
        X[:T, L.xo: L.xo + L.w1] = x[:, : L.w1].to(torch.bfloat16)
        X[:T, L.xo + L.k1p: L.xo + L.k1p + L.w2] = x[:, L.w1:].to(torch.bfloat16)
        if li > 0:
            words = relu_mask_words_plain(x[:, : L.w1], L.nx if split else None)
            masks[li, : words.shape[0]] = words
        u = L.units(L.kz).to(dev)
        cols = L.go + torch.nonzero(u >= 0).reshape(-1)
        G[:T, cols] = g[:, u[u >= 0]].to(torch.bfloat16)
        db[:T, cols] = g[:, u[u >= 0]]
    return X, G, masks, db.view(2 * n_tiles, WG_TILE // 2, lay.KG).sum(dim=1)


# ---------------------------------------------------------------------------
# the float32 K2 on wgmma (csrc/fused_mlp_wgmma.cu k2_tf, k2_dw_tf), plain
# ---------------------------------------------------------------------------

K2_TF32WG = "launch.K2.tf32wg"  # counted once per launch of the float32 K2 on wgmma


@dataclass(frozen=True)
class TfLayer:
    """One layer as the float32 wgmma K2 runs it. Its padded input: segment 1
    at 0 .. w1, padded to k1p (64, 128 or 256), segment 2 at k1p .. k1p +
    w2, padded to 32 (c2). nm: the forward product's N, the features (the
    outputs, less the density unit) padded to 64 (0 at the last layer,
    which the recompute skips); kz: g_x's K, g_z's columns: the features,
    and at the last trunk layer (dens) the density unit at column nm, padded
    to 32; mz: dW's rows, the outputs padded to 64. rf / rt: first row in the
    forward / transposed weights; x1 / x2: the workspace rows of X's
    segments (x2 -1: none); go: of g_z, the outputs in order but the density
    unit last."""

    out: int
    n_in: int
    w1: int
    w2: int
    k1p: int
    c2: int
    kp: int
    dens: bool
    nm: int
    kz: int
    mz: int
    rf: int
    rt: int
    x1: int
    x2: int
    go: int

    def inputs(self) -> torch.Tensor:
        return _padded_inputs(self.kp, self.k1p, self.w1, self.w2)

    def forward_units(self) -> torch.Tensor:
        """The output unit of each forward row (nm of them), -1 in padding."""
        r = torch.arange(self.nm)
        return torch.where(r < self.out - self.dens, r + int(self.dens), -1)

    def gz_units(self) -> torch.Tensor:
        """The output unit of each g_z column (kz of them), -1 in padding."""
        c = torch.arange(self.kz)
        feat = torch.where(c < self.out - self.dens, c + int(self.dens), -1)
        return torch.where((c == self.nm) & self.dens, 0, feat)

    def dw_units(self) -> torch.Tensor:
        """The output unit of each dW row (mz) and G row: the density unit last."""
        r = torch.arange(self.mz)
        if self.dens:
            return torch.where(r < self.out - 1, r + 1, torch.where(r == self.out - 1, 0, -1))
        return torch.where(r < self.out, r, -1)


@dataclass(frozen=True)
class TfLayout:
    layers: Tuple[TfLayer, ...]
    RF: int  # forward weights: 2 RF rows (hi, then lo) x KF
    KF: int
    RT: int  # transposed weights: 2 RT rows x KT
    KT: int
    NX: int  # workspace rows: X NX, G NG; each row T_pad points
    NG: int


@functools.lru_cache(maxsize=16)
def tf32wg_layout(dims: Tuple[int, ...]) -> Optional[TfLayout]:
    """csrc/fused_mlp_wgmma.cu build_tf_desc: the float32 wgmma K2's layout
    where it takes the chain (pts_enc and view_enc at most 64 wide, every
    layer's first input segment padded to 64, 128 or 256: the bf16 plan M's
    chains), None where fused_mlp.cu's K2 runs it; ValueError for a chain
    whose widths do not match."""
    n_feat, n_rgb, d_in, d_view, view_dep = dims[:5]
    n_layers = n_feat + n_rgb
    if n_feat < 1 or n_rgb < 1 or n_layers > 16:
        raise ValueError(_DESC_ERRORS[-1])
    pad64 = lambda x: -(-x // 64) * 64  # noqa: E731
    pad32 = lambda x: -(-x // 32) * 32  # noqa: E731
    take = 1 <= d_in <= 64 and 0 <= d_view <= 64
    layers: List[TfLayer] = []
    RF = RT = NG = 0
    KF = KT = 32
    xf = d_in + d_view
    for li, (out, n_in, w1, w2, *_) in enumerate(_layers(dims)):
        dens, last, skip = li == n_feat - 1, li == n_layers - 1, dims[7 + 3 * li]
        if (out < 1 + dens or w1 < 1 or (li == 0 and (skip or w1 != d_in))
                or (li > 0 and layers[-1].out - layers[-1].dens != w1)):
            raise ValueError(_DESC_ERRORS[-3])
        k1p = pad64(w1)
        take = take and k1p in (64, 128, 256)
        c2 = pad32(w2)
        nm = 0 if last else pad64(out - dens)
        kz = pad32(out) if last else nm + (32 if dens else 0)
        layers.append(TfLayer(out, n_in, w1, w2, k1p, c2, k1p + c2, dens, nm, kz, pad64(out), RF,
                              RT, 0 if li == 0 else xf, -1 if w2 == 0 else (0 if skip else d_in),
                              NG))
        xf += w1 if li > 0 else 0
        RF, RT, NG = RF + nm, RT + k1p + c2, NG + out
        KF = KF if last else max(KF, k1p + c2)
        KT = max(KT, kz)
    if layers[-1].out != 3:
        raise ValueError(_DESC_ERRORS[-3])
    return TfLayout(tuple(layers), RF, KF, RT, KT, xf, NG) if take else None


def _hi_lo(x: torch.Tensor) -> torch.Tensor:
    """[hi; lo] along the rows: hi = tf32_round(x), lo = x - hi (exact)."""
    hi = tf32_round(x)
    return torch.cat([hi, x - hi])


def tf32wg_weights_plain(dims: Sequence[int], weights: Sequence[torch.Tensor]):
    """The float32 wgmma K2's weights (k_tf_layout's plain version): (wf (2
    RF, KF): the forward B operands, rows the layers' features, columns the
    padded inputs; wt (2 RT, KT): g_x's, rows the padded inputs, columns
    g_z's; each the TF32 hi rows, then the lo rows; bias_f (RF,) in the
    forward row order); zeros in the padding."""
    lay = tf32wg_layout(tuple(dims))
    if lay is None:
        raise ValueError("the float32 wgmma K2 does not take this chain")
    dev = weights[0].device
    wf = torch.zeros((lay.RF, lay.KF), device=dev)
    wt = torch.zeros((lay.RT, lay.KT), device=dev)
    bias = torch.zeros(lay.RF, device=dev)
    for L, W, b in zip(lay.layers, weights[::2], weights[1::2]):
        if L.nm:
            u = L.forward_units()
            wf[L.rf: L.rf + L.nm, : L.kp] = _block(W, u, L.inputs())
            bias[L.rf: L.rf + L.nm] = torch.where(u.to(dev) >= 0, b.detach()[u.clamp(min=0)], 0.0)
        wt[L.rt: L.rt + L.kp, : L.kz] = _block(W, L.gz_units(), L.inputs()).t()
    return _hi_lo(wf), _hi_lo(wt), bias


def tf32wg_workspace_plain(meta: FusedMeta, pts_enc: torch.Tensor, view_enc: torch.Tensor,
                           weights: Sequence[torch.Tensor], g_density: torch.Tensor,
                           g_rgb: torch.Tensor):
    """What the float32 wgmma K2's first pass (k2_tf) stores, plain: (X (NX,
    T_pad): every layer's input, a row per input column and point-contiguous
    (pts_enc's and view_enc's rows once, then each layer's features): the dW
    pass's B operand, which it splits into TF32 hi and lo; G (NG, T_pad):
    every layer's g_z, a row per output (the density unit last): its A
    operand; masks (n_layers, T_pad / 128, 256, 4) int32: per layer the ReLU
    mask words of its input features (relu_mask_words_plain; layer 0's
    unused, 0)). T_pad = T rounded up to 128; the padded points hold zeros
    here (the kernel's X and masks hold their activations, whose g_z is 0)."""
    lay = tf32wg_layout(tuple(meta.dims(weights)))
    if lay is None:
        raise ValueError("the float32 wgmma K2 does not take this chain")
    T, dev = pts_enc.shape[0], pts_enc.device
    x_rows = -(-T // WG_TILE) * WG_TILE
    g_zs: List[torch.Tensor] = []
    with torch.no_grad():
        _, _, xs = _forward_chain(meta, pts_enc, view_enc, weights)
        fused_mlp_backward_plain(meta, pts_enc, view_enc, weights, g_density, g_rgb, g_zs=g_zs)
    X = torch.zeros((lay.NX, x_rows), device=dev)
    G = torch.zeros((lay.NG, x_rows), device=dev)
    masks = torch.zeros((len(lay.layers), x_rows // WG_TILE, 256, 4), dtype=torch.int32,
                        device=dev)
    X[: meta.d_in, :T] = pts_enc.t()
    X[meta.d_in: meta.d_in + meta.d_view, :T] = view_enc.t()
    for li, (L, x, g) in enumerate(zip(lay.layers, xs, g_zs)):
        if li > 0:
            X[L.x1: L.x1 + L.w1, :T] = x[:, : L.w1].t()
            masks[li] = relu_mask_words_plain(x[:, : L.w1])
        u = L.dw_units()[: L.out].to(dev)
        G[L.go: L.go + L.out, :T] = g[:, u].t()
    return X, G, masks


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------


def _check_operands(pts_enc, view_enc, weights, *extra):
    """Every operand float32 (whatever the compute dtype), contiguous, on one device."""
    dev = pts_enc.device
    for t in (pts_enc, view_enc, *weights, *extra):
        if t.device != dev:
            raise ValueError(f"fused MLP operands on {t.device} and {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"fused MLP kernels take float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("fused MLP kernels take contiguous tensors")


def _raise_rc(lib, rc: int, which: str):
    if rc < 0:
        hint = ("; cfg.tpu.use_pallas=False runs the MLP in torch ops (nerf_mlp.nerf_apply)"
                if rc in (-2, -4, -7) else "")
        raise ValueError(f"{which}: the kernels take {_DESC_ERRORS.get(rc, 'rc=%d' % rc)}{hint}")
    if rc > 0:
        raise RuntimeError(f"{which} launch failed: {lib.sparf_cuda_error_string(rc).decode()}")


def _ptrs(weights):
    return (ctypes.c_void_p * len(weights))(*[w.data_ptr() for w in weights])


def _dims(meta, weights):
    dims = meta.dims(weights)
    return (ctypes.c_int * len(dims))(*dims)


def _sizes(lib, dims, which: str) -> List[int]:
    """[n_params, n_frag_elems, n_part, x_total, g_total, n_splits, tile] of
    the 3xTF32 kernels (csrc sparf_fused_mlp_sizes_tf32; tile: the points of
    one block, 64 in the wide plan)."""
    sizes = (ctypes.c_int * 7)()
    from sparf_tpu_torch.ops._build import entry

    _raise_rc(lib, entry(lib, "sizes")(dims, sizes), which)
    return list(sizes)


def _wg_sizes(lib, dims, which: str) -> List[int]:
    """[n_params, wf elements, wt elements, RF, KX, KG, n_part, n_splits, tile]
    of the bf16 kernels (csrc sparf_fused_mlp_wg_sizes)."""
    from sparf_tpu_torch.ops._build import wg_entry

    sizes = (ctypes.c_int * 9)()
    _raise_rc(lib, wg_entry(lib, "sizes")(dims, sizes), which)
    return list(sizes)


def wg_layout_kernel(dims: Sequence[int], weights: Sequence[torch.Tensor],
                     transposed: bool = True):
    """k_wg_layout on the card: (wf, wt, bias_f) as wgmma_layout_plain (wt
    None without `transposed`)."""
    from sparf_tpu_torch.ops._build import load_library, wg_entry

    lib = load_library()
    c_dims = (ctypes.c_int * len(dims))(*dims)
    sizes = _wg_sizes(lib, c_dims, "k_wg_layout")
    dev = weights[0].device
    wf = torch.empty(sizes[1], dtype=torch.bfloat16, device=dev)
    wt = torch.empty(sizes[2], dtype=torch.bfloat16, device=dev) if transposed else None
    bias_f = torch.empty(sizes[3], dtype=torch.float32, device=dev)
    rc = wg_entry(lib, "layout")(c_dims, _ptrs(weights), wf.data_ptr(),
                                 wt.data_ptr() if transposed else None, bias_f.data_ptr(),
                                 torch.cuda.current_stream(dev).cuda_stream)
    _raise_rc(lib, rc, "k_wg_layout")
    return (wf.view(-1, sizes[1] // sizes[3]),
            wt.view(-1, wg_layout(tuple(dims)).KT) if transposed else None, bias_f)


def _launch_k1_wg(meta: FusedMeta, pts_enc, view_enc, weights):
    """K1 at bf16 (fused_mlp_wgmma.cu): lays out the weights (k_wg_layout),
    then the wgmma forward (k1_wg)."""
    from sparf_tpu_torch.ops._build import load_library, wg_entry

    lib = load_library()
    T, dev = pts_enc.shape[0], pts_enc.device
    dims = _dims(meta, weights)
    sizes = _wg_sizes(lib, dims, "K1 (fused MLP forward, bf16)")
    wf = torch.empty(sizes[1], dtype=torch.bfloat16, device=dev)
    bias_f = torch.empty(sizes[3], dtype=torch.float32, device=dev)
    out = torch.empty((T, 4), dtype=torch.float32, device=dev)
    rc = wg_entry(lib, "forward")(pts_enc.data_ptr(), view_enc.data_ptr(), out.data_ptr(), T,
                                  dims, _ptrs(weights), wf.data_ptr(), bias_f.data_ptr(),
                                  torch.cuda.current_stream(dev).cuda_stream)
    _raise_rc(lib, rc, "K1 (fused MLP forward, bf16)")
    _counted("K1", True)
    return out[:, 0], out[:, 1:4]


def _launch_k3_wg(meta: FusedMeta, pts_enc, view_enc, packed: WgPackedWeights):
    """K3 at bf16 (fused_mlp_wgmma.cu k3_wg): K1's wgmma forward on the
    forward layout that pack_weights made once per call."""
    from sparf_tpu_torch.ops._build import load_library, wg_entry

    lib = load_library()
    dims = (ctypes.c_int * len(packed.dims))(*packed.dims)
    sizes = _wg_sizes(lib, dims, "K3 (fused MLP forward, packed weights, bf16)")
    wf, bias_f = packed.wf, packed.bias_f
    if (wf.dtype != torch.bfloat16 or wf.numel() != sizes[1] or bias_f.numel() != sizes[3]
            or not wf.is_contiguous() or wf.device != pts_enc.device):
        raise ValueError("K3 takes the contiguous bf16 layout of pack_weights on the points' "
                         "device")
    T = pts_enc.shape[0]
    out = torch.empty((T, 4), dtype=torch.float32, device=pts_enc.device)
    rc = wg_entry(lib, "forward_packed")(pts_enc.data_ptr(), view_enc.data_ptr(), out.data_ptr(),
                                         T, dims, wf.data_ptr(), bias_f.data_ptr(),
                                         torch.cuda.current_stream(pts_enc.device).cuda_stream)
    _raise_rc(lib, rc, "K3 (fused MLP forward, packed weights, bf16)")
    _counted("K3", True)
    return out[:, 0], out[:, 1:4]


def _launch_k2_wg(meta: FusedMeta, pts_enc, view_enc, weights, gout):
    """K2 at bf16 (fused_mlp_wgmma.cu): k_wg_layout, k2_wg, k2_dw_wg,
    k2_reduce_wg."""
    from sparf_tpu_torch.ops._build import load_library, wg_entry

    lib = load_library()
    T, dev = pts_enc.shape[0], pts_enc.device
    dims = _dims(meta, weights)
    n_params, n_wf, n_wt, RF, KX, KG, n_part, n_splits, tile = _wg_sizes(
        lib, dims, "K2 (fused MLP backward, bf16)")
    x_rows = -(-T // WG_TILE) * WG_TILE  # the workspace's rows; blocks of `tile` points
    n_blocks = x_rows // tile
    d_pts = torch.zeros_like(pts_enc)
    d_view = torch.empty_like(view_enc)
    d_params = torch.empty(n_params, dtype=torch.float32, device=dev)
    bf = dict(dtype=torch.bfloat16, device=dev)
    wf, wt = torch.empty(n_wf, **bf), torch.empty(n_wt, **bf)
    bias_f = torch.empty(RF, dtype=torch.float32, device=dev)
    # every layer's input and g_z in bf16 for the dW pass: ~9 KB per point at full width
    xws, gws = torch.empty((x_rows, KX), **bf), torch.empty((x_rows, KG), **bf)
    # the recompute's ReLU mask words: per layer, tile and consumer thread 4 x 32 bits
    masks = torch.empty((meta.n_feat + meta.n_rgb, n_blocks, 256, 4), dtype=torch.int32,
                        device=dev)
    db_part = torch.empty((x_rows // 64, KG), dtype=torch.float32, device=dev)
    partial = torch.empty(n_splits * n_part, dtype=torch.float32, device=dev)
    rc = wg_entry(lib, "backward")(
        pts_enc.data_ptr(), view_enc.data_ptr(), gout.data_ptr(), d_pts.data_ptr(),
        d_view.data_ptr(), d_params.data_ptr(), wf.data_ptr(), wt.data_ptr(), bias_f.data_ptr(),
        xws.data_ptr(), gws.data_ptr(), masks.data_ptr(), db_part.data_ptr(), partial.data_ptr(),
        T, dims,
        _ptrs(weights), torch.cuda.current_stream(dev).cuda_stream)
    _raise_rc(lib, rc, "K2 (fused MLP backward, bf16)")
    return d_pts, d_view, d_params


def _launch_k2_tf32wg(meta: FusedMeta, pts_enc, view_enc, weights, gout):
    """K2 at float32 on wgmma (fused_mlp_wgmma.cu): k_tf_layout, k2_tf,
    k2_dw_tf, k2_reduce_tf; None where it does not take the chain (C sizes
    -7: fused_mlp.cu's K2 runs it)."""
    from sparf_tpu_torch.ops._build import load_library, tf32wg_entry

    lib = load_library()
    T, dev = pts_enc.shape[0], pts_enc.device
    dims = _dims(meta, weights)
    sizes = (ctypes.c_int * 9)()
    rc = tf32wg_entry(lib, "sizes")(dims, sizes)
    if rc == -7:
        return None
    _raise_rc(lib, rc, "K2 (fused MLP backward)")
    n_params, n_wf, n_wt, RF, NX, NG, n_part, n_splits, _ = sizes
    x_rows = -(-T // WG_TILE) * WG_TILE
    d_pts = torch.zeros_like(pts_enc)
    d_view = torch.empty_like(view_enc)
    d_params = torch.empty(n_params, dtype=torch.float32, device=dev)
    wf, wt = torch.empty(n_wf, device=dev), torch.empty(n_wt, device=dev)
    bias_f = torch.empty(RF, dtype=torch.float32, device=dev)
    # every layer's input and g_z, point-contiguous, for the dW pass: ~18 KB
    # per point on the presets' chain
    ws = torch.empty((NX + NG) * x_rows, dtype=torch.float32, device=dev)
    masks = torch.empty((meta.n_feat + meta.n_rgb, x_rows // WG_TILE, 256, 4), dtype=torch.int32,
                        device=dev)
    partial = torch.empty(n_splits * n_part, dtype=torch.float32, device=dev)
    rc = tf32wg_entry(lib, "backward")(
        pts_enc.data_ptr(), view_enc.data_ptr(), gout.data_ptr(), d_pts.data_ptr(),
        d_view.data_ptr(), d_params.data_ptr(), wf.data_ptr(), wt.data_ptr(), bias_f.data_ptr(),
        ws.data_ptr(), masks.data_ptr(), partial.data_ptr(), T, dims, _ptrs(weights),
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_rc(lib, rc, "K2 (fused MLP backward)")
    tracing.count(K2_TF32WG)
    return d_pts, d_view, d_params


def tf32wg_weights_kernel(dims: Sequence[int], weights: Sequence[torch.Tensor]):
    """k_tf_layout on the card: (wf, wt, bias_f) as tf32wg_weights_plain."""
    from sparf_tpu_torch.ops._build import load_library, tf32wg_entry

    lay = tf32wg_layout(tuple(dims))
    lib = load_library()
    c_dims = (ctypes.c_int * len(dims))(*dims)
    dev = weights[0].device
    wf = torch.empty((2 * lay.RF, lay.KF), device=dev)
    wt = torch.empty((2 * lay.RT, lay.KT), device=dev)
    bias_f = torch.empty(lay.RF, device=dev)
    rc = tf32wg_entry(lib, "layout")(c_dims, _ptrs(weights), wf.data_ptr(), wt.data_ptr(),
                                     bias_f.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _raise_rc(lib, rc, "k_tf_layout")
    return wf, wt, bias_f


def _launch_k1(meta: FusedMeta, pts_enc, view_enc, weights):
    """Packs the weights into fragments (k_pack) and launches K1 on them; at
    bf16 the wgmma K1."""
    from sparf_tpu_torch.ops._build import entry, load_library

    _check_operands(pts_enc, view_enc, weights)
    if meta.bf16:
        return _launch_k1_wg(meta, pts_enc, view_enc, weights)
    lib = load_library()
    T, dev = pts_enc.shape[0], pts_enc.device
    dims = _dims(meta, weights)
    frag = torch.empty(_sizes(lib, dims, "K1 (fused MLP forward)")[1], device=dev)
    out = torch.empty((T, 4), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = entry(lib, "forward")(pts_enc.data_ptr(), view_enc.data_ptr(), out.data_ptr(), T, dims,
                               _ptrs(weights), frag.data_ptr(), 0, stream)
    _raise_rc(lib, rc, "K1 (fused MLP forward)")
    _counted("K1", False)
    return out[:, 0], out[:, 1:4]


def _launch_k3(meta: FusedMeta, pts_enc, view_enc, packed: PackedWeights):
    """K3 on pack_weights' layout: the 3xTF32 k3_forward, at bf16 k3_wg."""
    from sparf_tpu_torch.ops._build import entry, load_library

    if (list(packed.dims[:5]) != [meta.n_feat, meta.n_rgb, meta.d_in, meta.d_view,
                                  int(meta.view_dep)]
            or isinstance(packed, WgPackedWeights) != meta.bf16):
        raise ValueError("K3: packed weights of another chain or compute dtype")
    if meta.bf16:
        _check_operands(pts_enc, view_enc, [packed.bias_f])
        return _launch_k3_wg(meta, pts_enc, view_enc, packed)
    _check_operands(pts_enc, view_enc, packed.biases)
    if packed.frag.device != pts_enc.device or not packed.frag.is_contiguous():
        raise ValueError("K3 takes the contiguous fragments of pack_weights on the points' device")
    lib = load_library()
    dims = (ctypes.c_int * len(packed.dims))(*packed.dims)
    if packed.frag.numel() != _sizes(lib, dims, "K3 (fused MLP forward, packed weights)")[1]:
        raise ValueError("K3 takes the fragments of pack_weights")
    T = pts_enc.shape[0]
    out = torch.empty((T, 4), dtype=torch.float32, device=pts_enc.device)
    stream = torch.cuda.current_stream(pts_enc.device).cuda_stream
    params = (ctypes.c_void_p * (2 * len(packed.biases)))(
        *[p for b in packed.biases for p in (None, b.data_ptr())])
    rc = entry(lib, "forward")(pts_enc.data_ptr(), view_enc.data_ptr(), out.data_ptr(), T, dims,
                               params, packed.frag.data_ptr(), 1, stream)
    _raise_rc(lib, rc, "K3 (fused MLP forward, packed weights)")
    _counted("K3", False)
    return out[:, 0], out[:, 1:4]


def _launch_k2(meta: FusedMeta, pts_enc, view_enc, weights, g_density, g_rgb):
    """K2: at float32 the 3xTF32 wgmma kernels where they take the chain,
    else the 3xTF32 mma.sync ones; at bf16 the wgmma ones."""
    from sparf_tpu_torch.ops._build import entry, load_library

    gout = torch.cat([g_density[:, None], g_rgb], dim=-1).contiguous()
    _check_operands(pts_enc, view_enc, weights, gout)
    out = (_launch_k2_wg if meta.bf16 else _launch_k2_tf32wg)(meta, pts_enc, view_enc, weights,
                                                              gout)
    if out is not None:
        _counted("K2", meta.bf16)
        return out[0], out[1], _split_flat(out[2], weights)
    lib = load_library()
    T = pts_enc.shape[0]
    dev = pts_enc.device
    dims = _dims(meta, weights)
    n_params, n_frag, n_part, x_total, g_total, n_splits, _ = _sizes(lib, dims,
                                                                     "K2 (fused MLP backward)")
    x_rows = -(-T // K2_TILE) * K2_TILE
    d_pts = torch.empty_like(pts_enc)
    d_view = torch.empty_like(view_enc)
    d_params = torch.empty(n_params, dtype=torch.float32, device=dev)
    frag = torch.empty((2, n_frag), device=dev)
    partial = torch.empty(n_splits * n_part, dtype=torch.float32, device=dev)
    # every layer's input and g_z for the dW pass: ~17 KB per point at full width
    workspace = torch.empty(x_rows * (x_total + g_total), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = entry(lib, "backward")(
        pts_enc.data_ptr(), view_enc.data_ptr(), gout.data_ptr(), d_pts.data_ptr(),
        d_view.data_ptr(), d_params.data_ptr(), frag[0].data_ptr(), frag[1].data_ptr(),
        partial.data_ptr(), workspace.data_ptr(), T, dims, _ptrs(weights), stream)
    _raise_rc(lib, rc, "K2 (fused MLP backward)")
    _counted("K2", False)
    return d_pts, d_view, _split_flat(d_params, weights)


def _split_flat(d_params, weights) -> List[torch.Tensor]:
    """The flat gradient [W0, b0, W1, ...] as views in the weights' shapes."""
    grads, ofs = [], 0
    for w in weights:
        grads.append(d_params[ofs: ofs + w.numel()].view(w.shape))
        ofs += w.numel()
    return grads


def fused_mlp_forward(meta, pts_enc, view_enc, weights):
    """K1 on a CUDA tensor, the plain chain on a CPU tensor."""
    if pts_enc.device.type == "cuda":
        return _launch_k1(meta, pts_enc, view_enc, weights)
    if pts_enc.device.type == "cpu":
        return fused_mlp_forward_plain(meta, pts_enc, view_enc, weights)
    raise ValueError(f"fused MLP: no kernel for device {pts_enc.device}")


def fused_mlp_forward_packed(meta, pts_enc, view_enc, packed):
    """K3 on a CUDA tensor, its plain version on a CPU tensor."""
    if pts_enc.device.type == "cuda":
        return _launch_k3(meta, pts_enc, view_enc, packed)
    if pts_enc.device.type == "cpu":
        return fused_mlp_forward_packed_plain(meta, pts_enc, view_enc, packed)
    raise ValueError(f"fused MLP: no kernel for device {pts_enc.device}")


def fused_mlp_backward(meta, pts_enc, view_enc, weights, g_density, g_rgb):
    """K2 on a CUDA tensor, its plain version on a CPU tensor."""
    if pts_enc.device.type == "cuda":
        return _launch_k2(meta, pts_enc, view_enc, weights, g_density, g_rgb)
    if pts_enc.device.type == "cpu":
        return fused_mlp_backward_plain(meta, pts_enc, view_enc, weights, g_density, g_rgb)
    raise ValueError(f"fused MLP: no kernel for device {pts_enc.device}")


class FusedMLPFunction(torch.autograd.Function):
    """(raw_density (T,), raw_rgb (T,3)) = MLP(pts_enc (T,d_in), view_enc (T,d_view))."""

    @staticmethod
    def forward(ctx, meta: FusedMeta, pts_enc, view_enc, *weights):
        raw_density, raw_rgb = fused_mlp_forward(meta, pts_enc, view_enc, weights)
        ctx.meta = meta
        ctx.save_for_backward(pts_enc, view_enc, *weights)
        return raw_density, raw_rgb

    @staticmethod
    def backward(ctx, g_density, g_rgb):
        with tracing.span("mlp.backward"):
            pts_enc, view_enc, *weights = ctx.saved_tensors
            T = pts_enc.shape[0]
            if g_density is None:
                g_density = pts_enc.new_zeros(T)
            if g_rgb is None:
                g_rgb = pts_enc.new_zeros((T, 3))
            with tracing.span("mlp.launch"):
                d_pts, d_view, grads = fused_mlp_backward(
                    ctx.meta, pts_enc, view_enc, weights, g_density.contiguous(),
                    g_rgb.contiguous())
            return (None, d_pts, d_view, *grads)


@tracing.traced("mlp.forward")
def nerf_apply_fused(params: Dict[str, Any], cfg: MLPConfig, pts: torch.Tensor,
                     ray: torch.Tensor, progress: float,
                     density_noise: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """nerf_mlp.nerf_apply with the MLP chain through the fused kernels:
    FusedMLPFunction (K1, K2) when autograd will ask for a gradient of the
    points, the views or the weights; K3 on packed weights otherwise."""
    B, R, S, _ = pts.shape
    T = B * R * S
    with tracing.span("mlp.encode"):
        pts_enc = nerf_mlp.encode_points(cfg, pts, progress).reshape(T, -1)
        if cfg.view_dep:
            view = nerf_mlp.encode_views(cfg, nerf_mlp.unit_rays(ray), progress)
            view_enc = view[:, :, None, :].expand(B, R, S, view.shape[-1]).reshape(T, -1)
        else:
            view_enc = pts_enc.new_zeros((T, 0))
        pts_enc, view_enc = pts_enc.contiguous(), view_enc.contiguous()
    meta, weights = FusedMeta.from_cfg(cfg), flat_weights(params)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (pts_enc, view_enc, *weights)):
        with tracing.span("mlp.launch"):
            raw_density, raw_rgb = FusedMLPFunction.apply(meta, pts_enc, view_enc, *weights)
    else:
        with tracing.span("mlp.pack"):
            packed = pack_weights(params, meta)
        with tracing.span("mlp.launch"):
            raw_density, raw_rgb = fused_mlp_forward_packed(meta, pts_enc, view_enc, packed)
    if density_noise is not None and cfg.density_noise_reg:
        raw_density = raw_density + density_noise.reshape(T) * cfg.density_noise_reg
    density = nerf_mlp.density_activation(raw_density, cfg.density_activ)
    return dict(rgb_samples=torch.sigmoid(raw_rgb).reshape(B, R, S, 3),
                density_samples=density.reshape(B, R, S))

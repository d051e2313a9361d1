// Fused NeRF-MLP forward (K1, K3) and backward (K2) for Hopper (sm_90a) at
// compute_dtype float32, every product on the tensor cores in 3xTF32 (fp32
// accuracy). The bf16 K1, K2 and K3 run wgmma on TMA-fed bf16 tiles
// (fused_mlp_wgmma.cu, its own header note); they replaced bf16 variants of
// this file's mma.sync loops, which bounded them: K2 bf16 at 13.7 ms of a
// 0.84-ms bound, K1 bf16 at 2.1 ms and K3 bf16 at 2.0 ms of 0.28. The float32
// K1, K2 and K3 of every chain the bf16 plan M takes (the presets' among
// them) run 3xTF32 wgmma there too (fused_mlp_wgmma.cu, "The float32 K2" and
// "The float32 K1/K3"); this file's kernels (k1_forward, k3_forward, their
// wide plans, k2_backward, k2_backward_w, k2_dw, k2_reduce, k_pack) run the
// other chains of the domain only (ops/fused_mlp.py's route picks the
// kernels from the chain's dims before any launch).
//
// Replaces the Pallas TPU kernels of sparf_tpu/ops/fused_mlp_vjp.py:
//   K1 = _fwd_kernel (launched by _core_forward), K2 = _bwd_kernel (launched
//   by _core_bwd, the custom_vjp backward);
// and of sparf_tpu/ops/fused_mlp.py:
//   K3 = _kernel (launched by fused_mlp_forward), the forward-only chain on
//   weights packed once per call (the no-gradient renders: full images at
//   validation and evaluation, videos, the depth-consistency visibility pass).
// They compute the 10-matmul NeRF chain: trunk layers with ReLU, pts_enc
// concatenated at the skip layers, raw density from unit 0 of the last trunk
// layer, [features | view_enc] through the RGB head. K1 and K3 write only
// [raw_density | raw_rgb] (T, 4). K2 recomputes the forward per tile and
// backpropagates [g_density | g_rgb] into d_pts_enc (incl. the skip share),
// d_view_enc and the gradients of all weights and biases.
//
// The MMA (Tf32x3):
// mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 (warp-level tensor-core
// MMA). Every operand x is split as hi = TF32 of x (round to nearest), lo =
// x - hi (of which the tensor core reads the top 19 bits), and each product
// is hi*hi + hi*lo + lo*hi accumulated in fp32: the dropped lo*lo term and
// the truncation of lo leave an error of about 2^-21 of the product, within
// a small factor of fp32's own (tests/test_torch_fused_mlp.py holds an
// emulation of it to the float64 chain; one TF32 pass misses that bound).
//
// What bounds them on an H100, and what the design does about it:
//   * Arithmetic: 527,872 multiply-adds per point through the full 8x256
//     chain: at T = 262,144 the 3xTF32 bound is 1.68 ms for the forward and
//     5.03 ms for K2 (recompute + g_x + dW); bytes are < 0.1 ms.
//     Measured (PERF.md): K1/K3 at ~1/3 of the bound, bound by mma.sync
//     issue and what feeds it: every warp loads and converts the A
//     fragments of all 8 m-tiles from shared memory. K2 at ~1/5: the dW
//     pass reads its ~17 KB per point of workspace from device memory, and
//     its g_x loop spills registers.
//   * Registers: 255 per thread, one 256-thread block per SM. A warp holds 8
//     m-tiles x 4 n-tiles of accumulators (128 fp32) plus this and the next
//     k-step's B fragments; K1/K3 and K2's recompute spill nothing,
//     k2_backward's g_x spills (~1.7 KB of spill loads), k2_dw a little.
//   * Weights: ops/fused_mlp.py::pack_fragments_plain is the layout (k_pack
//     here, once per call): every W as ready B fragments, per (k-step,
//     n-tile) one float4 per lane {hi(b0), hi(b1), lo(b0), lo(b1)}: a warp
//     loads a fragment with one coalesced read from L2 and converts nothing.
//     K2 also takes the transposed set (B = W for g_x = g_z W). Each n-tile
//     is 8 wide, each k-step 8 deep, with the input dimension padded per
//     segment ([feat | pts_enc] at the skip layer, [feat | view_enc] at the
//     RGB head: the concat is two segments of the k loop, never a copy).
//   * Forward layer loop (forward_layer, shared by K1, K3 and K2's
//     recompute): the tile's activations stay in shared memory in fp32 with
//     a row stride = 4 mod 32 floats, so a warp's A-fragment loads hit 32
//     different banks. Warp w owns n-tiles w, w + 8, ... for all m-tiles of
//     the tile and keeps their sums in registers; the next k-step's B
//     fragments are loaded while this one's MMAs run. A layer's output
//     overwrites its input in place after a barrier. n-tiles past a
//     multiple of 8 ("extras", at most 4: the density unit of the 257-wide
//     layer, the 3 RGB outputs) are spread over the warps one m-tile each.
//   * K1/K3: 128-point tiles (8 m-tiles), 256 threads, one block per SM;
//     shared memory 128 x (260 + 68 + 36) floats = 186,368 bytes (the
//     wide plan's tiles: below).
//   * K2 in two passes. k2_backward: 128-point tiles (8 m-tiles), one block
//     per tile; the recomputed forward (the same loop) stores each layer's
//     input in a workspace in device memory (2,176 fp32 per point); then,
//     from the last layer down, g_z sits in shared memory (row stride 296 =
//     8 mod 32), is stored to the workspace for the dW pass (2,208 fp32 per
//     point), and g_x = g_z W runs the forward loop's MMA core on the
//     transposed fragments, in two phases: the skip / view segment first
//     (added into d_pts or written to d_view), then the features, masked by
//     X > 0 (the ReLU of the previous layer, exactly as before) into the
//     previous layer's g_z, written over g_z after a barrier. Splitting by
//     segment keeps every phase at <= 4 n-tiles per warp (the 320-wide skip
//     layer in one phase spilled). Shared memory 219,136 bytes. The
//     workspace is fp32 (3xTF32 splits both operands of dW).
//     k2_dw: dW = g_z^T X per layer as a GEMM over the points: 128 x 128
//     output tiles x 64 point ranges (short fp32 sums: 4,096 points at
//     T = 262,144), points staged 32 at a time through shared memory (both
//     operands split on the fly), the next stage loaded into
//     registers during this one's MMAs; each range writes its own partial,
//     and k2_reduce sums the 64 in order into the (out, in) layout: no
//     atomics, two runs give the same bits. The workspace (~17 KB per point,
//     4.6 GB at T = 262,144) is K2's main memory cost. Per-block dW slices
//     updated per tile, as before, cost ~8 ms of slice traffic at 128-point
//     tiles (PERF.md).
//   * The ragged last tile is masked: points past T load zeros, get zero
//     output gradients, and store nothing. Padded rows and columns hold
//     zeros, so they add nothing.
//
// Shapes the kernels take, in two plans that build_desc picks per chain
// before any launch (else a negative code, which sparf_fused_mlp_sizes_tf32
// returns and ops/fused_mlp.py raises as ValueError; cfg.tpu.use_pallas=False
// runs such a chain in torch ops):
//   * 128-point tiles (the above; the presets' 8x256 chain): every layer at
//     most 288 outputs and 320 padded inputs, at most 4 n-tiles (and k-steps
//     of each input segment) past a multiple of 8, activations within one
//     block. Unchanged by the wide plan: the same kernels and code.
//   * The wide plan (k1_forward_w, k3_forward_w, k2_backward_w; every other
//     chain of 1-16 layers with at most 512 features per layer, a 513-wide
//     last trunk layer with its density unit, and pts_enc and view_enc at
//     most 128 wide): 64-point tiles (4 m-tiles), so a warp's 128
//     accumulators hold 8 n-tiles: a 520-wide product in one pass, and a
//     layer's output still overwrites its input in place. Each product runs
//     0, 1, 2, 4 or 8 rounds of 8 n-tiles per warp (wide_rounds: 5 bodies;
//     one per round count 0-8 took the build from ~65 to 229 s) and up to 8
//     n-tiles as extras (4 per warp at 4 m-tiles); where more would be left,
//     the next count up with its last rounds reading zero fragments. Any
//     remainder of n-tiles or k-steps works. Shared memory: K1/K3
//     64 x (ld_act + ld_pts + ld_view) floats, at the corner (512 features,
//     128-wide encodings: strides 516 + 132 + 132) 199,680 bytes; K2 the
//     same buffers for its recompute, then g_z (row stride ld_g, 552 at 513
//     outputs), d_pts and g_density over them, since the recompute's buffers
//     are dead by then: max(199,680, 4 x 64 x (552 + 128 + 1) = 174,336).
//     The fp32 workspace grows with the chain (x_total + g_total floats per
//     point: 8,480 at 8x512 with a 128-wide head, 8.9 GB at T = 262,144,
//     allocated by the caller as before).
//
// Timing-only builds (sparf_tpu_torch/kernel_split.py): K2_TIME_NO_FWD,
// K2_TIME_NO_DW and K2_TIME_NO_GX each drop one part of K2's work (the
// recompute's MMAs, the dW pass, the g_x MMAs); their outputs are wrong and
// only their times are read.
//
// Build: compiled once, in parallel with fused_mlp_wgmma.cu (ops/_build.py),
// and the two objects are linked into one library; entry points *_tf32.
//
// Interface: plain C, loaded with ctypes; every entry point takes the chain's
// dims, launches on the given stream, allocates nothing, and returns
// cudaGetLastError() (> 0), a negative code for a layer configuration the
// kernels do not take, or 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLayers = 16;
constexpr int kTile1 = 128;    // K1/K3: points per block (8 m-tiles)
constexpr int kTile2 = 128;    // K2: points per tile (8 m-tiles)
constexpr int kMaxPad = 320;   // padded input width
constexpr int kLdG = 296;      // K2: row stride of the g_z buffer (= 8 mod 32)
constexpr int kDwBM = 128, kDwBN = 128;  // k2_dw: output tile (outputs x padded inputs)
constexpr int kDwBK = 32;      // k2_dw: points per stage
constexpr int kDwSplits = 64;  // k2_dw: point ranges summed by k2_reduce
constexpr int kMaxExtra = 4;   // n-tiles past a multiple of 8 per layer (128-point tiles)
constexpr int kMaxOut = 8 * (8 * 4 + kMaxExtra);  // 288: the forward's JN <= 4
constexpr int kMaxSmem = 232448;
// the wide plan (64-point tiles, 4 m-tiles, JN <= 8): every chain within these
constexpr int kTileW = 64;
constexpr int kMaxFeatW = 512;  // features of a layer (out, less the density unit)
constexpr int kMaxEncW = 128;   // pts_enc, view_enc

struct MLPDesc {
  int n_layers, n_feat;
  int d_in, d_view, view_dep;
  int n_params;      // flat gradient, (out, in) layout
  int n_part;        // K2: floats of one split's dW partial (plain (out_pad16, kp) + bias)
  int x_total;       // K2: workspace floats per point (stored feature inputs)
  int g_total;       // K2: workspace floats per point (every layer's g_z, out padded to 16)
  int n_dw_tiles;    // K2: dW output tiles of kDwBM x kDwBN over all layers
  int n_frag;        // B fragments (one per lane per (k-step, n-tile)) of one set
  int ld_act, ld_pts, ld_view;  // forward strides (= 4 mod 32)
  int skip[kMaxLayers];
  int in_dim[kMaxLayers], out_dim[kMaxLayers];
  int w1[kMaxLayers];   // width of input segment 1 (features; pts_enc for layer 0)
  int k1p[kMaxLayers];  // w1 padded to the k-step of 8
  int kp[kMaxLayers];   // k1p + (in - w1) padded to 8
  int np[kMaxLayers];   // out padded to 8 (n-tiles; K2's g_x k-steps)
  int w_off[kMaxLayers], b_off[kMaxLayers];  // flat gradient offsets
  int f_off[kMaxLayers];  // offset of the layer's fragments, in fragments
  int g_off[kMaxLayers];  // K2: offset of the layer's dW in a split's partial
  int x_off[kMaxLayers];  // K2: floats per point of the stored inputs before layer li
  int z_off[kMaxLayers];  // K2: floats per point of the stored g_z before layer li
  int t_off[kMaxLayers];  // K2: dW tiles before layer li
  const float* W[kMaxLayers];  // (out, in) row-major
  const float* b[kMaxLayers];
  int wide;          // 1: the wide plan (64-point tiles), 0: 128-point tiles
  int ld_g;          // K2 wide: row stride of the g_z buffer (= 8 mod 32)
};

__host__ __device__ constexpr int pad_to(int x, int m) { return (x + m - 1) / m * m; }
__host__ __device__ constexpr int pad16(int x) { return pad_to(x, 16); }
// smallest stride >= w with stride = r (mod 32)
__host__ __device__ constexpr int ld_mod(int w, int r) { return w + ((32 + r - w % 32) % 32); }

// Host-side description of the chain. dims = [n_feat, n_rgb, d_in, d_view,
// view_dep, (out, in, skip) per layer]; params = [W0, b0, W1, b1, ...].
int k1_smem_bytes(const MLPDesc& d) {
  return 4 * (d.wide ? kTileW : kTile1) * (d.ld_act + d.ld_pts + d.ld_view);
}

// K2 at 128-point tiles: floats of the forward's buffers or of g_z, whichever
// is larger (aliased)
__host__ __device__ inline int k2_main_floats(const MLPDesc& d) {
  const int fwd = kTile2 * (d.ld_act + d.ld_pts + d.ld_view), bwd = kTile2 * kLdG;
  return fwd > bwd ? fwd : bwd;
}

// K2 wide: the forward's buffers, or g_z, d_pts and g_density over them (the
// forward's buffers are dead once the recompute is done)
int k2_smem_bytes(const MLPDesc& d) {
  if (!d.wide) return 4 * (k2_main_floats(d) + kTile2 * d.d_in + kTile2);
  const int fwd = kTileW * (d.ld_act + d.ld_pts + d.ld_view), bwd = kTileW * (d.ld_g + d.d_in + 1);
  return 4 * (fwd > bwd ? fwd : bwd);
}

// Host-side description of the chain. dims = [n_feat, n_rgb, d_in, d_view,
// view_dep, (out, in, skip) per layer]; params = [W0, b0, W1, b1, ...]. The
// chains of 128-point tiles are those of the first plan (every layer at most
// 288 outputs and 320 padded inputs, at most 4 n-tiles past a multiple of 8,
// the activations within one block); every other chain in the domain takes
// the wide plan.
int build_desc(const int* dims, const void* const* params, MLPDesc* d) {
  d->n_feat = dims[0];
  const int n_rgb = dims[1];
  d->n_layers = d->n_feat + n_rgb;
  if (d->n_feat < 1 || n_rgb < 1 || d->n_layers > kMaxLayers) return -1;
  d->d_in = dims[2];
  d->d_view = dims[3];
  d->view_dep = dims[4];
  const int ks = 8;  // the k-step
  int off = 0, frag = 0, part = 0, x_total = 0, g_total = 0, tiles = 0, max_w1 = 0, max_g = 16;
  bool narrow = true;  // the 128-point plan takes every layer
  bool wide = d->d_in <= kMaxEncW && d->d_view <= kMaxEncW;  // the wide plan takes every layer
  for (int li = 0; li < d->n_layers; ++li) {
    const int out = dims[5 + 3 * li], in = dims[6 + 3 * li], skip = dims[7 + 3 * li];
    const int w2 = skip ? d->d_in : ((li == d->n_feat && d->view_dep) ? d->d_view : 0);
    const int w1 = in - w2, dens = li == d->n_feat - 1 ? 1 : 0;
    const int k1p = pad_to(w1, ks), kp = k1p + pad_to(w2, ks), np = pad_to(out, ks);
    if (out < 1 || w1 < 1) return -2;
    if (kp > kMaxPad || np > kMaxOut || (np / 8) % 8 > kMaxExtra || (k1p / 8) % 8 > kMaxExtra ||
        ((kp - k1p) / 8) % 8 > kMaxExtra || k1p > kMaxOut || kp - k1p > kMaxOut)
      narrow = false;
    if (out - dens > kMaxFeatW || k1p > kMaxFeatW || kp - k1p > kMaxEncW) wide = false;
    if (!narrow && !wide) return -2;
    if (li == 0 && (skip || w1 != d->d_in)) return -3;
    if (li > 0) {
      const int prev = d->out_dim[li - 1] - (li - 1 == d->n_feat - 1 ? 1 : 0);
      if (prev != w1) return -3;
      d->x_off[li] = x_total;
      x_total += w1;
      if (w1 > max_w1) max_w1 = w1;
    }
    d->skip[li] = skip;
    d->in_dim[li] = in;
    d->out_dim[li] = out;
    d->w1[li] = w1;
    d->k1p[li] = k1p;
    d->kp[li] = kp;
    d->np[li] = np;
    d->w_off[li] = off;
    off += out * in;
    d->b_off[li] = off;
    off += out;
    d->f_off[li] = frag;
    frag += (kp / ks) * (np / 8) * 32;
    d->g_off[li] = part;
    part += pad16(out) * kp + (out + 3) / 4 * 4;
    d->z_off[li] = g_total;
    g_total += pad16(out);
    if (pad16(out) > max_g) max_g = pad16(out);
    d->t_off[li] = tiles;
    tiles += ((pad16(out) + kDwBM - 1) / kDwBM) * ((kp + kDwBN - 1) / kDwBN);
    d->W[li] = static_cast<const float*>(params[2 * li]);
    d->b[li] = static_cast<const float*>(params[2 * li + 1]);
  }
  if (d->out_dim[d->n_layers - 1] != 3) return -3;
  d->n_params = off;
  d->n_part = part;
  d->n_frag = frag;
  d->x_total = x_total;
  d->g_total = g_total;
  d->n_dw_tiles = tiles;
  d->ld_act = ld_mod(pad_to(max_w1, ks), 4);
  d->ld_pts = ld_mod(pad_to(d->d_in, ks), 4);
  d->ld_view = ld_mod(pad_to(d->d_view > 0 ? d->d_view : 1, ks), 4);
  d->ld_g = ld_mod(max_g, 8);
  d->wide = 0;
  if (narrow && k1_smem_bytes(*d) <= kMaxSmem && k2_smem_bytes(*d) <= kMaxSmem) return 0;
  if (!wide) return narrow ? 0 : -2;  // narrow: the shared-memory checks refuse it (-4)
  d->wide = 1;
  return 0;
}

// ---------------------------------------------------------------------------
// the MMA (3xTF32)
// ---------------------------------------------------------------------------

// x = hi + lo: hi the nearest TF32 value (ties away from zero, as
// cvt.rna.tf32.f32) by integer add and mask, lo the exact fp32 rest, whose
// top 19 bits the tensor core reads. Three full-rate instructions: the
// conversion unit's cvt runs at a quarter of that rate and bounded the first
// version of these loops.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 3xTF32, k-steps of 8. A fragment of the 16 x 8 block at A (row-major,
// stride lda): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4),
// split into hi and lo. B fragment: {hi b0, hi b1, lo b0, lo b1} with b0 =
// B[t, g], b1 = B[t + 4, g]. c += a * b, the small terms first.
struct Tf32x3 {
  static constexpr int kK = 8;
  static constexpr int kLdDw = kDwBM + 8;  // k2_dw staging stride (= 8 mod 32)
  using Frag = float4;
  struct AFrag {
    uint32_t hi[4], lo[4];
  };
  static __device__ __forceinline__ void load_a(const float* A, int lda, int g, int t,
                                                AFrag& a) {
    const float* p = A + g * lda + t;
    split(p[0], a.hi[0], a.lo[0]);
    split(p[8 * lda], a.hi[1], a.lo[1]);
    split(p[4], a.hi[2], a.lo[2]);
    split(p[8 * lda + 4], a.hi[3], a.lo[3]);
  }
  static __device__ __forceinline__ void mma(float (&c)[4], const AFrag& a, const Frag& b) {
    mma_tf32(c, a.lo, __float_as_uint(b.x), __float_as_uint(b.y));
    mma_tf32(c, a.hi, __float_as_uint(b.z), __float_as_uint(b.w));
    mma_tf32(c, a.hi, __float_as_uint(b.x), __float_as_uint(b.y));
  }
  // the fragment of lane (g, t), b(k) = B[ks * 8 + k, nt * 8 + g]
  template <typename B>
  static __device__ __forceinline__ Frag make_b(B b, int t) {
    uint32_t h0, l0, h1, l1;
    split(b(t), h0, l0);
    split(b(t + 4), h1, l1);
    return make_float4(__uint_as_float(h0), __uint_as_float(h1), __uint_as_float(l0),
                       __uint_as_float(l1));
  }
};

using Frag = Tf32x3::Frag;
using AFrag = Tf32x3::AFrag;

// The A operand of a layer product: k-steps [0, ks1) read segment 1, the rest
// segment 2 (the skip or view concat); a tile of rows starts at row 0.
struct AOperand {
  const float* a1;
  int ld1, ks1;
  const float* a2;
  int ld2;
  template <int K>
  __device__ __forceinline__ const float* at(int ks, int& ld) const {
    if (ks < ks1) {
      ld = ld1;
      return a1 + ks * K;
    }
    ld = ld2;
    return a2 + (ks - ks1) * K;
  }
};

// acc[m][j] += A (MT*16 x KK*KS) x B for the n-tiles w + 8 j, j < JN, of warp
// w; B comes as packed fragments Bf[(ks * NT + nt) * 32 + lane]. With
// kPrefetch the next k-step's fragments are loaded while this one's MMAs run
// (K2's g_x goes without: it has more live state, and the registers spilled).
// kPred (the wide plan): the rounds' n-tiles at or past n_on load zero
// fragments (their sums are never read), so one body serves a range of
// widths without a branch among the MMAs (a body of its own, so that the
// 128-point plan compiles as it did).
template <int MT, int JN, bool kPrefetch = true, bool kPred = false>
__device__ __forceinline__ void mma_rows(const AOperand& A, int KS,
                                         const Frag* __restrict__ Bf, int NT,
                                         float (&acc)[MT][JN > 0 ? JN : 1][4], int n_on = 0) {
  if constexpr (JN > 0 && !kPred) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
    const Frag* bp = Bf + warp * 32 + lane;
    Frag b[JN], bn[JN];
#pragma unroll
    for (int j = 0; j < JN; ++j) b[j] = __ldg(bp + j * 8 * 32);
    for (int ks = 0; ks < KS; ++ks) {
      if (kPrefetch && ks + 1 < KS) {
#pragma unroll
        for (int j = 0; j < JN; ++j) bn[j] = __ldg(bp + ((size_t)(ks + 1) * NT + j * 8) * 32);
      }
      int lda;
      const float* a = A.at<Tf32x3::kK>(ks, lda);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        AFrag af;
        Tf32x3::load_a(a + m * 16 * lda, lda, g, t, af);
#pragma unroll
        for (int j = 0; j < JN; ++j) Tf32x3::mma(acc[m][j], af, b[j]);
      }
#pragma unroll
      for (int j = 0; j < JN; ++j) {
        if (kPrefetch)
          b[j] = bn[j];
        else if (ks + 1 < KS)
          b[j] = __ldg(bp + ((size_t)(ks + 1) * NT + j * 8) * 32);
      }
    }
  } else if constexpr (JN > 0) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
    const Frag* bp = Bf + warp * 32 + lane;
    const Frag zero = make_float4(0.f, 0.f, 0.f, 0.f);
    auto ld = [&](int ks, int j) {
      return warp + 8 * j < n_on ? __ldg(bp + ((size_t)ks * NT + j * 8) * 32) : zero;
    };
    Frag b[JN], bn[JN];
#pragma unroll
    for (int j = 0; j < JN; ++j) b[j] = ld(0, j);
    for (int ks = 0; ks < KS; ++ks) {
      if (kPrefetch && ks + 1 < KS) {
#pragma unroll
        for (int j = 0; j < JN; ++j) bn[j] = ld(ks + 1, j);
      }
      int lda;
      const float* a = A.at<Tf32x3::kK>(ks, lda);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        AFrag af;
        Tf32x3::load_a(a + m * 16 * lda, lda, g, t, af);
#pragma unroll
        for (int j = 0; j < JN; ++j) Tf32x3::mma(acc[m][j], af, b[j]);
      }
#pragma unroll
      for (int j = 0; j < JN; ++j) {
        if (kPrefetch)
          b[j] = bn[j];
        else if (ks + 1 < KS)
          b[j] = ld(ks + 1, j);
      }
    }
  }
}

// The wide plan's rounds of 8 n-tiles per warp for a product over nt
// n-tiles: 0, 1, 2, 4 or 8, the rest as extras (at 4 m-tiles up to 8
// n-tiles); where more would be left, the next count up, its last rounds
// predicated (mma_rows kPred).
__host__ __device__ inline int wide_rounds(int nt) {
  for (int jn = 8; jn >= 1; jn /= 2)
    if (nt >= 8 * jn) return nt - 8 * jn <= 8 ? jn : 2 * jn;
  return 0;
}

#define SPARF_WIDE_ROUNDS(n_tiles, CALL)                               \
  do {                                                                 \
    switch (wide_rounds(n_tiles)) {                                    \
      case 0: CALL(0, true); break;                                    \
      case 1: CALL(1, true); break;                                    \
      case 2: CALL(2, true); break;                                    \
      case 4: CALL(4, true); break;                                    \
      default: CALL(8, true); break;                                   \
    }                                                                  \
  } while (0)

// The extra n-tiles 8 JN + e, e < R <= kMaxExtra, over MT m-tiles: pair q =
// warp + 8 i is (m-tile q % MT, n-tile 8 JN + q / MT).
template <int MT, bool kExtras>
__device__ __forceinline__ void mma_extras(const AOperand& A, int KS,
                                           const Frag* __restrict__ Bf, int NT,
                                           int nt0, int R, float (&acc)[kMaxExtra][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < (kExtras ? kMaxExtra : 0); ++i) {
    const int q = warp + kWarps * i;
    if (q >= MT * R) break;
    const int m = q % MT, nt = nt0 + q / MT;
    for (int ks = 0; ks < KS; ++ks) {
      const Frag b = __ldg(Bf + ((size_t)ks * NT + nt) * 32 + lane);
      int lda;
      const float* a = A.at<Tf32x3::kK>(ks, lda);
      AFrag af;
      Tf32x3::load_a(a + m * 16 * lda, lda, g, t, af);
      Tf32x3::mma(acc[i], af, b);
    }
  }
}

// Calls f(row, col, value) for every accumulator of the warp: the main
// n-tiles, then the extras. Fragment C: c0 (g, 2t), c1 (g, 2t + 1),
// c2 (g + 8, 2t), c3 (g + 8, 2t + 1).
template <int MT, int JN, bool kExtras, typename F>
__device__ __forceinline__ void for_each_acc(float (&acc)[MT][JN > 0 ? JN : 1][4],
                                             float (&ext)[kMaxExtra][4], int R, int col0, F f) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < JN; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        f(m * 16 + g + 8 * (c >> 1), col0 + (warp + 8 * j) * 8 + 2 * t + (c & 1), acc[m][j][c]);
#pragma unroll
  for (int i = 0; i < (kExtras ? kMaxExtra : 0); ++i) {
    const int q = warp + kWarps * i;
    if (q >= MT * R) break;
    const int m = q % MT, nt = 8 * JN + q / MT;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      f(m * 16 + g + 8 * (c >> 1), col0 + nt * 8 + 2 * t + (c & 1), ext[i][c]);
  }
}

// Sets every accumulator to the bias of its column (0 past `out`, or with no bias).
template <int MT, int JN, bool kExtras>
__device__ __forceinline__ void init_acc(float (&acc)[MT][JN > 0 ? JN : 1][4],
                                         float (&ext)[kMaxExtra][4], int R,
                                         const float* __restrict__ bias, int out) {
  auto bv = [&](int col) { return (bias != nullptr && col < out) ? __ldg(bias + col) : 0.f; };
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, t = lane & 3;
#pragma unroll
  for (int j = 0; j < JN; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float v = bv((warp + 8 * j) * 8 + 2 * t + (c & 1));
#pragma unroll
      for (int m = 0; m < MT; ++m) acc[m][j][c] = v;
    }
#pragma unroll
  for (int i = 0; i < (kExtras ? kMaxExtra : 0); ++i) {
    const int q = warp + kWarps * i;
    if (q >= MT * R) break;
    const int nt = 8 * JN + q / MT;
#pragma unroll
    for (int c = 0; c < 4; ++c) ext[i][c] = bv(nt * 8 + 2 * t + (c & 1));
  }
}

// ---------------------------------------------------------------------------
// forward (K1, K3, K2's recompute)
// ---------------------------------------------------------------------------

// One layer over a tile of MT * 16 points. X1 (stride ld1) holds the layer's
// first input segment, X2 (ld2) the second; Y (ldy) gets the ReLU of the
// output, over X1 when they alias. Modes: 0 = ReLU into Y; 1 = last trunk
// layer (unit 0 is raw density, to out_g[:, 0] when out_g is given; ReLU of
// units 1.. into Y); 2 = last RGB layer (raw rgb to out_g[:, 1:4]). xs (K2):
// when given, Y's real columns are also stored there, row-major (points, w1
// of the next layer).
template <int MT, int JN, bool kExtras>
__device__ void forward_layer_j(const MLPDesc& d, const Frag* __restrict__ F, int li,
                                const float* X1, int ld1, const float* X2, int ld2, float* Y,
                                int ldy, float* __restrict__ out_g, float* __restrict__ xs,
                                int p0, int T) {
  const int out = d.out_dim[li], NT = d.np[li] / 8, R = NT - 8 * JN;
  const int mode = (li == d.n_layers - 1) ? 2 : (li == d.n_feat - 1 ? 1 : 0);
  const int shift = mode == 1 ? 1 : 0;
  const int ncol = mode == 2 ? 0 : d.k1p[li + 1], wnext = mode == 2 ? 0 : d.w1[li + 1];
  float acc[MT][JN > 0 ? JN : 1][4], ext[kMaxExtra][4];
  init_acc<MT, JN, kExtras>(acc, ext, R, d.b[li], out);
  const AOperand A{X1, ld1, d.k1p[li] / Tf32x3::kK, X2, ld2};
  const Frag* Bf = F + d.f_off[li];
#ifdef K2_TIME_NO_FWD
  if (xs == nullptr)
#endif
  {
    // (the wide plan: every n-tile below NT, past 4 per warp without the
    // prefetch, whose fragments would spill)
    mma_rows<MT, JN, (JN <= 4), (MT != 8)>(A, d.kp[li] / Tf32x3::kK, Bf, NT, acc, NT);
    mma_extras<MT, kExtras>(A, d.kp[li] / Tf32x3::kK, Bf, NT, 8 * JN, R, ext);
  }
  __syncthreads();  // every warp has read the input; Y may overwrite it
  for_each_acc<MT, JN, kExtras>(acc, ext, R, 0, [&](int p, int col, float z) {
    const bool valid = p0 + p < T;
    if (mode == 2) {
      if (col < 3 && valid) out_g[(size_t)(p0 + p) * 4 + 1 + col] = z;
      return;
    }
    if (shift && col == 0) {
      if (out_g != nullptr && valid) out_g[(size_t)(p0 + p) * 4] = z;
      return;
    }
    const int c = col - shift;
    if (c < ncol) {
      const float y = fmaxf(z, 0.f);
      Y[p * ldy + c] = y;
      if (xs != nullptr && c < wnext) xs[p * wnext + c] = y;
    }
  });
  __syncthreads();  // Y complete before the next layer reads it
}

template <int MT>
__device__ __forceinline__ void forward_layer(const MLPDesc& d, const Frag* F, int li,
                                              const float* X1, int ld1, const float* X2, int ld2,
                                              float* Y, int ldy, float* out_g, float* xs, int p0,
                                              int T) {
  // one body per JN, with the extras code (an extras-free second body per JN
  // made the register allocation spill in K1); the wide plan: wide_rounds
#define SPARF_FWD(JN) \
  forward_layer_j<MT, JN, true>(d, F, li, X1, ld1, X2, ld2, Y, ldy, out_g, xs, p0, T)
#define SPARF_FWD2(JN, EXTRAS) SPARF_FWD(JN)
  if constexpr (MT == 8) {
    switch (d.np[li] / 64) {
      case 0: SPARF_FWD(0); break;
      case 1: SPARF_FWD(1); break;
      case 2: SPARF_FWD(2); break;
      case 3: SPARF_FWD(3); break;
      default: SPARF_FWD(4); break;
    }
  } else {
    SPARF_WIDE_ROUNDS(d.np[li] / 8, SPARF_FWD2);
  }
#undef SPARF_FWD2
#undef SPARF_FWD
}

// Loads rows [p0, p0 + n) of a (T, width) array into shared memory with row
// stride ld; zeros past T and in the padding columns [width, wp).
__device__ __forceinline__ void load_rows(float* dst, int ld, const float* __restrict__ src,
                                          int width, int wp, int n, int p0, int T) {
  for (int idx = threadIdx.x; idx < n * wp; idx += kThreads) {
    const int p = idx / wp, k = idx - p * wp;
    dst[p * ld + k] = (p0 + p < T && k < width) ? src[(size_t)(p0 + p) * width + k] : 0.f;
  }
}

// Loads the tile's inputs and runs the forward chain on MT * 16 points:
// layers [0, n_run) (K1/K3: all; K2: all but the last). xws (K2): the stored
// inputs, layer li's as a (x_rows, w1) array at xws + x_rows * x_off[li].
template <int MT>
__device__ __forceinline__ void forward_tile(const MLPDesc& d,
                                             const Frag* __restrict__ F,
                                             const float* __restrict__ pts,
                                             const float* __restrict__ view, float* smem,
                                             float* __restrict__ out, float* __restrict__ xws,
                                             int x_rows, int n_run, int p0, int T) {
  constexpr int P = MT * 16;
  float* s_act = smem;
  float* s_pts = s_act + P * d.ld_act;
  float* s_view = s_pts + P * d.ld_pts;
  load_rows(s_pts, d.ld_pts, pts, d.d_in, pad_to(d.d_in, Tf32x3::kK), P, p0, T);
  if (d.d_view > 0) load_rows(s_view, d.ld_view, view, d.d_view, pad_to(d.d_view, Tf32x3::kK), P, p0, T);
  __syncthreads();
  for (int li = 0; li < n_run; ++li) {
    const float* x1 = li == 0 ? s_pts : s_act;
    const int ld1 = li == 0 ? d.ld_pts : d.ld_act;
    const bool seg2_pts = d.skip[li] != 0;
    float* xs = (xws != nullptr && li + 1 < d.n_layers)
                    ? xws + (size_t)x_rows * d.x_off[li + 1] + (size_t)p0 * d.w1[li + 1]
                    : nullptr;
    forward_layer<MT>(d, F, li, x1, ld1, seg2_pts ? s_pts : s_view,
                         seg2_pts ? d.ld_pts : d.ld_view, s_act, d.ld_act, out, xs, p0, T);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
k1_forward(MLPDesc d, const Frag* __restrict__ F, const float* __restrict__ pts,
           const float* __restrict__ view, float* __restrict__ out, int T) {
  extern __shared__ float4 smem4[];
  forward_tile<kTile1 / 16>(d, F, pts, view, reinterpret_cast<float*>(smem4), out, nullptr, 0,
                               d.n_layers, blockIdx.x * kTile1, T);
}

// K3: the same loop on fragments that pack_weights prepared once per call
__global__ void __launch_bounds__(kThreads, 1)
k3_forward(MLPDesc d, const Frag* __restrict__ F, const float* __restrict__ pts,
           const float* __restrict__ view, float* __restrict__ out, int T) {
  extern __shared__ float4 smem4[];
  forward_tile<kTile1 / 16>(d, F, pts, view, reinterpret_cast<float*>(smem4), out, nullptr, 0,
                               d.n_layers, blockIdx.x * kTile1, T);
}

// The wide plan's K1 and K3: the same loop on 64-point tiles (4 m-tiles, up
// to 8 n-tiles per warp)
__global__ void __launch_bounds__(kThreads, 1)
k1_forward_w(MLPDesc d, const Frag* __restrict__ F, const float* __restrict__ pts,
             const float* __restrict__ view, float* __restrict__ out, int T) {
  extern __shared__ float4 smem4[];
  forward_tile<kTileW / 16>(d, F, pts, view, reinterpret_cast<float*>(smem4), out, nullptr, 0,
                            d.n_layers, blockIdx.x * kTileW, T);
}

__global__ void __launch_bounds__(kThreads, 1)
k3_forward_w(MLPDesc d, const Frag* __restrict__ F, const float* __restrict__ pts,
             const float* __restrict__ view, float* __restrict__ out, int T) {
  extern __shared__ float4 smem4[];
  forward_tile<kTileW / 16>(d, F, pts, view, reinterpret_cast<float*>(smem4), out, nullptr, 0,
                            d.n_layers, blockIdx.x * kTileW, T);
}

// ---------------------------------------------------------------------------
// fragment packing (ops/fused_mlp.py::pack_fragments_plain is the same map)
// ---------------------------------------------------------------------------

// W[n, k] with k in the padded input [seg 1 | pad | seg 2 | pad]; 0 in padding
__device__ __forceinline__ float weight_at(const MLPDesc& d, int li, int n, int kpad) {
  const int w1 = d.w1[li], w2 = d.in_dim[li] - w1, k1p = d.k1p[li];
  const int k = kpad < k1p ? (kpad < w1 ? kpad : -1) : (kpad - k1p < w2 ? w1 + kpad - k1p : -1);
  return (n < d.out_dim[li] && k >= 0) ? d.W[li][(size_t)n * d.in_dim[li] + k] : 0.f;
}

// F: B = W^T (k over the padded input, n over outputs) for the forward;
// FT (blockIdx.y = 1): B = W (k over outputs, n over the padded input) for
// K2's g_x. Fragment (ks, nt), lane (g, t) = Tf32x3::make_b of B[ks*kK + ., nt*8 + g].
__global__ void k_pack(MLPDesc d, Frag* __restrict__ F, Frag* __restrict__ FT) {
  const bool tr = FT != nullptr && blockIdx.y == 1;
  for (int idx = blockIdx.x * blockDim.x + threadIdx.x; idx < d.n_frag;
       idx += gridDim.x * blockDim.x) {
    int li = 0;
    while (li + 1 < d.n_layers && idx >= d.f_off[li + 1]) ++li;
    const int local = idx - d.f_off[li], lane = local & 31, tile = local >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int NT = (tr ? d.kp[li] : d.np[li]) / 8, nt = tile % NT, ks = tile / NT;
    const int col = nt * 8 + g;
    auto b = [&](int k) {
      const int row = ks * Tf32x3::kK + k;
      return tr ? weight_at(d, li, row, col) : weight_at(d, li, col, row);
    };
    (tr ? FT : F)[idx] = Tf32x3::make_b(b, t);
  }
}

// ---------------------------------------------------------------------------
// backward (K2)
// ---------------------------------------------------------------------------

// Layer li's input X (point P, padded column k): the feature segment from the
// stored inputs (pts_enc for layer 0), the skip or view segment from the
// inputs; 0 in the padding and past T. Read from device memory.
struct LayerInput {
  const float* feat;  // rows of ld_feat floats: stored inputs, or pts_enc at layer 0
  const float* seg2;  // pts_enc or view_enc rows (w2 floats each)
  int w1, w2, k1p, ld_feat, feat_rows, T;  // feat holds rows P < feat_rows
  __device__ __forceinline__ float operator()(int P, int k) const {
    if (k < w1) return P < feat_rows ? feat[(size_t)P * ld_feat + k] : 0.f;
    const int k2 = k - k1p;
    return (k2 >= 0 && k2 < w2 && P < T) ? seg2[(size_t)P * w2 + k2] : 0.f;
  }
};

// xws: the stored inputs of K2's recompute, (x_rows, w1) per layer
__device__ __forceinline__ LayerInput layer_input(const MLPDesc& d, int li,
                                                  const float* __restrict__ xws, int x_rows,
                                                  const float* __restrict__ pts,
                                                  const float* __restrict__ view, int T) {
  const int w1 = d.w1[li];
  if (li == 0) return LayerInput{pts, view, w1, 0, d.k1p[0], d.d_in, T, T};
  return LayerInput{xws + (size_t)x_rows * d.x_off[li], d.skip[li] ? pts : view, w1,
                    d.in_dim[li] - w1, d.k1p[li], w1, x_rows, T};
}

// K2's g_z buffer: row stride (kLdG at 128-point tiles, the descriptor's in
// the wide plan)
template <int MT>
__device__ __forceinline__ int g_stride(const MLPDesc& d) {
  return MT == kTile2 / 16 ? kLdG : d.ld_g;
}

// Calls CALL(JN, kExtras) for a product over n_tiles n-tiles: JN full rounds
// of 8 (one n-tile per warp each), the rest as extras (128-point tiles; the
// wide plan calls one predicated body per segment, gx_layer).
#define SPARF_DISPATCH_JN(n_tiles, CALL)                               \
  do {                                                                 \
    const int nt_ = (n_tiles);                                         \
    if (nt_ % 8) {                                                     \
      switch (nt_ / 8) {                                               \
        case 0: CALL(0, true); break;                                  \
        case 1: CALL(1, true); break;                                  \
        case 2: CALL(2, true); break;                                  \
        case 3: CALL(3, true); break;                                  \
        default: CALL(4, true); break;                                 \
      }                                                                \
    } else {                                                           \
      switch (nt_ / 8) {                                               \
        case 1: CALL(1, false); break;                                 \
        case 2: CALL(2, false); break;                                 \
        case 3: CALL(3, false); break;                                 \
        default: CALL(4, false); break;                                \
      }                                                                \
    }                                                                  \
  } while (0)

// g_x = G W over the n-tiles [nt0, nt0 + 8 JN + R) of the padded input,
// into acc (warp w: n-tiles nt0 + w + 8 j, then the extras; the wide plan:
// with R < 0, the rounds' n-tiles below nt0 + 8 JN + R).
template <int MT, int JN, bool kExtras>
__device__ __forceinline__ void gx_mma(const MLPDesc& d, const Frag* __restrict__ FT,
                                       int li, const float* G, int nt0, int R,
                                       float (&acc)[MT][JN > 0 ? JN : 1][4],
                                       float (&ext)[kMaxExtra][4]) {
  const int NT = d.kp[li] / 8, ldG = g_stride<MT>(d);
  init_acc<MT, JN, kExtras>(acc, ext, R, nullptr, 0);
#ifndef K2_TIME_NO_GX
  const AOperand A{G, ldG, d.np[li] / Tf32x3::kK, G, ldG};
  const Frag* Bf = FT + d.f_off[li] + nt0 * 32;
  mma_rows<MT, JN, false, (MT != 8)>(A, d.np[li] / Tf32x3::kK, Bf, NT, acc, 8 * JN + R);
  mma_extras<MT, kExtras>(A, d.np[li] / Tf32x3::kK, Bf, NT, 8 * JN, R, ext);
#endif
}

// g_x of the skip (pts_enc) or view segment: added into d_pts or written to
// d_view. Reads G and writes nothing that another warp reads.
template <int MT, int JN, bool kExtras>
__device__ void gx_seg2_j(const MLPDesc& d, const Frag* FT, int li, const float* G,
                          float* s_dpts, float* __restrict__ d_view_g, int p0, int T) {
  const int k1p = d.k1p[li], w2 = d.in_dim[li] - d.w1[li];
  const int R = (d.kp[li] - k1p) / 8 - 8 * JN;
  float acc[MT][JN > 0 ? JN : 1][4], ext[kMaxExtra][4];
  gx_mma<MT, JN, kExtras>(d, FT, li, G, k1p / 8, R, acc, ext);
  for_each_acc<MT, JN, kExtras>(acc, ext, R, 0, [&](int p, int k, float v) {
    if (k >= w2) return;
    if (d.skip[li])
      s_dpts[p * d.d_in + k] += v;
    else if (p0 + p < T)
      d_view_g[(size_t)(p0 + p) * d.d_view + k] = v;
  });
}

// g_x of the feature segment: into d_pts at layer 0; otherwise masked by
// X > 0 (the ReLU of the previous layer) into the previous layer's g_z,
// written over G once every warp is done reading it.
template <int MT, int JN, bool kExtras>
__device__ void gx_seg1_j(const MLPDesc& d, const Frag* FT, int li, float* G,
                          const LayerInput& X, float* s_dpts, const float* s_gd, int p0) {
  constexpr int P = MT * 16;
  const int w1 = d.w1[li], R = d.k1p[li] / 8 - 8 * JN, ldG = g_stride<MT>(d);
  const int shift = (li == d.n_feat) ? 1 : 0;  // g_z of the last trunk layer starts with g_density
  float acc[MT][JN > 0 ? JN : 1][4], ext[kMaxExtra][4];
  gx_mma<MT, JN, kExtras>(d, FT, li, G, 0, R, acc, ext);
  if (li == 0) {
    for_each_acc<MT, JN, kExtras>(acc, ext, R, 0, [&](int p, int k, float v) {
      if (k < w1) s_dpts[p * d.d_in + k] += v;
    });
    return;
  }
  const float* xf = X.feat;  // the stored inputs: every row of the tile is there
  const int ldx = X.ld_feat;
  for_each_acc<MT, JN, kExtras>(acc, ext, R, 0, [&](int p, int k, float& v) {
    if (k < w1) v = xf[(size_t)(p0 + p) * ldx + k] > 0.f ? v : 0.f;
  });
  __syncthreads();  // every warp is done reading G
  for_each_acc<MT, JN, kExtras>(acc, ext, R, 0, [&](int p, int k, float v) {
    if (k < w1) G[p * ldG + k + shift] = v;
  });
  const int n_prev = w1 + shift, n_pad = pad16(n_prev) - n_prev;
  for (int idx = threadIdx.x; idx < P * n_pad; idx += kThreads) {
    const int p = idx / n_pad;
    G[p * ldG + n_prev + idx - p * n_pad] = 0.f;
  }
  if (shift)
    for (int p = threadIdx.x; p < P; p += kThreads) G[p * ldG] = s_gd[p];
}

// One layer's g_x: the second segment first, then the features (whose
// routing overwrites G).
template <int MT>
__device__ __forceinline__ void gx_layer(const MLPDesc& d, const Frag* FT, int li,
                                         float* G, const LayerInput& X, float* s_dpts,
                                         const float* s_gd, float* d_view_g, int p0, int T) {
  const int nt2 = (d.kp[li] - d.k1p[li]) / 8, nt1 = d.k1p[li] / 8;
#define SPARF_SEG2(JN, EXTRAS) gx_seg2_j<MT, JN, EXTRAS>(d, FT, li, G, s_dpts, d_view_g, p0, T)
#define SPARF_SEG1(JN, EXTRAS) gx_seg1_j<MT, JN, EXTRAS>(d, FT, li, G, X, s_dpts, s_gd, p0)
  if constexpr (MT == 8) {
    if (nt2 > 0) SPARF_DISPATCH_JN(nt2, SPARF_SEG2);
    SPARF_DISPATCH_JN(nt1, SPARF_SEG1);
  } else {
    if (nt2 > 0) SPARF_WIDE_ROUNDS(nt2, SPARF_SEG2);
    SPARF_WIDE_ROUNDS(nt1, SPARF_SEG1);
  }
#undef SPARF_SEG2
#undef SPARF_SEG1
}

// K2, pass 1: per 128-point tile, the recomputed forward (storing every
// layer's input in xws) and the g_z chain (storing every layer's g_z in gws,
// (x_rows, pad16(out)) per layer); d_pts and d_view.
__global__ void __launch_bounds__(kThreads, 1)
k2_backward(MLPDesc d, const Frag* __restrict__ F,
            const Frag* __restrict__ FT, const float* __restrict__ pts,
            const float* __restrict__ view, const float* __restrict__ gout,
            float* __restrict__ d_pts, float* __restrict__ d_view_g, float* __restrict__ xws,
            float* __restrict__ gws, int T, int x_rows) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* s_dpts = smem + k2_main_floats(d);
  float* s_gd = s_dpts + kTile2 * d.d_in;
  float* G = smem;  // g_z of the current layer, over the recompute's buffers
  const int tid = threadIdx.x, p0 = blockIdx.x * kTile2;

  // recompute the forward, storing every layer's feature input in xws
  forward_tile<kTile2 / 16>(d, F, pts, view, smem, nullptr, xws, x_rows, d.n_layers - 1, p0,
                               T);
  for (int idx = tid; idx < kTile2 * 16; idx += kThreads) {  // g_z of the last layer
    const int p = idx >> 4, o = idx & 15;
    G[p * kLdG + o] = (o < 3 && p0 + p < T) ? gout[(size_t)(p0 + p) * 4 + 1 + o] : 0.f;
  }
  for (int p = tid; p < kTile2; p += kThreads)
    s_gd[p] = (p0 + p < T) ? gout[(size_t)(p0 + p) * 4] : 0.f;
  for (int idx = tid; idx < kTile2 * d.d_in; idx += kThreads) s_dpts[idx] = 0.f;
  __syncthreads();

  for (int li = d.n_layers - 1; li >= 0; --li) {
    // this layer's g_z for the dW pass (k2_dw), 16-byte stores
    const int ldg = pad16(d.out_dim[li]) / 4;
    float4* gdst = reinterpret_cast<float4*>(gws + (size_t)x_rows * d.z_off[li]) + (size_t)p0 * ldg;
    for (int idx = tid; idx < kTile2 * ldg; idx += kThreads) {
      const int p = idx / ldg, c = idx - p * ldg;
      gdst[idx] = reinterpret_cast<const float4*>(G + p * kLdG)[c];
    }
    const LayerInput X = layer_input(d, li, xws, x_rows, pts, view, T);
    gx_layer<kTile2 / 16>(d, FT, li, G, X, s_dpts, s_gd, d_view_g, p0, T);
    __syncthreads();  // G holds the previous layer's g_z
  }
  for (int idx = tid; idx < kTile2 * d.d_in; idx += kThreads) {
    const int p = idx / d.d_in;
    if (p0 + p < T) d_pts[(size_t)p0 * d.d_in + idx] = s_dpts[idx];
  }
}

// The wide plan's pass 1: the same on 64-point tiles (k2_backward keeps a
// body of its own, so that it compiles as it did). Shared memory: the
// forward's buffers, then G (row stride ld_g), d_pts and g_density over them:
// the recompute's buffers are dead by then.
__global__ void __launch_bounds__(kThreads, 1)
k2_backward_w(MLPDesc d, const Frag* __restrict__ F,
              const Frag* __restrict__ FT, const float* __restrict__ pts,
              const float* __restrict__ view, const float* __restrict__ gout,
              float* __restrict__ d_pts, float* __restrict__ d_view_g, float* __restrict__ xws,
              float* __restrict__ gws, int T, int x_rows) {
  constexpr int P = kTileW;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ldG = d.ld_g;
  float* s_dpts = smem + P * ldG;
  float* s_gd = s_dpts + P * d.d_in;
  float* G = smem;  // g_z of the current layer, over the recompute's buffers
  const int tid = threadIdx.x, p0 = blockIdx.x * P;

  forward_tile<P / 16>(d, F, pts, view, smem, nullptr, xws, x_rows, d.n_layers - 1, p0, T);
  for (int idx = tid; idx < P * 16; idx += kThreads) {  // g_z of the last layer
    const int p = idx >> 4, o = idx & 15;
    G[p * ldG + o] = (o < 3 && p0 + p < T) ? gout[(size_t)(p0 + p) * 4 + 1 + o] : 0.f;
  }
  for (int p = tid; p < P; p += kThreads) s_gd[p] = (p0 + p < T) ? gout[(size_t)(p0 + p) * 4] : 0.f;
  for (int idx = tid; idx < P * d.d_in; idx += kThreads) s_dpts[idx] = 0.f;
  __syncthreads();

  for (int li = d.n_layers - 1; li >= 0; --li) {
    const int ldg = pad16(d.out_dim[li]) / 4;
    float4* gdst = reinterpret_cast<float4*>(gws + (size_t)x_rows * d.z_off[li]) + (size_t)p0 * ldg;
    for (int idx = tid; idx < P * ldg; idx += kThreads) {
      const int p = idx / ldg, c = idx - p * ldg;
      gdst[idx] = reinterpret_cast<const float4*>(G + p * ldG)[c];
    }
    const LayerInput X = layer_input(d, li, xws, x_rows, pts, view, T);
    gx_layer<P / 16>(d, FT, li, G, X, s_dpts, s_gd, d_view_g, p0, T);
    __syncthreads();  // G holds the previous layer's g_z
  }
  for (int idx = tid; idx < P * d.d_in; idx += kThreads) {
    const int p = idx / d.d_in;
    if (p0 + p < T) d_pts[(size_t)p0 * d.d_in + idx] = s_dpts[idx];
  }
}

// K2, pass 2: dW (pad16(out) x kp) = sum over points of g_z^T X, one
// kDwBM x kDwBN output tile per block (blockIdx.x over the tiles of every
// layer) and one of kDwSplits point ranges (blockIdx.y), written plain into
// that range's partial; db (the unrounded g_z) from the tiles of column 0.
// The points come in stages of kDwBK through shared memory (fp32), the next
// stage loaded into registers while this one's MMAs run; both operands are
// split (3xTF32) as they are read. Warp (wm, wn) =
// (w % 4, w / 4) owns rows wm*32 .. +32 (2 m-tiles) and columns wn*64 .. +64
// (8 n-tiles).
__global__ void __launch_bounds__(kThreads, 1)
k2_dw(MLPDesc d, const float* __restrict__ pts, const float* __restrict__ view,
      const float* __restrict__ xws, const float* __restrict__ gws, float* __restrict__ partial,
      int T, int x_rows) {
  constexpr int ld = Tf32x3::kLdDw;
  __shared__ float Gs[kDwBK * ld], Xs[kDwBK * ld];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;
  int li = 0;
  while (li + 1 < d.n_layers && (int)blockIdx.x >= d.t_off[li + 1]) ++li;
  const int ldg = pad16(d.out_dim[li]), kp = d.kp[li];
  const int n_col_tiles = (kp + kDwBN - 1) / kDwBN, tile = blockIdx.x - d.t_off[li];
  const int row0 = (tile / n_col_tiles) * kDwBM, col0 = (tile % n_col_tiles) * kDwBN;
  const int rows = min(kDwBM, ldg - row0), cols = min(kDwBN, kp - col0);
  const float* Gl = gws + (size_t)x_rows * d.z_off[li];
  const LayerInput X = layer_input(d, li, xws, x_rows, pts, view, T);
  const int per = (x_rows / kDwBK + kDwSplits - 1) / kDwSplits * kDwBK;
  const int P_begin = blockIdx.y * per, P_end = min(x_rows, P_begin + per);

  constexpr int kLoads = kDwBK * kDwBM / kThreads;  // per thread and operand: 16
  float gr[kLoads], xr[kLoads];
  auto load_stage = [&](int P0) {
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int idx = tid + i * kThreads, p = idx / kDwBM, c = idx % kDwBM;
      gr[i] = c < rows ? Gl[(size_t)(P0 + p) * ldg + row0 + c] : 0.f;
      xr[i] = c < cols ? X(P0 + p, col0 + c) : 0.f;
    }
  };
  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;
  float bias = 0.f;  // db of row tid (column-0 tiles)

  if (P_begin < P_end) load_stage(P_begin);
  for (int P0 = P_begin; P0 < P_end; P0 += kDwBK) {
    __syncthreads();  // the previous stage's MMAs are done with Gs / Xs
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int idx = tid + i * kThreads, p = idx / kDwBM, c = idx % kDwBM;
      Gs[p * ld + c] = gr[i];
      Xs[p * ld + c] = xr[i];
    }
    __syncthreads();
    if (P0 + kDwBK < P_end) load_stage(P0 + kDwBK);
    if (col0 == 0 && tid < kDwBM)
      for (int p = 0; p < kDwBK; ++p) bias += Gs[p * ld + tid];
#pragma unroll
    for (int ks = 0; ks < kDwBK / Tf32x3::kK; ++ks) {
      // A[m = output][k = point] = Gs[point][output]; B[k = point][n = input] = Xs[point][input]
      const float* ga = Gs + (ks * 8 + t) * ld + wm * 32 + g;
      const float* xb = Xs + (ks * 8 + t) * ld + wn * 64 + g;
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        split(ga[i * 16], ah[i][0], al[i][0]);
        split(ga[i * 16 + 8], ah[i][1], al[i][1]);
        split(ga[4 * ld + i * 16], ah[i][2], al[i][2]);
        split(ga[4 * ld + i * 16 + 8], ah[i][3], al[i][3]);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint32_t bh0, bl0, bh1, bl1;
        split(xb[j * 8], bh0, bl0);
        split(xb[4 * ld + j * 8], bh1, bl1);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_tf32(acc[i][j], al[i], bh0, bh1);
          mma_tf32(acc[i][j], ah[i], bl0, bl1);
          mma_tf32(acc[i][j], ah[i], bh0, bh1);
        }
      }
    }
  }
  float* out = partial + (size_t)blockIdx.y * d.n_part + d.g_off[li];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = wm * 32 + i * 16 + g + 8 * (c >> 1), k = wn * 64 + j * 8 + 2 * t + (c & 1);
        if (r < rows && k < cols) out[(size_t)(row0 + r) * kp + col0 + k] = acc[i][j][c];
      }
  if (col0 == 0 && tid < rows && row0 + tid < d.out_dim[li])
    out[(size_t)ldg * kp + row0 + tid] = bias;
}

// Sums the kDwSplits partials in order (deterministic) into the (out, in)
// layout of the flat gradient.
__global__ void k2_reduce(MLPDesc d, const float* __restrict__ partial, float* __restrict__ out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= d.n_params) return;
  int li = 0;
  while (li + 1 < d.n_layers && j >= d.w_off[li + 1]) ++li;
  const int kp = d.kp[li];
  int pos;
  if (j < d.b_off[li]) {
    const int r = j - d.w_off[li], n = r / d.in_dim[li], k = r - n * d.in_dim[li];
    pos = d.g_off[li] + n * kp + (k < d.w1[li] ? k : d.k1p[li] + k - d.w1[li]);
  } else {
    pos = d.g_off[li] + pad16(d.out_dim[li]) * kp + (j - d.b_off[li]);
  }
  float s = 0.f;
  for (int g = 0; g < kDwSplits; ++g) s += partial[(size_t)g * d.n_part + pos];
  out[j] = s;
}

int launch_pack(const MLPDesc& d, void* frag, void* frag_t, cudaStream_t s) {
  const int blocks = (d.n_frag + kThreads - 1) / kThreads;
  k_pack<<<dim3(blocks, frag_t != nullptr ? 2 : 1), kThreads, 0, s>>>(
      d, static_cast<Frag*>(frag), static_cast<Frag*>(frag_t));
  return static_cast<int>(cudaGetLastError());
}

int forward(const MLPDesc& d, const float* pts, const float* view, float* out, int T, void* frag,
            int packed, cudaStream_t s) {
  const int smem = k1_smem_bytes(d);
  if (smem > kMaxSmem) return -4;
  if (T <= 0) return 0;
  void (*kernel)(MLPDesc, const Frag*, const float*, const float*, float*, int) =
      d.wide ? k3_forward_w : k3_forward;
  if (!packed) {
    const int rc = launch_pack(d, frag, nullptr, s);
    if (rc != 0) return rc;
    kernel = d.wide ? k1_forward_w : k1_forward;
  }
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const int tile = d.wide ? kTileW : kTile1, blocks = (T + tile - 1) / tile;
  kernel<<<blocks, kThreads, smem, s>>>(d, static_cast<const Frag*>(frag), pts, view,
                                        out, T);
  return static_cast<int>(cudaGetLastError());
}

int backward(const MLPDesc& d, const float* pts, const float* view, const float* gout,
             float* d_pts, float* d_view, float* d_params, void* frag, void* frag_t,
             float* partial, float* workspace, int T, cudaStream_t s) {
  const int smem = k2_smem_bytes(d);
  if (smem > kMaxSmem) return -4;
  if (T <= 0) return -5;
  const int n_tiles = (T + kTile2 - 1) / kTile2, x_rows = n_tiles * kTile2;
  int rc = launch_pack(d, frag, frag_t, s);
  if (rc != 0) return rc;
  float* xws = workspace;
  float* gws = workspace + (size_t)x_rows * d.x_total;
  // the workspace's rows: T rounded up to 128 in either plan
  const auto kernel = d.wide ? k2_backward_w : k2_backward;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  kernel<<<x_rows / (d.wide ? kTileW : kTile2), kThreads, smem, s>>>(
      d, static_cast<const Frag*>(frag), static_cast<const Frag*>(frag_t),
      pts, view, gout, d_pts, d_view, xws, gws, T, x_rows);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
#ifndef K2_TIME_NO_DW
  k2_dw<<<dim3(d.n_dw_tiles, kDwSplits), kThreads, 0, s>>>(d, pts, view, xws, gws, partial, T,
                                                              x_rows);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
#endif
  k2_reduce<<<(d.n_params + kThreads - 1) / kThreads, kThreads, 0, s>>>(d, partial, d_params);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// [n_params, n_frag_elems, n_part, x_total, g_total, n_splits, tile] of the
// chain (n_frag_elems: floats of one fragment set, 4 per fragment; tile: the
// points of one block of K1, K2 and K3, 128 or 64 in the wide plan), or a
// negative code: also -4 where K1's or K2's activations do not fit one block.
int sparf_fused_mlp_sizes_tf32(const int* dims, int* sizes) {
  static const void* const null_params[2 * kMaxLayers] = {};
  MLPDesc d;
  const int rc = build_desc(dims, null_params, &d);
  if (rc < 0) return rc;
  if (k1_smem_bytes(d) > kMaxSmem || k2_smem_bytes(d) > kMaxSmem) return -4;
  sizes[0] = d.n_params;
  sizes[1] = 4 * d.n_frag;
  sizes[2] = d.n_part;
  sizes[3] = d.x_total;
  sizes[4] = d.g_total;
  sizes[5] = kDwSplits;
  sizes[6] = d.wide ? kTileW : kTile1;
  return 0;
}

// Packs params = [W (out, in), b (out), ...] into B fragments: frag for the
// forward, frag_t (may be null) for K2's g_x; each n_frag_elems, 16-byte aligned.
int sparf_fused_mlp_pack_tf32(const int* dims, const void* const* params, void* frag,
                              void* frag_t, void* stream) {
  MLPDesc d;
  const int rc = build_desc(dims, params, &d);
  if (rc < 0) return rc;
  return launch_pack(d, frag, frag_t, static_cast<cudaStream_t>(stream));
}

// K1 (packed = 0: packs params into frag first) and K3 (packed = 1: frag
// comes from sparf_fused_mlp_pack_tf32): out (T, 4) = [raw_density | raw_rgb].
int sparf_fused_mlp_forward_tf32(const float* pts, const float* view, float* out, int T,
                                 const int* dims, const void* const* params, void* frag,
                                 int packed, void* stream) {
  MLPDesc d;
  const int rc = build_desc(dims, params, &d);
  if (rc < 0) return rc;
  return forward(d, pts, view, out, T, frag, packed, static_cast<cudaStream_t>(stream));
}

// K2. gout (T, 4) = [g_density | g_rgb]; d_params (n_params,) in the order
// W0, b0, W1, b1, ...; frag and frag_t are scratch of n_frag_elems each,
// partial of n_splits * n_part floats and workspace of T_pad * (x_total +
// g_total) floats, T_pad = T rounded up to a multiple of 128.
int sparf_fused_mlp_backward_tf32(const float* pts, const float* view, const float* gout,
                                  float* d_pts, float* d_view, float* d_params, void* frag,
                                  void* frag_t, float* partial, float* workspace, int T,
                                  const int* dims, const void* const* params, void* stream) {
  MLPDesc d;
  const int rc = build_desc(dims, params, &d);
  if (rc < 0) return rc;
  return backward(d, pts, view, gout, d_pts, d_view, d_params, frag, frag_t, partial,
                          workspace, T, static_cast<cudaStream_t>(stream));
}

const char* sparf_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

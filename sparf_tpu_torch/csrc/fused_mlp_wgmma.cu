// The bf16 fused NeRF-MLP forward (K1, K3) and backward (K2), and the
// float32 (3xTF32) ones, for Hopper (sm_90a) on warpgroup MMAs (wgmma) fed
// by the Tensor Memory Accelerator (TMA). The float32 kernels have their own
// notes below ("The float32 K2", "The float32 K1/K3").
//
// Replaces, at compute_dtype bfloat16, the Pallas TPU kernels of
// sparf_tpu/ops/fused_mlp_vjp.py: K1 = _fwd_kernel (:175, launched by
// _core_forward) and K2 = _bwd_kernel (:86, the custom_vjp backward); and of
// sparf_tpu/ops/fused_mlp.py: K3 = _kernel (:97), the forward on weights
// laid out once per call (k3_wg: K1's body, forward_tile, under a symbol of
// its own, so K3 gives K1's bits). The float32 (3xTF32) K1, K2 and K3 of
// the chains the float32 kernels below do not take are fused_mlp.cu's
// (mma.sync on packed fragments); this file is compiled once, beside that
// file (ops/_build.py), and its entry points are sparf_fused_mlp_wg_* (bf16)
// and sparf_fused_mlp_tf32wg_* (the float32 K1, K2 and K3).
//
// The compute_dtype contract of the TPU kernels: each dot takes its two
// operands rounded to bf16 (round to nearest even) and sums in fp32; bias,
// ReLU and its masks, g_x, d_pts_enc and d_view_enc stay fp32; db sums the
// unrounded g_z; dW = bf16(g_z)^T bf16(x), g_x = bf16(g_z) bf16(W).
//
// What bounds them on an H100 (T = 262,144 points, the 8x256 chain with the
// 128-wide view head: 527,872 multiply-adds per point), and what the design
// does about it:
//   * K1 and K3: 0.28 ms of bf16 tensor-core work; bytes < 0.05 ms. Each
//     128-point tile streams every weight (1.2 MB in bf16) from L2. K3 runs
//     K1's loop and only drops K1's layout of the weights (k_wg_layout) from
//     each launch: pack_weights lays them out once per call. Design: per tile
//     one block of two consumer warpgroups (64 points each) and one producer
//     warpgroup. The tile's activations stay in shared memory as bf16, in
//     wgmma's 128-byte-swizzled K-major layout ([points][64 columns] chunks),
//     written once per layer by the epilogue (ReLU in fp32, then rounded;
//     each sum starts from its bias, in fp32): that is the A operand every
//     next product reads. W is
//     streamed per layer in 64-column k-chunks by TMA ([rows][64] boxes,
//     the same swizzle) through a 3-stage ring of 33 KB stages, full and
//     empty mbarriers between the producer and the consumers. One
//     m64nNk16 wgmma per 16 columns, N = the layer's width (256, 128, 8 for
//     the RGB output) plus one m64n8k16 for the density unit of the 257-wide
//     layer; the skip concat [features | pts_enc] and the view concat
//     [features | view_enc] are two segments of the k loop (their own
//     chunks), never a copy.
//   * K2: 0.84 ms of tensor-core work (recompute, g_x and dW); its floor is
//     the workspace: every layer's input X and every g_z, stored by the
//     backward pass and read by the dW pass. It is bf16 (exactly the
//     operands dW rounds to): 9.3 KB per point, 2.4 GB written and read at
//     T = 262,144, >= 1.45 ms at 3.35 TB/s (the earlier fp32 workspace: 17.5
//     KB per point). Design, three passes and a reduction:
//     - k2_wg (one block per 128-point tile, the same roles and ring): the
//       recompute runs K1's layer loop and stores each layer's input chunks
//       to the workspace with TMA stores straight from shared memory; then,
//       from the last layer down, g_z sits in shared memory as bf16 (the A
//       operand), is stored to the workspace by TMA, and g_x = g_z W runs on
//       wgmma against the transposed weights (TMA through the same ring): the
//       second segment first (pts_enc's share of a skip layer into d_pts,
//       view_enc's into d_view), then the features, masked by X > 0 into the
//       previous layer's g_z, in place. The ReLU masks are the fp32 X > 0,
//       not the bf16 copy's (a positive fp32 subnormal can round to +0): the
//       recompute keeps each thread's mask bits of its accumulator fragment
//       (16 bytes per thread and layer) and the backward reads them back in
//       the same thread with one load issued before the layer's products
//       (reading the bf16 X back for it was a chain of global loads per
//       layer). db leaves the workspace: each warpgroup writes the column
//       sums of its 64 points' fp32 g_z per layer (a warp reduce-scatter, a
//       fixed order, no atomics, no barrier between the two warpgroups, so
//       one's epilogue runs beside the other's MMAs).
//     - k2_dw_wg: dW = g_z^T X per layer as a GEMM over the points: 128 x N
//       output tiles (N = 256, 128 or 64 input columns) x 64 point ranges;
//       both operands come point-major from the workspace ([64 points][64
//       columns] TMA boxes, 4-stage ring of 48 KB), read by wgmma in its
//       transposed (MN-major) mode, which 16-bit types allow; each range
//       writes its partial, and the db partials of its tiles in order.
//     - k2_reduce_wg sums the 64 ranges in order into the (out, in) layout:
//       two runs give the same bits.
//   * Weights: k_wg_layout writes every W as bf16 in the two layouts the
//     TMA maps read (K1 and K2 on each launch, K1 the forward one only; for
//     K3 pack_weights, once per call, the forward one): forward rows =
//     outputs (the density unit of the last trunk layer moved behind the
//     features, so the features feed the next layer's columns 0..), columns
//     = the padded input segments; transposed rows = the padded input,
//     columns = the same output order; and the biases in the forward row
//     order.
//     ops/fused_mlp.py::wgmma_layout_plain is the same map.
//   * Registers: 384 threads, one block per SM; the producer warpgroup
//     (one thread issues the TMA loads) gives its registers to the two
//     consumer warpgroups (setmaxnreg: 56 and 224 per thread); the
//     accumulators of one 64 x 256 product are 128 of them. No kernel
//     spills. Global loads are issued in batches ahead of the shared-memory
//     stores (whose asm carries a memory clobber), and L2 keeps the weights
//     (evict_last) while the workspace streams through (evict_first).
//   * Measured on an H100 80GB HBM3 at 700 W (PERF.md, PR 10): K1 0.67 ms
//     (from 2.11 on mma.sync) and K2 3.55 ms (from 13.66) at T = 262,144;
//     of K2, the dW pass 0.94 ms; K3's time is beside them in PERF.md.
//
// Shapes the kernels take, in two plans that build_wg_desc picks per chain
// before any launch (else -7, which sparf_fused_mlp_wg_sizes returns and
// ops/fused_mlp.py raises as ValueError naming cfg.tpu.use_pallas=False; its
// mirror is ops/fused_mlp.py::wg_layout):
//   * Plan M (k1_wg, k2_wg, k3_wg; the design above, unchanged, and the
//     presets' 8x256 chain): pts_enc and view_enc at most 64 wide, every
//     layer's features at most 256 and, as a layer's input, padded to 64,
//     128 or 256. At the last trunk layer the density row sits at nm >= 64,
//     past the next layer's padded input (with 32 features or fewer it sat
//     at 8 or 32, where that input's zeros overwrote its gradient).
//   * Plan N (k1_wg_n, k2_wg_n, k3_wg_n; every other chain of 1-16 layers
//     with at most 512 features per layer and pts_enc and view_enc at most
//     128 wide): 64-point tiles, and the two consumer warpgroups split N
//     instead of M: each takes one half of every product (the forward's
//     nm / 2 = pad64(features) / 2, a multiple of 32, 8 at the RGB output;
//     g_x's k1p / 2 and pad64(w2) / 2) for the tile's 64 points, so a
//     512-wide layer is two m64n256 products, 128 accumulators per thread
//     as in plan M, and the forward's halves are g_x's, so a thread's ReLU
//     mask bits are its own again in the backward. Activations: chunks of
//     [64 points][64 columns] (8 KB): the features (pad64 of the widest
//     input), then pts_enc's and view_enc's (1 or 2 each); g_z over them.
//     Weights: each k-chunk is two ring stages, warpgroup 0's rows then 1's
//     (with the density rows at the last trunk layer), loaded as boxes of 32
//     rows (8 for the RGB output and the density rows: the 128-byte swizzle
//     repeats every 8 rows, so boxes laid end to end read as one); each
//     warpgroup waits only for its own stages, on full barriers of its own
//     (Ring::acquire_own: TMA fills of two slots complete in either order),
//     and releases them (4 warps per empty barrier). Both warpgroups read every
//     input chunk and the epilogue overwrites them in place, so a barrier of
//     the 256 consumer threads (bar.sync 3) stands before each epilogue and
//     after it, and one thread issues the workspace's TMA stores. Shared
//     memory at the corner (512 features, both encodings 128 wide): 12
//     chunks, 96 KB; the ring, 3 x 33 KB; dbuf for 576 columns (512
//     features, the density unit) x 8 warps, 18 KB; the barriers and 1 KB of
//     alignment: 219,208 bytes of 232,448. K2's dW pass and its reduction
//     are plan M's (they read only the workspace, whose rows are T rounded
//     up to 128 in both plans).
//
// The float32 K2 (k_tf_layout, k2_tf, k2_dw_tf, k2_reduce_tf) replaces, at
// compute_dtype float32, sparf_tpu/ops/fused_mlp_vjp.py::_bwd_kernel (:86)
// for every chain plan M takes (build_tf_desc, mirrored by
// ops/fused_mlp.py::tf32wg_layout; the presets' 8x256 chain among them);
// fused_mlp.cu's mma.sync K2 runs the other chains. Its arithmetic is
// fused_mlp.cu's 3xTF32: each operand x is split into hi = TF32 of x (round
// to nearest, ties away, by integer add and mask: fused_mlp.cu's split) and
// lo = x - hi, and each product is lo(A) hi(B) + hi(A) lo(B) + hi(A) hi(B),
// summed in fp32 (wgmma m64nNk8 .tf32, which truncates each operand word
// to TF32: hi is exact in it, and lo loses only what 3xTF32 drops). The
// weights' hi and lo are laid out once per launch by k_tf_layout
// (ops/fused_mlp.py::tf32wg_weights_plain); activations and g_z are split
// as they are read.
//   * Bound on an H100 (T = 262,144, the presets' chain): three TF32
//     products for each of the recompute's, g_x's and dW's ~527,872
//     multiply-adds per point, 5.03 ms at 495 TFLOP/s (the benchmark's
//     count, one product per multiply-add and no recompute: 1.12 ms); its
//     workspace, every layer's input and g_z in fp32 (17.8 KB per point,
//     written once and read once, 9.3 GB), >= 2.8 ms at 3.35 TB/s.
//   * TF32 wgmma reads shared-memory operands only K-major (the transposed
//     mode is for 16-bit types). The layer products put the points on M:
//     A (the activations, g_z) comes from registers, split as loaded, and B
//     (the weights' hi or lo) is a TMA-fed K-major box. dW = g_z^T X puts
//     the points on K: the workspace stores every column point-contiguous
//     ([column][point] rows), so that both of dW's operands are K-major
//     boxes that TMA loads as they lie: g_z feeds A from registers, X is B.
//   * Pass 1 (k2_tf; plan M's tile and roles): 128-point tiles, two consumer
//     warpgroups of 64 points that take every product's full N (up to 256:
//     128 accumulators a thread), one producer thread that issues a TMA box
//     of one 32-column k-chunk of the hi or the lo weights per ring stage
//     (32 KB, three stages), setmaxnreg 56/224. Each product runs every
//     k-chunk against its hi stages (lo(A) hi(B) + hi(A) hi(B)), then
//     against its lo stages (hi(A) lo(B)). The tile's activations, then its
//     g_z, sit in shared memory in fp32 (128 x 256, columns XOR-swizzled by
//     row so that the A fragments' loads hit 32 banks; 128 KB), where each
//     warp reads and writes only its own 16 rows, so the consumers wait on
//     nothing but the ring. The recompute keeps the ReLU masks as each
//     thread's bits (plan M's words); the density unit's g_x column comes
//     from gout. A layer's input (and g_z) goes to the workspace while the
//     next product's MMAs run, a slice per k-chunk, not in the epilogue.
//   * Pass 2 (k2_dw_tf): dW tiles of 128 (or 64) rows of g_z x one input
//     segment (N = 256, 128, 64 or 32) over 64 point ranges; per stage of
//     32 points the g_z box and the X box (raw fp32, three stages of 48 KB),
//     the X box split by the 256 consumers into hi (in place) and lo (one of
//     two 32-KB buffers), the next stage's while this one's MMAs run; db
//     from the A fragments' rows; k2_reduce_tf sums the 64 partials in
//     order: no atomics, two runs give the same bits.
//   * Measured on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md): 10.71 ms at T
//     = 262,144, beside 23.03 ms of fused_mlp.cu's k2_backward + k2_dw +
//     k2_reduce on the same card; by part (timing-only builds): recompute
//     MMAs 2.85 ms, g_x MMAs 1.99, dW pass 3.36, the rest of pass 1 ~2.7.
//     ptxas serializes both passes' MMAs (their register-fed A beside up to
//     128 accumulators; C7512 in the build log). A dW pass with both
//     operands in shared memory (the g_z box split too, in two 96-KB
//     stages) ran unserialized, and 0.7-0.9 ms slower.
//
// The float32 K1/K3 (k1_tf, k3_tf, on the forward half of k_tf_layout)
// replace, at compute_dtype float32, sparf_tpu/ops/fused_mlp_vjp.py::
// _fwd_kernel (:175, K1) and sparf_tpu/ops/fused_mlp.py::_kernel (:97, K3)
// on the chains the float32 K2 takes (build_tf_desc: K1/K3 go where K2
// goes); fused_mlp.cu's k1_forward / k3_forward run the others. One body
// (ft_tile) under two symbols, so K3 gives K1's bits: K1 lays the forward
// half out on each launch, K3 reads the one pack_weights laid out once per
// call. The arithmetic is K2's 3xTF32 (the split above).
//   * Bound on an H100 (T = 262,144, the presets' chain): three TF32
//     products for each of ~527,872 multiply-adds per point, 1.677 ms at 495
//     TFLOP/s (the benchmark's count, one product: 0.559 ms); device memory
//     < 0.05 ms. Every 128-point tile streams the chain's hi and lo weights
//     from L2: 4.2 MB a tile, 8.6 GB a launch.
//   * Design: k2_tf's pass-1 tile, roles and shared memory (128 points, two
//     consumer warpgroups of 64, one producer thread, a ring of three 32-KB
//     stages, the activations in fp32 at act_at), without the workspace,
//     the mask words and g_z; the epilogue writes [raw_density | raw_rgb].
//     A stage holds one 16-column k-chunk of a layer's weights, its hi rows
//     then its lo rows, 64 bytes a row (TMA's 64-byte swizzle, wgmma layout
//     type 2), so the A fragments of a chunk are loaded and split once and
//     feed all three products of its two k-steps (six m64nNk8 MMAs); K2's
//     recompute loads and splits them once for its hi stages and again for
//     its lo. The density unit and the RGB output are 8-wide products
//     (m64n8k8) on one stage each that holds their 8 forward rows over every
//     k-chunk (rows rd and rf of the last layer, behind K2's rows); the
//     density's runs after the last trunk layer's features, before their
//     epilogue overwrites the layer's input.
//   * Limits (a) and (b) of the float32 K2's pass 1: this kernel addresses
//     (a) in part: half the A loads and splits of K2's recompute for the
//     same products, and no workspace stores beside the MMAs; the forward
//     runs whole in less time than the recompute's MMAs took inside K2
//     (2.85 ms). ptxas still serializes the register-fed wgmma (C7512,
//     insufficient register resources: the 128 accumulators, the A fragments
//     and the addresses fill the 168 registers a thread that ptxas allocates
//     for a 384-thread block; the consumers' setmaxnreg does not raise it:
//     the SASS uses R0-R167; 32 bytes spilled). (b) does not bind here: a
//     timing-only build whose producer loads nothing ran 2.55-2.61 ms beside
//     2.63-2.69, and a 2-block cluster that shared each stage by TMA
//     multicast (half the L2 bytes) ran 3.88-3.91 ms, both blocks pacing
//     each other's releases; it was not kept.
//   * Measured on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md): K1 2.61-2.70
//     ms and K3 2.56-2.60 ms at T = 262,144, beside 4.93-5.09 and 4.89-5.08
//     ms of fused_mlp.cu's k1_forward and k3_forward in the same calls: 0.62-
//     0.66 of the 3xTF32 bound (0.33 before).
//
// Timing-only builds (sparf_tpu_torch/kernel_split.py): K2_TIME_NO_FWD,
// K2_TIME_NO_DW and K2_TIME_NO_GX drop the recompute's MMAs, the dW pass and
// the g_x MMAs (of both K2s of this file); their outputs are wrong and only
// their times are read.
//
// Interface: plain C, loaded with ctypes; every entry point launches on the
// given stream, allocates nothing, and returns cudaGetLastError() (> 0), a
// negative code, or 0.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kMaxLayers = 16;
constexpr int kTile = 128;                 // points per tile (two warpgroups of 64)
constexpr int kThreadsWg = 384;            // two consumer warpgroups, one producer warpgroup
constexpr int kConsumers = 256;
constexpr int kChunkBytes = kTile * 128;   // one [128 points][64 bf16] chunk
constexpr int kRowsBytes = 64 * 128;       // one warpgroup's 64 points of a chunk
constexpr int kActChunks = 6;              // features 0-3, pts_enc 4, view_enc 5
constexpr int kDbufColsN = 576;            // plan N: g_z columns (512 features, the density unit)
constexpr int kFwdStages = 3;
constexpr int kStageBytes = (256 + 8) * 128;  // W box of up to 256 rows + the density rows
constexpr int kDbufCols = 320;
constexpr int kRingOff = kActChunks * kChunkBytes;
constexpr int kDbufOff = kRingOff + kFwdStages * kStageBytes;
constexpr int kBarOff = kDbufOff + 8 * kDbufCols * 4;
constexpr int kFwdSmem = kBarOff + 2 * kFwdStages * 8 + 1024;  // + alignment slack
constexpr int kDwStages = 4;
constexpr int kDwStageBytes = (2 + 4) * 8192;  // two g_z boxes, up to four X boxes
constexpr int kDwSmem = kDwStages * kDwStageBytes + 2 * kDwStages * 8 + 1024;
constexpr int kSplits = 64;                // dW point ranges summed by k2_reduce_wg
constexpr int kCodes = 5;                  // TMA box heights
constexpr int kMaxSmem = 232448;          // a block's dynamic shared memory on an H100
static_assert(kFwdSmem <= kMaxSmem && kDwSmem <= kMaxSmem, "shared memory of one block");

__host__ __device__ constexpr int code_height(int c) {
  return c == 0 ? 8 : (c == 1 ? 32 : (c == 2 ? 64 : (c == 3 ? 128 : 256)));
}
__host__ __device__ constexpr int pad64(int x) { return (x + 63) / 64 * 64; }

// The chain as the kernels run it. Layer row order ("rows"): the outputs,
// except at the last trunk layer (dens), whose features come first (rows 0
// .. out-2) and whose density unit sits at row nm, behind the nm main rows.
struct WgDesc {
  int n_layers, n_feat, d_in, d_view;
  int n_params, n_part, n_dw_tiles;
  int KF, RF;      // forward weights: RF rows x KF columns (bf16)
  int KT, RT;      // transposed weights: RT rows x KT columns
  int KX, KG;      // workspace columns per point: stored inputs, g_z (bf16)
  int out[kMaxLayers], in[kMaxLayers], w1[kMaxLayers], w2[kMaxLayers];
  int k1p[kMaxLayers], kp[kMaxLayers];  // segment 1 padded to 64; both segments
  int seg2c[kMaxLayers];  // chunk of the second segment: 4 (pts_enc), 5 (view_enc), -1
  int dens[kMaxLayers];   // 1 at the last trunk layer (unit 0 is raw density)
  int nm[kMaxLayers], ncode[kMaxLayers];  // the forward product's N and its box code
  int kz[kMaxLayers];     // g_z columns: rows padded to 64 (g_x's K, dW's M)
  int rf[kMaxLayers], rt[kMaxLayers];     // first row in the forward / transposed weights
  int xo[kMaxLayers], go[kMaxLayers];     // first workspace column of X / g_z
  int po[kMaxLayers];     // offset of the layer's dW (kz x kp) and db (kz) in a partial
  int wo[kMaxLayers], bo[kMaxLayers];     // flat gradient offsets, (out, in) layout
  int to[kMaxLayers + 1], nnt[kMaxLayers];  // dW tiles before the layer; n-tiles per m-block
  const float* W[kMaxLayers];
  const float* b[kMaxLayers];
  int plan;        // 0: plan M (128-point tiles), 1: plan N (64-point tiles, split outputs)
  // a warpgroup's share of each product: the forward's N (plan M nm, plan N
  // nm / 2), g_x's N over the features (k1p, k1p / 2) and over the second
  // segment (64, its padded width / 2); that segment's chunks
  int nw[kMaxLayers], nx[kMaxLayers], n2w[kMaxLayers], n2c[kMaxLayers];
  // plan N's shared memory: activation chunks, first pts_enc and view_enc
  // chunk, offsets of the ring, dbuf and the barriers, bytes in all
  int n_act, c_pts, c_view, nc_pts, nc_view, ring_off, dbuf_off, bar_off, smem;
};

struct Maps {
  CUtensorMap wf[kCodes];  // forward weights, box {64, code_height}
  CUtensorMap wt[kCodes];  // transposed weights
  CUtensorMap x, g;        // workspace, box {64 columns, 64 points}
};

int code_of(int n) {
  for (int c = 0; c < kCodes; ++c)
    if (code_height(c) >= n) return c;
  return -1;
}

int n_tiles_of(int kp) {  // dW n-tiles over kp columns: 256 while it lasts, then 128, 64
  int n = 0;
  for (int n0 = 0; n0 < kp; ++n) n0 += kp - n0 >= 256 ? 256 : (kp - n0 >= 128 ? 128 : 64);
  return n;
}

// The chain's layer rows, padded inputs, workspace columns and weight
// offsets in plan M (split = false) or plan N; false where the plan does not
// take the chain (a width) or its widths do not match (*bad).
bool layout_wg_desc(const int* dims, const void* const* params, bool split, WgDesc* d, bool* bad) {
  memset(d, 0, sizeof(*d));
  d->plan = split ? 1 : 0;
  d->n_feat = dims[0];
  const int n_rgb = dims[1];
  d->n_layers = d->n_feat + n_rgb;
  d->d_in = dims[2];
  d->d_view = dims[3];
  const int view_dep = dims[4], max_enc = split ? 128 : 64;
  if (d->d_in < 1 || d->d_in > max_enc || d->d_view < 0 || d->d_view > max_enc) return false;
  d->nc_pts = pad64(d->d_in) / 64;
  d->nc_view = pad64(d->d_view) / 64;
  int off = 0, tiles = 0, feat_chunks = 1, max_kz = 64;
  d->KF = d->KT = 64;
  for (int li = 0; li < d->n_layers; ++li) {
    const int out = dims[5 + 3 * li], in = dims[6 + 3 * li], skip = dims[7 + 3 * li];
    const int w2 = skip ? d->d_in : ((li == d->n_feat && view_dep) ? d->d_view : 0);
    const int w1 = in - w2, dens = li == d->n_feat - 1, last = li == d->n_layers - 1;
    if (out < 1 + dens || w1 < 1 || (li == 0 && (skip || w1 != d->d_in)) ||
        (li > 0 && d->out[li - 1] - d->dens[li - 1] != w1)) {
      *bad = true;
      return false;
    }
    const int k1p = pad64(w1);
    int nm, nw, ncode = 0;
    if (split) {  // each warpgroup half of the outputs (the RGB output: 8 of 16 rows)
      if (out - dens > 512 || k1p > 512) return false;
      nw = last ? 8 : pad64(out - dens) / 2;
      nm = 2 * nw;
    } else {
      // (the density row sits at nm, past the next layer's padded input: so at
      // least 64 rows at the last trunk layer)
      ncode = code_of(dens && out - dens < 64 ? 64 : out - dens);
      if (ncode < 0 || (k1p != 64 && k1p != 128 && k1p != 256)) return false;
      nm = nw = code_height(ncode);
    }
    const int kz = pad64(dens ? nm + 8 : out);
    if (kz > (split ? kDbufColsN : kDbufCols)) return false;
    d->out[li] = out;
    d->in[li] = in;
    d->w1[li] = w1;
    d->w2[li] = w2;
    d->k1p[li] = k1p;
    d->kp[li] = k1p + pad64(w2);
    d->seg2c[li] = w2 == 0 ? -1 : (skip ? 4 : 5);  // plan N: set below
    d->dens[li] = dens;
    d->nm[li] = nm;
    d->ncode[li] = ncode;
    d->nw[li] = nw;
    d->nx[li] = split ? k1p / 2 : k1p;
    d->n2w[li] = split ? pad64(w2) / 2 : 64;
    d->n2c[li] = pad64(w2) / 64;
    d->kz[li] = kz;
    if (li > 0 && k1p / 64 > feat_chunks) feat_chunks = k1p / 64;
    if (kz > max_kz) max_kz = kz;
    d->rf[li] = d->RF;
    d->RF += nm + (dens ? 8 : 0);
    d->rt[li] = d->RT;
    d->RT += d->kp[li];
    if (d->kp[li] > d->KF) d->KF = d->kp[li];
    if (kz > d->KT) d->KT = kz;
    d->xo[li] = d->KX;
    d->KX += d->kp[li];
    d->go[li] = d->KG;
    d->KG += kz;
    d->po[li] = d->n_part;
    d->n_part += kz * d->kp[li] + kz;
    d->wo[li] = off;
    off += out * in;
    d->bo[li] = off;
    off += out;
    d->nnt[li] = n_tiles_of(d->kp[li]);
    d->to[li] = tiles;
    tiles += (kz + 127) / 128 * d->nnt[li];
    d->W[li] = static_cast<const float*>(params[2 * li]);
    d->b[li] = static_cast<const float*>(params[2 * li + 1]);
  }
  if (d->out[d->n_layers - 1] != 3) {
    *bad = true;
    return false;
  }
  d->to[d->n_layers] = tiles;
  d->n_dw_tiles = tiles;
  d->n_params = off;
  if (split) {
    // chunks: the features, pts_enc's, view_enc's; g_z (max_kz columns) over them
    d->c_pts = feat_chunks;
    d->c_view = feat_chunks + d->nc_pts;
    d->n_act = d->c_view + d->nc_view;
    if (max_kz / 64 > d->n_act) return false;
    for (int li = 0; li < d->n_layers; ++li)
      if (d->w2[li] > 0) d->seg2c[li] = li < d->n_feat ? d->c_pts : d->c_view;
    d->ring_off = d->n_act * kRowsBytes;
    d->dbuf_off = d->ring_off + kFwdStages * kStageBytes;
    d->bar_off = d->dbuf_off + 8 * kDbufColsN * 4;
    d->smem = d->bar_off + 3 * kFwdStages * 8 + 1024;  // two sets of full barriers
    if (d->smem > kMaxSmem) return false;
  }
  return true;
}

// dims = [n_feat, n_rgb, d_in, d_view, view_dep, (out, in, skip) per layer];
// params = [W0, b0, W1, b1, ...] (fp32, W (out, in)). Plan M where it takes
// the chain (as it always has), else plan N; -7 past both.
int build_wg_desc(const int* dims, const void* const* params, WgDesc* d) {
  const int n_layers = dims[0] + dims[1];
  if (dims[0] < 1 || dims[1] < 1 || n_layers > kMaxLayers) return -1;
  bool bad = false;
  if (layout_wg_desc(dims, params, false, d, &bad)) return 0;
  if (bad) return -3;
  if (layout_wg_desc(dims, params, true, d, &bad)) return 0;
  return bad ? -3 : -7;
}

// ---------------------------------------------------------------------------
// PTX: shared memory, mbarriers, TMA, wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// (Its memory clobber keeps loads from moving across it: the loops below
// issue their global loads in batches before their stores.)
__device__ __forceinline__ void sts32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
// A wait that has not completed after ~2^35 cycles (~20 s) traps: a fault in
// the producer / consumer schedule fails the launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long t0 = clock64();
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > (1ll << 35)) __trap();
  } while (!done);
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// L2 policies: the weights, read by every tile, stay (evict_last); the
// workspace, 2.4 GB streamed through, goes first (evict_first).
__device__ __forceinline__ uint64_t policy_keep() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n" : "=l"(p));
  return p;
}
__device__ __forceinline__ uint64_t policy_stream() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(p));
  return p;
}
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                         int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, "
      "%4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                         int c1, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint "
      "[%0], [%1, {%3, %4}], [%2], %5;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "l"(policy)
      : "memory");
}
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                          uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group.L2::cache_hint [%0, {%2, %3}], [%1], "
      "%4;\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "l"(policy)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_read() {  // the stores have read shared memory
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_all() {  // the stores are complete
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ void fence_async_smem() {  // generic writes -> TMA / wgmma reads
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wg_bar(int wg) {  // one consumer warpgroup
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// the producer warpgroup's registers to the consumers: 128 x 56 + 256 x 224
// <= 384 x 168, the block's registers at launch (each side in one branch
// that never rejoins the other)
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n" ::: "memory");
}
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n" ::: "memory");
}
// keeps the compiler from moving accumulator accesses across the async MMAs
template <int R>
__device__ __forceinline__ void fence_regs(float (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int R>
__device__ __forceinline__ void zero(float (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) r[i] = 0.f;
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile (layout type 1):
// SBO = 1024 bytes between 8-row groups; LBO = 0 for K-major (unused), the
// distance between 64-column atoms for MN-major.
__device__ __forceinline__ uint64_t sdesc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// byte offset of (row, col) in a [rows][64] bf16 tile with the 128-byte
// swizzle of TMA's CU_TENSOR_MAP_SWIZZLE_128B (the tile 1024-byte aligned)
__device__ __forceinline__ uint32_t swz(int row, int col) {
  return row * 128 + ((((col >> 3) ^ row) & 7) << 4) + ((col & 7) << 1);
}

// {bf16(lo), bf16(hi)}, round to nearest even; lo in the low half
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}
// The ReLU masks of K2 (the fp32 z > 0 of each layer's output), per
// consumer thread its accumulator fragment's bits: column block j, row half
// h, column e of the pair at bit 4 (j % 8) + 2 h + e of word j / 8 (N <= 256:
// four words). The recompute writes them, the backward reads them back in
// the same thread (ops/fused_mlp.py::relu_mask_words_plain).
__device__ __forceinline__ uint32_t mask_bit(int j, int h, int e) {
  return 1u << (4 * (j & 7) + 2 * h + e);
}

// D (64 x N, fp32, in registers) (+)= A (64 x 16) B (16 x N), bf16 operands
// from shared memory; TR = 0: both K-major, 1: both MN-major (transposed)
template <int N, int TR>
struct Wgmma;

template <>
struct Wgmma<8, 0> {
  static __device__ __forceinline__ void mma(float (&d)[4], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3"
      "}, %4, %5, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<32, 0> {
  static __device__ __forceinline__ void mma(float (&d)[16], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<64, 0> {
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<128, 0> {
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<256, 0> {
  static __device__ __forceinline__ void mma(float (&d)[128], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(scale_d));
  }
};

// plan N's warpgroup halves of 192-, 320-, 384- and 448-wide products
template <>
struct Wgmma<96, 0> {
  static __device__ __forceinline__ void mma(float (&d)[48], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<160, 0> {
  static __device__ __forceinline__ void mma(float (&d)[80], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %82, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
      "}, %80, %81, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<192, 0> {
  static __device__ __forceinline__ void mma(float (&d)[96], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<224, 0> {
  static __device__ __forceinline__ void mma(float (&d)[112], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %114, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n224k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111"
      "}, %112, %113, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111])
      : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<64, 1> {
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<128, 1> {
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<256, 1> {
  static __device__ __forceinline__ void mma(float (&d)[128], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(scale_d));
  }
};

// The ring of weight (or workspace) stages between the producer and the
// consumers: full[s] completes when the stage's TMA bytes have landed,
// empty[s] when all consumer warps that read it are done (8; in plan N the
// 4 of the warpgroup whose half it holds). A consumer keeps one chunk's
// MMAs in flight: it releases a stage once the MMAs of the next chunk are
// issued and those reading it are done (wgmma.wait_group 1).
struct Ring {
  uint32_t full, empty, data, bytes;
  int n, stage, phase;
  __device__ uint32_t buf(int s) const { return data + s * bytes; }
  // waits for the next stage's bytes; its index
  __device__ int acquire() {
    mbar_wait(full + 8 * stage, phase);
    const int s = stage;
    if (++stage == n) {
      stage = 0;
      phase ^= 1;
    }
    return s;
  }
  // Plan N (make_ring_split): stage 2 c + h of k-chunk c is warpgroup h's
  // and lands on that warpgroup's own full barrier of its slot, full + 8 (h n
  // + slot); `stage` counts the chunks. Waits for the bytes of warpgroup h's
  // next stage and returns its slot. (One full barrier per slot for both
  // would not do: fills of two slots complete in either order, so the other
  // warpgroup's fill before this stage in its slot may still be pending, and
  // a parity wait would then pass one phase early.) A slot takes warpgroup
  // h's stages every 2 n stages, each completing one phase of its barrier.
  __device__ int acquire_own(int h) {
    const int j = 2 * stage++ + h, s = j % n;
    mbar_wait(full + 8 * (h * n + s), (j / (2 * n)) & 1);
    return s;
  }
  __device__ void release(int s) const {
    if ((threadIdx.x & 31) == 0) mbar_arrive(empty + 8 * s);
  }
};

// Initializes the ring's barriers at `bars` (thread 0) and syncs the block.
__device__ __forceinline__ Ring make_ring(uint32_t data, uint32_t bytes, int n, uint32_t bars) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < n; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (n + s), kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return Ring{bars, bars + 8 * n, data, bytes, n, 0, 0};
}

// Plan N's ring: the full barriers of warpgroup 0, then of warpgroup 1
// (count 1 each), then the empty barriers (count 4: the warps of the
// warpgroup whose stage the slot holds).
__device__ __forceinline__ Ring make_ring_split(uint32_t data, uint32_t bytes, int n,
                                                uint32_t bars) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < 2 * n; ++s) mbar_init(bars + 8 * s, 1);
    for (int s = 0; s < n; ++s) mbar_init(bars + 8 * (2 * n + s), 4);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return Ring{bars, bars + 16 * n, data, bytes, n, 0, 0};
}

// The producer's side of the ring: one TMA issue per stage.
struct Producer {
  Ring r;
  // waits for the stage to be free, then loads the boxes; `bytes` in all;
  // owner (plan N): the warpgroup whose full barrier of the slot they land on
  template <typename F>
  __device__ void issue(uint32_t bytes, F load, int owner = 0) {
    mbar_wait(r.empty + 8 * r.stage, r.phase ^ 1);
    const uint32_t fb = r.full + 8 * (owner * r.n + r.stage);
    mbar_expect_tx(fb, bytes);
    load(r.buf(r.stage), fb);
    if (++r.stage == r.n) {
      r.stage = 0;
      r.phase ^= 1;
    }
  }
};

// Plan M's weight schedule (K1, K2): the forward layers' k-chunks (layers
// [0, n_fwd)), then for K2 each layer's g_x k-chunks from the last layer
// down (the second segment's product first).
__device__ void produce_weights(const Maps& m, const WgDesc& d, Ring ring, bool k2) {
  Producer p{ring};
  const uint64_t keep = policy_keep();
  const int n_fwd = k2 ? d.n_layers - 1 : d.n_layers;
  for (int li = 0; li < n_fwd; ++li) {
    const int h = code_height(d.ncode[li]), extra = d.dens[li] ? 8 : 0;
    for (int kc = 0; kc < d.kp[li] / 64; ++kc)
      p.issue((h + extra) * 128, [&](uint32_t dst, uint32_t fb) {
        tma_load(dst, &m.wf[d.ncode[li]], fb, 64 * kc, d.rf[li], keep);
        if (extra) tma_load(dst + h * 128, &m.wf[0], fb, 64 * kc, d.rf[li] + d.nm[li], keep);
      });
  }
  if (!k2) return;
  for (int li = d.n_layers - 1; li >= 0; --li) {
    const int nk = d.kz[li] / 64, k1p = d.k1p[li];
    if (d.seg2c[li] >= 0)
      for (int kc = 0; kc < nk; ++kc)
        p.issue(64 * 128, [&](uint32_t dst, uint32_t fb) {
          tma_load(dst, &m.wt[2], fb, 64 * kc, d.rt[li] + k1p, keep);
        });
    const int c1 = k1p == 64 ? 2 : (k1p == 128 ? 3 : 4);
    for (int kc = 0; kc < nk; ++kc)
      p.issue(k1p * 128, [&](uint32_t dst, uint32_t fb) {
        tma_load(dst, &m.wt[c1], fb, 64 * kc, d.rt[li], keep);
      });
  }
}

// Plan N: `rows` rows (8, or a multiple of 32: boxes of 32) of the forward
// (tr = 0) or transposed weights from row r0, k-chunk at column col, to dst.
// The 128-byte swizzle repeats every 8 rows, so boxes laid end to end read
// as one.
__device__ __forceinline__ void load_weight_rows(const Maps& m, bool tr, uint32_t dst, uint32_t fb,
                                                 int col, int r0, int rows, uint64_t keep) {
  if (rows == 8) {
    tma_load(dst, &m.wf[0], fb, col, r0, keep);
    return;
  }
  for (int i = 0; i < rows / 32; ++i)
    tma_load(dst + i * 32 * 128, tr ? &m.wt[1] : &m.wf[1], fb, col, r0 + 32 * i, keep);
}

// Plan N's weight schedule: the same order, each k-chunk as two stages, the
// rows of warpgroup 0's half of the product, then warpgroup 1's (with the
// density rows behind them at the last trunk layer).
__device__ void produce_weights_n(const Maps& m, const WgDesc& d, Ring ring, bool k2) {
  Producer p{ring};
  const uint64_t keep = policy_keep();
  const int n_fwd = k2 ? d.n_layers - 1 : d.n_layers;
  for (int li = 0; li < n_fwd; ++li) {
    const int h = d.nw[li], extra = d.dens[li] ? 8 : 0;
    for (int kc = 0; kc < d.kp[li] / 64; ++kc)
      for (int g = 0; g < 2; ++g)
        p.issue((h + (g ? extra : 0)) * 128, [&](uint32_t dst, uint32_t fb) {
          load_weight_rows(m, false, dst, fb, 64 * kc, d.rf[li] + g * h, h, keep);
          if (g && extra) tma_load(dst + h * 128, &m.wf[0], fb, 64 * kc, d.rf[li] + d.nm[li], keep);
        }, g);
  }
  if (!k2) return;
  for (int li = d.n_layers - 1; li >= 0; --li) {
    const int nk = d.kz[li] / 64, k1p = d.k1p[li];
    if (d.seg2c[li] >= 0) {
      const int h = d.n2w[li];
      for (int kc = 0; kc < nk; ++kc)
        for (int g = 0; g < 2; ++g)
          p.issue(h * 128, [&](uint32_t dst, uint32_t fb) {
            load_weight_rows(m, true, dst, fb, 64 * kc, d.rt[li] + k1p + g * h, h, keep);
          }, g);
    }
    const int h = d.nx[li];
    for (int kc = 0; kc < nk; ++kc)
      for (int g = 0; g < 2; ++g)
        p.issue(h * 128, [&](uint32_t dst, uint32_t fb) {
          load_weight_rows(m, true, dst, fb, 64 * kc, d.rt[li] + g * h, h, keep);
        }, g);
  }
}

// Per consumer thread: warpgroup, thread in it, and the accumulator rows
// r0, r0 + 8 (of the warpgroup's 64) and column pair 2t of each 8 columns.
struct Lane {
  int wg, tid, lane, g, t, r0;
  uint32_t rows;  // byte offset of the warpgroup's 64 rows in a chunk
  __device__ Lane() {
    wg = threadIdx.x >> 7;
    tid = threadIdx.x & 127;
    lane = threadIdx.x & 31;
    g = lane >> 2;
    t = lane & 3;
    r0 = 16 * (tid >> 5) + g;
    rows = wg * kRowsBytes;
  }
};

// Both consumer warpgroups (plan N: they share their points)
__device__ __forceinline__ void consumers_bar() {
  asm volatile("bar.sync 3, 256;\n" ::: "memory");
}

// The two tile plans (header note). Plan M: 128-point tiles, each consumer
// warpgroup its 64 points and every product's full width. Plan N: 64-point
// tiles, both warpgroups on the same points, each half of every product's
// width; a chunk is then [64 points][64 columns], a layer's epilogue
// overwrites chunks that the other warpgroup reads, and one thread issues
// the TMA stores.
struct PlanM {
  static constexpr bool kSplit = false;
  static constexpr int kTile = 128, kChunk = kChunkBytes, kDbuf = kDbufCols;
  static __device__ __forceinline__ uint32_t rows(const Lane& L) { return L.rows; }
  static __device__ __forceinline__ int row0(const Lane& L) { return 64 * L.wg; }
  static __device__ __forceinline__ void sync(const Lane& L) { wg_bar(L.wg); }
  static __device__ __forceinline__ bool storer(const Lane& L) { return L.tid == 0; }
  static __device__ __forceinline__ int acquire(Ring& r, const Lane&) { return r.acquire(); }
  static __device__ __forceinline__ int c_pts(const WgDesc&) { return 4; }
  static __device__ __forceinline__ int c_view(const WgDesc&) { return 5; }
  static __device__ __forceinline__ uint32_t ring_off(const WgDesc&) { return kRingOff; }
  static __device__ __forceinline__ uint32_t dbuf_off(const WgDesc&) { return kDbufOff; }
  static __device__ __forceinline__ uint32_t bar_off(const WgDesc&) { return kBarOff; }
};

struct PlanN {
  static constexpr bool kSplit = true;
  static constexpr int kTile = 64, kChunk = kRowsBytes, kDbuf = kDbufColsN;
  static __device__ __forceinline__ uint32_t rows(const Lane&) { return 0; }
  static __device__ __forceinline__ int row0(const Lane&) { return 0; }
  static __device__ __forceinline__ void sync(const Lane&) { consumers_bar(); }
  static __device__ __forceinline__ bool storer(const Lane&) { return threadIdx.x == 0; }
  static __device__ __forceinline__ int acquire(Ring& r, const Lane& L) {
    return r.acquire_own(L.wg);
  }
  static __device__ __forceinline__ int c_pts(const WgDesc& d) { return d.c_pts; }
  static __device__ __forceinline__ int c_view(const WgDesc& d) { return d.c_view; }
  static __device__ __forceinline__ uint32_t ring_off(const WgDesc& d) { return d.ring_off; }
  static __device__ __forceinline__ uint32_t dbuf_off(const WgDesc& d) { return d.dbuf_off; }
  static __device__ __forceinline__ uint32_t bar_off(const WgDesc& d) { return d.bar_off; }
};

// The warpgroup's 64 rows of a (T, width) fp32 input, rounded to bf16, into a
// chunk (zeros past T and past width).
__device__ void load_input(uint32_t chunk, const float* __restrict__ src, int width, int p0, int T,
                           const Lane& L) {
  constexpr int kPer = 64 * 32 / 128;  // column pairs per thread, all loaded first
  float v[kPer][2];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = L.tid + 128 * k, r = i >> 5, c = (i & 31) * 2, P = p0 + 64 * L.wg + r;
    v[k][0] = (P < T && c < width) ? src[(size_t)P * width + c] : 0.f;
    v[k][1] = (P < T && c + 1 < width) ? src[(size_t)P * width + c + 1] : 0.f;
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = L.tid + 128 * k;
    sts32(chunk + L.rows + swz(i >> 5, (i & 31) * 2), bf16x2(v[k][0], v[k][1]));
  }
}

// Plan N: the tile's 64 rows of a (T, width) fp32 input, rounded to bf16,
// into nc chunks (zeros past T and past width), over both warpgroups.
__device__ void load_input_n(uint32_t chunk, const float* __restrict__ src, int width, int nc,
                             int p0, int T) {
  for (int i = threadIdx.x; i < 64 * 32 * nc; i += kConsumers) {
    const int q = i >> 11, r = (i >> 5) & 63, c = (i & 31) * 2, col = 64 * q + c, P = p0 + r;
    const float v0 = (P < T && col < width) ? src[(size_t)P * width + col] : 0.f;
    const float v1 = (P < T && col + 1 < width) ? src[(size_t)P * width + col + 1] : 0.f;
    sts32(chunk + q * kRowsBytes + swz(r, c), bf16x2(v0, v1));
  }
}

// The tile's pts_enc (and view_enc) chunks, read by every consumer.
template <class P>
__device__ __forceinline__ void load_inputs(const WgDesc& d, uint32_t s,
                                            const float* __restrict__ pts,
                                            const float* __restrict__ view, int p0, int T,
                                            const Lane& L) {
  if constexpr (P::kSplit) {
    load_input_n(s + d.c_pts * kRowsBytes, pts, d.d_in, d.nc_pts, p0, T);
    if (d.d_view > 0) load_input_n(s + d.c_view * kRowsBytes, view, d.d_view, d.nc_view, p0, T);
  } else {
    load_input(s + 4 * kChunkBytes, pts, d.d_in, p0, T, L);
    if (d.d_view > 0) load_input(s + 5 * kChunkBytes, view, d.d_view, p0, T, L);
  }
  fence_async_smem();
  P::sync(L);
}

// One forward layer of the tile: the warpgroup's product of width N over
// the layer's k-chunks from the ring (plan M: its 64 points, all outputs;
// plan N: the tile's 64 points, its half of the outputs), then bias and
// ReLU in fp32 into the feature chunks as bf16 (or, at the last layer, raw
// rgb into out[:, 1:4]); with EXT (K1's last trunk layer; in plan N
// warpgroup 1's) the density unit's product too, into out[:, 0]. out may be
// null (K2). k2: the previous layer's input chunks may still be being
// stored (TMA), the ReLU mask words go to masks (slot li + 1: the next
// layer's input), and the recompute's MMAs may be dropped (K2_TIME_NO_FWD).
template <class P, int N, bool EXT>
__device__ void fwd_layer(const WgDesc& d, int li, Ring& ring, uint32_t s,
                          const float* __restrict__ bias_f, float* __restrict__ out,
                          uint4* __restrict__ masks, int p0, int T, bool k2, const Lane& L) {
  constexpr int C = P::kChunk;
  const int nk = d.kp[li] >> 6, nk1 = d.k1p[li] >> 6;
  const uint32_t seg1 = s + (li == 0 ? P::c_pts(d) : 0) * C + P::rows(L);
  const uint32_t seg2 = s + (d.seg2c[li] < 0 ? 0 : d.seg2c[li]) * C + P::rows(L);
  const bool last = li == d.n_layers - 1;
  const int col0 = P::kSplit ? L.wg * N : 0;  // the warpgroup's first output column
  // every sum starts from its row's bias (fp32; all loads in flight before
  // the first stage is waited for)
  const float* bias = bias_f + d.rf[li] + col0;
  float acc[N / 2], ext[4];
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[4 * j + c] = __ldg(bias + 8 * j + 2 * L.t + (c & 1));
#pragma unroll
  for (int c = 0; c < 4; ++c) ext[c] = EXT ? __ldg(bias + N + 2 * L.t + (c & 1)) : 0.f;
  int prev = -1;
  for (int kc = 0; kc < nk; ++kc) {
    const int st = P::acquire(ring, L);
    uint32_t a = kc < nk1 ? seg1 + kc * C : seg2;
    if constexpr (P::kSplit) a += kc < nk1 ? 0 : (kc - nk1) * C;  // (two chunks of view_enc)
    const uint32_t b = ring.buf(st);
#ifdef K2_TIME_NO_FWD
    if (!k2)
#endif
    {
      fence_regs(acc);
      fence_regs(ext);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        Wgmma<N, 0>::mma(acc, sdesc(a + 32 * ks, 0), sdesc(b + 32 * ks, 0), 1);
        if constexpr (EXT)
          Wgmma<8, 0>::mma(ext, sdesc(a + 32 * ks, 0), sdesc(b + N * 128 + 32 * ks, 0), 1);
      }
      wgmma_commit();
      wgmma_wait<1>();
    }
    if (prev >= 0) ring.release(prev);
    prev = st;
  }
  wgmma_wait<0>();
  fence_regs(acc);
  fence_regs(ext);
  ring.release(prev);
  if constexpr (P::kSplit) {
    // the stores of this layer's input (TMA) and both warpgroups' products
    // are done reading the chunks the epilogue overwrites
    if (k2 && P::storer(L)) bulk_wait_read();
    consumers_bar();
  } else if (k2) {  // the stores of this layer's input (TMA) are done reading the chunks
    if (L.tid == 0) bulk_wait_read();
    wg_bar(L.wg);
  }
  uint32_t mw[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int col = col0 + 8 * j + 2 * L.t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = L.r0 + 8 * h, P_ = p0 + P::row0(L) + r;
      const float z0 = acc[4 * j + 2 * h], z1 = acc[4 * j + 2 * h + 1];
      if (last) {
        if (out != nullptr && P_ < T) {
          if (col < 3) out[(size_t)P_ * 4 + 1 + col] = z0;
          if (col + 1 < 3) out[(size_t)P_ * 4 + 2 + col] = z1;
        }
      } else {
        sts32(s + (col >> 6) * C + P::rows(L) + swz(r, col & 63),
              bf16x2(fmaxf(z0, 0.f), fmaxf(z1, 0.f)));
        mw[j >> 3] |= (z0 > 0.f ? mask_bit(j, h, 0) : 0u) | (z1 > 0.f ? mask_bit(j, h, 1) : 0u);
      }
    }
  }
  if (k2 && !last)
    masks[((size_t)(li + 1) * gridDim.x + blockIdx.x) * kConsumers + threadIdx.x] =
        make_uint4(mw[0], mw[1], mw[2], mw[3]);
  if (EXT && out != nullptr && L.t == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int P_ = p0 + P::row0(L) + L.r0 + 8 * h;
      if (P_ < T) out[(size_t)P_ * 4] = ext[2 * h];
    }
  }
  if constexpr (!P::kSplit && N < 64) {  // zeros in the rest of the chunk: the next layer reads 64 columns
    constexpr int per = (64 - N) / 2;
    if (!last)
      for (int i = L.tid; i < 64 * per; i += 128)
        sts32(s + L.rows + swz(i / per, N + 2 * (i % per)), 0u);
  }
  fence_async_smem();
  P::sync(L);
}

template <class P, bool EXT>
__device__ __forceinline__ void fwd_layer_n(const WgDesc& d, int li, Ring& ring, uint32_t s,
                                            const float* bias_f, float* out, uint4* masks,
                                            int p0, int T, bool k2, const Lane& L) {
#define SPARF_FWD(N) fwd_layer<P, N, EXT>(d, li, ring, s, bias_f, out, masks, p0, T, k2, L)
  if constexpr (P::kSplit) {
    switch (d.nw[li]) {
      case 8: if constexpr (!EXT) SPARF_FWD(8); break;  // the RGB output (no density unit)
      case 32: SPARF_FWD(32); break;
      case 64: SPARF_FWD(64); break;
      case 96: SPARF_FWD(96); break;
      case 128: SPARF_FWD(128); break;
      case 160: SPARF_FWD(160); break;
      case 192: SPARF_FWD(192); break;
      case 224: SPARF_FWD(224); break;
      default: SPARF_FWD(256); break;
    }
  } else {
    switch (d.ncode[li]) {
      case 0: SPARF_FWD(8); break;
      case 1: SPARF_FWD(32); break;
      case 2: SPARF_FWD(64); break;
      case 3: SPARF_FWD(128); break;
      default: SPARF_FWD(256); break;
    }
  }
#undef SPARF_FWD
}

// K2's recompute needs no raw density (its gradient comes from gout).
template <class P>
__device__ __forceinline__ void fwd_layer_any(const WgDesc& d, int li, Ring& ring, uint32_t s,
                                              const float* bias_f, float* out, uint4* masks,
                                              int p0, int T, bool k2, const Lane& L) {
  if (!k2 && d.dens[li] && (!P::kSplit || L.wg == 1))
    fwd_layer_n<P, true>(d, li, ring, s, bias_f, out, masks, p0, T, k2, L);
  else
    fwd_layer_n<P, false>(d, li, ring, s, bias_f, out, masks, p0, T, k2, L);
}

// Shared memory of K1 and K2, 1024-byte aligned: the activation chunks
// (plan M 6, plan N n_act), the ring, K2's db buffer, the barriers.
__device__ __forceinline__ uint32_t aligned_base(uint8_t* raw, uint8_t** generic) {
  const uint32_t a = smem_u32(raw), base = (a + 1023) & ~1023u;
  *generic = raw + (base - a);
  return base;
}

// The forward of one tile, K1's and K3's body: out (T, 4) = [raw_density |
// raw_rgb] on the forward weights of the maps.
template <class P>
__device__ __forceinline__ void forward_tile(uint8_t* smem_raw, const Maps& maps, const WgDesc& d,
                                             const float* __restrict__ bias_f,
                                             const float* __restrict__ pts,
                                             const float* __restrict__ view,
                                             float* __restrict__ out, int T) {
  uint8_t* gen;
  const uint32_t s = aligned_base(smem_raw, &gen);
  Ring ring = P::kSplit ? make_ring_split(s + P::ring_off(d), kStageBytes, kFwdStages, s + P::bar_off(d))
                        : make_ring(s + P::ring_off(d), kStageBytes, kFwdStages, s + P::bar_off(d));
  if (threadIdx.x >= kConsumers) {
    setmaxnreg_dec();
    if (threadIdx.x == kConsumers) {
      if constexpr (P::kSplit)
        produce_weights_n(maps, d, ring, false);
      else
        produce_weights(maps, d, ring, false);
    }
    return;
  }
  setmaxnreg_inc();
  const Lane L;
  const int p0 = blockIdx.x * P::kTile;
  load_inputs<P>(d, s, pts, view, p0, T, L);
  for (int li = 0; li < d.n_layers; ++li)
    fwd_layer_any<P>(d, li, ring, s, bias_f, out, nullptr, p0, T, false, L);
}

// K1: the forward on the weights its launch laid out.
__global__ void __launch_bounds__(kThreadsWg, 1)
k1_wg(const __grid_constant__ Maps maps, const __grid_constant__ WgDesc d,
      const float* __restrict__ bias_f, const float* __restrict__ pts,
      const float* __restrict__ view, float* __restrict__ out, int T) {
  extern __shared__ uint8_t smem_raw[];
  forward_tile<PlanM>(smem_raw, maps, d, bias_f, pts, view, out, T);
}

// K3: the same body on the weights pack_weights laid out once per call (its
// own symbol, so that a profile tells the two apart).
__global__ void __launch_bounds__(kThreadsWg, 1)
k3_wg(const __grid_constant__ Maps maps, const __grid_constant__ WgDesc d,
      const float* __restrict__ bias_f, const float* __restrict__ pts,
      const float* __restrict__ view, float* __restrict__ out, int T) {
  extern __shared__ uint8_t smem_raw[];
  forward_tile<PlanM>(smem_raw, maps, d, bias_f, pts, view, out, T);
}

// Plan N's K1 and K3 (the same pair on one body).
__global__ void __launch_bounds__(kThreadsWg, 1)
k1_wg_n(const __grid_constant__ Maps maps, const __grid_constant__ WgDesc d,
        const float* __restrict__ bias_f, const float* __restrict__ pts,
        const float* __restrict__ view, float* __restrict__ out, int T) {
  extern __shared__ uint8_t smem_raw[];
  forward_tile<PlanN>(smem_raw, maps, d, bias_f, pts, view, out, T);
}

__global__ void __launch_bounds__(kThreadsWg, 1)
k3_wg_n(const __grid_constant__ Maps maps, const __grid_constant__ WgDesc d,
        const float* __restrict__ bias_f, const float* __restrict__ pts,
        const float* __restrict__ view, float* __restrict__ out, int T) {
  extern __shared__ uint8_t smem_raw[];
  forward_tile<PlanN>(smem_raw, maps, d, bias_f, pts, view, out, T);
}

// ---------------------------------------------------------------------------
// K2, pass 1: recompute, workspace, g_x, db per tile
// ---------------------------------------------------------------------------

// g_x = g_z W over the layer's g_z chunks (K = kz) for the warpgroup's N
// columns of the padded input, B from the ring (the transposed weights).
template <class P, int N>
__device__ __forceinline__ void gx_gemm(const WgDesc& d, int li, Ring& ring, uint32_t gz,
                                        float (&acc)[N / 2], const Lane& L) {
  zero(acc);
  int prev = -1;
  for (int kc = 0; kc < d.kz[li] / 64; ++kc) {
    const int st = P::acquire(ring, L);
#ifndef K2_TIME_NO_GX
    const uint32_t a = gz + kc * P::kChunk, b = ring.buf(st);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      Wgmma<N, 0>::mma(acc, sdesc(a + 32 * ks, 0), sdesc(b + 32 * ks, 0), kc | ks);
    wgmma_commit();
    wgmma_wait<1>();
#endif
    if (prev >= 0) ring.release(prev);
    prev = st;
  }
  wgmma_wait<0>();
  fence_regs(acc);
  ring.release(prev);
}

// g_x of an input segment read by no ReLU: added into d_pts (pts_enc, of a
// skip layer or of layer 0) or written to d_view; the warpgroup's N columns.
template <class P, int N>
__device__ __forceinline__ void gx_to_inputs(const float (&acc)[N / 2], float* d_in_g, int width,
                                             bool add, int p0, int T, const Lane& L) {
  const int col0 = P::kSplit ? L.wg * N : 0;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int col = col0 + 8 * j + 2 * L.t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int P_ = p0 + P::row0(L) + L.r0 + 8 * h;
      if (P_ >= T) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (col + e >= width) continue;
        float* q = d_in_g + (size_t)P_ * width + col + e;
        *q = add ? *q + acc[4 * j + 2 * h + e] : acc[4 * j + 2 * h + e];
      }
    }
  }
}

// Column sums of the fp32 g_z of layer pl, columns [c0, c1), over the rows
// of the warpgroup's 4 warps, into its row of db_part (one per 64 points):
// per-warp sums in dbuf (written by the caller), then the 4 warps in order.
// Each warpgroup on its own, so one's epilogue can run beside the other's
// MMAs (plan M).
template <class P>
__device__ __forceinline__ void db_flush(const WgDesc& d, int pl, const float* dbuf,
                                         float* __restrict__ db_part, const Lane& L, int c0,
                                         int c1) {
  wg_bar(L.wg);
  const size_t row = P::kSplit ? blockIdx.x : 2 * blockIdx.x + L.wg;
  for (int c = c0 + L.tid; c < c1; c += 128) {
    float sum = 0.f;
    for (int w = 4 * L.wg; w < 4 * L.wg + 4; ++w) sum += dbuf[w * P::kDbuf + c];
    db_part[row * d.KG + d.go[pl] + c] = sum;
  }
  wg_bar(L.wg);
}

// One step of the reduce-scatter over lanes m apart: v[i], i < W / 2, becomes
// this lane's half of the pair (v[i], v[i + W / 2]) (the upper one where
// `upper`) plus the partner's copy of the same element.
template <int W, int R>
__device__ __forceinline__ void halve(float (&v)[R], int upper, int m) {
#pragma unroll
  for (int i = 0; i < W / 2; ++i) {
    const float keep = upper ? v[i + W / 2] : v[i], send = upper ? v[i] : v[i + W / 2];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, m);
  }
}

// The stores of the g_z chunks of layer pl to the workspace (plan M: the
// warpgroup's rows; plan N: the tile's, by one thread).
template <class P>
__device__ __forceinline__ void store_gz(const Maps& maps, const WgDesc& d, int pl, uint32_t s,
                                         int p0, const Lane& L) {
  fence_async_smem();
  P::sync(L);
  if (P::storer(L)) {
    const uint64_t stream = policy_stream();
    for (int q = 0; q < d.kz[pl] / 64; ++q)
      tma_store(&maps.g, s + q * P::kChunk + P::rows(L), d.go[pl] + 64 * q, p0 + P::row0(L),
                stream);
    bulk_commit();
  }
}

// g_x of layer li's features (li >= 1), the warpgroup's N columns: masked by
// its input's ReLU mask (the recompute's words), it is g_z of layer pl =
// li - 1 (and the density gradient at row nm of the last trunk layer): into
// the g_z chunks as bf16, to the workspace, and its column sums
// (unrounded) into db_part.
template <class P, int N>
__device__ void gx_features(const Maps& maps, const WgDesc& d, int li, float (&acc)[N / 2],
                            uint32_t s, float* dbuf, const uint4& mwords,
                            const float* __restrict__ gout, float* __restrict__ db_part, int p0,
                            int T, const Lane& L) {
  constexpr int C = P::kChunk;
  const int pl = li - 1, w1 = d.w1[li], kzp = d.kz[pl];
  const int col0 = P::kSplit ? L.wg * N : 0, cx = d.k1p[li];  // columns past the product: cx..
  const int wl = 4 * L.wg + (L.tid >> 5);  // warp of the tile
  const uint32_t mw[4] = {mwords.x, mwords.y, mwords.z, mwords.w};
  // the previous g_z stores (and plan N: both products) are done reading the chunks
  if (P::storer(L)) bulk_wait_read();
  P::sync(L);
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int col = col0 + 8 * j + 2 * L.t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = L.r0 + 8 * h;
      float& v0 = acc[4 * j + 2 * h];
      float& v1 = acc[4 * j + 2 * h + 1];
      v0 = (col < w1 && (mw[j >> 3] & mask_bit(j, h, 0))) ? v0 : 0.f;
      v1 = (col + 1 < w1 && (mw[j >> 3] & mask_bit(j, h, 1))) ? v1 : 0.f;
      sts32(s + (col >> 6) * C + P::rows(L) + swz(r, col & 63), bf16x2(v0, v1));
    }
  }
  // the columns past this product: zeros, and the density gradient (plan N:
  // warpgroup h the rows 32 h ..)
  const int per = (kzp - cx) / 2, nd = d.dens[pl] ? d.nm[pl] : -1;
  const int n_rows = P::kSplit ? 32 : 64, r_first = P::kSplit ? 32 * L.wg : 0;
  for (int i = L.tid; i < n_rows * per; i += 128) {
    const int r = r_first + i / per, c = cx + 2 * (i % per), P_ = p0 + P::row0(L) + r;
    const float v = (c == nd && P_ < T) ? gout[(size_t)P_ * 4] : 0.f;
    sts32(s + (c >> 6) * C + P::rows(L) + swz(r, c & 63), bf16x2(v, 0.f));
  }
  store_gz<P>(maps, d, pl, s, p0, L);
  // db: rows g and g + 8 (value 2 j + e: column 8 j + 2 t + e), then the
  // warp's 8 row groups (lanes 4, 8, 16 apart) by a reduce-scatter: each
  // halving keeps half of the values and adds the partner's half of the
  // other, so lane g ends with the sums of values g V/8 .. (g + 1) V/8.
  constexpr int V = N / 4;
  float v[V];
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    v[2 * j] = acc[4 * j] + acc[4 * j + 2];
    v[2 * j + 1] = acc[4 * j + 1] + acc[4 * j + 3];
  }
  halve<V>(v, (L.lane >> 4) & 1, 16);
  halve<V / 2>(v, (L.lane >> 3) & 1, 8);
  halve<V / 4>(v, (L.lane >> 2) & 1, 4);
#pragma unroll
  for (int i = 0; i < V / 8; ++i) {
    const int idx = L.g * (V / 8) + i;
    dbuf[wl * P::kDbuf + col0 + 8 * (idx >> 1) + 2 * L.t + (idx & 1)] = v[i];
  }
  // the columns past the product: each warp its 16 rows (plan N: warpgroup 1)
  if (!P::kSplit || L.wg == 1)
    for (int c = cx + L.lane; c < kzp; c += 32) {
      float v = 0.f;
      if (c == nd)
        for (int i = 0; i < 16; ++i) {
          const int P_ = p0 + (P::kSplit ? 16 * (L.tid >> 5) : 16 * wl) + i;
          v += P_ < T ? gout[(size_t)P_ * 4] : 0.f;
        }
      dbuf[wl * P::kDbuf + c] = v;
    }
  if constexpr (P::kSplit)
    db_flush<P>(d, pl, dbuf, db_part, L, col0, L.wg == 0 ? N : kzp);
  else
    db_flush<P>(d, pl, dbuf, db_part, L, 0, kzp);
}

// One layer of the backward: the second segment's g_x (into d_pts or
// d_view), then the features' (into d_pts at layer 0, else the previous
// layer's g_z); N: the warpgroup's share of the features' product.
template <class P, int N>
__device__ void bwd_layer(const Maps& maps, const WgDesc& d, int li, Ring& ring, uint32_t s,
                          float* dbuf, const uint4* masks, const float* __restrict__ gout,
                          float* d_pts, float* d_view, float* __restrict__ db_part, int p0, int T,
                          const Lane& L) {
  // the mask words of the layer's input, loaded before the products
  const uint4 mwords = li > 0 ? masks[((size_t)li * gridDim.x + blockIdx.x) * kConsumers +
                                      threadIdx.x]
                              : make_uint4(0u, 0u, 0u, 0u);
  const uint32_t gz = s + P::rows(L);
  if (d.seg2c[li] >= 0) {
    const bool pts_seg = d.seg2c[li] == P::c_pts(d);
    float* dst = pts_seg ? d_pts : d_view;
    const int width = pts_seg ? d.d_in : d.d_view;
    if (!P::kSplit || d.n2w[li] == 64) {
      float acc2[32];
      gx_gemm<P, 64>(d, li, ring, gz, acc2, L);
      gx_to_inputs<P, 64>(acc2, dst, width, pts_seg, p0, T, L);
    } else {
      float acc2[16];
      gx_gemm<P, 32>(d, li, ring, gz, acc2, L);
      gx_to_inputs<P, 32>(acc2, dst, width, pts_seg, p0, T, L);
    }
  }
  float acc[N / 2];
  gx_gemm<P, N>(d, li, ring, gz, acc, L);
  if (li == 0)
    gx_to_inputs<P, N>(acc, d_pts, d.d_in, true, p0, T, L);
  else
    gx_features<P, N>(maps, d, li, acc, s, dbuf, mwords, gout, db_part, p0, T, L);
}

// K2, pass 1, per tile: the recomputed forward stores every layer's input in
// the X workspace (bf16); then the g_z chain stores every layer's g_z in the
// G workspace (bf16) and its column sums in db_part; d_pts (zeroed by the
// caller) and d_view.
template <class P>
__device__ __forceinline__ void backward_tile(uint8_t* smem_raw, const Maps& maps,
                                              const WgDesc& d, const float* __restrict__ bias_f,
                                              const float* __restrict__ pts,
                                              const float* __restrict__ view,
                                              const float* __restrict__ gout, float* d_pts,
                                              float* d_view, uint4* __restrict__ masks,
                                              float* __restrict__ db_part, int T) {
  constexpr int C = P::kChunk;
  uint8_t* gen;
  const uint32_t s = aligned_base(smem_raw, &gen);
  float* dbuf = reinterpret_cast<float*>(gen + P::dbuf_off(d));
  Ring ring = P::kSplit ? make_ring_split(s + P::ring_off(d), kStageBytes, kFwdStages, s + P::bar_off(d))
                        : make_ring(s + P::ring_off(d), kStageBytes, kFwdStages, s + P::bar_off(d));
  if (threadIdx.x >= kConsumers) {
    setmaxnreg_dec();
    if (threadIdx.x == kConsumers) {
      if constexpr (P::kSplit)
        produce_weights_n(maps, d, ring, true);
      else
        produce_weights(maps, d, ring, true);
    }
    return;
  }
  setmaxnreg_inc();
  const Lane L;
  const int p0 = blockIdx.x * P::kTile, Lr = d.n_layers;
  const int row = p0 + P::row0(L);
  load_inputs<P>(d, s, pts, view, p0, T, L);
  const uint64_t stream = policy_stream();
  if (P::storer(L)) {  // layer 0's input: pts_enc
    for (int q = 0; q < d.k1p[0] / 64; ++q)
      tma_store(&maps.x, s + (P::c_pts(d) + q) * C + P::rows(L), d.xo[0] + 64 * q, row, stream);
    bulk_commit();
  }
  for (int li = 0; li + 1 < Lr; ++li) {
    fwd_layer_any<P>(d, li, ring, s, bias_f, nullptr, masks, p0, T, true, L);
    if (P::storer(L)) {  // layer li + 1's input: the features, then the second segment
      const int nl = li + 1;
      for (int q = 0; q < d.k1p[nl] / 64; ++q)
        tma_store(&maps.x, s + q * C + P::rows(L), d.xo[nl] + 64 * q, row, stream);
      if (d.seg2c[nl] >= 0)
        for (int q = 0; q < d.n2c[nl]; ++q)
          tma_store(&maps.x, s + (d.seg2c[nl] + q) * C + P::rows(L),
                    d.xo[nl] + d.k1p[nl] + 64 * q, row, stream);
      bulk_commit();
    }
  }
  if (P::storer(L)) bulk_wait_all();  // every input store has read the chunks (g_z reuses them)
  P::sync(L);

  // g_z of the last layer: the rgb gradient (plan N: over both warpgroups)
  const int wl = 4 * L.wg + (L.tid >> 5);
  for (int i = P::kSplit ? threadIdx.x : L.tid; i < 64 * 32; i += P::kSplit ? kConsumers : 128) {
    const int r = i >> 5, c = (i & 31) * 2, P_ = row + r;
    const float v0 = (c < 3 && P_ < T) ? gout[(size_t)P_ * 4 + 1 + c] : 0.f;
    const float v1 = (c + 1 < 3 && P_ < T) ? gout[(size_t)P_ * 4 + 2 + c] : 0.f;
    sts32(s + P::rows(L) + swz(r, c), bf16x2(v0, v1));
  }
  store_gz<P>(maps, d, Lr - 1, s, p0, L);
  // its column sums: each warp its 16 rows (plan N: warpgroup 0's warps)
  if (!P::kSplit || L.wg == 0)
    for (int c = L.lane; c < d.kz[Lr - 1]; c += 32) {
      float v = 0.f;
      if (c < 3)
        for (int i = 0; i < 16; ++i) {
          const int P_ = p0 + (P::kSplit ? 16 * (L.tid >> 5) : 16 * wl) + i;
          v += P_ < T ? gout[(size_t)P_ * 4 + 1 + c] : 0.f;
        }
      dbuf[wl * P::kDbuf + c] = v;
    }
  db_flush<P>(d, Lr - 1, dbuf, db_part, L, 0, (!P::kSplit || L.wg == 0) ? d.kz[Lr - 1] : 0);

#define SPARF_BWD(N) \
  bwd_layer<P, N>(maps, d, li, ring, s, dbuf, masks, gout, d_pts, d_view, db_part, p0, T, L)
  for (int li = Lr - 1; li >= 0; --li) {
    if constexpr (P::kSplit) {
      switch (d.nx[li]) {
        case 32: SPARF_BWD(32); break;
        case 64: SPARF_BWD(64); break;
        case 96: SPARF_BWD(96); break;
        case 128: SPARF_BWD(128); break;
        case 160: SPARF_BWD(160); break;
        case 192: SPARF_BWD(192); break;
        case 224: SPARF_BWD(224); break;
        default: SPARF_BWD(256); break;
      }
    } else {
      switch (d.k1p[li]) {
        case 64: SPARF_BWD(64); break;
        case 128: SPARF_BWD(128); break;
        default: SPARF_BWD(256); break;
      }
    }
  }
#undef SPARF_BWD
  if (P::storer(L)) bulk_wait_all();
}

__global__ void __launch_bounds__(kThreadsWg, 1)
k2_wg(const __grid_constant__ Maps maps, const __grid_constant__ WgDesc d,
      const float* __restrict__ bias_f, const float* __restrict__ pts,
      const float* __restrict__ view, const float* __restrict__ gout, float* d_pts,
      float* d_view, uint4* __restrict__ masks, float* __restrict__ db_part, int T) {
  extern __shared__ uint8_t smem_raw[];
  backward_tile<PlanM>(smem_raw, maps, d, bias_f, pts, view, gout, d_pts, d_view, masks, db_part,
                       T);
}

// Plan N's pass 1
__global__ void __launch_bounds__(kThreadsWg, 1)
k2_wg_n(const __grid_constant__ Maps maps, const __grid_constant__ WgDesc d,
        const float* __restrict__ bias_f, const float* __restrict__ pts,
        const float* __restrict__ view, const float* __restrict__ gout, float* d_pts,
        float* d_view, uint4* __restrict__ masks, float* __restrict__ db_part, int T) {
  extern __shared__ uint8_t smem_raw[];
  backward_tile<PlanN>(smem_raw, maps, d, bias_f, pts, view, gout, d_pts, d_view, masks, db_part,
                       T);
}

// ---------------------------------------------------------------------------
// K2, pass 2: dW = g_z^T X over the points (wgmma, MN-major operands)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void dw_tile(const WgDesc& d, int b, int& li, int& m0, int& n0,
                                        int& nt) {
  li = 0;
  while (li + 1 < d.n_layers && b >= d.to[li + 1]) ++li;
  const int local = b - d.to[li], ni = local % d.nnt[li];
  m0 = 128 * (local / d.nnt[li]);
  n0 = 0;
  for (int i = 0;; ++i) {
    const int rest = d.kp[li] - n0;
    nt = rest >= 256 ? 256 : (rest >= 128 ? 128 : 64);
    if (i == ni) break;
    n0 += nt;
  }
}

// The consumers of one output tile: rows m0 + 64 wg .. of the layer's g_z
// columns (a warpgroup past kz has no rows and only keeps the ring going),
// columns n0 .. n0 + NT of its padded input; the partial of this point range
// and, on the tiles of column 0, its db (the sums of its 64-point rows of
// db_part, in order).
template <int NT>
__device__ void dw_consume(const WgDesc& d, int li, int m0, int n0, int n_chunks, Ring& ring,
                           float* __restrict__ dst, const float* __restrict__ db_part, int t0,
                           int t1) {
  const Lane L;
  const bool active = m0 + 64 * L.wg < d.kz[li];
  float acc[NT / 2];
  zero(acc);
  int prev = -1;
  for (int c = 0; c < n_chunks; ++c) {
    const int st = ring.acquire();
    if (active) {
      const uint32_t a = ring.buf(st) + L.wg * 8192, b = ring.buf(st) + 2 * 8192;
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        Wgmma<NT, 1>::mma(acc, sdesc(a + 2048 * kk, 8192), sdesc(b + 2048 * kk, 8192), 1);
      wgmma_commit();
      wgmma_wait<1>();
    }
    if (prev >= 0) ring.release(prev);
    prev = st;
  }
  wgmma_wait<0>();
  fence_regs(acc);
  if (prev >= 0) ring.release(prev);
  if (!active) return;
  const int kp = d.kp[li];
#pragma unroll
  for (int j = 0; j < NT / 8; ++j) {
    const int col = n0 + 8 * j + 2 * L.t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + 64 * L.wg + L.r0 + 8 * h;
      *reinterpret_cast<float2*>(dst + (size_t)r * kp + col) =
          make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
  if (n0 == 0 && L.tid < 64) {
    const int r = m0 + 64 * L.wg + L.tid;
    float sum = 0.f;
    for (int t = 2 * t0; t < 2 * t1; ++t) sum += __ldg(db_part + (size_t)t * d.KG + d.go[li] + r);
    dst[(size_t)d.kz[li] * kp + r] = sum;
  }
}

__global__ void __launch_bounds__(kThreadsWg, 1)
k2_dw_wg(const __grid_constant__ Maps maps, const __grid_constant__ WgDesc d,
         const float* __restrict__ db_part, float* __restrict__ partial, int n_tiles) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* gen;
  const uint32_t s = aligned_base(smem_raw, &gen);
  Ring ring = make_ring(s, kDwStageBytes, kDwStages, s + kDwStages * kDwStageBytes);
  int li, m0, n0, nt;
  dw_tile(d, blockIdx.x, li, m0, n0, nt);
  const int per = (n_tiles + kSplits - 1) / kSplits;
  const int t0 = min(n_tiles, (int)blockIdx.y * per), t1 = min(n_tiles, t0 + per);
  const int n_chunks = 2 * (t1 - t0);
  if (threadIdx.x >= kConsumers) {
    if (threadIdx.x != kConsumers) return;
    Producer p{ring};
    const int n_a = (m0 + 64 < d.kz[li]) ? 2 : 1;
    for (int c = 0; c < n_chunks; ++c) {
      const int P0 = t0 * kTile + 64 * c;
      p.issue((n_a + nt / 64) * 8192, [&](uint32_t dst, uint32_t fb) {
        for (int a = 0; a < n_a; ++a) tma_load(dst + a * 8192, &maps.g, fb, d.go[li] + m0 + 64 * a, P0);
        for (int j = 0; j < nt / 64; ++j)
          tma_load(dst + (2 + j) * 8192, &maps.x, fb, d.xo[li] + n0 + 64 * j, P0);
      });
    }
    return;
  }
  float* dst = partial + (size_t)blockIdx.y * d.n_part + d.po[li];
  switch (nt) {
    case 64: dw_consume<64>(d, li, m0, n0, n_chunks, ring, dst, db_part, t0, t1); break;
    case 128: dw_consume<128>(d, li, m0, n0, n_chunks, ring, dst, db_part, t0, t1); break;
    default: dw_consume<256>(d, li, m0, n0, n_chunks, ring, dst, db_part, t0, t1); break;
  }
}

// layer row of output unit n (WgDesc note)
__host__ __device__ __forceinline__ int row_of(const WgDesc& d, int li, int n) {
  return d.dens[li] ? (n == 0 ? d.nm[li] : n - 1) : n;
}
// output unit of layer row r, or -1
__host__ __device__ __forceinline__ int unit_of(const WgDesc& d, int li, int r) {
  if (d.dens[li]) return r < d.out[li] - 1 ? r + 1 : (r == d.nm[li] ? 0 : -1);
  return r < d.out[li] ? r : -1;
}
// input index of padded column k, or -1
__host__ __device__ __forceinline__ int input_of(const WgDesc& d, int li, int k) {
  if (k < d.k1p[li]) return k < d.w1[li] ? k : -1;
  return k - d.k1p[li] < d.w2[li] ? d.w1[li] + k - d.k1p[li] : -1;
}

// Sums the kSplits partials in order (deterministic) into the (out, in)
// layout of the flat gradient.
__global__ void k2_reduce_wg(const __grid_constant__ WgDesc d, const float* __restrict__ partial,
                             float* __restrict__ out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= d.n_params) return;
  int li = 0;
  while (li + 1 < d.n_layers && j >= d.wo[li + 1]) ++li;
  const int kp = d.kp[li];
  int pos;
  if (j < d.bo[li]) {
    const int q = j - d.wo[li], n = q / d.in[li], k = q - n * d.in[li];
    pos = d.po[li] + row_of(d, li, n) * kp + (k < d.w1[li] ? k : d.k1p[li] + k - d.w1[li]);
  } else {
    pos = d.po[li] + d.kz[li] * kp + row_of(d, li, j - d.bo[li]);
  }
  float sum = 0.f;
  for (int s = 0; s < kSplits; ++s) sum += partial[(size_t)s * d.n_part + pos];
  out[j] = sum;
}

// The weights in the TMA maps' layouts (ops/fused_mlp.py::wgmma_layout_plain):
// wf (RF x KF) W[unit_of(row)][input_of(col)], wt (RT x KT) the same with
// rows and columns swapped, bias_f (RF) b[unit_of(row)]; bf16 rounded to
// nearest even, zeros in the padding. wt may be null.
__global__ void k_wg_layout(const __grid_constant__ WgDesc d, uint16_t* __restrict__ wf,
                            uint16_t* __restrict__ wt, float* __restrict__ bias_f) {
  const int nf = d.RF * d.KF, nt = wt != nullptr ? d.RT * d.KT : 0;
  for (int idx = blockIdx.x * blockDim.x + threadIdx.x; idx < nf + nt + d.RF;
       idx += gridDim.x * blockDim.x) {
    if (idx >= nf + nt) {
      const int R = idx - nf - nt;
      int li = 0;
      while (li + 1 < d.n_layers && R >= d.rf[li + 1]) ++li;
      const int n = unit_of(d, li, R - d.rf[li]);
      bias_f[R] = n >= 0 ? d.b[li][n] : 0.f;
      continue;
    }
    const bool tr = idx >= nf;
    const int e = tr ? idx - nf : idx, K = tr ? d.KT : d.KF, R = e / K, C = e - R * K;
    int li = 0;
    if (tr) {
      while (li + 1 < d.n_layers && R >= d.rt[li + 1]) ++li;
    } else {
      while (li + 1 < d.n_layers && R >= d.rf[li + 1]) ++li;
    }
    const int r = tr ? C : R - d.rf[li], k = tr ? R - d.rt[li] : C;
    const int n = (r < d.kz[li]) ? unit_of(d, li, r) : -1;
    const int i = k < d.kp[li] ? input_of(d, li, k) : -1;
    const float v = (n >= 0 && i >= 0) ? d.W[li][(size_t)n * d.in[li] + i] : 0.f;
    (tr ? wt : wf)[e] = static_cast<uint16_t>(bf16x2(v, 0.f) & 0xFFFFu);
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a 2D bf16 map over rows x cols (row-major), box {64 columns, box_rows},
// 128-byte swizzle
int make_map(CUtensorMap* m, const void* ptr, uint64_t rows, uint64_t cols, uint32_t box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return -6;
  const cuuint64_t dims[2] = {cols, rows}, strides[1] = {cols * 2};
  const cuuint32_t box[2] = {64, box_rows}, es[2] = {1, 1};
  const CUresult r = fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
                        strides, box, es, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -6;
}

// The weight maps the layers use: forward boxes of each main product's
// height (and 8 rows for the density unit); transposed (wt may be null) of
// each g_x product's width.
int weight_maps(const WgDesc& d, const void* wf, const void* wt, Maps* m) {
  bool f[kCodes] = {}, t[kCodes] = {};
  if (d.plan) {  // plan N: boxes of 32 rows (and 8: the RGB output, the density rows)
    f[0] = f[1] = t[1] = true;
  } else {
    for (int li = 0; li < d.n_layers; ++li) {
      f[d.ncode[li]] = true;
      if (d.dens[li]) f[0] = true;
      t[d.k1p[li] == 64 ? 2 : (d.k1p[li] == 128 ? 3 : 4)] = true;
      if (d.seg2c[li] >= 0) t[2] = true;
    }
  }
  for (int c = 0; c < kCodes; ++c) {
    if (f[c] && make_map(&m->wf[c], wf, d.RF, d.KF, code_height(c)) != 0) return -6;
    if (wt != nullptr && t[c] && make_map(&m->wt[c], wt, d.RT, d.KT, code_height(c)) != 0)
      return -6;
  }
  return 0;
}

int launch_layout(const WgDesc& d, void* wf, void* wt, void* bias_f, cudaStream_t s) {
  k_wg_layout<<<264, 256, 0, s>>>(d, static_cast<uint16_t*>(wf), static_cast<uint16_t*>(wt),
                                  static_cast<float*>(bias_f));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// [n_params, wf elements (RF x KF), wt elements (RT x KT), RF, KX, KG,
// n_part, n_splits, tile] of the chain (tile: the points of one block of K1,
// K2's first pass and K3: 128 in plan M, 64 in plan N; the workspace's rows
// are T rounded up to 128 either way), or a negative code.
int sparf_fused_mlp_wg_sizes(const int* dims, int* sizes) {
  static const void* const null_params[2 * kMaxLayers] = {};
  WgDesc d;
  const int rc = build_wg_desc(dims, null_params, &d);
  if (rc < 0) return rc;
  const int v[9] = {d.n_params, d.RF * d.KF, d.RT * d.KT, d.RF, d.KX, d.KG, d.n_part, kSplits,
                    d.plan ? PlanN::kTile : kTile};
  for (int i = 0; i < 9; ++i) sizes[i] = v[i];
  return 0;
}

// The weights in the kernels' layouts (wt may be null): the layout check.
int sparf_fused_mlp_wg_layout(const int* dims, const void* const* params, void* wf, void* wt,
                              void* bias_f, void* stream) {
  WgDesc d;
  const int rc = build_wg_desc(dims, params, &d);
  if (rc < 0) return rc;
  return launch_layout(d, wf, wt, bias_f, static_cast<cudaStream_t>(stream));
}

// K1 at bf16: lays out the weights into wf / bias_f (scratch of the sizes'
// elements), then out (T, 4) = [raw_density | raw_rgb].
int sparf_fused_mlp_wg_forward(const float* pts, const float* view, float* out, int T,
                               const int* dims, const void* const* params, void* wf,
                               void* bias_f, void* stream) {
  WgDesc d;
  int rc = build_wg_desc(dims, params, &d);
  if (rc < 0) return rc;
  if (T <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  Maps maps;
  memset(&maps, 0, sizeof(maps));
  if ((rc = weight_maps(d, wf, nullptr, &maps)) != 0) return rc;
  if ((rc = launch_layout(d, wf, nullptr, bias_f, s)) != 0) return rc;
  if (d.plan) {
    cudaFuncSetAttribute(k1_wg_n, cudaFuncAttributeMaxDynamicSharedMemorySize, d.smem);
    k1_wg_n<<<(T + PlanN::kTile - 1) / PlanN::kTile, kThreadsWg, d.smem, s>>>(
        maps, d, static_cast<const float*>(bias_f), pts, view, out, T);
    return static_cast<int>(cudaGetLastError());
  }
  cudaFuncSetAttribute(k1_wg, cudaFuncAttributeMaxDynamicSharedMemorySize, kFwdSmem);
  k1_wg<<<(T + kTile - 1) / kTile, kThreadsWg, kFwdSmem, s>>>(
      maps, d, static_cast<const float*>(bias_f), pts, view, out, T);
  return static_cast<int>(cudaGetLastError());
}

// K3 at bf16: out (T, 4) = [raw_density | raw_rgb] on the forward weights wf
// and biases bias_f that sparf_fused_mlp_wg_layout laid out (wt null), once
// per call.
int sparf_fused_mlp_wg_forward_packed(const float* pts, const float* view, float* out, int T,
                                      const int* dims, const void* wf, const void* bias_f,
                                      void* stream) {
  static const void* const null_params[2 * kMaxLayers] = {};
  WgDesc d;
  int rc = build_wg_desc(dims, null_params, &d);
  if (rc < 0) return rc;
  if (T <= 0) return 0;
  Maps maps;
  memset(&maps, 0, sizeof(maps));
  if ((rc = weight_maps(d, wf, nullptr, &maps)) != 0) return rc;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d.plan) {
    cudaFuncSetAttribute(k3_wg_n, cudaFuncAttributeMaxDynamicSharedMemorySize, d.smem);
    k3_wg_n<<<(T + PlanN::kTile - 1) / PlanN::kTile, kThreadsWg, d.smem, s>>>(
        maps, d, static_cast<const float*>(bias_f), pts, view, out, T);
    return static_cast<int>(cudaGetLastError());
  }
  cudaFuncSetAttribute(k3_wg, cudaFuncAttributeMaxDynamicSharedMemorySize, kFwdSmem);
  k3_wg<<<(T + kTile - 1) / kTile, kThreadsWg, kFwdSmem, s>>>(
      maps, d, static_cast<const float*>(bias_f), pts, view, out, T);
  return static_cast<int>(cudaGetLastError());
}

// K2 at bf16. gout (T, 4) = [g_density | g_rgb]; d_pts zeroed by the caller;
// d_params (n_params,) in the order W0, b0, W1, b1, ...; scratch: wf, wt,
// bias_f (the sizes' elements), xws (T_pad x KX bf16) and gws (T_pad x KG),
// T_pad = T rounded up to 128, masks (n_layers x T_pad / tile x 256 uint4),
// db_part (T_pad / 64 x KG fp32), partial (n_splits x n_part fp32).
int sparf_fused_mlp_wg_backward(const float* pts, const float* view, const float* gout,
                                float* d_pts, float* d_view, float* d_params, void* wf, void* wt,
                                void* bias_f, void* xws, void* gws, void* masks, float* db_part,
                                float* partial, int T, const int* dims,
                                const void* const* params, void* stream) {
  WgDesc d;
  int rc = build_wg_desc(dims, params, &d);
  if (rc < 0) return rc;
  if (T <= 0) return -5;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_tiles = (T + kTile - 1) / kTile, x_rows = n_tiles * kTile;
  Maps maps;
  memset(&maps, 0, sizeof(maps));
  if ((rc = weight_maps(d, wf, wt, &maps)) != 0) return rc;
  if (make_map(&maps.x, xws, x_rows, d.KX, 64) != 0 || make_map(&maps.g, gws, x_rows, d.KG, 64) != 0)
    return -6;
  if ((rc = launch_layout(d, wf, wt, bias_f, s)) != 0) return rc;
  if (d.plan) {
    cudaFuncSetAttribute(k2_wg_n, cudaFuncAttributeMaxDynamicSharedMemorySize, d.smem);
    k2_wg_n<<<x_rows / PlanN::kTile, kThreadsWg, d.smem, s>>>(
        maps, d, static_cast<const float*>(bias_f), pts, view, gout, d_pts, d_view,
        static_cast<uint4*>(masks), db_part, T);
  } else {
    cudaFuncSetAttribute(k2_wg, cudaFuncAttributeMaxDynamicSharedMemorySize, kFwdSmem);
    k2_wg<<<n_tiles, kThreadsWg, kFwdSmem, s>>>(maps, d, static_cast<const float*>(bias_f), pts,
                                                 view, gout, d_pts, d_view,
                                                 static_cast<uint4*>(masks), db_part, T);
  }
  if ((rc = static_cast<int>(cudaGetLastError())) != 0) return rc;
#ifndef K2_TIME_NO_DW
  cudaFuncSetAttribute(k2_dw_wg, cudaFuncAttributeMaxDynamicSharedMemorySize, kDwSmem);
  k2_dw_wg<<<dim3(d.n_dw_tiles, kSplits), kThreadsWg, kDwSmem, s>>>(maps, d, db_part, partial,
                                                                    n_tiles);
  if ((rc = static_cast<int>(cudaGetLastError())) != 0) return rc;
#endif
  k2_reduce_wg<<<(d.n_params + 255) / 256, 256, 0, s>>>(d, partial, d_params);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

// ===========================================================================
// K2 at float32: 3xTF32 on wgmma (k_tf_layout, k2_tf, k2_dw_tf, k2_reduce_tf;
// the design is in the header note, "The float32 K2")
// ===========================================================================

namespace {

constexpr int kTfStages = 3;
constexpr int kTfStageBytes = 256 * 128;  // a box of up to 256 rows x 32 fp32 (hi or lo)
constexpr int kTfActOff = kTfStages * kTfStageBytes;
constexpr int kTfActCols = 256;           // the tile's activations / g_z: 128 x 256 fp32
constexpr int kTfBarOff = kTfActOff + kTile * kTfActCols * 4;
constexpr int kTfSmem = kTfBarOff + 2 * kTfStages * 8 + 1024;
constexpr int kTfDwStages = 3;
constexpr int kTfDwXOff = 128 * 128;      // a stage: the g_z box (up to 128 rows), then X's
constexpr int kTfDwStageBytes = kTfDwXOff + kTfStageBytes;  // (up to 256 rows; split in place)
constexpr int kTfDwLoOff = kTfDwStages * kTfDwStageBytes;   // then two buffers of X's lo
constexpr int kTfDwBarOff = kTfDwLoOff + 2 * kTfStageBytes;
constexpr int kTfDwSmem = kTfDwBarOff + 2 * kTfDwStages * 8 + 1024;
static_assert(kTfSmem <= kMaxSmem && kTfDwSmem <= kMaxSmem, "shared memory of one block");

__host__ __device__ constexpr int pad32(int x) { return (x + 31) / 32 * 32; }
// TMA box heights of the fp32 maps: 32, 64, 128, 256 rows
__host__ __device__ constexpr int tf_code(int rows) {
  return rows <= 32 ? 0 : (rows <= 64 ? 1 : (rows <= 128 ? 2 : 3));
}

// The chain as the float32 K2 and K1/K3 run it. Forward weights: 2 RF rows
// (hi, then lo) x KF columns; per layer but the last nm rows, the features
// (at the last trunk layer units 1 ..), columns the padded input [segment 1
// | pad to 64 | segment 2 | pad to 32]; behind them the rows only K1/K3 read,
// 8 each: the RGB output's (units 0-2, from rf of the last layer) and the
// density unit's (unit 0 of the last trunk layer, from rd). Transposed
// weights: 2 RT rows x KT columns; per layer kp rows (the padded input),
// columns g_z's: the features, and at the last trunk layer the density unit
// at column nm. Workspace ([row][point], fp32): X, NX rows: pts_enc (rows 0
// .. d_in), view_enc (d_in ..), then each layer's feature input; G, NG
// rows: each layer's g_z, its outputs in order but the density unit last.
struct TfDesc {
  int n_layers, n_feat, d_in, d_view;
  int n_params, n_part, n_dw_tiles;
  int RF, KF, RT, KT, NX, NG;
  int out[kMaxLayers], in[kMaxLayers], w1[kMaxLayers], w2[kMaxLayers];
  int k1p[kMaxLayers], c2[kMaxLayers], kp[kMaxLayers];  // segment 1 padded to 64, 2 to 32
  int dens[kMaxLayers];   // 1 at the last trunk layer
  int nm[kMaxLayers];     // the forward product's N: the features padded to 64 (0: last layer)
  int kz[kMaxLayers];     // g_x's K: g_z columns padded to 32 (+ 32: the density chunk)
  int mz[kMaxLayers];     // dW rows: the outputs padded to 64
  int rf[kMaxLayers], rt[kMaxLayers];  // first row in the forward / transposed weights (hi)
  int rd;                 // the density unit's forward rows
  int x1[kMaxLayers], x2[kMaxLayers];  // workspace rows of X's segments (x2 -1: none)
  int go[kMaxLayers];     // workspace row of g_z
  int po[kMaxLayers];     // the layer's dW (mz x kp) and db (mz) in a partial
  int wo[kMaxLayers], bo[kMaxLayers];  // flat gradient offsets, (out, in) layout
  int to[kMaxLayers + 1]; // dW tiles before the layer: m-tiles of 128 rows x 1 or 2 n-tiles
  const float* W[kMaxLayers];
  const float* b[kMaxLayers];
};

// dims = [n_feat, n_rgb, d_in, d_view, view_dep, (out, in, skip) per layer].
// 0 where the float32 wgmma K2 takes the chain: pts_enc and view_enc at most
// 64 wide, every layer's first input segment padded to 64, 128 or 256 (the
// chains of the bf16 plan M); -7 where it does not (fused_mlp.cu's K2 runs
// them); -1 / -3 as build_wg_desc.
int build_tf_desc(const int* dims, const void* const* params, TfDesc* d) {
  memset(d, 0, sizeof(*d));
  d->n_feat = dims[0];
  const int n_rgb = dims[1];
  d->n_layers = d->n_feat + n_rgb;
  if (d->n_feat < 1 || n_rgb < 1 || d->n_layers > kMaxLayers) return -1;
  d->d_in = dims[2];
  d->d_view = dims[3];
  const int view_dep = dims[4];
  bool take = d->d_in >= 1 && d->d_in <= 64 && d->d_view >= 0 && d->d_view <= 64;
  int off = 0, tiles = 0, xf = d->d_in + d->d_view;
  d->KF = d->KT = 32;
  for (int li = 0; li < d->n_layers; ++li) {
    const int out = dims[5 + 3 * li], in = dims[6 + 3 * li], skip = dims[7 + 3 * li];
    const int w2 = skip ? d->d_in : ((li == d->n_feat && view_dep) ? d->d_view : 0);
    const int w1 = in - w2, dens = li == d->n_feat - 1, last = li == d->n_layers - 1;
    if (out < 1 + dens || w1 < 1 || (li == 0 && (skip || w1 != d->d_in)) ||
        (li > 0 && d->out[li - 1] - d->dens[li - 1] != w1))
      return -3;
    const int k1p = pad64(w1);
    if (k1p != 64 && k1p != 128 && k1p != 256) take = false;
    d->out[li] = out;
    d->in[li] = in;
    d->w1[li] = w1;
    d->w2[li] = w2;
    d->k1p[li] = k1p;
    d->c2[li] = pad32(w2);
    d->kp[li] = k1p + d->c2[li];
    d->dens[li] = dens;
    d->nm[li] = last ? 0 : pad64(out - dens);
    d->kz[li] = last ? pad32(out) : d->nm[li] + (dens ? 32 : 0);
    d->mz[li] = pad64(out);
    d->rf[li] = d->RF;
    d->RF += d->nm[li];
    d->rt[li] = d->RT;
    d->RT += d->kp[li];
    if (d->kp[li] > d->KF) d->KF = d->kp[li];
    if (d->kz[li] > d->KT) d->KT = d->kz[li];
    d->x1[li] = li == 0 ? 0 : xf;
    if (li > 0) xf += w1;
    d->x2[li] = w2 == 0 ? -1 : (skip ? 0 : d->d_in);
    d->go[li] = d->NG;
    d->NG += out;
    d->po[li] = d->n_part;
    d->n_part += d->mz[li] * d->kp[li] + d->mz[li];
    d->wo[li] = off;
    off += out * in;
    d->bo[li] = off;
    off += out;
    d->to[li] = tiles;
    tiles += (d->mz[li] + 127) / 128 * (w2 > 0 ? 2 : 1);
    d->W[li] = static_cast<const float*>(params[2 * li]);
    d->b[li] = static_cast<const float*>(params[2 * li + 1]);
  }
  if (d->out[d->n_layers - 1] != 3) return -3;
  d->rd = d->RF + 8;  // behind the RGB output's 8 rows (rf of the last layer)
  d->RF += 16;
  d->to[d->n_layers] = tiles;
  d->n_dw_tiles = tiles;
  d->n_params = off;
  d->NX = xf;
  return take ? 0 : -7;
}

// x = hi + lo as fused_mlp.cu's split: hi the nearest TF32 value (ties away
// from zero), lo the exact fp32 rest, whose top 19 bits the tensor core reads
__device__ __forceinline__ float tf32_hi(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xFFFFE000u);
}
template <int KS>
__device__ __forceinline__ void split_tf(const float (&x)[KS][4], uint32_t (&hi)[KS][4],
                                         uint32_t (&lo)[KS][4]) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float h = tf32_hi(x[ks][i]);
      hi[ks][i] = __float_as_uint(h);
      lo[ks][i] = __float_as_uint(x[ks][i] - h);
    }
}

// keeps the A fragments' registers unchanged while the async MMAs that read
// them are in flight, as register-fed wgmma requires: they stay live from
// before the wgmma fence to after the wait
template <int KS>
__device__ __forceinline__ void fence_frags(uint32_t (&r)[KS][4]) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(r[ks][i])::"memory");
}

// D (64 x N, fp32, in registers) += A (64 x 8, tf32, in registers: a0 (g,
// t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4) of the warp's 16 rows)
// B (8 x N, tf32, K-major in 128-byte-swizzled shared memory)
template <int N>
struct WgmmaTf;

template <>
struct WgmmaTf<8> {
  static __device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct WgmmaTf<32> {
  static __device__ __forceinline__ void mma(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct WgmmaTf<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct WgmmaTf<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct WgmmaTf<256> {
  static __device__ __forceinline__ void mma(float (&d)[128], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

// The weight maps (boxes of 32, 64, 128, 256 rows x 32 columns) of pass 1,
// the workspace maps (X: 32 .. 256 rows; G: 64, 128 rows x 32 points) of the
// dW pass.
struct TfWMaps {
  CUtensorMap wf[4], wt[4];
};
struct TfXMaps {
  CUtensorMap x[4], g[2];
};

// Pass 1's weight schedule, one ring stage per (product, hi / lo, k-chunk of
// 32): the forward layers [0, n_layers - 1), every k-chunk of the hi
// weights, then of the lo; then from the last layer down g_x of the second
// segment (if any) and of the features, the same way.
__device__ void produce_tf(const TfWMaps& m, const TfDesc& d, Ring ring) {
  Producer p{ring};
  const uint64_t keep = policy_keep();
  for (int li = 0; li + 1 < d.n_layers; ++li) {
    const int h = d.nm[li];
    for (int half = 0; half < 2; ++half)
      for (int kc = 0; kc < d.kp[li] / 32; ++kc)
        p.issue(h * 128, [&](uint32_t dst, uint32_t fb) {
          tma_load(dst, &m.wf[tf_code(h)], fb, 32 * kc, half * d.RF + d.rf[li], keep);
        });
  }
  for (int li = d.n_layers - 1; li >= 0; --li) {
    for (int seg = d.c2[li] > 0 ? 2 : 1; seg >= 1; --seg) {
      const int h = seg == 2 ? d.c2[li] : d.k1p[li], r0 = d.rt[li] + (seg == 2 ? d.k1p[li] : 0);
      for (int half = 0; half < 2; ++half)
        for (int kc = 0; kc < d.kz[li] / 32; ++kc)
          p.issue(h * 128, [&](uint32_t dst, uint32_t fb) {
            tma_load(dst, &m.wt[tf_code(h)], fb, 32 * kc, half * d.RT + r0, keep);
          });
    }
  }
}

// The tile's activations (the recompute) or g_z (the backward): 128 rows x
// 256 fp32, column c of row r at c ^ 4 (r % 8), so that the A fragments'
// loads (rows g, g + 8, columns t, t + 4) hit 32 banks; byte offsets.
__device__ __forceinline__ uint32_t act_at(int r, int c) {
  return 4u * (r * kTfActCols + (c ^ ((r & 7) << 2)));
}
// shared memory by 32-bit address (the A fragments' loads keep no 64-bit
// pointers live beside the accumulators)
__device__ __forceinline__ float lds32(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
  return v;
}
__device__ __forceinline__ void sts64(uint32_t addr, float a, float b) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(addr), "f"(a), "f"(b) : "memory");
}

// One k-chunk (4 k-steps) of a product against the ring's next stage, which
// holds B's hi (kHi: lo(A) hi(B) + hi(A) hi(B)) or lo (hi(A) lo(B)); side()
// runs while the chunk's MMAs do.
template <int N, bool kHi, typename F>
__device__ __forceinline__ void tf_chunk(float (&acc)[N / 2], const float (&a)[4][4], Ring& ring,
                                         bool run, F&& side) {
  const int st = ring.acquire();
  if (run) {
    const uint32_t b = ring.buf(st);
    uint32_t ah[4][4], al[4][4];
    split_tf(a, ah, al);
    fence_frags(ah);
    if constexpr (kHi) fence_frags(al);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      if constexpr (kHi) WgmmaTf<N>::mma(acc, al[ks], sdesc(b + 32 * ks, 0));
      WgmmaTf<N>::mma(acc, ah[ks], sdesc(b + 32 * ks, 0));
    }
    wgmma_commit();
    side();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_frags(ah);
    if constexpr (kHi) fence_frags(al);
  } else {
    side();
  }
  ring.release(st);
}

// Step q of Q of storing the tile's buffer's columns [0, w) (the warp's own
// rows) to the workspace rows at dst (a row per column, point-contiguous
// from the tile's first point): the column blocks of 8 j = q, q + Q, ...,
// 8 consecutive points a column per warp store.
__device__ __forceinline__ void store_cols(uint32_t act, float* __restrict__ dst, int w, int q,
                                           int Q, int x_rows, const Lane& L) {
  for (int j = q; 8 * j < w; j += Q)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = 64 * L.wg + L.r0 + 8 * h, col = 8 * j + 2 * L.t + e;
        if (col < w) dst[col * x_rows + r] = lds32(act + act_at(r, col));
      }
}

// The A fragments of the KS k-steps of 8 from column c0 of a layer's input,
// raw: the features from the tile's buffer (li > 0, columns < k1p), else
// pts_enc (layer 0, or a skip's second segment) or view_enc from device
// memory (zeros past T and past the width).
template <int KS>
__device__ __forceinline__ void fwd_a(const TfDesc& d, int li, int c0, uint32_t act,
                                      const float* __restrict__ pts,
                                      const float* __restrict__ view, int p0, int T,
                                      const Lane& L, float (&a)[KS][4]) {
  if (li > 0 && c0 < d.k1p[li]) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = 64 * L.wg + L.r0 + 8 * (i & 1), c = c0 + 8 * ks + L.t + 4 * (i >> 1);
        a[ks][i] = lds32(act + act_at(r, c));
      }
    return;
  }
  const bool pts_seg = li == 0 || d.x2[li] == 0;
  const float* src = pts_seg ? pts : view;
  const int width = pts_seg ? d.d_in : d.d_view, cb = li == 0 ? c0 : c0 - d.k1p[li];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int P = p0 + 64 * L.wg + L.r0 + 8 * (i & 1), c = cb + 8 * ks + L.t + 4 * (i >> 1);
      a[ks][i] = (P < T && c < width) ? __ldg(src + (size_t)P * width + c) : 0.f;
    }
}

// One recomputed layer li (N = nm): the warpgroup's 64 points x N features
// from their biases, every k-chunk against the hi weights, then the lo,
// while the layer's input features (the tile's buffer) go to X; ReLU into
// the tile's buffer, the ReLU mask words of the next layer's input.
template <int N>
__device__ void tf_fwd_layer(const TfDesc& d, int li, Ring& ring, uint32_t act,
                             const float* __restrict__ bias_f, const float* __restrict__ pts,
                             const float* __restrict__ view, float* __restrict__ ws,
                             uint4* __restrict__ masks, int p0, int T, int x_rows,
                             const Lane& L) {
  float acc[N / 2];
  const float* bias = bias_f + d.rf[li];
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[4 * j + c] = __ldg(bias + 8 * j + 2 * L.t + (c & 1));
#ifdef K2_TIME_NO_FWD
  constexpr bool run = false;
#else
  constexpr bool run = true;
#endif
  const int nk = d.kp[li] / 32, w_in = li > 0 ? d.w1[li] : 0;
  float* xs = ws + (size_t)d.x1[li] * x_rows + p0;  // (column, point) at column * x_rows + point
  int q = 0;
  auto side = [&]() { store_cols(act, xs, w_in, q++, 2 * nk, x_rows, L); };
  float a[4][4];
#pragma unroll 1
  for (int kc = 0; kc < nk; ++kc) {
    fwd_a(d, li, 32 * kc, act, pts, view, p0, T, L, a);
    tf_chunk<N, true>(acc, a, ring, run, side);
  }
#pragma unroll 1
  for (int kc = 0; kc < nk; ++kc) {
    fwd_a(d, li, 32 * kc, act, pts, view, p0, T, L, a);
    tf_chunk<N, false>(acc, a, ring, run, side);
  }
  __syncwarp();  // the warp's loads of its rows are done: its rows take the output
  uint32_t mw[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 64 * L.wg + L.r0 + 8 * h, col = 8 * j + 2 * L.t;
      float y[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float z = acc[4 * j + 2 * h + e];
        y[e] = fmaxf(z, 0.f);
        mw[j >> 3] |= z > 0.f ? mask_bit(j, h, e) : 0u;
      }
      sts64(act + act_at(r, col), y[0], y[1]);
    }
  }
  masks[((size_t)(li + 1) * gridDim.x + blockIdx.x) * kConsumers + threadIdx.x] =
      make_uint4(mw[0], mw[1], mw[2], mw[3]);
  __syncwarp();
}

// g_x = g_z W of layer li over its kz g_z columns, N columns of the padded
// input from the ring (the transposed weights): A from the tile's buffer,
// but the density chunk (column nm of the last trunk layer) from gout.
// With g: meanwhile the layer's g_z features (the tile's buffer) go to G.
template <int N>
__device__ void tf_gx(const TfDesc& d, int li, Ring& ring, uint32_t act,
                      const float* __restrict__ gout, int p0, int T, const Lane& L,
                      float (&acc)[N / 2], float* __restrict__ g = nullptr, int x_rows = 0) {
  zero(acc);
#ifdef K2_TIME_NO_GX
  constexpr bool run = false;
#else
  constexpr bool run = true;
#endif
  const int nk = d.kz[li] / 32, kd = d.dens[li] ? d.nm[li] / 32 : -1;
  const int w_g = g != nullptr ? d.out[li] - d.dens[li] : 0;
  int q = 0;
  auto side = [&]() { store_cols(act, g, w_g, q++, 2 * nk, x_rows, L); };
  float a[4][4];
  auto load = [&](int kc) {
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = 64 * L.wg + L.r0 + 8 * (i & 1);
        if (kc == kd) {  // the density gradient at the chunk's column 0
          const int P = p0 + r;
          a[ks][i] = (ks == 0 && i < 2 && L.t == 0 && P < T) ? __ldg(gout + (size_t)P * 4) : 0.f;
        } else {
          a[ks][i] = lds32(act + act_at(r, 32 * kc + 8 * ks + L.t + 4 * (i >> 1)));
        }
      }
  };
#pragma unroll 1
  for (int kc = 0; kc < nk; ++kc) {
    load(kc);
    tf_chunk<N, true>(acc, a, ring, run, side);
  }
#pragma unroll 1
  for (int kc = 0; kc < nk; ++kc) {
    load(kc);
    tf_chunk<N, false>(acc, a, ring, run, side);
  }
}

// g_x of a second segment (N = c2): pts_enc's share of a skip layer added
// into d_pts, view_enc's written to d_view (points < T, columns < w2).
template <int N>
__device__ void tf_gx_seg2(const TfDesc& d, int li, Ring& ring, uint32_t act,
                           const float* __restrict__ gout, float* d_pts,
                           float* __restrict__ d_view, int p0, int T, const Lane& L) {
  float acc[N / 2];
  tf_gx<N>(d, li, ring, act, gout, p0, T, L, acc);
  const bool pts_seg = d.x2[li] == 0;
  float* dst = pts_seg ? d_pts : d_view;
  const int width = d.w2[li];
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int P = p0 + 64 * L.wg + L.r0 + 8 * h;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + 2 * L.t + e;
        if (P >= T || col >= width) continue;
        float* q = dst + (size_t)P * width + col;
        *q = pts_seg ? *q + acc[4 * j + 2 * h + e] : acc[4 * j + 2 * h + e];
      }
    }
}

// g_x of layer li's features (N = k1p), while g_z of layer li (the tile's
// buffer; the last layer's is in G already) goes to G: into d_pts at layer
// 0; else masked by its input's ReLU mask words, g_z of layer li - 1 (its
// features), into the tile's buffer (over g_z of layer li: each warp its
// own rows).
template <int N>
__device__ void tf_gx_feat(const TfDesc& d, int li, Ring& ring, uint32_t act,
                           const float* __restrict__ gout, float* d_pts, float* __restrict__ ws,
                           const uint4* __restrict__ masks, int p0, int T, int x_rows,
                           const Lane& L) {
  const uint4 mwords = li > 0 ? masks[((size_t)li * gridDim.x + blockIdx.x) * kConsumers +
                                      threadIdx.x]
                              : make_uint4(0u, 0u, 0u, 0u);
  float acc[N / 2];
  float* g = li + 1 < d.n_layers ? ws + (size_t)(d.NX + d.go[li]) * x_rows + p0 : nullptr;
  tf_gx<N>(d, li, ring, act, gout, p0, T, L, acc, g, x_rows);
  const int w1 = d.w1[li];
  if (li == 0) {
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int P = p0 + 64 * L.wg + L.r0 + 8 * h;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * j + 2 * L.t + e;
          if (P < T && col < w1) d_pts[(size_t)P * w1 + col] += acc[4 * j + 2 * h + e];
        }
      }
    return;
  }
  const uint32_t mw[4] = {mwords.x, mwords.y, mwords.z, mwords.w};
  __syncwarp();  // the warp's loads of its rows are done: its rows take g_z of layer li - 1
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 64 * L.wg + L.r0 + 8 * h, col = 8 * j + 2 * L.t;
      float v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        v[e] = (col + e < w1 && (mw[j >> 3] & mask_bit(j, h, e))) ? acc[4 * j + 2 * h + e] : 0.f;
      }
      sts64(act + act_at(r, col), v[0], v[1]);
    }
  __syncwarp();
}

// K2 at float32, pass 1, per 128-point tile: pts_enc and view_enc into X;
// the recompute (every layer's input into X as hi and lo, the ReLU mask
// words); the output gradients into G (and the tile's buffer: g_z of the
// last layer); then from the last layer down g_x (into d_pts, d_view and g_z
// of the layer before, into G). d_pts zeroed by the caller.
__global__ void __launch_bounds__(kThreadsWg, 1)
k2_tf(const __grid_constant__ TfWMaps maps, const __grid_constant__ TfDesc d,
      const float* __restrict__ bias_f, const float* __restrict__ pts,
      const float* __restrict__ view, const float* __restrict__ gout, float* d_pts,
      float* __restrict__ d_view, float* __restrict__ ws, uint4* __restrict__ masks, int T,
      int x_rows) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* gen;
  const uint32_t s = aligned_base(smem_raw, &gen);
  const uint32_t act = s + kTfActOff;
  Ring ring = make_ring(s, kTfStageBytes, kTfStages, s + kTfBarOff);
  if (threadIdx.x >= kConsumers) {
    setmaxnreg_dec();
    if (threadIdx.x == kConsumers) produce_tf(maps, d, ring);
    return;
  }
  setmaxnreg_inc();
  const Lane L;
  const int p0 = blockIdx.x * kTile, Lr = d.n_layers;
  // pts_enc and view_enc into X (rows 0 .. d_in + d_view)
  for (int i = threadIdx.x; i < (d.d_in + d.d_view) * kTile; i += kConsumers) {
    const int c = i / kTile, P = p0 + i % kTile;
    ws[(size_t)c * x_rows + P] = P >= T ? 0.f
                                        : (c < d.d_in ? __ldg(pts + (size_t)P * d.d_in + c)
                                                      : __ldg(view + (size_t)P * d.d_view + c - d.d_in));
  }
  for (int li = 0; li + 1 < Lr; ++li) {
    switch (d.nm[li]) {
      case 64: tf_fwd_layer<64>(d, li, ring, act, bias_f, pts, view, ws, masks, p0, T, x_rows, L); break;
      case 128: tf_fwd_layer<128>(d, li, ring, act, bias_f, pts, view, ws, masks, p0, T, x_rows, L); break;
      default: tf_fwd_layer<256>(d, li, ring, act, bias_f, pts, view, ws, masks, p0, T, x_rows, L); break;
    }
  }
  // the last layer's input (the last recomputed layer's output) into X
  __syncwarp();
  store_cols(act, ws + (size_t)d.x1[Lr - 1] * x_rows + p0, d.w1[Lr - 1], 0, 1, x_rows, L);
  __syncwarp();
  // the output gradients: into G (the last layer's rows, the density unit's
  // row of the last trunk layer) and, for each warp its rows, the rgb
  // gradient into the tile's buffer's first 32 columns
  float* G = ws + (size_t)d.NX * x_rows;
  if (threadIdx.x < kTile) {
    const int P = p0 + threadIdx.x;
    const bool in = P < T;
    for (int c = 0; c < 3; ++c)
      G[(size_t)(d.go[Lr - 1] + c) * x_rows + P] = in ? __ldg(gout + (size_t)P * 4 + 1 + c) : 0.f;
    const int lf = d.n_feat - 1;
    G[(size_t)(d.go[lf] + d.out[lf] - 1) * x_rows + P] = in ? __ldg(gout + (size_t)P * 4) : 0.f;
  }
  for (int i = L.lane; i < 16 * 32; i += 32) {
    const int r = 64 * L.wg + 16 * (L.tid >> 5) + (i >> 5), c = i & 31, P = p0 + r;
    const float v = (c < 3 && P < T) ? __ldg(gout + (size_t)P * 4 + 1 + c) : 0.f;
    asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(act + act_at(r, c)), "f"(v) : "memory");
  }
  __syncwarp();
  for (int li = Lr - 1; li >= 0; --li) {
    if (d.c2[li] == 64)
      tf_gx_seg2<64>(d, li, ring, act, gout, d_pts, d_view, p0, T, L);
    else if (d.c2[li] == 32)
      tf_gx_seg2<32>(d, li, ring, act, gout, d_pts, d_view, p0, T, L);
    switch (d.k1p[li]) {
      case 64: tf_gx_feat<64>(d, li, ring, act, gout, d_pts, ws, masks, p0, T, x_rows, L); break;
      case 128: tf_gx_feat<128>(d, li, ring, act, gout, d_pts, ws, masks, p0, T, x_rows, L); break;
      default: tf_gx_feat<256>(d, li, ring, act, gout, d_pts, ws, masks, p0, T, x_rows, L); break;
    }
  }
}

// ---------------------------------------------------------------------------
// the float32 K2, pass 2: dW = g_z^T X over the points
// ---------------------------------------------------------------------------

// dW tile b: layer li, rows m0 .. m0 + 128 of its g_z, n-tile ni (0: the
// first input segment, N = k1p, at column 0; 1: the second, N = c2, at
// column k1p).
__device__ __forceinline__ void tf_dw_tile(const TfDesc& d, int b, int& li, int& m0, int& ni) {
  li = 0;
  while (li + 1 < d.n_layers && b >= d.to[li + 1]) ++li;
  const int local = b - d.to[li], nn = d.c2[li] > 0 ? 2 : 1;
  m0 = 128 * (local / nn);
  ni = local % nn;
}

// X's box of a stage, raw fp32 as TMA brought it, split for the MMAs: hi
// over it in place, lo into the buffer at lo (the same layout: elementwise,
// 16 bytes a step), by the 256 consumers; then the fence that shows those
// generic writes to wgmma's reads.
template <int N>
__device__ __forceinline__ void tf_split_x(uint32_t x, uint32_t lo) {
#pragma unroll
  for (int k = 0; k < N / 32; ++k) {
    const uint32_t i = 16 * (k * kConsumers + threadIdx.x);
    float v[4], h[4];
    asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                 : "=f"(v[0]), "=f"(v[1]), "=f"(v[2]), "=f"(v[3]) : "r"(x + i) : "memory");
#pragma unroll
    for (int e = 0; e < 4; ++e) h[e] = tf32_hi(v[e]);
    asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(x + i), "f"(h[0]),
                 "f"(h[1]), "f"(h[2]), "f"(h[3]) : "memory");
    asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(lo + i), "f"(v[0] - h[0]),
                 "f"(v[1] - h[1]), "f"(v[2] - h[2]), "f"(v[3] - h[3]) : "memory");
  }
  fence_async_smem();
}

// The consumers of one dW tile over a point range: per stage of 32 points
// A = g_z^T from the g_z box (point-contiguous rows, read into registers
// and split), B = X from the X box, split in shared memory (hi in place, lo
// in one of two buffers), the next stage's while this one's MMAs run; the
// warpgroup's 64 rows (a warpgroup past mz has none: it splits, runs its
// MMAs on what the stage holds and writes nothing, since a branch around
// wgmma serializes them); the partial of this range and, on the first
// n-tile, the row sums of g_z (db).
template <int N>
__device__ void tf_dw_consume(const TfDesc& d, int li, int m0, int ni, int n_chunks, Ring& ring,
                              uint32_t lo0, float* __restrict__ dst) {
  const Lane L;
  float acc[N / 2];
  zero(acc);
  float s0 = 0.f, s1 = 0.f;  // db of rows r0 and r0 + 8
  int st = 0;
  if (n_chunks > 0) {
    st = ring.acquire();
    tf_split_x<N>(ring.buf(st) + kTfDwXOff, lo0);
    consumers_bar();
  }
#pragma unroll 1
  for (int c = 0; c < n_chunks; ++c) {
    const uint32_t ga = ring.buf(st) + L.wg * 64 * 128;
    float a[4][4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = L.r0 + 8 * (i & 1), p = 8 * ks + L.t + 4 * (i >> 1);
        a[ks][i] = lds32(ga + r * 128 + ((((p >> 2) ^ r) & 7) << 4) + (p & 3) * 4);
      }
    if (ni == 0)
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        s0 += a[ks][0] + a[ks][2];
        s1 += a[ks][1] + a[ks][3];
      }
    uint32_t ah[4][4], al[4][4];
    split_tf(a, ah, al);
    const uint32_t bh = ring.buf(st) + kTfDwXOff, bl = lo0 + (c & 1) * kTfStageBytes;
    fence_frags(ah);
    fence_frags(al);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      WgmmaTf<N>::mma(acc, al[ks], sdesc(bh + 32 * ks, 0));
      WgmmaTf<N>::mma(acc, ah[ks], sdesc(bl + 32 * ks, 0));
      WgmmaTf<N>::mma(acc, ah[ks], sdesc(bh + 32 * ks, 0));
    }
    wgmma_commit();
    const int cur = st;
    if (c + 1 < n_chunks) {  // the next stage's X, split while this stage's MMAs run
      st = ring.acquire();
      tf_split_x<N>(ring.buf(st) + kTfDwXOff, lo0 + ((c + 1) & 1) * kTfStageBytes);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    fence_frags(ah);
    fence_frags(al);
    ring.release(cur);
    consumers_bar();  // the next stage is split; this one's lo buffer is free
  }
  if (m0 + 64 * L.wg >= d.mz[li]) return;
  const int kp = d.kp[li], col0 = ni == 0 ? 0 : d.k1p[li];
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + 64 * L.wg + L.r0 + 8 * h, col = col0 + 8 * j + 2 * L.t;
      *reinterpret_cast<float2*>(dst + (size_t)r * kp + col) =
          make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  if (ni == 0) {  // the row sums of the warp's four lanes t, in a fixed order
    s0 += __shfl_xor_sync(0xffffffffu, s0, 1);
    s0 += __shfl_xor_sync(0xffffffffu, s0, 2);
    s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
    s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
    if (L.t == 0) {
      const int r = m0 + 64 * L.wg + L.r0;
      dst[(size_t)d.mz[li] * kp + r] = s0;
      dst[(size_t)d.mz[li] * kp + r + 8] = s1;
    }
  }
}

// Pass 2: one dW tile (blockIdx.x) over one of kSplits point ranges
// (blockIdx.y), its partial written plain; stages of 32 points: the g_z box
// (128 or 64 rows) and X's box (N rows).
__global__ void __launch_bounds__(kThreadsWg, 1)
k2_dw_tf(const __grid_constant__ TfXMaps maps, const __grid_constant__ TfDesc d,
         float* __restrict__ partial, int n_tiles) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* gen;
  const uint32_t s = aligned_base(smem_raw, &gen);
  Ring ring = make_ring(s, kTfDwStageBytes, kTfDwStages, s + kTfDwBarOff);
  int li, m0, ni;
  tf_dw_tile(d, blockIdx.x, li, m0, ni);
  const int N = ni == 0 ? d.k1p[li] : d.c2[li];
  const int per = (n_tiles + kSplits - 1) / kSplits;
  const int t0 = min(n_tiles, (int)blockIdx.y * per), t1 = min(n_tiles, t0 + per);
  const int n_chunks = (t1 - t0) * kTile / 32;
  if (threadIdx.x >= kConsumers) {
    setmaxnreg_dec();
    if (threadIdx.x != kConsumers) return;
    Producer p{ring};
    const uint64_t stream = policy_stream();
    const int rows = d.mz[li] - m0 >= 128 ? 128 : 64;
    const int xr = ni == 0 ? d.x1[li] : d.x2[li];
    for (int c = 0; c < n_chunks; ++c) {
      const int P0 = t0 * kTile + 32 * c;
      p.issue((rows + N) * 128, [&](uint32_t dst, uint32_t fb) {
        tma_load(dst, &maps.g[rows == 128 ? 1 : 0], fb, P0, d.go[li] + m0, stream);
        tma_load(dst + kTfDwXOff, &maps.x[tf_code(N)], fb, P0, xr, stream);
      });
    }
    return;
  }
  setmaxnreg_inc();
  float* dst = partial + (size_t)blockIdx.y * d.n_part + d.po[li];
  switch (N) {
    case 32: tf_dw_consume<32>(d, li, m0, ni, n_chunks, ring, s + kTfDwLoOff, dst); break;
    case 64: tf_dw_consume<64>(d, li, m0, ni, n_chunks, ring, s + kTfDwLoOff, dst); break;
    case 128: tf_dw_consume<128>(d, li, m0, ni, n_chunks, ring, s + kTfDwLoOff, dst); break;
    default: tf_dw_consume<256>(d, li, m0, ni, n_chunks, ring, s + kTfDwLoOff, dst); break;
  }
}

// dW row of output unit n (the density unit last) and input column of input
// k (the padded input)
__device__ __forceinline__ int tf_row_of(const TfDesc& d, int li, int n) {
  return d.dens[li] ? (n == 0 ? d.out[li] - 1 : n - 1) : n;
}

// Sums the kSplits partials in order (deterministic) into the (out, in)
// layout of the flat gradient.
__global__ void k2_reduce_tf(const __grid_constant__ TfDesc d, const float* __restrict__ partial,
                             float* __restrict__ out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= d.n_params) return;
  int li = 0;
  while (li + 1 < d.n_layers && j >= d.wo[li + 1]) ++li;
  const int kp = d.kp[li];
  int pos;
  if (j < d.bo[li]) {
    const int q = j - d.wo[li], n = q / d.in[li], k = q - n * d.in[li];
    pos = d.po[li] + tf_row_of(d, li, n) * kp + (k < d.w1[li] ? k : d.k1p[li] + k - d.w1[li]);
  } else {
    pos = d.po[li] + d.mz[li] * kp + tf_row_of(d, li, j - d.bo[li]);
  }
  float sum = 0.f;
  for (int s = 0; s < kSplits; ++s) sum += partial[(size_t)s * d.n_part + pos];
  out[j] = sum;
}

// ---------------------------------------------------------------------------
// K1 and K3 at float32: the forward on wgmma (header note, "The float32 K1/K3")
// ---------------------------------------------------------------------------

// The forward's weight maps: boxes of 16 columns (64 bytes, 64-byte swizzle)
// x 8, 64, 128 or 256 rows
struct TfFMaps {
  CUtensorMap w[4];
};
__host__ __device__ constexpr int ft_code(int rows) {
  return rows <= 8 ? 0 : (rows <= 64 ? 1 : (rows <= 128 ? 2 : 3));
}

// wgmma shared-memory descriptor of a K-major tile with the 64-byte swizzle
// (layout type 2): rows of 64 bytes, SBO = 512 bytes between 8-row groups
__device__ __forceinline__ uint64_t sdesc64(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(512 >> 4) << 32) |
         (2ull << 62);
}

// The forward's weight schedule, one ring stage per 16-column k-chunk of a
// layer but the last (its nm rows of hi, then of lo: 64 bytes a row); behind
// the last trunk layer's chunks the density unit's 8 rows over every
// k-chunk in one stage, and the RGB output's the same way (chunk c's hi at
// 1024 c, its lo at 1024 c + 512).
__device__ void produce_ft(const TfFMaps& m, const TfDesc& d, Ring ring) {
  Producer p{ring};
  const uint64_t keep = policy_keep();
  auto narrow = [&](int li, int r0) {
    const int nk = d.kp[li] / 16;
    p.issue(1024 * nk, [&](uint32_t dst, uint32_t fb) {
      for (int kc = 0; kc < nk; ++kc) {
        tma_load(dst + 1024 * kc, &m.w[0], fb, 16 * kc, r0, keep);
        tma_load(dst + 1024 * kc + 512, &m.w[0], fb, 16 * kc, d.RF + r0, keep);
      }
    });
  };
  for (int li = 0; li + 1 < d.n_layers; ++li) {
    const int h = d.nm[li], c = ft_code(h);
    for (int kc = 0; kc < d.kp[li] / 16; ++kc)
      p.issue(2 * h * 64, [&](uint32_t dst, uint32_t fb) {
        tma_load(dst, &m.w[c], fb, 16 * kc, d.rf[li], keep);
        tma_load(dst + h * 64, &m.w[c], fb, 16 * kc, d.RF + d.rf[li], keep);
      });
    if (d.dens[li]) narrow(li, d.rd);
  }
  narrow(d.n_layers - 1, d.rf[d.n_layers - 1]);
}

// A product of width N over every 16-column k-chunk of layer li's input,
// from its biases at bias (a column per output): per chunk the A fragments
// of its two k-steps, split into hi and lo once, and lo(A) hi(B) + hi(A)
// hi(B) + hi(A) lo(B) for each k-step on the B tile at b (hi; lo at +
// lo_off). STAGE: each chunk on a ring stage of its own (acquired and
// released here), else chunk kc at b0 + 1024 kc.
template <int N, bool STAGE>
__device__ __forceinline__ void ft_product(float (&acc)[N / 2], const TfDesc& d, int li,
                                           const float* __restrict__ bias, Ring& ring, uint32_t b0,
                                           uint32_t lo_off, uint32_t act,
                                           const float* __restrict__ pts,
                                           const float* __restrict__ view, int p0, int T,
                                           const Lane& L) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[4 * j + c] = __ldg(bias + 8 * j + 2 * L.t + (c & 1));
#pragma unroll 1
  for (int kc = 0; kc < d.kp[li] / 16; ++kc) {
    float a[2][4];
    fwd_a(d, li, 16 * kc, act, pts, view, p0, T, L, a);
    uint32_t ah[2][4], al[2][4];
    split_tf(a, ah, al);
    int st = 0;
    uint32_t b = b0 + 1024 * kc;
    if constexpr (STAGE) {
      st = ring.acquire();
      b = ring.buf(st);
    }
    fence_frags(ah);
    fence_frags(al);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      WgmmaTf<N>::mma(acc, al[ks], sdesc64(b + 32 * ks));
      WgmmaTf<N>::mma(acc, ah[ks], sdesc64(b + 32 * ks));
      WgmmaTf<N>::mma(acc, ah[ks], sdesc64(b + lo_off + 32 * ks));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_frags(ah);
    fence_frags(al);
    if constexpr (STAGE) ring.release(st);
  }
}

// An 8-wide product (the density unit, the RGB output) of layer li over its
// one stage of every k-chunk, from the biases of its forward rows at r0.
__device__ __forceinline__ void ft_narrow(float (&acc)[4], const TfDesc& d, int li, int r0,
                                          const float* __restrict__ bias_f, Ring& ring,
                                          uint32_t act, const float* __restrict__ pts,
                                          const float* __restrict__ view, int p0, int T,
                                          const Lane& L) {
  const int st = ring.acquire();
  ft_product<8, false>(acc, d, li, bias_f + r0, ring, ring.buf(st), 512, act, pts, view, p0, T, L);
  ring.release(st);
}

// One forward layer li but the last (N = nm): the warpgroup's 64 points x N
// features, then (the last trunk layer) the density unit, whose raw value
// goes to out[:, 0]; ReLU into the tile's buffer, each warp its own rows.
template <int N>
__device__ void ft_layer(const TfDesc& d, int li, Ring& ring, uint32_t act,
                         const float* __restrict__ bias_f, const float* __restrict__ pts,
                         const float* __restrict__ view, float* __restrict__ out, int p0, int T,
                         const Lane& L) {
  float acc[N / 2];
  ft_product<N, true>(acc, d, li, bias_f + d.rf[li], ring, 0, N * 64, act, pts, view, p0, T, L);
  if (d.dens[li]) {
    float dens[4];
    ft_narrow(dens, d, li, d.rd, bias_f, ring, act, pts, view, p0, T, L);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int P = p0 + 64 * L.wg + L.r0 + 8 * h;
      if (L.t == 0 && P < T) out[(size_t)P * 4] = dens[2 * h];
    }
  }
  __syncwarp();  // the warp's loads of its rows are done: its rows take the output
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      sts64(act + act_at(64 * L.wg + L.r0 + 8 * h, 8 * j + 2 * L.t),
            fmaxf(acc[4 * j + 2 * h], 0.f), fmaxf(acc[4 * j + 2 * h + 1], 0.f));
  __syncwarp();
}

// The forward of one 128-point tile, K1's and K3's body: out (T, 4) =
// [raw_density | raw_rgb] on the forward half of k_tf_layout's weights.
// Shared memory as k2_tf's: the ring (three 32-KB stages), the tile's
// activations (fp32, act_at), the barriers.
__device__ __forceinline__ void ft_tile(const TfFMaps& maps, const TfDesc& d,
                                        const float* __restrict__ bias_f,
                                        const float* __restrict__ pts,
                                        const float* __restrict__ view, float* __restrict__ out,
                                        int T) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* gen;
  const uint32_t s = aligned_base(smem_raw, &gen);
  const uint32_t act = s + kTfActOff;
  Ring ring = make_ring(s, kTfStageBytes, kTfStages, s + kTfBarOff);
  if (threadIdx.x >= kConsumers) {
    setmaxnreg_dec();
    if (threadIdx.x == kConsumers) produce_ft(maps, d, ring);
    return;
  }
  setmaxnreg_inc();
  const Lane L;
  const int p0 = blockIdx.x * kTile, Lr = d.n_layers;
  for (int li = 0; li + 1 < Lr; ++li) {
    switch (d.nm[li]) {
      case 64: ft_layer<64>(d, li, ring, act, bias_f, pts, view, out, p0, T, L); break;
      case 128: ft_layer<128>(d, li, ring, act, bias_f, pts, view, out, p0, T, L); break;
      default: ft_layer<256>(d, li, ring, act, bias_f, pts, view, out, p0, T, L); break;
    }
  }
  float rgb[4];
  ft_narrow(rgb, d, Lr - 1, d.rf[Lr - 1], bias_f, ring, act, pts, view, p0, T, L);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int P = p0 + 64 * L.wg + L.r0 + 8 * (c >> 1), col = 2 * L.t + (c & 1);
    if (col < 3 && P < T) out[(size_t)P * 4 + 1 + col] = rgb[c];
  }
}

// K1: the forward on the weights its launch laid out.
__global__ void __launch_bounds__(kThreadsWg, 1)
k1_tf(const __grid_constant__ TfFMaps maps, const __grid_constant__ TfDesc d,
      const float* __restrict__ bias_f, const float* __restrict__ pts,
      const float* __restrict__ view, float* __restrict__ out, int T) {
  ft_tile(maps, d, bias_f, pts, view, out, T);
}

// K3: the same body on the weights pack_weights laid out once per call (its
// own symbol, so that a profile tells the two apart).
__global__ void __launch_bounds__(kThreadsWg, 1)
k3_tf(const __grid_constant__ TfFMaps maps, const __grid_constant__ TfDesc d,
      const float* __restrict__ bias_f, const float* __restrict__ pts,
      const float* __restrict__ view, float* __restrict__ out, int T) {
  ft_tile(maps, d, bias_f, pts, view, out, T);
}

// output unit of forward row R (its layer in *li), or -1 (TfDesc note)
__device__ __forceinline__ int tf_forward_unit(const TfDesc& d, int R, int* li) {
  if (R >= d.rd) {
    *li = d.n_feat - 1;
    return R == d.rd ? 0 : -1;
  }
  int l = 0;
  while (l + 1 < d.n_layers && R >= d.rf[l + 1]) ++l;
  *li = l;
  return R - d.rf[l] < d.out[l] - d.dens[l] ? R - d.rf[l] + d.dens[l] : -1;
}

// The weights in the TMA maps' layouts (ops/fused_mlp.py::tf32wg_weights_plain):
// wf (2 RF x KF) rows of hi then of lo, W[unit of the row][input of the
// column]; wt (2 RT x KT; null: K1/K3, which read only wf) the same over
// (padded input, g_z column); bias_f (RF) b of the forward rows; zeros in the
// padding.
__global__ void k_tf_layout(const __grid_constant__ TfDesc d, float* __restrict__ wf,
                            float* __restrict__ wt, float* __restrict__ bias_f) {
  const int nf = d.RF * d.KF, nt = wt != nullptr ? d.RT * d.KT : 0;
  for (int idx = blockIdx.x * blockDim.x + threadIdx.x; idx < nf + nt + d.RF;
       idx += gridDim.x * blockDim.x) {
    int li = 0, n = -1, k = -1;
    if (idx >= nf + nt) {
      const int R = idx - nf - nt;
      n = tf_forward_unit(d, R, &li);
      bias_f[R] = n >= 0 ? d.b[li][n] : 0.f;
      continue;
    }
    const bool tr = idx >= nf;
    const int e = tr ? idx - nf : idx, K = tr ? d.KT : d.KF, R = e / K, C = e - R * K;
    if (tr) {
      while (li + 1 < d.n_layers && R >= d.rt[li + 1]) ++li;
      k = R - d.rt[li];
      const int nf_ = d.out[li] - d.dens[li];  // the features, then (dens) the unit at nm
      n = C < nf_ ? C + d.dens[li] : (d.dens[li] && C == d.nm[li] ? 0 : -1);
    } else {
      n = tf_forward_unit(d, R, &li);
      k = C;
    }
    const int i = k >= d.kp[li] ? -1
                  : k < d.k1p[li] ? (k < d.w1[li] ? k : -1)
                                  : (k - d.k1p[li] < d.w2[li] ? d.w1[li] + k - d.k1p[li] : -1);
    const float v = (n >= 0 && i >= 0) ? d.W[li][(size_t)n * d.in[li] + i] : 0.f;
    const float hi = tf32_hi(v);
    float* dst = tr ? wt + e : wf + e;
    dst[0] = hi;
    dst[tr ? nt : nf] = v - hi;
  }
}

// a 2D fp32 map over rows x cols (row-major), box {32 columns, box_rows},
// 128-byte swizzle (K1/K3's: {16 columns, box_rows}, 64-byte swizzle)
int make_map_f32(CUtensorMap* m, const void* ptr, uint64_t rows, uint64_t cols, uint32_t box_rows,
                 bool sw64 = false) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return -6;
  const cuuint64_t dims[2] = {cols, rows}, strides[1] = {cols * 4};
  const cuuint32_t box[2] = {sw64 ? 16u : 32u, box_rows}, es[2] = {1, 1};
  const CUresult r = fn(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(ptr), dims,
                        strides, box, es, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        sw64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -6;
}

int launch_tf_layout(const TfDesc& d, void* wf, void* wt, void* bias_f, cudaStream_t s) {
  k_tf_layout<<<264, 256, 0, s>>>(d, static_cast<float*>(wf), static_cast<float*>(wt),
                                  static_cast<float*>(bias_f));
  return static_cast<int>(cudaGetLastError());
}

// K1 (k1_tf) or K3 (k3_tf) on the forward half of wf (2 RF x KF) and bias_f
int launch_ft(bool k3, const TfDesc& d, const void* wf, const void* bias_f, const float* pts,
              const float* view, float* out, int T, cudaStream_t s) {
  TfFMaps m;
  memset(&m, 0, sizeof(m));
  bool f[4] = {true};  // 8 rows: the density unit, the RGB output
  for (int li = 0; li + 1 < d.n_layers; ++li) f[ft_code(d.nm[li])] = true;
  for (int c = 0; c < 4; ++c)
    if (f[c] && make_map_f32(&m.w[c], wf, 2 * d.RF, d.KF, c == 0 ? 8 : 32 << c, true) != 0)
      return -6;
  const auto kernel = k3 ? k3_tf : k1_tf;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kTfSmem);
  kernel<<<(T + kTile - 1) / kTile, kThreadsWg, kTfSmem, s>>>(
      m, d, static_cast<const float*>(bias_f), pts, view, out, T);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// [n_params, wf elements (2 RF x KF), wt elements (2 RT x KT), RF, NX, NG,
// n_part, n_splits, n_dw_tiles] of the float32 wgmma K2, or a negative code:
// -7 where it does not take the chain (fused_mlp.cu's K2 runs it).
int sparf_fused_mlp_tf32wg_sizes(const int* dims, int* sizes) {
  static const void* const null_params[2 * kMaxLayers] = {};
  TfDesc d;
  const int rc = build_tf_desc(dims, null_params, &d);
  if (rc < 0) return rc;
  const int v[9] = {d.n_params, 2 * d.RF * d.KF, 2 * d.RT * d.KT, d.RF, d.NX, d.NG, d.n_part,
                    kSplits, d.n_dw_tiles};
  for (int i = 0; i < 9; ++i) sizes[i] = v[i];
  return 0;
}

// The weights in the layouts of the float32 K2 and K1/K3 (wt null: the
// forward half, for K3, once per call; else the layout check).
int sparf_fused_mlp_tf32wg_layout(const int* dims, const void* const* params, void* wf, void* wt,
                              void* bias_f, void* stream) {
  TfDesc d;
  const int rc = build_tf_desc(dims, params, &d);
  if (rc < 0) return rc;
  return launch_tf_layout(d, wf, wt, bias_f, static_cast<cudaStream_t>(stream));
}

// K1 at float32 on wgmma: lays out the forward half of the weights into wf /
// bias_f (scratch of 2 RF x KF and RF elements), then out (T, 4) =
// [raw_density | raw_rgb].
int sparf_fused_mlp_tf32wg_forward(const float* pts, const float* view, float* out, int T,
                                   const int* dims, const void* const* params, void* wf,
                                   void* bias_f, void* stream) {
  TfDesc d;
  int rc = build_tf_desc(dims, params, &d);
  if (rc < 0) return rc;
  if (T <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((rc = launch_tf_layout(d, wf, nullptr, bias_f, s)) != 0) return rc;
  return launch_ft(false, d, wf, bias_f, pts, view, out, T, s);
}

// K3 at float32 on wgmma: out (T, 4) = [raw_density | raw_rgb] on the forward
// half wf / bias_f that sparf_fused_mlp_tf32wg_layout laid out (wt null),
// once per call.
int sparf_fused_mlp_tf32wg_forward_packed(const float* pts, const float* view, float* out, int T,
                                          const int* dims, const void* wf, const void* bias_f,
                                          void* stream) {
  static const void* const null_params[2 * kMaxLayers] = {};
  TfDesc d;
  const int rc = build_tf_desc(dims, null_params, &d);
  if (rc < 0) return rc;
  if (T <= 0) return 0;
  return launch_ft(true, d, wf, bias_f, pts, view, out, T, static_cast<cudaStream_t>(stream));
}

// K2 at float32 on wgmma. gout (T, 4) = [g_density | g_rgb]; d_pts zeroed by
// the caller; d_params (n_params,) in the order W0, b0, W1, b1, ...;
// scratch: wf, wt, bias_f (the sizes' elements), ws ((NX + NG) x T_pad
// fp32: X, then G, each row T_pad points), T_pad = T rounded up to 128,
// masks (n_layers x T_pad / 128 x 256 uint4), partial (n_splits x n_part).
int sparf_fused_mlp_tf32wg_backward(const float* pts, const float* view, const float* gout,
                                float* d_pts, float* d_view, float* d_params, void* wf, void* wt,
                                void* bias_f, float* ws, void* masks, float* partial, int T,
                                const int* dims, const void* const* params, void* stream) {
  TfDesc d;
  int rc = build_tf_desc(dims, params, &d);
  if (rc < 0) return rc;
  if (T <= 0) return -5;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_tiles = (T + kTile - 1) / kTile, x_rows = n_tiles * kTile;
  TfWMaps wm;
  TfXMaps xm;
  memset(&wm, 0, sizeof(wm));
  memset(&xm, 0, sizeof(xm));
  bool f[4] = {}, t[4] = {}, g[2] = {};  // the box heights in use
  for (int li = 0; li < d.n_layers; ++li) {
    if (d.nm[li] > 0) f[tf_code(d.nm[li])] = true;
    t[tf_code(d.k1p[li])] = true;
    if (d.c2[li] > 0) t[tf_code(d.c2[li])] = true;
    g[d.mz[li] % 128 != 0 ? 0 : 1] = true;
    if (d.mz[li] >= 128) g[1] = true;
  }
  float* G = ws + (size_t)d.NX * x_rows;
  for (int c = 0; c < 4; ++c) {
    const int h = 32 << c;
    if ((f[c] && make_map_f32(&wm.wf[c], wf, 2 * d.RF, d.KF, h) != 0) ||
        (t[c] && make_map_f32(&wm.wt[c], wt, 2 * d.RT, d.KT, h) != 0) ||
        (t[c] && make_map_f32(&xm.x[c], ws, d.NX, x_rows, h) != 0) ||
        (c < 2 && g[c] && make_map_f32(&xm.g[c], G, d.NG, x_rows, 64 << c) != 0))
      return -6;
  }
  if ((rc = launch_tf_layout(d, wf, wt, bias_f, s)) != 0) return rc;
  cudaFuncSetAttribute(k2_tf, cudaFuncAttributeMaxDynamicSharedMemorySize, kTfSmem);
  k2_tf<<<n_tiles, kThreadsWg, kTfSmem, s>>>(wm, d, static_cast<const float*>(bias_f), pts, view,
                                             gout, d_pts, d_view, ws, static_cast<uint4*>(masks),
                                             T, x_rows);
  if ((rc = static_cast<int>(cudaGetLastError())) != 0) return rc;
#ifndef K2_TIME_NO_DW
  cudaFuncSetAttribute(k2_dw_tf, cudaFuncAttributeMaxDynamicSharedMemorySize, kTfDwSmem);
  k2_dw_tf<<<dim3(d.n_dw_tiles, kSplits), kThreadsWg, kTfDwSmem, s>>>(xm, d, partial, n_tiles);
  if ((rc = static_cast<int>(cudaGetLastError())) != 0) return rc;
#endif
  k2_reduce_tf<<<(d.n_params + 255) / 256, 256, 0, s>>>(d, partial, d_params);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

// Fused NeRF-MLP forward (K1, K3) and backward (K2) for Hopper (sm_90a), fp32.
//
// Replaces the Pallas TPU kernels of sparf_tpu/ops/fused_mlp_vjp.py:
//   K1 = _fwd_kernel (launched by _core_forward), K2 = _bwd_kernel (launched
//   by _core_bwd, the custom_vjp backward);
// and of sparf_tpu/ops/fused_mlp.py:
//   K3 = _kernel (launched by fused_mlp_forward), the forward-only chain on
//   weights packed once per call (the no-gradient renders: full images at
//   validation and evaluation, the depth-consistency visibility pass).
// They compute the 10-matmul NeRF chain: trunk layers with ReLU, pts_enc
// concatenated at the skip layers, raw density from unit 0 of the last trunk
// layer, [features | view_enc] through the RGB head. K1 writes only
// [raw_density | raw_rgb] (T, 4). K2 recomputes the forward per tile, keeps
// every layer input on chip, and backpropagates [g_density | g_rgb] into
// d_pts_enc (incl. the skip share), d_view_enc and the gradients of all
// weights and biases.
//
// What bounds them on an H100, and what the design does about it:
//   * Arithmetic: ~1.06 MFLOP per point forward at the full 8x256 width. This
//     first version runs fp32 FMA on the CUDA cores (no TF32, no wgmma), so
//     both kernels are bound by fp32 issue rate and shared-memory bandwidth.
//     A block computes a register micro-tile (points x 32-strided output
//     units) so each staged weight feeds several FMAs.
//   * Weights (~0.53M fp32 per network, ~2.1 MB) are read in their (out, in)
//     layout straight from global memory; they stay in the 50 MB L2. The
//     forward layer loop (K1, and K2's recomputed forward) stages 32-column
//     chunks through shared memory, double-buffered with cp.async so that
//     the next chunk's copy overlaps this chunk's FMAs; K2's backward reads
//     them coalesced along the input dimension.
//   * Layer inputs stay in shared memory. The skip concat [feat | pts_enc]
//     and the view concat [feat | view_enc] are two input segments of the
//     layer loop, never copies.
//   * K2's shared-memory budget: every stored layer input of one point is
//     63 + 27 + 7*256 + 256 + 128 = 2,266 fp32 at full width; a 16-point tile
//     holds them in ~145 KB, plus the g_z double buffer (aliased with the
//     two weight staging buffers of the recomputed forward, 73,984 bytes)
//     and the d_pts tile: 223,104 of the 232,448 bytes a block may use. The
//     tile is 16 points. (K1: 64 points, 228,096 bytes.)
//   * dW and db cross the grid without atomics: K2 runs a fixed number of
//     persistent blocks; block g handles tiles g, g+G, ... in order and
//     accumulates into its own slice of a (G, n_params) scratch buffer.
//     A second kernel sums the slices in block order. Two runs on one card
//     give the same bits. The per-tile read-modify-write of the block's
//     slice (~4 MB per tile at full width) is the kernel's memory cost; the
//     132 slices do not fit in L2, so K2 loads the weights and dW partials
//     of 16 output units before using any of them (8 on layers of more than
//     256 inputs, where a thread owns two input columns): latency, not
//     bandwidth, bounded the one-at-a-time loop.
//   * Both kernels run one 256-thread block per SM (their shared memory
//     allows no second one), so 8 warps must hide every load and barrier.
//     That occupancy is the likeliest reason they stay slower than cuBLAS
//     on this card (an estimate; no hardware-counter trace). At full
//     width K2's backward is three quarters of its time, about 3x above both
//     its HBM floor (the dW slice traffic) and its FMA issue floor; loading
//     the next pass one pass ahead gained only 5%, so it is not bound by the
//     latency of one pass's loads either.
//   * The ragged last tile is masked in the kernels: points past T load
//     zeros, get zero output gradients, and store nothing.
//   * K3 is K1's kernel with another weight layout: its operands come packed
//     as (in, out_pad) matrices, out_pad = 32 * ceil(out / 32), zero past
//     `out` (ops/fused_mlp.py::pack_weights). A chunk of kKC input rows is
//     then one contiguous block, staged with 16-byte cp.async copies and no
//     transpose, where K1 stages 4-byte transposing copies. Both run the one
//     layer loop, forward_layer_j, templated on the layout.
//
// Interface: plain C, loaded with ctypes. Every entry point launches on the
// given stream, allocates nothing, and returns cudaGetLastError() (> 0), a
// negative code for a layer configuration the kernels do not take, or 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLayers = 16;
constexpr int kMaxJ = 9;                  // output units <= 32 * kMaxJ = 288
constexpr int kKC = 32;                   // weight columns staged per chunk
constexpr int kLDS = 32 * kMaxJ + 1;      // staging row stride (odd: no bank conflicts)
constexpr int kMaxC = 2;                  // K2: input columns per thread, in_dim <= 512
constexpr int kTile1 = 64;                // K1: points per block
constexpr int kTile2 = 16;                // K2: points per tile
constexpr int kOB = 16;                   // K2: output units x input columns per batch of loads
constexpr int kMaxSmem = 232448;          // bytes a block may use on sm_90

struct MLPDesc {
  int n_layers, n_feat;
  int d_in, d_view, view_dep;
  int n_params;
  int max_w1;                   // widest stored feature input
  int x_total;                  // K2: floats of stored feature inputs per tile
  int skip[kMaxLayers];
  int in_dim[kMaxLayers], out_dim[kMaxLayers];
  int w1[kMaxLayers];           // width of input segment 1 (features; pts_enc for layer 0)
  int w_off[kMaxLayers], b_off[kMaxLayers];  // offsets in the flat parameter gradient
  int x_off[kMaxLayers];        // K2: shared-memory offset of layer li's stored input
  const float* W[kMaxLayers];   // K1, K2: (out, in); K3: (in, 32 * ceil(out / 32)); row-major
  const float* b[kMaxLayers];
};

// Host-side description of the chain. dims = [n_feat, n_rgb, d_in, d_view,
// view_dep, (out, in, skip) per layer]; params = [W0, b0, W1, b1, ...].
int build_desc(const int* dims, const void* const* params, MLPDesc* d) {
  d->n_feat = dims[0];
  const int n_rgb = dims[1];
  d->n_layers = d->n_feat + n_rgb;
  if (d->n_feat < 1 || n_rgb < 1 || d->n_layers > kMaxLayers) return -1;
  d->d_in = dims[2];
  d->d_view = dims[3];
  d->view_dep = dims[4];
  int off = 0, max_w1 = 0, x_total = 0;
  for (int li = 0; li < d->n_layers; ++li) {
    const int out = dims[5 + 3 * li], in = dims[6 + 3 * li], skip = dims[7 + 3 * li];
    const int w2 = skip ? d->d_in : ((li == d->n_feat && d->view_dep) ? d->d_view : 0);
    const int w1 = in - w2;
    if (out < 1 || out > 32 * kMaxJ || in > kThreads * kMaxC || w1 < 1) return -2;
    if (li == 0 && (skip || w1 != d->d_in)) return -3;
    if (li > 0) {
      const int prev = d->out_dim[li - 1] - (li - 1 == d->n_feat - 1 ? 1 : 0);
      if (prev != w1) return -3;
      d->x_off[li] = x_total;
      x_total += kTile2 * w1;
      if (w1 > max_w1) max_w1 = w1;
    }
    d->skip[li] = skip;
    d->in_dim[li] = in;
    d->out_dim[li] = out;
    d->w1[li] = w1;
    d->w_off[li] = off;
    off += out * in;
    d->b_off[li] = off;
    off += out;
    d->W[li] = static_cast<const float*>(params[2 * li]);
    d->b[li] = static_cast<const float*>(params[2 * li + 1]);
  }
  if (d->out_dim[d->n_layers - 1] != 3) return -3;
  d->n_params = off;
  d->max_w1 = max_w1;
  d->x_total = x_total;
  return 0;
}

// weight staging: two buffers of kKC columns, one filling while the other is read
constexpr int kStageFloats = 2 * kKC * kLDS;

int k1_smem_bytes(const MLPDesc& d) {
  return 4 * (kTile1 * (d.d_in + d.d_view + 2 * d.max_w1) + kStageFloats);
}

int k2_work_floats() {
  const int gz = 2 * 32 * kMaxJ * kTile2;
  return kStageFloats > gz ? kStageFloats : gz;
}

int k2_smem_bytes(const MLPDesc& d) {
  return 4 * (kTile2 * (2 * d.d_in + d.d_view + 1) + d.x_total + k2_work_floats());
}

__device__ __forceinline__ const float* second_segment(const MLPDesc& d, int li,
                                                       const float* s_pts,
                                                       const float* s_view) {
  if (d.skip[li]) return s_pts;
  if (li == d.n_feat && d.view_dep) return s_view;
  return nullptr;
}

// 4-byte asynchronous copy from global to shared memory (sm_80+), so a
// weight chunk can be in flight while the previous one is multiplied.
__device__ __forceinline__ void cp_async_f32(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

// 16-byte asynchronous copy; both addresses 16-byte aligned (K3's staging).
__device__ __forceinline__ void cp_async_16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Starts copying columns [col0, col0 + kc) of W (out, in) into Ws,
// transposed: Ws[kk * kLDS + o] = W[o, col0 + kk]. A warp reads 32
// consecutive floats of one row.
__device__ __forceinline__ void stage_chunk(const float* __restrict__ W, int out, int in,
                                            int col0, int kc, float* Ws) {
  const int kk = threadIdx.x & 31;
  if (kk < kc)
    for (int o = threadIdx.x >> 5; o < out; o += kThreads / 32)
      cp_async_f32(Ws + kk * kLDS + o, W + (size_t)o * in + col0 + kk);
  cp_async_commit();
}

// Starts copying rows [row0, row0 + kc) of a packed W (in, ldw) into Ws, as
// they are: Ws[kk * ldw + o] = W[row0 + kk, o]. The rows are one contiguous
// block of kc * ldw floats (ldw a multiple of 32), copied 16 bytes a thread.
__device__ __forceinline__ void stage_chunk_packed(const float* __restrict__ W, int ldw,
                                                   int row0, int kc, float* Ws) {
  const float* src = W + (size_t)row0 * ldw;
  for (int i = threadIdx.x; i < kc * ldw / 4; i += kThreads) cp_async_16(Ws + 4 * i, src + 4 * i);
  cp_async_commit();
}

// One layer forward over a tile of 8 * PPT points held in shared memory.
// Thread (tx, ty) owns points ty*PPT .. ty*PPT+PPT-1 and output units
// tx + 32 j, j < J. The input columns come in chunks of kKC: chunk ch + 1
// of W is copied into one half of Ws while chunk ch is read from the other.
// Epilogue modes: 0 = ReLU into Y; 1 = last trunk layer (unit 0 is raw
// density, to out_g[:, 0] when out_g is given; ReLU of units 1.. into Y);
// 2 = last RGB layer (raw rgb to out_g[:, 1:4]).
// kPacked: W is packed (in, 32 J) and staged as it is (K3); otherwise W is
// (out, in) and staged transposed (K1, K2). A staged chunk's row stride is
// ldw either way.
template <int PPT, int J, bool kPacked>
__device__ __forceinline__ void forward_layer_j(const MLPDesc& d, int li, const float* X1,
                                                const float* X2, float* Ws, float* Y,
                                                float* out_g, int p0, int T) {
  const int tid = threadIdx.x, tx = tid & 31, ty = tid >> 5;
  const int out = d.out_dim[li], in = d.in_dim[li], w1 = d.w1[li], w2 = in - w1;
  const float* __restrict__ W = d.W[li];
  const float* __restrict__ B = d.b[li];
  const int mode = (li == d.n_layers - 1) ? 2 : (li == d.n_feat - 1 ? 1 : 0);
  const int ldy = (mode == 2) ? 0 : d.w1[li + 1];
  constexpr int ldw = kPacked ? 32 * J : kLDS;

  float acc[PPT][J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int o = tx + 32 * j;
    const float bv = (o < out) ? B[o] : 0.f;
#pragma unroll
    for (int i = 0; i < PPT; ++i) acc[i][j] = bv;
  }
  // chunk ch: columns [k0, k0 + kc) of segment 1 (ch < n1) or segment 2
  const int n1 = (w1 + kKC - 1) / kKC, n_chunks = n1 + (w2 + kKC - 1) / kKC;
  auto k0_of = [&](int ch) { return (ch < n1 ? ch : ch - n1) * kKC; };
  auto kc_of = [&](int ch) { return min(kKC, (ch < n1 ? w1 : w2) - k0_of(ch)); };
  auto col0_of = [&](int ch) { return (ch < n1 ? 0 : w1) + k0_of(ch); };
  // column col0 of W (out, in) is row col0 of the packed W (in, out_pad)
  auto stage = [&](int ch, float* dst) {
    if constexpr (kPacked)
      stage_chunk_packed(W, ldw, col0_of(ch), kc_of(ch), dst);
    else
      stage_chunk(W, out, in, col0_of(ch), kc_of(ch), dst);
  };

  __syncthreads();  // both halves of Ws free, previous epilogue visible
  stage(0, Ws);
  for (int ch = 0; ch < n_chunks; ++ch) {
    cp_async_wait_all();
    __syncthreads();  // chunk ch visible; every thread is done reading chunk ch - 1
    if (ch + 1 < n_chunks) stage(ch + 1, Ws + ((ch + 1) & 1) * kKC * kLDS);
    const float* X = ch < n1 ? X1 : X2;
    const int w = ch < n1 ? w1 : w2, k0 = k0_of(ch), kc = kc_of(ch);
    const float* Wc = Ws + (ch & 1) * kKC * kLDS;
    for (int kk = 0; kk < kc; ++kk) {
      float xv[PPT];
#pragma unroll
      for (int i = 0; i < PPT; ++i) xv[i] = X[(ty * PPT + i) * w + k0 + kk];
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const float wv = Wc[kk * ldw + tx + 32 * j];
#pragma unroll
        for (int i = 0; i < PPT; ++i) acc[i][j] = fmaf(xv[i], wv, acc[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const int p = ty * PPT + i;
    const bool valid = (p0 + p) < T;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int o = tx + 32 * j;
      if (o >= out) continue;
      const float z = acc[i][j];
      if (mode == 0) {
        Y[p * ldy + o] = fmaxf(z, 0.f);
      } else if (mode == 1) {
        if (o == 0) {
          if (out_g != nullptr && valid) out_g[(size_t)(p0 + p) * 4] = z;
        } else {
          Y[p * ldy + o - 1] = fmaxf(z, 0.f);
        }
      } else if (valid) {
        out_g[(size_t)(p0 + p) * 4 + 1 + o] = z;
      }
    }
  }
}

template <int PPT, bool kPacked>
__device__ __forceinline__ void forward_layer(const MLPDesc& d, int li, const float* X1,
                                              const float* X2, float* Ws, float* Y,
                                              float* out_g, int p0, int T) {
  switch ((d.out_dim[li] + 31) / 32) {
    case 1: forward_layer_j<PPT, 1, kPacked>(d, li, X1, X2, Ws, Y, out_g, p0, T); break;
    case 2: forward_layer_j<PPT, 2, kPacked>(d, li, X1, X2, Ws, Y, out_g, p0, T); break;
    case 3: forward_layer_j<PPT, 3, kPacked>(d, li, X1, X2, Ws, Y, out_g, p0, T); break;
    case 4: forward_layer_j<PPT, 4, kPacked>(d, li, X1, X2, Ws, Y, out_g, p0, T); break;
    case 5: forward_layer_j<PPT, 5, kPacked>(d, li, X1, X2, Ws, Y, out_g, p0, T); break;
    case 6: forward_layer_j<PPT, 6, kPacked>(d, li, X1, X2, Ws, Y, out_g, p0, T); break;
    case 7: forward_layer_j<PPT, 7, kPacked>(d, li, X1, X2, Ws, Y, out_g, p0, T); break;
    case 8: forward_layer_j<PPT, 8, kPacked>(d, li, X1, X2, Ws, Y, out_g, p0, T); break;
    default: forward_layer_j<PPT, 9, kPacked>(d, li, X1, X2, Ws, Y, out_g, p0, T); break;
  }
}

// Loads rows [p0, p0 + n) of a (T, width) array into shared memory, zeros past T.
__device__ __forceinline__ void load_rows(float* dst, const float* __restrict__ src,
                                          int width, int n, int p0, int T) {
  for (int idx = threadIdx.x; idx < n * width; idx += kThreads) {
    const int p = idx / width;
    dst[idx] = (p0 + p < T) ? src[(size_t)p0 * width + idx] : 0.f;
  }
}

// The whole chain over one kTile1-point tile: K1 (kPacked false) and K3.
template <bool kPacked>
__device__ __forceinline__ void forward_tile(const MLPDesc& d, const float* __restrict__ pts,
                                             const float* __restrict__ view,
                                             float* __restrict__ out, int T) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* s_pts = smem;
  float* s_view = s_pts + kTile1 * d.d_in;
  float* s_buf[2] = {s_view + kTile1 * d.d_view, s_view + kTile1 * (d.d_view + d.max_w1)};
  float* s_w = s_buf[1] + kTile1 * d.max_w1;
  const int p0 = blockIdx.x * kTile1;

  load_rows(s_pts, pts, d.d_in, kTile1, p0, T);
  if (d.d_view > 0) load_rows(s_view, view, d.d_view, kTile1, p0, T);
  for (int li = 0; li < d.n_layers; ++li) {
    const float* x1 = (li == 0) ? s_pts : s_buf[(li - 1) & 1];
    forward_layer<kTile1 / 8, kPacked>(d, li, x1, second_segment(d, li, s_pts, s_view), s_w,
                                       s_buf[li & 1], out, p0, T);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
k1_forward(MLPDesc d, const float* __restrict__ pts, const float* __restrict__ view,
           float* __restrict__ out, int T) {
  forward_tile<false>(d, pts, view, out, T);
}

__global__ void __launch_bounds__(kThreads, 1)
k3_forward(MLPDesc d, const float* __restrict__ pts, const float* __restrict__ view,
           float* __restrict__ out, int T) {
  forward_tile<true>(d, pts, view, out, T);
}

// One layer backward over a 16-point tile. gz holds this layer's output
// gradient transposed, gz[o * kTile2 + p]. Thread t owns input columns
// k = t + 256 c, c < C (C = 1 for layers of at most 256 inputs, else 2): it
// keeps x[:, k] in registers, forms g_x[:, k] and dW[:, k] in one pass over
// the output units, and routes g_x to the previous layer's g_z (masked by
// this layer's input > 0, the ReLU of the previous layer), to d_pts (layer 0
// and skip segments) or to d_view.
template <int C>
__device__ __forceinline__ void backward_layer_c(const MLPDesc& d, int li, const float* X1,
                                                 const float* X2, const float* gz,
                                                 float* gz_next, float* s_dpts,
                                                 const float* s_gd,
                                                 float* __restrict__ d_view_g,
                                                 float* __restrict__ part, bool first,
                                                 int p0, int T) {
  // OB output units per pass: their weights and dW partials are loaded
  // before any is used, so 2 * OB * C = 32 global loads are in flight per
  // thread (the block's dW slice does not fit in L2; one load at a time
  // left the loop bound by memory latency)
  constexpr int OB = kOB / C;
  const int tid = threadIdx.x;
  const int out = d.out_dim[li], in = d.in_dim[li], w1 = d.w1[li], w2 = in - w1;
  const float* __restrict__ W = d.W[li];
  float* __restrict__ dW = part + d.w_off[li];
  float* __restrict__ dB = part + d.b_off[li];

  float xr[C][kTile2], gx[C][kTile2];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int k = tid + kThreads * c;
#pragma unroll
    for (int p = 0; p < kTile2; ++p) {
      xr[c][p] = (k < w1) ? X1[p * w1 + k] : ((k < in) ? X2[p * w2 + (k - w1)] : 0.f);
      gx[c][p] = 0.f;
    }
  }
  for (int o0 = 0; o0 < out; o0 += OB) {
    float wv[C][OB], acc[C][OB];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int k = tid + kThreads * c;
#pragma unroll
      for (int j = 0; j < OB; ++j) {
        const bool ok = k < in && o0 + j < out;
        const size_t idx = (size_t)(o0 + j) * in + k;
        wv[c][j] = ok ? W[idx] : 0.f;
        acc[c][j] = (ok && !first) ? dW[idx] : 0.f;
      }
    }
#pragma unroll
    for (int j = 0; j < OB; ++j) {
      if (o0 + j >= out) break;
      float g[kTile2];
      const float4* g4 = reinterpret_cast<const float4*>(gz + (o0 + j) * kTile2);
#pragma unroll
      for (int q = 0; q < kTile2 / 4; ++q) {
        const float4 v = g4[q];
        g[4 * q] = v.x;
        g[4 * q + 1] = v.y;
        g[4 * q + 2] = v.z;
        g[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int c = 0; c < C; ++c) {
        float dw = 0.f;
#pragma unroll
        for (int p = 0; p < kTile2; ++p) {
          dw = fmaf(g[p], xr[c][p], dw);
          gx[c][p] = fmaf(g[p], wv[c][j], gx[c][p]);
        }
        acc[c][j] += dw;
      }
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int k = tid + kThreads * c;
#pragma unroll
      for (int j = 0; j < OB; ++j)
        if (k < in && o0 + j < out) dW[(size_t)(o0 + j) * in + k] = acc[c][j];
    }
  }
  for (int o = tid; o < out; o += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int p = 0; p < kTile2; ++p) s += gz[o * kTile2 + p];
    dB[o] = first ? s : dB[o] + s;
  }

  const int shift = (li == d.n_feat) ? 1 : 0;  // g_z of the last trunk layer starts with g_density
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int k = tid + kThreads * c;
    if (k >= in) continue;
    if (k < w1) {
      if (li == 0) {
#pragma unroll
        for (int p = 0; p < kTile2; ++p) s_dpts[p * d.d_in + k] += gx[c][p];
      } else {
#pragma unroll
        for (int p = 0; p < kTile2; ++p)
          gz_next[(k + shift) * kTile2 + p] = xr[c][p] > 0.f ? gx[c][p] : 0.f;
      }
    } else if (d.skip[li]) {
#pragma unroll
      for (int p = 0; p < kTile2; ++p) s_dpts[p * d.d_in + (k - w1)] += gx[c][p];
    } else {
#pragma unroll
      for (int p = 0; p < kTile2; ++p)
        if (p0 + p < T) d_view_g[(size_t)(p0 + p) * d.d_view + (k - w1)] = gx[c][p];
    }
  }
  if (shift)
    for (int p = tid; p < kTile2; p += kThreads) gz_next[p] = s_gd[p];
}

__device__ __forceinline__ void backward_layer(const MLPDesc& d, int li, const float* X1,
                                               const float* X2, const float* gz,
                                               float* gz_next, float* s_dpts,
                                               const float* s_gd,
                                               float* __restrict__ d_view_g,
                                               float* __restrict__ part, bool first,
                                               int p0, int T) {
  if (d.in_dim[li] <= kThreads)
    backward_layer_c<1>(d, li, X1, X2, gz, gz_next, s_dpts, s_gd, d_view_g, part, first, p0, T);
  else
    backward_layer_c<2>(d, li, X1, X2, gz, gz_next, s_dpts, s_gd, d_view_g, part, first, p0, T);
}

__global__ void __launch_bounds__(kThreads, 1)
k2_backward(MLPDesc d, const float* __restrict__ pts, const float* __restrict__ view,
            const float* __restrict__ gout, float* __restrict__ d_pts,
            float* __restrict__ d_view_g, float* __restrict__ partial, int T, int n_tiles) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* s_pts = smem;
  float* s_view = s_pts + kTile2 * d.d_in;
  float* s_dpts = s_view + kTile2 * d.d_view;
  float* s_gd = s_dpts + kTile2 * d.d_in;
  float* s_x = s_gd + kTile2;
  float* s_work = s_x + d.x_total;
  float* part = partial + (size_t)blockIdx.x * d.n_params;
  const int tid = threadIdx.x;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const bool first = (tile == (int)blockIdx.x);
    const int p0 = tile * kTile2;
    __syncthreads();  // the previous tile is done with shared memory
    load_rows(s_pts, pts, d.d_in, kTile2, p0, T);
    if (d.d_view > 0) load_rows(s_view, view, d.d_view, kTile2, p0, T);
    for (int idx = tid; idx < kTile2 * d.d_in; idx += kThreads) s_dpts[idx] = 0.f;

    // recompute the forward, keeping every layer's input (the last layer's
    // output is not needed)
    for (int li = 0; li < d.n_layers - 1; ++li) {
      const float* x1 = (li == 0) ? s_pts : s_x + d.x_off[li];
      forward_layer<kTile2 / 8, false>(d, li, x1, second_segment(d, li, s_pts, s_view), s_work,
                                       s_x + d.x_off[li + 1], nullptr, p0, T);
    }
    __syncthreads();

    float* gz = s_work;
    float* gz_next = s_work + 32 * kMaxJ * kTile2;
    for (int idx = tid; idx < 3 * kTile2; idx += kThreads) {
      const int o = idx / kTile2, p = idx - o * kTile2;
      gz[idx] = (p0 + p < T) ? gout[(size_t)(p0 + p) * 4 + 1 + o] : 0.f;
    }
    for (int p = tid; p < kTile2; p += kThreads)
      s_gd[p] = (p0 + p < T) ? gout[(size_t)(p0 + p) * 4] : 0.f;
    __syncthreads();

    for (int li = d.n_layers - 1; li >= 0; --li) {
      const float* x1 = (li == 0) ? s_pts : s_x + d.x_off[li];
      backward_layer(d, li, x1, second_segment(d, li, s_pts, s_view), gz, gz_next, s_dpts,
                     s_gd, d_view_g, part, first, p0, T);
      __syncthreads();
      float* t = gz;
      gz = gz_next;
      gz_next = t;
    }
    for (int idx = tid; idx < kTile2 * d.d_in; idx += kThreads) {
      const int p = idx / d.d_in;
      if (p0 + p < T) d_pts[(size_t)p0 * d.d_in + idx] = s_dpts[idx];
    }
  }
}

// Sums the per-block partials in block order (deterministic).
__global__ void k2_reduce(const float* __restrict__ partial, float* __restrict__ out,
                          int n_blocks, int n_params) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n_params) return;
  float s = 0.f;
  for (int g = 0; g < n_blocks; ++g) s += partial[(size_t)g * n_params + j];
  out[j] = s;
}

using ForwardKernel = void (*)(MLPDesc, const float*, const float*, float*, int);

int launch_forward(ForwardKernel kernel, const float* pts, const float* view, float* out, int T,
                   const int* dims, const void* const* params, void* stream) {
  MLPDesc d;
  int rc = build_desc(dims, params, &d);
  if (rc < 0) return rc;
  const int smem = k1_smem_bytes(d);
  if (smem > kMaxSmem) return -4;
  if (T <= 0) return 0;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const int blocks = (T + kTile1 - 1) / kTile1;
  kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(d, pts, view, out, T);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Number of fp32 entries of the flat parameter gradient, or a negative code.
int sparf_fused_mlp_n_params(const int* dims) {
  static const void* const null_params[2 * kMaxLayers] = {};
  MLPDesc d;
  const int rc = build_desc(dims, null_params, &d);
  return rc < 0 ? rc : d.n_params;
}

// K1: out (T, 4) = [raw_density | raw_rgb]; params = [W (out, in), b (out), ...].
int sparf_fused_mlp_forward(const float* pts, const float* view, float* out, int T,
                            const int* dims, const void* const* params, void* stream) {
  return launch_forward(k1_forward, pts, view, out, T, dims, params, stream);
}

// K3: as K1, with params = [W (in, 32 * ceil(out / 32)), b (out), ...] packed,
// each W 16-byte aligned; dims name the real (out, in) of each layer.
int sparf_fused_mlp_forward_packed(const float* pts, const float* view, float* out, int T,
                                   const int* dims, const void* const* params, void* stream) {
  return launch_forward(k3_forward, pts, view, out, T, dims, params, stream);
}

// gout (T, 4) = [g_density | g_rgb]; d_params (n_params,) in the order
// W0, b0, W1, b1, ...; partial is scratch of n_blocks * n_params floats.
int sparf_fused_mlp_backward(const float* pts, const float* view, const float* gout,
                             float* d_pts, float* d_view, float* d_params, float* partial,
                             int T, int n_blocks, const int* dims, const void* const* params,
                             void* stream) {
  MLPDesc d;
  int rc = build_desc(dims, params, &d);
  if (rc < 0) return rc;
  const int smem = k2_smem_bytes(d);
  if (smem > kMaxSmem) return -4;
  if (T <= 0 || n_blocks <= 0) return -5;
  const int n_tiles = (T + kTile2 - 1) / kTile2;
  if (n_blocks > n_tiles) return -5;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaFuncSetAttribute(k2_backward, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  k2_backward<<<n_blocks, kThreads, smem, s>>>(d, pts, view, gout, d_pts, d_view, partial, T,
                                               n_tiles);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  k2_reduce<<<(d.n_params + kThreads - 1) / kThreads, kThreads, 0, s>>>(partial, d_params,
                                                                      n_blocks, d.n_params);
  return static_cast<int>(cudaGetLastError());
}

const char* sparf_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

// The WaveNet coupling net (WN) of one flow step, forward and backward, for
// Hopper (sm_90a), exact float32.
//
// Replaces the TPU kernels of feature_level_style_transfer_for_tsc_tpu/ops/wn_fused.py:
//   _wn_fwd_kernel  (wn_fused.py:164)  ->  wn_fwd
//   _wn_bwd_kernel  (wn_fused.py:195)  ->  wn_bwd
// on the batch collapsed into rows: x (R, H) with R = B*T, position
// pos(r) = r % T.  With C the WN width, L the layers and d = 2^i:
//   audio_0 = x @ w_start + b_start
//   z_i     = lo(r)*audio_i[r-d] @ w_in[i,0] + audio_i[r] @ w_in[i,1]
//             + hi(r)*audio_i[r+d] @ w_in[i,2] + x @ w_cond[:, i*2C:(i+1)*2C] + b_z[i]
//   acts_i  = tanh(z_i[:, :C]) * sigmoid(z_i[:, C:])
//   rs_i    = acts_i @ w_rs[i] + b_rs[i]        (the last layer zero-embedded)
//   audio_{i+1} = audio_i + rs_i[:, :C];  skip += rs_i[:, C:]
//   y       = skip @ w_end + b_end
// with lo(r) = pos >= d and hi(r) = pos < T - d (a tap that would read across
// a series boundary reads zero), b_z = b_in + b_cond.  The forward keeps
// aud[i] = audio_i (L, R, C) and skip for the backward, which recomputes z
// from them and returns the input gradient and every weight gradient but
// those of the end projection, taken outside as in the JAX package.
//
// Bound on an H100 SXM.  At the training shapes (R = 46,080 or 23,040, H = 25,
// C = 120, L = 8; H is half the target extractor's output width, 25 to 168 over
// the vendored datasets) one forward does about 1.96 MFLOP per row on about 4.6 KB
// per row of audio/skip written, so both directions are bound by operations,
// not by memory: the FP32 pipes' 67 TFLOP/s (exact f32, no tensor cores).
//
// Design, simple and exact first (tensor cores, wgmma and TMA are later work):
// * The halo does not fit one block: layer i reads audio at r +- 2^i (up to
//   +-128 rows, and +-255 over the 8 layers), and a whole series' audio
//   (1152 x 120 floats) is larger than shared memory.  So each layer is one
//   launch over tiles of 64 rows, and the launch boundary is the grid-wide
//   barrier between layers.  The start projection is its own launch; the end
//   projection is folded into the last layer.
// * In a layer, each of the 256 threads owns 4 rows x 8 column pairs (j and
//   j + C), so the tanh and sigmoid halves of the gate meet in one thread's
//   registers.  Every product is a block-level FMA GEMM whose reduction axis
//   is staged 16 at a time through shared memory: the three masked taps and
//   the cond slice form one 3C+H deep reduction (w_in[i] is 345 KB and is
//   streamed, never resident); acts stay in shared memory for the res/skip
//   product.
// * H is any width: every product over H (the start projection, the cond slice
//   of the z reduction, the weight gradients) is a reduction staged KC deep, and
//   every product with H or 2H output columns (the end projection, g_x, the
//   start's input gradient) walks them in chunks of CMAX columns, in a loop
//   (the end projection) or over blockIdx.y (the others).
// * The backward walks the layers in reverse with two launches each: one
//   recomputes z, forms g_z and keeps acts; the next, after the barrier, takes
//   the transposed taps of g_z at u +- d (and the cond input gradient).
// * Weight gradients reduce over all rows.  Each block writes the partial sum
//   of a 1024-row slice, and a second pass adds the slices in a fixed order:
//   no float atomics, so every run gives the same bits.
// Unlike the TPU kernel there is no pad of T to a multiple of 8 (a TPU
// sublane rule) and no roll: each block reads the rows it needs.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int TR = 64;        // rows per block
constexpr int RM = 4;         // rows per thread
constexpr int NTX = 16;       // threads along the columns
constexpr int NTHREADS = 256; // (TR / RM) * NTX
constexpr int KC = 16;        // reduction depth staged per pass
constexpr int AS_STRIDE = KC + 1;
constexpr int WMAX = 256;     // staged weight columns
constexpr int CMAX = 128;     // widest C; also the output columns of one block
constexpr int SK_STRIDE = CMAX + 1;
constexpr int CP = CMAX / NTX;  // column pairs per thread

constexpr size_t GEMM_SMEM = (TR * AS_STRIDE + KC * WMAX) * sizeof(float);
constexpr size_t LAYER_SMEM = GEMM_SMEM + TR * SK_STRIDE * sizeof(float);

// Weight-gradient GEMM tiles.
constexpr int KT = 64;
constexpr int NT = 64;
constexpr int RB = 16;

__device__ __forceinline__ float sigmoidf_(float v) { return 1.f / (1.f + expf(-v)); }

// acc[m][q] += sum_k A(m, k) * W(k, col[q]) over the block's TR rows (m is
// the row within the tile), k < kdim; W's columns >= wcols read as zero.
template <int NQ, class AF, class WF>
__device__ __forceinline__ void tile_gemm(float (&acc)[RM][NQ], const int (&col)[NQ],
                                          int kdim, int wcols, const AF& a_at,
                                          const WF& w_at, float* smem) {
  float* as = smem;
  float* ws = smem + TR * AS_STRIDE;
  const int tid = threadIdx.x;
  const int ty = tid / NTX;
  for (int k0 = 0; k0 < kdim; k0 += KC) {
    __syncthreads();  // the previous pass is done reading as and ws
    for (int i = tid; i < TR * KC; i += NTHREADS) {
      const int m = i / KC;
      const int kk = i - m * KC;
      as[m * AS_STRIDE + kk] = (k0 + kk < kdim) ? a_at(m, k0 + kk) : 0.f;
    }
    for (int i = tid; i < KC * WMAX; i += NTHREADS) {
      const int kk = i / WMAX;
      const int n = i - kk * WMAX;
      ws[i] = (k0 + kk < kdim && n < wcols) ? w_at(k0 + kk, n) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < KC; ++kk) {
      float a[RM];
#pragma unroll
      for (int m = 0; m < RM; ++m) a[m] = as[(ty * RM + m) * AS_STRIDE + kk];
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const float w = ws[kk * WMAX + col[q]];
#pragma unroll
        for (int m = 0; m < RM; ++m) acc[m][q] = fmaf(a[m], w, acc[m][q]);
      }
    }
  }
}

template <int RMX, int NQ>
__device__ __forceinline__ void zero(float (&acc)[RMX][NQ]) {
#pragma unroll
  for (int m = 0; m < RMX; ++m)
#pragma unroll
    for (int q = 0; q < NQ; ++q) acc[m][q] = 0.f;
}

// A of the z product: [lo*aud[r-d] | aud[r] | hi*aud[r+d] | x[r]], 3C+H deep.
struct ZA {
  const float* aud;
  const float* x;
  int r0, rows, t_len, c, h, d;
  __device__ float operator()(int m, int k) const {
    const int r = r0 + m;
    if (r >= rows) return 0.f;
    if (k >= 3 * c) return x[static_cast<size_t>(r) * h + (k - 3 * c)];
    const int tap = k / c;
    const int ch = k - tap * c;
    const int pos = r % t_len;
    int src = r;
    if (tap == 0) {
      if (pos < d) return 0.f;
      src = r - d;
    } else if (tap == 2) {
      if (pos >= t_len - d) return 0.f;
      src = r + d;
    }
    return aud[static_cast<size_t>(src) * c + ch];
  }
};

// W of the z product: [w_in[i] (3C, 2C) ; w_cond[:, coff:coff+2C] (H, 2C)].
struct ZW {
  const float* w_in_i;
  const float* w_cond;
  int c, ldc, coff;
  __device__ float operator()(int k, int n) const {
    if (k < 3 * c) return w_in_i[static_cast<size_t>(k) * 2 * c + n];
    return w_cond[static_cast<size_t>(k - 3 * c) * ldc + coff + n];
  }
};

// A row-major (rows, lda) matrix; rows past the end read zero.
struct RowA {
  const float* a;
  int r0, rows, lda;
  __device__ float operator()(int m, int k) const {
    const int r = r0 + m;
    return r < rows ? a[static_cast<size_t>(r) * lda + k] : 0.f;
  }
};

// A tile kept in shared memory, (TR, SK_STRIDE).
struct SmemA {
  const float* s;
  __device__ float operator()(int m, int k) const { return s[m * SK_STRIDE + k]; }
};

// A row-major (K, ldw) weight.
struct RowW {
  const float* w;
  int ldw;
  __device__ float operator()(int k, int n) const { return w[static_cast<size_t>(k) * ldw + n]; }
};

// ------------------------------------------------------------- forward ----

// out[r, n] = (accumulate ? out[r, n] : 0) + a[r] @ w[:, n] + bias[n]; each
// block takes CMAX columns from n0 = blockIdx.y * CMAX.
__global__ void __launch_bounds__(NTHREADS)
rowgemm_kernel(const float* __restrict__ a, const float* __restrict__ w,
               const float* __restrict__ bias, float* __restrict__ out, int rows, int k,
               int n, int accumulate) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tx = threadIdx.x % NTX;
  const int ty = threadIdx.x / NTX;
  const int r0 = blockIdx.x * TR;
  const int n0 = blockIdx.y * CMAX;
  const int nc = min(CMAX, n - n0);
  int col[CP];
#pragma unroll
  for (int q = 0; q < CP; ++q) col[q] = tx + NTX * q;
  float acc[RM][CP];
  zero(acc);
  tile_gemm(acc, col, k, nc, RowA{a, r0, rows, k}, RowW{w + n0, n}, smem);
#pragma unroll
  for (int m = 0; m < RM; ++m) {
    const int r = r0 + ty * RM + m;
    if (r >= rows) break;
#pragma unroll
    for (int q = 0; q < CP; ++q) {
      const int j = col[q];
      if (j >= nc) break;
      const size_t o = static_cast<size_t>(r) * n + n0 + j;
      float v = acc[m][q] + (bias ? bias[n0 + j] : 0.f);
      if (accumulate) v += out[o];
      out[o] = v;
    }
  }
}

// One WN layer of the forward over a tile of TR rows.
template <bool LAST>
__global__ void __launch_bounds__(NTHREADS, 2)
wn_layer_fwd_kernel(const float* __restrict__ x, const float* __restrict__ aud_i,
                    const float* __restrict__ w_in_i, const float* __restrict__ w_cond,
                    const float* __restrict__ b_z_i, const float* __restrict__ w_rs_i,
                    const float* __restrict__ b_rs_i, const float* __restrict__ w_end,
                    const float* __restrict__ b_end, float* __restrict__ aud_next,
                    float* __restrict__ skip, float* __restrict__ y, int rows, int t_len,
                    int h, int c, int layer, int n_layers) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* sk = smem + TR * AS_STRIDE + KC * WMAX;  // acts, then the final skip
  const int tx = threadIdx.x % NTX;
  const int ty = threadIdx.x / NTX;
  const int r0 = blockIdx.x * TR;
  const int d = 1 << layer;

  int col[2 * CP];
#pragma unroll
  for (int q = 0; q < CP; ++q) {
    col[q] = tx + NTX * q;
    col[CP + q] = c + tx + NTX * q;
  }
  float acc[RM][2 * CP];
  zero(acc);
  tile_gemm(acc, col, 3 * c + h, 2 * c, ZA{aud_i, x, r0, rows, t_len, c, h, d},
            ZW{w_in_i, w_cond, c, 2 * c * n_layers, 2 * c * layer}, smem);
#pragma unroll
  for (int m = 0; m < RM; ++m) {
#pragma unroll
    for (int q = 0; q < CP; ++q) {
      const int j = col[q];
      if (j < c) {
        const float t = tanhf(acc[m][q] + b_z_i[j]);
        const float s = sigmoidf_(acc[m][CP + q] + b_z_i[c + j]);
        sk[(ty * RM + m) * SK_STRIDE + j] = t * s;
      }
    }
  }
  zero(acc);
  tile_gemm(acc, col, c, 2 * c, SmemA{sk}, RowW{w_rs_i, 2 * c}, smem);
#pragma unroll
  for (int m = 0; m < RM; ++m) {
    const int r = r0 + ty * RM + m;
#pragma unroll
    for (int q = 0; q < CP; ++q) {
      const int j = col[q];
      if (r < rows && j < c) {
        const size_t o = static_cast<size_t>(r) * c + j;
        if (!LAST) aud_next[o] = aud_i[o] + acc[m][q] + b_rs_i[j];
        const float s = acc[m][CP + q] + b_rs_i[c + j] + (layer > 0 ? skip[o] : 0.f);
        skip[o] = s;
        if (LAST) sk[(ty * RM + m) * SK_STRIDE + j] = s;
      }
    }
  }
  if (LAST) {  // y = skip @ w_end + b_end, CMAX of the 2H columns at a time
    int ecol[CP];
#pragma unroll
    for (int q = 0; q < CP; ++q) ecol[q] = tx + NTX * q;
    for (int n0 = 0; n0 < 2 * h; n0 += CMAX) {
      const int nc = min(CMAX, 2 * h - n0);
      float e[RM][CP];
      zero(e);
      tile_gemm(e, ecol, c, nc, SmemA{sk}, RowW{w_end + n0, 2 * h}, smem);
#pragma unroll
      for (int m = 0; m < RM; ++m) {
        const int r = r0 + ty * RM + m;
#pragma unroll
        for (int q = 0; q < CP; ++q) {
          const int j = ecol[q];
          if (r < rows && j < nc)
            y[static_cast<size_t>(r) * 2 * h + n0 + j] = e[m][q] + b_end[n0 + j];
        }
      }
    }
  }
}

// ------------------------------------------------------------ backward ----

// g_rs = [g_audio_{i+1} | g_skip]: 2C deep; g_audio after the last layer is 0.
struct GrsA {
  const float* ga_next;
  const float* gskip;
  int r0, rows, c;
  __device__ float operator()(int m, int k) const {
    const int r = r0 + m;
    if (r >= rows) return 0.f;
    if (k < c) return ga_next ? ga_next[static_cast<size_t>(r) * c + k] : 0.f;
    return gskip[static_cast<size_t>(r) * c + k - c];
  }
};

// Layer i, first half: recompute z, then g_acts = g_rs @ w_rs[i]^T, g_z and acts.
__global__ void __launch_bounds__(NTHREADS, 2)
wn_layer_gz_kernel(const float* __restrict__ x, const float* __restrict__ aud_i,
                   const float* __restrict__ w_in_i, const float* __restrict__ w_cond,
                   const float* __restrict__ b_z_i, const float* __restrict__ w_rs_t_i,
                   const float* __restrict__ ga_next, const float* __restrict__ gskip,
                   float* __restrict__ gz, float* __restrict__ acts, int rows, int t_len,
                   int h, int c, int layer, int n_layers) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tx = threadIdx.x % NTX;
  const int ty = threadIdx.x / NTX;
  const int r0 = blockIdx.x * TR;
  const int d = 1 << layer;

  int col[2 * CP];
#pragma unroll
  for (int q = 0; q < CP; ++q) {
    col[q] = tx + NTX * q;
    col[CP + q] = c + tx + NTX * q;
  }
  float zt[RM][2 * CP];  // z, then (tanh, sigmoid) of its halves
  zero(zt);
  tile_gemm(zt, col, 3 * c + h, 2 * c, ZA{aud_i, x, r0, rows, t_len, c, h, d},
            ZW{w_in_i, w_cond, c, 2 * c * n_layers, 2 * c * layer}, smem);
#pragma unroll
  for (int m = 0; m < RM; ++m) {
#pragma unroll
    for (int q = 0; q < CP; ++q) {
      const int j = col[q] < c ? col[q] : 0;
      zt[m][q] = tanhf(zt[m][q] + b_z_i[j]);
      zt[m][CP + q] = sigmoidf_(zt[m][CP + q] + b_z_i[c + j]);
    }
  }
  int acol[CP];
#pragma unroll
  for (int q = 0; q < CP; ++q) acol[q] = tx + NTX * q;
  float ga[RM][CP];
  zero(ga);
  tile_gemm(ga, acol, 2 * c, c, GrsA{ga_next, gskip, r0, rows, c}, RowW{w_rs_t_i, c}, smem);
#pragma unroll
  for (int m = 0; m < RM; ++m) {
    const int r = r0 + ty * RM + m;
#pragma unroll
    for (int q = 0; q < CP; ++q) {
      const int j = acol[q];
      if (r < rows && j < c) {
        const float t = zt[m][q];
        const float s = zt[m][CP + q];
        const float g = ga[m][q];
        gz[static_cast<size_t>(r) * 2 * c + j] = g * s * (1.f - t * t);
        gz[static_cast<size_t>(r) * 2 * c + c + j] = g * t * s * (1.f - s);
        acts[static_cast<size_t>(r) * c + j] = t * s;
      }
    }
  }
}

// A of the transposed taps: [mask*gz[u+d] | gz[u] | mask*gz[u-d]], 6C deep.
struct GaA {
  const float* gz;
  int r0, rows, t_len, c, d;
  __device__ float operator()(int m, int k) const {
    const int u = r0 + m;
    if (u >= rows) return 0.f;
    const int tap = k / (2 * c);
    const int kk = k - tap * 2 * c;
    int src = u;
    if (tap == 0) {  // g_z[u+d] fed tap -d: valid iff pos(u+d) >= d
      src = u + d;
      if (src >= rows || src % t_len < d) return 0.f;
    } else if (tap == 2) {  // g_z[u-d] fed tap +d: valid iff pos(u-d) < T-d
      src = u - d;
      if (src < 0 || src % t_len >= t_len - d) return 0.f;
    }
    return gz[static_cast<size_t>(src) * 2 * c + kk];
  }
};

// Layer i, second half.  blockIdx.y == 0: g_audio_i = g_audio_{i+1} +
// taps^T(g_z), the 6C-deep product with w_in[i]^T as (3*2C, C) rows;
// blockIdx.y = 1 + j: g_x[:, jCMAX:(j+1)CMAX] += g_z @ w_cond_i^T, 2C deep.
__global__ void __launch_bounds__(NTHREADS, 2)
wn_layer_ga_kernel(const float* __restrict__ gz, const float* __restrict__ w_in_t_i,
                   const float* __restrict__ w_cond_t_i, const float* __restrict__ ga_next,
                   float* __restrict__ ga_out, float* __restrict__ gx, int rows, int t_len,
                   int h, int c, int layer, int first) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tx = threadIdx.x % NTX;
  const int ty = threadIdx.x / NTX;
  const int r0 = blockIdx.x * TR;
  int col[CP];
#pragma unroll
  for (int q = 0; q < CP; ++q) col[q] = tx + NTX * q;
  float acc[RM][CP];
  zero(acc);
  if (blockIdx.y == 0) {
    tile_gemm(acc, col, 6 * c, c, GaA{gz, r0, rows, t_len, c, 1 << layer}, RowW{w_in_t_i, c},
              smem);
#pragma unroll
    for (int m = 0; m < RM; ++m) {
      const int u = r0 + ty * RM + m;
      if (u >= rows) break;
#pragma unroll
      for (int q = 0; q < CP; ++q) {
        const int n = col[q];
        if (n >= c) break;
        const size_t o = static_cast<size_t>(u) * c + n;
        ga_out[o] = (ga_next ? ga_next[o] : 0.f) + acc[m][q];
      }
    }
    return;
  }
  const int n0 = (blockIdx.y - 1) * CMAX;
  const int nc = min(CMAX, h - n0);
  tile_gemm(acc, col, 2 * c, nc, RowA{gz, r0, rows, 2 * c}, RowW{w_cond_t_i + n0, h}, smem);
#pragma unroll
  for (int m = 0; m < RM; ++m) {
    const int u = r0 + ty * RM + m;
    if (u >= rows) break;
#pragma unroll
    for (int q = 0; q < CP; ++q) {
      const int n = col[q];
      if (n >= nc) break;
      const size_t o = static_cast<size_t>(u) * h + n0 + n;
      gx[o] = (first ? 0.f : gx[o]) + acc[m][q];
    }
  }
}

// Weight gradients: P[s][k][n] = sum over the rows of slice s of A(r, k) B(r, n).
enum WGradMode { kLayerIn = 0, kLayerRs = 1, kStart = 2 };

struct WGradArgs {
  int mode;
  const float* aud_i;
  const float* x;
  const float* gz;
  const float* acts;
  const float* ga_next;
  const float* gskip;
  const float* ga0;
  int rows, t_len, h, c, d, kdim, ndim, split_rows;
};

__device__ __forceinline__ float wgrad_a(const WGradArgs& p, int r, int k) {
  if (p.mode == kLayerIn) {  // [lo*aud[r-d] | aud[r] | hi*aud[r+d] | x[r] | 1]
    if (k < 3 * p.c) return ZA{p.aud_i, p.x, 0, p.rows, p.t_len, p.c, p.h, p.d}(r, k);
    if (k < 3 * p.c + p.h) return p.x[static_cast<size_t>(r) * p.h + k - 3 * p.c];
    return 1.f;
  }
  if (p.mode == kLayerRs)  // [acts | 1]
    return k < p.c ? p.acts[static_cast<size_t>(r) * p.c + k] : 1.f;
  return k < p.h ? p.x[static_cast<size_t>(r) * p.h + k] : 1.f;  // [x | 1]
}

__device__ __forceinline__ float wgrad_b(const WGradArgs& p, int r, int n) {
  if (p.mode == kLayerIn) return p.gz[static_cast<size_t>(r) * 2 * p.c + n];
  if (p.mode == kLayerRs) return GrsA{p.ga_next, p.gskip, 0, p.rows, p.c}(r, n);
  return p.ga0[static_cast<size_t>(r) * p.c + n];
}

__global__ void __launch_bounds__(NTHREADS)
wgrad_partial_kernel(WGradArgs p, float* __restrict__ partial) {
  __shared__ float as[RB][KT];
  __shared__ float bs[RB][NT];
  const int tid = threadIdx.x;
  const int tk = tid / NTX;  // 16 x 4 rows of k
  const int tn = tid % NTX;  // 16 x 4 columns of n, strided
  const int k0 = blockIdx.x * KT;
  const int n0 = blockIdx.y * NT;
  const int rs = blockIdx.z * p.split_rows;
  const int re = min(rs + p.split_rows, p.rows);
  float acc[4][4];
  zero(acc);
  for (int rb = rs; rb < re; rb += RB) {
    __syncthreads();
    for (int i = tid; i < RB * KT; i += NTHREADS) {
      const int rr = i / KT;
      const int kk = i - rr * KT;
      const int r = rb + rr;
      as[rr][kk] = (r < re && k0 + kk < p.kdim) ? wgrad_a(p, r, k0 + kk) : 0.f;
    }
    for (int i = tid; i < RB * NT; i += NTHREADS) {
      const int rr = i / NT;
      const int nn = i - rr * NT;
      const int r = rb + rr;
      bs[rr][nn] = (r < re && n0 + nn < p.ndim) ? wgrad_b(p, r, n0 + nn) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int rr = 0; rr < RB; ++rr) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = as[rr][tk * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = bs[rr][tn + NTX * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
  float* out = partial + static_cast<size_t>(blockIdx.z) * p.kdim * p.ndim;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + tk * 4 + i;
    if (k >= p.kdim) break;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tn + NTX * j;
      if (n < p.ndim) out[static_cast<size_t>(k) * p.ndim + n] = acc[i][j];
    }
  }
}

// out[e] = sum_s partial[s][e], s in order: the same bits on every run.
__global__ void __launch_bounds__(NTHREADS)
reduce_partials_kernel(const float* __restrict__ partial, int nsplit, int count,
                       float* __restrict__ out) {
  for (int e = blockIdx.x * NTHREADS + threadIdx.x; e < count; e += gridDim.x * NTHREADS) {
    float s = 0.f;
    for (int i = 0; i < nsplit; ++i) s += partial[static_cast<size_t>(i) * count + e];
    out[e] = s;
  }
}

// ------------------------------------------------------------ launches ----

inline int tiles(int rows) { return (rows + TR - 1) / TR; }
inline int col_chunks(int n) { return (n + CMAX - 1) / CMAX; }

template <class K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

cudaError_t rowgemm(const float* a, const float* w, const float* bias, float* out, int rows,
                    int k, int n, int accumulate, cudaStream_t stream) {
  cudaError_t e = allow_smem(rowgemm_kernel, GEMM_SMEM);
  if (e != cudaSuccess) return e;
  rowgemm_kernel<<<dim3(tiles(rows), col_chunks(n)), NTHREADS, GEMM_SMEM, stream>>>(
      a, w, bias, out, rows, k, n, accumulate);
  return cudaGetLastError();
}

cudaError_t wgrad(const WGradArgs& p, float* partial, float* out, cudaStream_t stream) {
  const int nsplit = (p.rows + p.split_rows - 1) / p.split_rows;
  const dim3 grid((p.kdim + KT - 1) / KT, (p.ndim + NT - 1) / NT, nsplit);
  wgrad_partial_kernel<<<grid, NTHREADS, 0, stream>>>(p, partial);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int count = p.kdim * p.ndim;
  const int blocks = (count + NTHREADS - 1) / NTHREADS;
  reduce_partials_kernel<<<blocks, NTHREADS, 0, stream>>>(partial, nsplit, count, out);
  return cudaGetLastError();
}

// The geometry the kernels take; wn_fused.py check_geometry states the same.
bool bad_geometry(int rows, int t_len, int h, int c, int n_layers) {
  return rows < 1 || t_len < 1 || rows % t_len != 0 || h < 1 || c < 1 || c > CMAX ||
         n_layers < 1 || n_layers > 30;
}

}  // namespace

// Forward of one WN: y (R, 2H), aud (L, R, C), skip (R, C).  b_z = b_in + b_cond
// as (L, 2C).  1 + L kernel launches.
extern "C" int wn_fwd(const float* x, const float* w_start, const float* b_start,
                      const float* w_cond, const float* b_z, const float* w_in,
                      const float* w_rs, const float* b_rs, const float* w_end,
                      const float* b_end, float* y, float* aud, float* skip, int rows,
                      int t_len, int h, int c, int n_layers, void* stream_ptr) {
  if (bad_geometry(rows, t_len, h, c, n_layers)) return cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t e = rowgemm(x, w_start, b_start, aud, rows, h, c, 0, stream);
  if (e != cudaSuccess) return e;
  e = allow_smem(wn_layer_fwd_kernel<false>, LAYER_SMEM);
  if (e != cudaSuccess) return e;
  e = allow_smem(wn_layer_fwd_kernel<true>, LAYER_SMEM);
  if (e != cudaSuccess) return e;
  const size_t rc = static_cast<size_t>(rows) * c;
  for (int i = 0; i < n_layers; ++i) {
    const float* w_in_i = w_in + static_cast<size_t>(i) * 3 * c * 2 * c;
    const float* w_rs_i = w_rs + static_cast<size_t>(i) * c * 2 * c;
    const bool last = i == n_layers - 1;
    auto kernel = last ? wn_layer_fwd_kernel<true> : wn_layer_fwd_kernel<false>;
    kernel<<<tiles(rows), NTHREADS, LAYER_SMEM, stream>>>(
        x, aud + i * rc, w_in_i, w_cond, b_z + static_cast<size_t>(i) * 2 * c, w_rs_i,
        b_rs + static_cast<size_t>(i) * 2 * c, w_end, b_end, last ? nullptr : aud + (i + 1) * rc,
        skip, y, rows, t_len, h, c, i, n_layers);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

// Backward of one WN from g = dL/dy (R, 2H).  Outputs: gx (R, H);
// g_in (L, 3C+H+1, 2C) = per layer [gwi (3C rows) | gwc slice (H rows) | gbi];
// g_rs (L, C+1, 2C) = per layer [gwr | gbr]; g_start (H+1, C) = [gws | gbs].
// Transposed weights: w_in_t (L, 3, 2C, C), w_rs_t (L, 2C, C), w_cond_t
// (L, 2C, H), w_start_t (C, H), w_end_t (2H, C).  Scratch: ga (2, R, C),
// gskip (R, C), gz (R, 2C), acts (R, C), partial (ceil(R/split_rows) *
// (3C+H+1) * 2C).  4 + 6L kernel launches.
extern "C" int wn_bwd(const float* x, const float* g, const float* aud, const float* w_cond,
                      const float* w_in, const float* b_z, const float* w_in_t,
                      const float* w_rs_t, const float* w_cond_t, const float* w_start_t,
                      const float* w_end_t, float* gx, float* g_in, float* g_rs,
                      float* g_start, float* ga, float* gskip, float* gz, float* acts,
                      float* partial, int rows, int t_len, int h, int c, int n_layers,
                      int split_rows, void* stream_ptr) {
  if (bad_geometry(rows, t_len, h, c, n_layers) || split_rows < RB || split_rows % RB)
    return cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t e = rowgemm(g, w_end_t, nullptr, gskip, rows, 2 * h, c, 0, stream);
  if (e != cudaSuccess) return e;
  e = allow_smem(wn_layer_gz_kernel, GEMM_SMEM);
  if (e != cudaSuccess) return e;
  e = allow_smem(wn_layer_ga_kernel, GEMM_SMEM);
  if (e != cudaSuccess) return e;
  const size_t rc = static_cast<size_t>(rows) * c;
  const int k_in = 3 * c + h + 1;
  const float* ga_next = nullptr;
  for (int i = n_layers - 1; i >= 0; --i) {
    const float* aud_i = aud + i * rc;
    float* ga_out = ga + (i % 2) * rc;
    wn_layer_gz_kernel<<<tiles(rows), NTHREADS, GEMM_SMEM, stream>>>(
        x, aud_i, w_in + static_cast<size_t>(i) * 3 * c * 2 * c, w_cond,
        b_z + static_cast<size_t>(i) * 2 * c, w_rs_t + static_cast<size_t>(i) * 2 * c * c,
        ga_next, gskip, gz, acts, rows, t_len, h, c, i, n_layers);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    WGradArgs p{kLayerRs, aud_i, x, gz, acts, ga_next, gskip, nullptr,
                rows, t_len, h, c, 1 << i, c + 1, 2 * c, split_rows};
    e = wgrad(p, partial, g_rs + static_cast<size_t>(i) * (c + 1) * 2 * c, stream);
    if (e != cudaSuccess) return e;
    p.mode = kLayerIn;
    p.kdim = k_in;
    e = wgrad(p, partial, g_in + static_cast<size_t>(i) * k_in * 2 * c, stream);
    if (e != cudaSuccess) return e;
    wn_layer_ga_kernel<<<dim3(tiles(rows), 1 + col_chunks(h)), NTHREADS, GEMM_SMEM, stream>>>(
        gz, w_in_t + static_cast<size_t>(i) * 3 * 2 * c * c,
        w_cond_t + static_cast<size_t>(i) * 2 * c * h, ga_next, ga_out, gx, rows, t_len, h, c,
        i, i == n_layers - 1);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    ga_next = ga_out;
  }
  WGradArgs p{kStart, nullptr, x, nullptr, nullptr, nullptr, nullptr, ga_next,
              rows, t_len, h, c, 1, h + 1, c, split_rows};
  e = wgrad(p, partial, g_start, stream);
  if (e != cudaSuccess) return e;
  return rowgemm(ga_next, w_start_t, nullptr, gx, rows, c, h, 1, stream);
}

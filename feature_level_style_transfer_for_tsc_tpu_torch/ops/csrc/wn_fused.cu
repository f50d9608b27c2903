// The WaveNet coupling net (WN) of one flow step, forward and backward, for
// Hopper (sm_90a), exact float32, and the same on bf16 operands.
//
// Replaces the TPU kernels of feature_level_style_transfer_for_tsc_tpu/ops/wn_fused.py:
//   _wn_fwd_kernel  (wn_fused.py:164)  ->  wn_fwd_runs (one run: the wrapper wn_fwd)
//   _wn_bwd_kernel  (wn_fused.py:195)  ->  wn_bwd_runs (one run: wn_bwd)
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
// not by memory.  At float32 accuracy the least time is on the tensor cores
// taking each product as three TF32 products (3xTF32: 494.7 TFLOP/s / 3); the
// FP32 pipes' 67 TFLOP/s is the bound of the kernels that use them.
//
// Design, simple and exact first (wgmma and TMA are later work):
// * The halo does not fit one block: layer i reads audio at r +- 2^i (up to
//   +-128 rows, and +-255 over the 8 layers), and a whole series' audio
//   (1152 x 120 floats) is larger than shared memory.  So each layer is one
//   launch over tiles of rows, and the launch boundary is the grid-wide
//   barrier between layers.  The start projection is its own launch; the end
//   projection is folded into the last layer.
// * Forward: one launch a layer (wn_layer_fwd_kernel) over tiles of 64 rows:
//   z over the three masked taps and the cond slice (one 3C+H deep
//   reduction; w_in[i] is 345 KB and is streamed, never resident), the gate,
//   acts through an (R, C) scratch, res/skip, and in the last layer the end
//   projection.  On short series the row tiles shrink to 32 or 16 rows
//   where that still fits one wave.
// * H is any width: every product over H is a reduction staged in chunks, and
//   every product with H or 2H output columns (the end projection, g_x, the
//   start's input gradient) walks them in chunks, in a loop (the end
//   projection) or over blockIdx.y (the others).
// * Backward: the layers in reverse with two launches each: one recomputes
//   z, forms g_z and keeps acts; the next, after the barrier, takes the
//   transposed taps of g_z at u +- d (and the cond input gradient); between
//   them the weight gradients.
// * Every layer product in both directions runs on the tensor cores as
//   3xTF32 mma.sync (mma_tf32.cuh's helpers, as the conv tap GEMM),
//   each stage summed into zeroed registers and added to the running sum with
//   one rounded f32 add (the tensor core's accumulate truncates).  Operands
//   are staged as shifted row ranges with one mask a row (16-byte cp.async,
//   no divide or modulo an element) and each staged element is split once
//   into TF32 hi/lo planes that ldmatrix reads.
//   - Row-tile products (wn_layer_fwd_kernel, wn_layer_gz_kernel,
//     wn_layer_ga_kernel): tiles of 64 rows, 16 warps; the weights are split
//     once a call by wsplit_fwd_kernel / wsplit_kernel into
//     planes laid out (output column, reduction), so a stage copies them as
//     they are.  A warp keeps the gate pair (j, C + j) of its n8 tiles, with C
//     padded to a multiple of 8.  On short series (a row-tile grid under one
//     block an SM) the backward's blockIdx.y deals the column tiles to 2 or
//     4 blocks, and the forward halves its row tile (a tile's res/skip and
//     end projection need all of its acts and skip columns).
//   - Weight gradients (wgrad_kernel): A^T B over a slice of rows, both
//     operands data, so both are split a stage into planes stored transposed.
//     One tensor-core accumulator over 46,080 rows loses f32 accuracy; the
//     stage sums keep it.  Each block writes its slice's partial, about 64
//     slices a reduction so that short series fill the card (wn_fused.py
//     wgrad_split_rows), and a second pass adds them in a fixed order: no
//     float atomics, so every run gives the same bits.
//   - The start projection, its input gradient and g_skip (rowgemm_kernel)
//     stay FP32 FMA: under 1% of the FLOPs.
//   A non-finite input is not carried as f32 would carry it (hi = inf gives
//   lo = NaN): the contract is for finite inputs.
// * Runs (wn_fwd_runs, wn_bwd_runs): R independent WNs of one geometry in
//   one call, as the JAX package's multi-run training gets them from
//   jax.vmap (one more grid axis).  Every tensor holds the runs one after
//   the other; the run rides on a free grid axis of each kernel (y of the
//   forward layer kernel, z of the others, folded with the layer of the
//   weight splits and the slice of the weight gradients) and only offsets
//   pointers: each run's arithmetic, tiles and slices are the one-run
//   call's, and the launches are those of one run.  A one-run call is
//   runs = 1, which takes the kernels' RUNS = false instances (no run
//   offsets, as before the run axis).
// * bf16 operands (wn_fwd_runs / wn_bwd_runs with bf16 != 0: the JAX
//   kernels' bf16=True, set by FLSTTSC_WN_MXU=bf16): each direction is a
//   kernel set of its own, wn_fwd_bf16.cuh and wn_bwd_bf16.cuh: bf16 copies
//   of the operands written once, bf16 weight planes, native bf16
//   mma.m16n8k16 with f32 sums; the backward's bias gradients as f32 tile
//   sums.  The kernels above are f32 only, but for rowgemm's BF16 instance
//   (FP32 FMA on bf16-rounded operands), which both bf16 sets take for their
//   smallest products.
// Unlike the TPU kernel there is no pad of T to a multiple of 8 (a TPU
// sublane rule) and no roll: each block reads the rows it needs.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <initializer_list>

#include "mma_bf16.cuh"
#include "mma_tf32.cuh"

namespace {

using namespace tf32x3;  // split_tf32, mma_tf32, ldmatrix_x4, cp_async*

constexpr int TR = 64;        // rows per block
constexpr int RM = 4;         // rows per thread
constexpr int NTX = 16;       // threads along the columns
constexpr int NTHREADS = 256; // (TR / RM) * NTX
constexpr int KC = 16;        // reduction depth staged per pass
constexpr int AS_STRIDE = KC + 1;
constexpr int WMAX = 256;     // staged weight columns
constexpr int CMAX = 128;     // widest C; also the output columns of one block
constexpr int CP = CMAX / NTX;  // columns per thread

constexpr size_t GEMM_SMEM = (TR * AS_STRIDE + KC * WMAX) * sizeof(float);

__device__ __forceinline__ float sigmoidf_(float v) { return 1.f / (1.f + expf(-v)); }

__host__ __device__ inline int round8(int v) { return (v + 7) / 8 * 8; }

// A product's operand: v itself, or v rounded to bf16 (the BF16 instances).
template <bool BF16>
__device__ __forceinline__ float rounded(float v) {
  return BF16 ? __uint_as_float(round_bf16(v)) : v;
}

// acc[m][q] += sum_k A(m, k) * W(k, col[q]) over the block's TR rows (m is
// the row within the tile), k < kdim; W's columns >= wcols read as zero.
// BF16: both operands rounded to bf16 as they are staged.
template <bool BF16, int NQ, class AF, class WF>
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
      as[m * AS_STRIDE + kk] = (k0 + kk < kdim) ? rounded<BF16>(a_at(m, k0 + kk)) : 0.f;
    }
    for (int i = tid; i < KC * WMAX; i += NTHREADS) {
      const int kk = i / WMAX;
      const int n = i - kk * WMAX;
      ws[i] = (k0 + kk < kdim && n < wcols) ? rounded<BF16>(w_at(k0 + kk, n)) : 0.f;
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

// A row-major (rows, lda) matrix; rows past the end read zero.
struct RowA {
  const float* a;
  int r0, rows, lda;
  __device__ float operator()(int m, int k) const {
    const int r = r0 + m;
    return r < rows ? a[static_cast<size_t>(r) * lda + k] : 0.f;
  }
};

// A row-major (K, ldw) weight.
struct RowW {
  const float* w;
  int ldw;
  __device__ float operator()(int k, int n) const { return w[static_cast<size_t>(k) * ldw + n]; }
};

// ------------------------------------------- FP32 FMA row products ----

// out[r, n] = (accumulate ? out[r, n] : 0) + a[r] @ w[:, n] + bias[n]; each
// block takes CMAX columns from n0 = blockIdx.y * CMAX, of run blockIdx.z
// (each operand offset by its run stride).  The start projection, g_skip
// and the start's input gradient: under 1% of the FLOPs.  BF16: bf16
// operands, f32 sums (the bias and the accumulated out stay f32).  out16,
// where not null (n <= CMAX): out's bf16 copy too, rows padded with zeros to
// round8(n) values, run r's at out16 + r * out16_rs.
template <bool BF16>
__global__ void __launch_bounds__(NTHREADS)
rowgemm_kernel(const float* __restrict__ a, const float* __restrict__ w,
               const float* __restrict__ bias, float* __restrict__ out, int rows, int k,
               int n, int accumulate, long long a_rs, long long w_rs, long long bias_rs,
               long long out_rs, uint16_t* __restrict__ out16, long long out16_rs) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const long long run = blockIdx.z;
  a += run * a_rs;
  w += run * w_rs;
  if (bias) bias += run * bias_rs;
  out += run * out_rs;
  if (out16) out16 += run * out16_rs;
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
  tile_gemm<BF16>(acc, col, k, nc, RowA{a, r0, rows, k}, RowW{w + n0, n}, smem);
#pragma unroll
  for (int m = 0; m < RM; ++m) {
    const int r = r0 + ty * RM + m;
    if (r >= rows) break;
#pragma unroll
    for (int q = 0; q < CP; ++q) {
      const int j = col[q];
      if (j >= nc) {
        if (out16 && n0 + j < round8(n)) out16[static_cast<size_t>(r) * round8(n) + n0 + j] = 0;
        continue;
      }
      const size_t o = static_cast<size_t>(r) * n + n0 + j;
      float v = acc[m][q] + (bias ? bias[n0 + j] : 0.f);
      if (accumulate) v += out[o];
      out[o] = v;
      if (out16)
        out16[static_cast<size_t>(r) * round8(n) + n0 + j] =
            __bfloat16_as_ushort(__float2bfloat16_rn(v));
    }
  }
}

// ------------------------------------------------------------ backward ----

// ---------------------------------------------------- weight gradients ----
//
// P[s][k][n] = sum over the rows r of slice s of A(r, k) B(r, n), on the
// tensor cores (3xTF32), then out = sum_s P[s] in slice order.  A and B are
// rows of up to five segments side by side, each a row range of a row-major
// matrix, shifted by a constant and masked by one test a row:
//   g_in[i]  (gwi | gwc | gbi):  A = [lo*aud[r-d] | aud[r] | hi*aud[r+d] | x[r] | 1],
//                                B = g_z[r]
//   g_rs[i]  (gwr | gbr):        A = [acts[r] | 1],  B = [g_audio_{i+1}[r] | g_skip[r]]
//   g_start  (gws | gbs):        A = [x[r] | 1],     B = g_audio_0[r]

enum SegKind { kRows = 0, kLo = 1, kHi = 2, kOnes = 3, kZero = 4 };

// Columns [base, base + width) of an operand: src[run * rs + (r + shift) * ld
// + j] for run ``run``, zero where the row's mask is off (kLo: pos(r) >= d,
// kHi: pos(r) < T - d); kOnes is a column of ones, kZero a zero block.  vec:
// 16-byte copies are aligned in every run.
struct Seg {
  const float* src;
  int ld, width, shift, kind, vec;
  long long rs;
};
constexpr int MAX_SEGS = 5;
struct Operand {
  Seg seg[MAX_SEGS];
  int nseg, cols;
};
struct WGrad {
  Operand a, b;
  const float* any;  // a valid address for the zero-filling copies
  int rows, t_len, d, split_rows;
};
inline int n_splits(const WGrad& p) { return (p.rows + p.split_rows - 1) / p.split_rows; }

constexpr int WG_KT = 64;         // weight-gradient rows a block (the mma's m)
constexpr int WG_NT = 256;        // weight-gradient columns a block (n)
constexpr int WG_THREADS = 512;   // 16 warps: 2 (rows) x 8 (columns) of 32 x 32
constexpr int WG_RB = 32;         // input rows a stage: 4 mma k-steps
constexpr int WG_AS = WG_KT + 4;  // staged A row stride: float4 reads hit 32 banks
constexpr int WG_BS = WG_NT + 4;
constexpr int WG_PS = WG_RB + 4;  // split plane row stride: ldmatrix's 8 rows hit 32 banks
constexpr size_t WG_SMEM =
    (2 * WG_RB * (WG_AS + WG_BS) + 2 * (WG_KT + WG_NT) * WG_PS) * sizeof(float);

// Row r of run ``run``'s columns [k, k + 4) of an operand into dst (16-byte
// aligned): one 16-byte cp.async where the four lie in one aligned segment,
// else one a column; zero past the slice (row_ok false), past the operand,
// or where the segment's row mask is off.
__device__ __forceinline__ void stage4(const Operand& op, const float* any, int k, int r,
                                       bool row_ok, int pos, int d, int t_len, float* dst,
                                       int run) {
  int base = 0;
#pragma unroll
  for (int s = 0; s < MAX_SEGS; ++s) {
    if (s < op.nseg) {
      const Seg& g = op.seg[s];
      const int lo = max(k, base);
      const int hi = min(k + 4, base + g.width);
      if (lo < hi) {
        const bool ok = row_ok && (g.kind != kLo || pos >= d) && (g.kind != kHi || pos < t_len - d);
        if (g.kind == kOnes || g.kind == kZero) {
          for (int j = lo; j < hi; ++j) dst[j - k] = ok && g.kind == kOnes ? 1.f : 0.f;
        } else {
          const float* row =
              ok ? g.src + run * g.rs + static_cast<long long>(r + g.shift) * g.ld : any;
          if (g.vec && lo == k && hi == k + 4) {
            cp_async16(dst, ok ? row + (k - base) : any, ok);
          } else {
            for (int j = lo; j < hi; ++j) cp_async4(dst + j - k, ok ? row + (j - base) : any, ok);
          }
        }
      }
      base += g.width;
    }
  }
  for (int j = max(k, base); j < k + 4; ++j) dst[j - k] = 0.f;
}

// One block a (64-row, 256-column) tile of P[s] for slice s of run r,
// blockIdx.z = r * n_splits + s;
// 16 warps of 32 x 32 (2 x 4 mma tiles); a 128-column tile of 8 warps, two
// blocks an SM, was 9% slower at the pair shape (PERF.md).  A stage stages WG_RB input rows of
// the tile's A and B columns (double-buffered cp.async), splits each element
// once into TF32 hi/lo planes stored transposed (a plane row is a column of
// the stage, so both mma operands come by ldmatrix), and sums its
// lo*hi + hi*lo + hi*hi products into zeroed registers that are added to the
// running sum with one rounded f32 add.
template <bool RUNS>
__global__ void __launch_bounds__(WG_THREADS, 1)
wgrad_kernel(WGrad p, float* __restrict__ partial) {
  extern __shared__ float4 smem4[];
  float* const raw = reinterpret_cast<float*>(smem4);
  uint32_t* const ah = reinterpret_cast<uint32_t*>(raw + 2 * WG_RB * (WG_AS + WG_BS));
  uint32_t* const al = ah + WG_KT * WG_PS;
  uint32_t* const bh = al + WG_KT * WG_PS;
  uint32_t* const bl = bh + WG_NT * WG_PS;
  auto raw_a = [&](int buf) { return raw + buf * WG_RB * (WG_AS + WG_BS); };
  auto raw_b = [&](int buf) { return raw_a(buf) + WG_RB * WG_AS; };

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int k0 = blockIdx.x * WG_KT;
  const int n0 = blockIdx.y * WG_NT;
  const int nsplit = (p.rows + p.split_rows - 1) / p.split_rows;
  const int run = RUNS ? blockIdx.z / nsplit : 0;  // RUNS = false: one run, its offsets fold away
  const int rs = (blockIdx.z - run * nsplit) * p.split_rows;
  const int re = min(rs + p.split_rows, p.rows);
  const int n_stages = (re - rs + WG_RB - 1) / WG_RB;
  const int wm0 = (warp & 1) * 32;
  const int wn0 = (warp >> 1) * 32;
  // mma tiles past the operands' columns are not issued (warp-uniform)
  const int m_live = min(2, max(0, (p.a.cols - k0 - wm0 + 15) / 16));
  const int n_live = min(4, max(0, (p.b.cols - n0 - wn0 + 7) / 8));

  auto load = [&](int s, int buf) {
    const int rb = rs + s * WG_RB;
#pragma unroll
    for (int i = 0; i < WG_RB * WG_KT / 4 / WG_THREADS; ++i) {
      const int e = tid + i * WG_THREADS;
      const int rr = e / (WG_KT / 4);
      const int g = e % (WG_KT / 4);
      const int r = rb + rr;
      const bool ok = r < re;
      stage4(p.a, p.any, k0 + 4 * g, r, ok, ok ? r % p.t_len : 0, p.d, p.t_len,
             raw_a(buf) + rr * WG_AS + 4 * g, run);
    }
#pragma unroll
    for (int i = 0; i < WG_RB * WG_NT / 4 / WG_THREADS; ++i) {
      const int e = tid + i * WG_THREADS;
      const int rr = e / (WG_NT / 4);
      const int g = e % (WG_NT / 4);
      const int r = rb + rr;
      stage4(p.b, p.any, n0 + 4 * g, r, r < re, 0, p.d, p.t_len, raw_b(buf) + rr * WG_BS + 4 * g,
             run);
    }
  };
  // staged (row, column) -> planes (column, row); lanes take neighbouring
  // rows: float4 reads at a stride of 4 mod 32 words, 32-word stores
  auto split = [&](const float* src, int stride, int cols, uint32_t* hi, uint32_t* lo) {
    for (int e = tid; e < WG_RB * cols / 4; e += WG_THREADS) {
      const int r = e % WG_RB;
      const int c = (e / WG_RB) * 4;
      const float4 v = *reinterpret_cast<const float4*>(src + r * stride + c);
      split_tf32(v.x, hi[c * WG_PS + r], lo[c * WG_PS + r]);
      split_tf32(v.y, hi[(c + 1) * WG_PS + r], lo[(c + 1) * WG_PS + r]);
      split_tf32(v.z, hi[(c + 2) * WG_PS + r], lo[(c + 2) * WG_PS + r]);
      split_tf32(v.w, hi[(c + 3) * WG_PS + r], lo[(c + 3) * WG_PS + r]);
    }
  };

  float acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
  // ldmatrix rows of this lane: A rows of an m16 tile, B rows of two n8 tiles
  const int a_row = wm0 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_col = (lane >> 4) * 4;
  const int b_row = wn0 + (lane >> 4) * 8 + (lane & 7);
  const int b_col = ((lane >> 3) & 1) * 4;

  if (n_stages > 0) {
    load(0, 0);
    cp_async_commit();
  }
  for (int s = 0; s < n_stages; ++s) {
    cp_async_wait_all();
    __syncthreads();  // stage s landed; every warp is done with the planes of stage s-1
    if (s + 1 < n_stages) {
      load(s + 1, (s + 1) & 1);
      cp_async_commit();
    }
    split(raw_a(s & 1), WG_AS, WG_KT, ah, al);
    split(raw_b(s & 1), WG_BS, WG_NT, bh, bl);
    __syncthreads();  // the planes of stage s are written

    float part[2][4][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) part[mt][nt][i] = 0.f;
#pragma unroll
    for (int kb = 0; kb < WG_RB / 8; ++kb) {
      uint32_t fah[2][4], fal[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        if (mt < m_live) {
          const int i = (a_row + mt * 16) * WG_PS + kb * 8 + a_col;
          ldmatrix_x4(fah[mt], ah + i);
          ldmatrix_x4(fal[mt], al + i);
        }
      }
#pragma unroll
      for (int np = 0; np < 2; ++np) {  // n8 tiles 2np and 2np + 1
        if (2 * np < n_live) {
          const int i = (b_row + np * 16) * WG_PS + kb * 8 + b_col;
          uint32_t fbh[4], fbl[4];
          ldmatrix_x4(fbh, bh + i);
          ldmatrix_x4(fbl, bl + i);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            if (mt < m_live) {
              mma_tf32(part[mt][2 * np], fal[mt], fbh[0], fbh[1]);
              mma_tf32(part[mt][2 * np], fah[mt], fbl[0], fbl[1]);
              mma_tf32(part[mt][2 * np], fah[mt], fbh[0], fbh[1]);
              if (2 * np + 1 < n_live) {
                mma_tf32(part[mt][2 * np + 1], fal[mt], fbh[2], fbh[3]);
                mma_tf32(part[mt][2 * np + 1], fah[mt], fbl[2], fbl[3]);
                mma_tf32(part[mt][2 * np + 1], fah[mt], fbh[2], fbh[3]);
              }
            }
          }
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] += part[mt][nt][i];
  }

  float* out = partial + static_cast<size_t>(blockIdx.z) * p.a.cols * p.b.cols;
  const int gid = lane >> 2;
  const int tig = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int k = k0 + wm0 + mt * 16 + gid + half * 8;
      if (k >= p.a.cols) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int n = n0 + wn0 + nt * 8 + 2 * tig + q;
          if (n < p.b.cols) out[static_cast<size_t>(k) * p.b.cols + n] = acc[mt][nt][half * 2 + q];
        }
      }
    }
  }
}

// A segment of rows of a row-major (rows, ld) matrix whose runs lie rs
// floats apart (a zero block where src is null), and a column of ones.
inline Seg rows_of(const float* src, int ld, long long rs, int shift = 0, int kind = kRows) {
  return Seg{src, ld, ld, shift, src ? kind : kZero, 0, rs};
}
inline Seg ones() { return Seg{nullptr, 0, 1, 0, kOnes, 0, 0}; }

// The segments side by side.
inline Operand operand(std::initializer_list<Seg> segs) {
  Operand op{};
  for (Seg g : segs) {
    g.vec = g.kind <= kHi && g.ld % 4 == 0 && op.cols % 4 == 0 && g.rs % 4 == 0 &&
            reinterpret_cast<uintptr_t>(g.src) % 16 == 0;
    op.seg[op.nseg++] = g;
    op.cols += g.width;
  }
  return op;
}

// ---------------------------------------------------- row-tile products ----
//
// Y[r, n] = sum_k A(r, k) W(k, n) over a tile of RT_M rows, on the tensor
// cores (3xTF32), for every layer product but the weight gradients: z over
// [lo*aud[r-d] | aud[r] | hi*aud[r+d] | x[r]], in both directions; forward,
// res/skip over acts and the end projection over skip; backward, g_acts over
// [g_audio_{i+1} | g_skip], the transposed taps over [g_z[u+d] | g_z[u] |
// g_z[u-d]], and g_x over g_z.  The weights are split once a call
// (wsplit_fwd_kernel, wsplit_kernel) into TF32 hi/lo planes laid
// out (output column n, reduction k), so a stage copies its RT_KS columns of
// the planes as they are (16-byte cp.async, double-buffered) and B
// fragments load by ldmatrix.  A stage stages RT_KS columns of A as the
// weight gradients do (segments of shifted row ranges, one mask a row) and
// splits each element once in place; each stage is summed into zeroed
// registers.  A warp owns one m16 row tile and up to RT_NQ column units: a
// gate pair of n8 tiles (z columns j and C + j, at plane rows j and Cp + j
// with C padded to Cp = a multiple of 8, so tanh and sigmoid of one z meet in
// one thread) or one n8 tile.  On short series the backward deals the units
// over blockIdx.y as well and the forward takes fewer rows a tile, so that
// the grid fills the card.

constexpr int RT_M = 64;             // rows a block: RT_MT m16 tiles (the forward halves it on short series)
constexpr int RT_MT = RT_M / 16;
constexpr int RT_THREADS = 512;      // 16 warps: MT m16 tiles x 16 / MT unit slots
constexpr int RT_KS = 32;            // reduction columns a stage: 4 mma k-steps
constexpr int RT_NQ = 4;             // column units a warp
constexpr int RT_NMAX = 2 * CMAX;    // most plane rows a stage: the padded z columns
constexpr int RT_AS = RT_KS + 4;     // row stride of every staged tile: ldmatrix's 8 rows hit 32 banks
constexpr size_t RT_SMEM =
    (2 * RT_M * RT_AS + 2 * RT_M * RT_AS + 2 * 2 * RT_NMAX * RT_AS) * sizeof(float);

__host__ __device__ inline int round_ks(int v) { return (v + RT_KS - 1) / RT_KS * RT_KS; }

// The split weights of one layer in the caller's scratch: per matrix a hi
// plane then a lo plane, each (rows, k_pad) words, k_pad a whole number of
// stages: z (2Cp, 3C+H), g_acts (Cp, 2C), the transposed taps (Cp, 6C), the
// cond input gradient (Hp, 2C); wn_bwd_wsplit_words gives the caller the size.
struct WPlanes {
  int cp, hp, kz, kg, kt, kc;
  size_t z, g, t, x, layer;  // word offsets in a layer's block, and its size
};
__host__ __device__ inline WPlanes wplanes(int c, int h) {
  WPlanes p;
  p.cp = round8(c);
  p.hp = round8(h);
  p.kz = round_ks(3 * c + h);
  p.kg = p.kc = round_ks(2 * c);
  p.kt = round_ks(6 * c);
  p.z = 0;
  p.g = p.z + 2 * static_cast<size_t>(2 * p.cp) * p.kz;
  p.t = p.g + 2 * static_cast<size_t>(p.cp) * p.kg;
  p.x = p.t + 2 * static_cast<size_t>(p.cp) * p.kt;
  p.layer = p.x + 2 * static_cast<size_t>(p.hp) * p.kc;
  return p;
}

// The z column at plane row n of the gate-pair layout: row n < Cp is column
// n, row Cp + j is column C + j; -1 in the padding.
__device__ __forceinline__ int pair_col(int n, int c, int cp) {
  return n < cp ? (n < c ? n : -1) : (n - cp < c ? c + n - cp : -1);
}

// W(k, col) of layer i's z product, [w_in[i] (3C, 2C); w_cond[:, 2Ci:2C(i+1)]
// (H, 2C)], zero past it and for col = -1.
__device__ __forceinline__ float z_weight(const float* w_in, const float* w_cond, int c, int h,
                                          int n_layers, int i, int col, int k) {
  if (col < 0) return 0.f;
  if (k < 3 * c) return w_in[(static_cast<size_t>(i) * 3 * c + k) * 2 * c + col];
  if (k < 3 * c + h) return w_cond[(k - 3 * c) * static_cast<size_t>(2 * c) * n_layers + 2 * c * i + col];
  return 0.f;
}

// Splits W(k, n) of every run and layer (blockIdx.z = run * L + layer) and
// matrix (blockIdx.y: z,
// g_acts, the transposed taps, the cond input gradient) into its planes,
// one block a plane row n (blockIdx.x), zero past W and in the padding:
//   z:      W(k, col) = [w_in[i] (3C, 2C); w_cond[:, 2Ci:2C(i+1)] (H, 2C)],
//           plane row n < Cp is column n, row Cp + j is column C + j
//   g_acts: W(k, n) = w_rs[i][n][k]
//   taps:   W(k, n) = w_in[i][k / 2C][n][k % 2C]  (w_in[i]^T as (3*2C, C))
//   g_x:    W(k, n) = w_cond[n][2Ci + k]
__global__ void __launch_bounds__(NTHREADS)
wsplit_kernel(const float* __restrict__ w_in, const float* __restrict__ w_cond,
              const float* __restrict__ w_rs, uint32_t* __restrict__ out, int c, int h,
              int n_layers) {
  const int run = blockIdx.z / n_layers;
  const int i = blockIdx.z - run * n_layers;
  const int m = blockIdx.y;
  const int n = blockIdx.x;
  const WPlanes P = wplanes(c, h);
  w_in += static_cast<size_t>(run) * n_layers * 3 * c * 2 * c;
  w_cond += static_cast<size_t>(run) * h * 2 * c * n_layers;
  w_rs += static_cast<size_t>(run) * n_layers * c * 2 * c;
  out += run * n_layers * P.layer;
  const int rows_m = m == 0 ? 2 * P.cp : m == 3 ? P.hp : P.cp;
  if (n >= rows_m) return;
  const int k_pad = m == 0 ? P.kz : m == 1 ? P.kg : m == 2 ? P.kt : P.kc;
  const size_t off = m == 0 ? P.z : m == 1 ? P.g : m == 2 ? P.t : P.x;
  uint32_t* hi = out + i * P.layer + off + static_cast<size_t>(n) * k_pad;
  uint32_t* lo = hi + static_cast<size_t>(rows_m) * k_pad;
  const int col = pair_col(n, c, P.cp);
  const size_t ldc = static_cast<size_t>(2 * c) * n_layers;
  for (int k = threadIdx.x; k < k_pad; k += NTHREADS) {
    float v = 0.f;
    if (m == 0) {
      v = z_weight(w_in, w_cond, c, h, n_layers, i, col, k);
    } else if (m == 1) {
      if (n < c && k < 2 * c) v = w_rs[(static_cast<size_t>(i) * c + n) * 2 * c + k];
    } else if (m == 2) {
      if (n < c && k < 6 * c)
        v = w_in[((static_cast<size_t>(i) * 3 + k / (2 * c)) * c + n) * 2 * c + k % (2 * c)];
    } else if (n < h && k < 2 * c) {
      v = w_cond[n * ldc + 2 * c * i + k];
    }
    split_tf32(v, hi[k], lo[k]);
  }
}

// The forward's split weights in the caller's scratch, a hi then a lo plane
// a matrix as WPlanes: per layer z (2Cp, kz), laid out as the backward's, and
// res/skip (2Cp, kr), C deep, in the gate-pair layout (plane row j is audio
// column j, row Cp + j skip column C + j, so one thread holds both outputs of
// column j); after the layers, once, the end projection (Ep, kr), Ep = 2H
// rounded up to 8.  wn_fwd_wsplit_words gives the caller the size.
struct FPlanes {
  int cp, ep, kz, kr;
  size_t z, rs, layer;  // word offsets in a layer's block, and its size
};
__host__ __device__ inline FPlanes fplanes(int c, int h) {
  FPlanes p;
  p.cp = round8(c);
  p.ep = round8(2 * h);
  p.kz = round_ks(3 * c + h);
  p.kr = round_ks(c);
  p.z = 0;
  p.rs = p.z + 2 * static_cast<size_t>(2 * p.cp) * p.kz;
  p.layer = p.rs + 2 * static_cast<size_t>(2 * p.cp) * p.kr;
  return p;
}
// One run's words of the forward's split weights: every layer, then the end
// projection.
__host__ __device__ inline size_t fwd_words(const FPlanes& p, int n_layers) {
  return n_layers * p.layer + 2 * static_cast<size_t>(p.ep) * p.kr;
}

// Splits the forward's W(k, n) (blockIdx.y: z and res/skip of layer
// blockIdx.z % L of run blockIdx.z / L, or the run's end projection) into
// its planes, one block a plane row
// n (blockIdx.x), zero past W and in the padding:
//   z:        as wsplit_kernel
//   res/skip: W(k, col) = w_rs[i][k][col], plane row n holds col = pair_col(n)
//   end:      W(k, n) = w_end[k][n]
__global__ void __launch_bounds__(NTHREADS)
wsplit_fwd_kernel(const float* __restrict__ w_in, const float* __restrict__ w_cond,
                  const float* __restrict__ w_rs, const float* __restrict__ w_end,
                  uint32_t* __restrict__ out, int c, int h, int n_layers) {
  const int run = blockIdx.z / n_layers;
  const int i = blockIdx.z - run * n_layers;
  const int m = blockIdx.y;
  const int n = blockIdx.x;
  const FPlanes P = fplanes(c, h);
  w_in += static_cast<size_t>(run) * n_layers * 3 * c * 2 * c;
  w_cond += static_cast<size_t>(run) * h * 2 * c * n_layers;
  w_rs += static_cast<size_t>(run) * n_layers * c * 2 * c;
  w_end += static_cast<size_t>(run) * c * 2 * h;
  out += run * fwd_words(P, n_layers);
  if (m == 2 && i > 0) return;
  const int rows_m = m == 2 ? P.ep : 2 * P.cp;
  if (n >= rows_m) return;
  const int k_pad = m == 0 ? P.kz : P.kr;
  const size_t off = m == 2 ? n_layers * P.layer : i * P.layer + (m == 0 ? P.z : P.rs);
  uint32_t* hi = out + off + static_cast<size_t>(n) * k_pad;
  uint32_t* lo = hi + static_cast<size_t>(rows_m) * k_pad;
  const int col = pair_col(n, c, P.cp);
  for (int k = threadIdx.x; k < k_pad; k += NTHREADS) {
    float v = 0.f;
    if (m == 0) {
      v = z_weight(w_in, w_cond, c, h, n_layers, i, col, k);
    } else if (m == 1) {
      if (col >= 0 && k < c) v = w_rs[(static_cast<size_t>(i) * c + k) * 2 * c + col];
    } else if (n < 2 * h && k < c) {
      v = w_end[static_cast<size_t>(k) * 2 * h + n];
    }
    split_tf32(v, hi[k], lo[k]);
  }
}

// acc[j][t] += A(tile rows, :k_dim) @ W(:k_dim, n8 tile tiles[j][t]) for the
// units j < nu of this warp, over a tile of 16 * MT rows (MT m16 tiles, each
// taken by 16 / MT warps).  W is its split planes: w_hi (row n at w_hi + n *
// k_pad, the lo plane w_lo), of which the stage copies rows [0, w_rows).
template <int NTU, int MT = RT_MT>
__device__ __forceinline__ void rt_phase(float (&acc)[RT_NQ][NTU][4], const Operand& a,
                                         const uint32_t* w_hi, const uint32_t* w_lo, int k_pad,
                                         int w_rows, int k_dim, int r0, int rows, int t_len, int d,
                                         const float* any, const int (&tiles)[RT_NQ][NTU], int nu,
                                         float* smem, int run) {
  float* const raw_a = smem;  // 2 x [RT_M][RT_AS]
  uint32_t* const ah = reinterpret_cast<uint32_t*>(raw_a + 2 * RT_M * RT_AS);
  uint32_t* const al = ah + RT_M * RT_AS;
  uint32_t* const wbuf = al + RT_M * RT_AS;  // 2 x {hi, lo} x [RT_NMAX][RT_AS]
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int n_stages = (k_dim + RT_KS - 1) / RT_KS;

  auto load = [&](int s, int buf) {
    const int k0 = s * RT_KS;
    if (tid < 16 * MT * (RT_KS / 4)) {  // A: 16 * MT rows x RT_KS columns, one 4-column group a thread
      const int rr = tid / (RT_KS / 4);
      const int g = tid % (RT_KS / 4);
      const int r = r0 + rr;
      const bool ok = r < rows;
      stage4(a, any, k0 + 4 * g, r, ok, ok ? r % t_len : 0, d, t_len,
             raw_a + buf * RT_M * RT_AS + rr * RT_AS + 4 * g, run);
    }
    uint32_t* wb = wbuf + buf * 2 * RT_NMAX * RT_AS;
    for (int e = tid; e < 2 * w_rows * (RT_KS / 4); e += RT_THREADS) {  // W: 16-byte chunks
      const int q = e % (RT_KS / 4);
      const int n = (e / (RT_KS / 4)) % w_rows;
      const int p = e / (RT_KS / 4) / w_rows;
      const uint32_t* src = (p ? w_lo : w_hi) + static_cast<size_t>(n) * k_pad + k0 + 4 * q;
      cp_async16(wb + (p * RT_NMAX + n) * RT_AS + 4 * q, src, true);
    }
  };

  // ldmatrix rows of this lane: A rows of the warp's m16 tile; for B, lanes
  // 0-15 read the hi plane and 16-31 the lo plane of one n8 tile
  const int a_row = (warp % MT) * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_col = (lane >> 4) * 4;
  const int b_off = ((lane >> 4) * RT_NMAX + (lane & 7)) * RT_AS + ((lane >> 3) & 1) * 4;

  // every warp is done with an earlier phase of the block: its last stage
  // may have read buffer 0, which the first load below overwrites
  __syncthreads();
  if (n_stages > 0) {
    load(0, 0);
    cp_async_commit();
  }
  for (int s = 0; s < n_stages; ++s) {
    cp_async_wait_all();
    __syncthreads();  // stage s landed; every warp is done with stage s-1
    if (s + 1 < n_stages) {
      load(s + 1, (s + 1) & 1);
      cp_async_commit();
    }
    const float* xa = raw_a + (s & 1) * RT_M * RT_AS;
    for (int e = tid; e < 16 * MT * RT_KS; e += RT_THREADS) {
      const int i = (e / RT_KS) * RT_AS + e % RT_KS;
      split_tf32(xa[i], ah[i], al[i]);
    }
    __syncthreads();  // the A planes of stage s are written
    const uint32_t* wb = wbuf + (s & 1) * 2 * RT_NMAX * RT_AS + b_off;

    float part[RT_NQ][NTU][4];
#pragma unroll
    for (int j = 0; j < RT_NQ; ++j)
#pragma unroll
      for (int t = 0; t < NTU; ++t)
#pragma unroll
        for (int i = 0; i < 4; ++i) part[j][t][i] = 0.f;
#pragma unroll
    for (int kb = 0; kb < RT_KS / 8; ++kb) {
      uint32_t fah[4], fal[4];
      ldmatrix_x4(fah, ah + a_row * RT_AS + kb * 8 + a_col);
      ldmatrix_x4(fal, al + a_row * RT_AS + kb * 8 + a_col);
#pragma unroll
      for (int j = 0; j < RT_NQ; ++j) {
        if (j < nu) {
#pragma unroll
          for (int t = 0; t < NTU; ++t) {
            uint32_t fb[4];  // hi k 0-3, hi k 4-7, lo k 0-3, lo k 4-7
            ldmatrix_x4(fb, wb + tiles[j][t] * 8 * RT_AS + kb * 8);
            mma_tf32(part[j][t], fal, fb[0], fb[1]);
            mma_tf32(part[j][t], fah, fb[2], fb[3]);
            mma_tf32(part[j][t], fah, fb[0], fb[1]);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < RT_NQ; ++j)
#pragma unroll
      for (int t = 0; t < NTU; ++t)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][t][i] += part[j][t][i];
  }
}

// A row and column of this lane's element i of an m16n8 C fragment of the
// warp's m16 tile (column within the n8 tile).
template <int MT = RT_MT>
__device__ __forceinline__ int frag_row(int i) {
  return ((threadIdx.x >> 5) % MT) * 16 + ((threadIdx.x & 31) >> 2) + (i >> 1) * 8;
}
__device__ __forceinline__ int frag_col(int i) { return (threadIdx.x & 3) * 2 + (i & 1); }

// The n8 tiles (or gate pairs) of this warp: unit p = slot + (16 / MT) j of
// the block's share is unit y + ny*p of the whole; returns how many exist.
template <int MT = RT_MT>
__device__ __forceinline__ int rt_units(int y, int ny, int n_units, int (&unit)[RT_NQ]) {
  const int slot = (threadIdx.x >> 5) / MT;
  int nu = 0;
#pragma unroll
  for (int j = 0; j < RT_NQ; ++j) {
    unit[j] = y + ny * (slot + 16 / MT * j);
    if (unit[j] < n_units) nu = j + 1;
  }
  return nu;
}

// Layer i, first half: z = [taps of aud | x] @ [w_in[i]; w_cond_i], g_acts =
// [g_audio_{i+1} | g_skip] @ w_rs[i]^T, then g_z and acts.  blockIdx.y deals
// the gate pairs over gridDim.y blocks; blockIdx.z is the run (run 0's
// pointers, every run's own offset by its share).
struct GzArgs {
  Operand a_z, a_grs;
  const uint32_t* planes;  // the layer's split weights (WPlanes)
  const float* b_z;
  float* gz;
  float* acts;
  int rows, t_len, h, c, d, n_layers;
};

template <bool RUNS>
__global__ void __launch_bounds__(RT_THREADS, 1) wn_layer_gz_kernel(GzArgs p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int r0 = blockIdx.x * RT_M;
  const int c = p.c;
  const WPlanes P = wplanes(c, p.h);
  const int run = RUNS ? blockIdx.z : 0;  // RUNS = false: one run, its offsets fold away
  const uint32_t* planes = p.planes + run * p.n_layers * P.layer;
  const float* b_z = p.b_z + static_cast<size_t>(run) * p.n_layers * 2 * c;
  float* gz = p.gz + static_cast<size_t>(run) * p.rows * 2 * c;
  float* acts = p.acts + static_cast<size_t>(run) * p.rows * c;
  int unit[RT_NQ];
  const int nu = rt_units(blockIdx.y, gridDim.y, P.cp / 8, unit);
  int pair[RT_NQ][2], one[RT_NQ][1];
#pragma unroll
  for (int j = 0; j < RT_NQ; ++j) {
    pair[j][0] = one[j][0] = unit[j];
    pair[j][1] = unit[j] + P.cp / 8;
  }
  float t_[RT_NQ][4], s_[RT_NQ][4];  // tanh and sigmoid of the z pairs
  {
    float z[RT_NQ][2][4];
#pragma unroll
    for (int j = 0; j < RT_NQ; ++j)
#pragma unroll
      for (int i = 0; i < 8; ++i) z[j][i >> 2][i & 3] = 0.f;
    const uint32_t* wz = planes + P.z;
    rt_phase(z, p.a_z, wz, wz + static_cast<size_t>(2 * P.cp) * P.kz, P.kz, 2 * P.cp, p.a_z.cols,
             r0, p.rows, p.t_len, p.d, gz, pair, nu, smem, run);
#pragma unroll
    for (int j = 0; j < RT_NQ; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = min(unit[j] * 8 + frag_col(i), c - 1);
        t_[j][i] = tanhf(z[j][0][i] + b_z[col]);
        s_[j][i] = sigmoidf_(z[j][1][i] + b_z[c + col]);
      }
    }
  }
  float g[RT_NQ][1][4];
#pragma unroll
  for (int j = 0; j < RT_NQ; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) g[j][0][i] = 0.f;
  const uint32_t* wg = planes + P.g;
  rt_phase(g, p.a_grs, wg, wg + static_cast<size_t>(P.cp) * P.kg, P.kg, P.cp, 2 * c, r0, p.rows,
           p.t_len, p.d, gz, one, nu, smem, run);
#pragma unroll
  for (int j = 0; j < RT_NQ; ++j) {
    if (j >= nu) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + frag_row(i);
      const int col = unit[j] * 8 + frag_col(i);
      if (r < p.rows && col < c) {
        const float t = t_[j][i];
        const float s = s_[j][i];
        gz[static_cast<size_t>(r) * 2 * c + col] = g[j][0][i] * s * (1.f - t * t);
        gz[static_cast<size_t>(r) * 2 * c + c + col] = g[j][0][i] * t * s * (1.f - s);
        acts[static_cast<size_t>(r) * c + col] = t * s;
      }
    }
  }
}

// Layer i, second half.  Part blockIdx.y / ny == 0: g_audio_i = g_audio_{i+1}
// + [g_z[u+d] | g_z[u] | g_z[u-d]] @ w_in[i]^T as (3*2C, C), each tap masked
// at its source row: g_z[u+d] is live iff pos(u+d) >= d, which is pos(u) <
// T - d, and g_z[u-d] iff pos(u-d) < T - d, which is pos(u) >= d.  Part 1 +
// j: g_x[:, jCMAX:(j+1)CMAX] += g_z @ w_cond_i^T, 2C deep.  blockIdx.y % ny
// deals the n8 tiles; blockIdx.z is the run, as in wn_layer_gz_kernel.
struct GaArgs {
  Operand a_taps, a_gz;
  const uint32_t* planes;  // the layer's split weights (WPlanes)
  const float* ga_next;
  float* ga_out;
  float* gx;
  int rows, t_len, h, c, d, first, ny, n_layers;
};

template <bool RUNS>
__global__ void __launch_bounds__(RT_THREADS, 1) wn_layer_ga_kernel(GaArgs p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int r0 = blockIdx.x * RT_M;
  const WPlanes P = wplanes(p.c, p.h);
  const int run = RUNS ? blockIdx.z : 0;  // RUNS = false: one run, its offsets fold away
  const size_t rc2 = 2 * static_cast<size_t>(p.rows) * p.c;  // a run's g_audio ping-pong
  const uint32_t* planes = p.planes + run * p.n_layers * P.layer;
  const float* ga_next = p.ga_next ? p.ga_next + run * rc2 : nullptr;
  float* ga_out = p.ga_out + run * rc2;
  float* gx = p.gx + static_cast<size_t>(run) * p.rows * p.h;
  const int part = blockIdx.y / p.ny;
  const int n0 = (part - 1) * CMAX;
  const int nc = part == 0 ? p.c : min(CMAX, p.h - n0);
  int unit[RT_NQ], tile[RT_NQ][1];
  const int nu = rt_units(blockIdx.y % p.ny, p.ny, (nc + 7) / 8, unit);
#pragma unroll
  for (int j = 0; j < RT_NQ; ++j) tile[j][0] = unit[j];
  float acc[RT_NQ][1][4];
#pragma unroll
  for (int j = 0; j < RT_NQ; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][0][i] = 0.f;
  const float* any = p.a_gz.seg[0].src;
  if (part == 0) {
    const uint32_t* wt = planes + P.t;
    rt_phase(acc, p.a_taps, wt, wt + static_cast<size_t>(P.cp) * P.kt, P.kt, P.cp, 6 * p.c, r0,
             p.rows, p.t_len, p.d, any, tile, nu, smem, run);
  } else {
    const uint32_t* wx = planes + P.x;
    rt_phase(acc, p.a_gz, wx + static_cast<size_t>(n0) * P.kc,
             wx + static_cast<size_t>(P.hp + n0) * P.kc, P.kc, round8(nc), 2 * p.c, r0, p.rows,
             p.t_len, p.d, any, tile, nu, smem, run);
  }
#pragma unroll
  for (int j = 0; j < RT_NQ; ++j) {
    if (j >= nu) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int u = r0 + frag_row(i);
      const int n = tile[j][0] * 8 + frag_col(i);
      if (u >= p.rows || n >= nc) continue;
      if (part == 0) {
        const size_t o = static_cast<size_t>(u) * p.c + n;
        ga_out[o] = (ga_next ? ga_next[o] : 0.f) + acc[j][0][i];
      } else {
        const size_t o = static_cast<size_t>(u) * p.h + n0 + n;
        gx[o] = (p.first ? 0.f : gx[o]) + acc[j][0][i];
      }
    }
  }
}

// One forward layer over a tile of 16 * MT rows, three products, each an
// rt_phase:
//   z = [taps of aud_i | x] @ [w_in[i]; w_cond_i] + b_z, then acts = tanh(z[:,
//       :C]) * sigmoid(z[:, C:]) into the acts scratch;
//   rs = acts @ w_rs[i]: aud_next = aud_i + rs[:, :C] + b_rs, skip (+)= rs[:,
//       C:] + b_rs (the last layer has no aud_next);
//   in the last layer y = skip @ w_end + b_end, RT_END_COLS columns a pass.
// A product reads rows that the one before it wrote to global memory, the
// block's own rows; rt_phase opens with a barrier, so its cp.async sees them.
// Res/skip needs every acts column of a row and the end projection every
// skip column, so a block takes all columns of its rows; on short series the
// tiles shrink (MT 2 or 1) instead, so that the grid fills the card.
// blockIdx.y is the run: the pointers are run 0's, every run's own offset
// by its share.  The one-run call takes the RUNS = false instance, whose run
// is the constant 0: its offsets fold away, and with them the registers
// they cost (the RUNS = true instance spills a few bytes).
constexpr int RT_END_COLS = RT_MT * RT_NQ * 8;  // one n8 tile a unit: 16 units
struct FwdArgs {
  Operand a_z, a_acts, a_skip;
  const uint32_t* planes;      // the layer's split weights (FPlanes)
  const uint32_t* end_planes;  // the end projection's
  const float* aud_i;
  const float* b_z;
  const float* b_rs;
  const float* b_end;
  float* acts;
  float* aud_next;  // null in the last layer
  float* skip;
  float* y;
  int rows, t_len, h, c, d, first, last, n_layers;
};

template <int MT, bool RUNS>
__global__ void __launch_bounds__(RT_THREADS, 1) wn_layer_fwd_kernel(FwdArgs p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int r0 = blockIdx.x * 16 * MT;
  const int c = p.c;
  const FPlanes P = fplanes(c, p.h);
  // the run's pointers, each formed in the part that uses it (few live registers)
  const int run = RUNS ? blockIdx.y : 0;
  const size_t rc = static_cast<size_t>(p.rows) * c;
  const float* aud_i = p.aud_i + run * p.n_layers * rc;
  int unit[RT_NQ], pair[RT_NQ][2];
  const int nu = rt_units<MT>(0, 1, P.cp / 8, unit);
#pragma unroll
  for (int j = 0; j < RT_NQ; ++j) {
    pair[j][0] = unit[j];
    pair[j][1] = unit[j] + P.cp / 8;
  }
  {
    float z[RT_NQ][2][4];
#pragma unroll
    for (int j = 0; j < RT_NQ; ++j)
#pragma unroll
      for (int i = 0; i < 8; ++i) z[j][i >> 2][i & 3] = 0.f;
    const uint32_t* wz = p.planes + run * fwd_words(P, p.n_layers) + P.z;
    rt_phase<2, MT>(z, p.a_z, wz, wz + static_cast<size_t>(2 * P.cp) * P.kz, P.kz, 2 * P.cp,
                    p.a_z.cols, r0, p.rows, p.t_len, p.d, aud_i, pair, nu, smem, run);
    const float* b_z = p.b_z + static_cast<size_t>(run) * p.n_layers * 2 * c;
    float* acts = p.acts + run * rc;
#pragma unroll
    for (int j = 0; j < RT_NQ; ++j) {
      if (j >= nu) continue;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = r0 + frag_row<MT>(i);
        const int col = unit[j] * 8 + frag_col(i);
        if (r < p.rows && col < c)
          acts[static_cast<size_t>(r) * c + col] =
              tanhf(z[j][0][i] + b_z[col]) * sigmoidf_(z[j][1][i] + b_z[c + col]);
      }
    }
  }
  {
    float rs[RT_NQ][2][4];
#pragma unroll
    for (int j = 0; j < RT_NQ; ++j)
#pragma unroll
      for (int i = 0; i < 8; ++i) rs[j][i >> 2][i & 3] = 0.f;
    const uint32_t* wr = p.planes + run * fwd_words(P, p.n_layers) + P.rs;
    rt_phase<2, MT>(rs, p.a_acts, wr, wr + static_cast<size_t>(2 * P.cp) * P.kr, P.kr, 2 * P.cp,
                    c, r0, p.rows, p.t_len, p.d, aud_i, pair, nu, smem, run);
    const float* b_rs = p.b_rs + static_cast<size_t>(run) * p.n_layers * 2 * c;
    float* aud_next = p.aud_next ? p.aud_next + run * p.n_layers * rc : nullptr;
    float* skip = p.skip + run * rc;
#pragma unroll
    for (int j = 0; j < RT_NQ; ++j) {
      if (j >= nu) continue;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = r0 + frag_row<MT>(i);
        const int col = unit[j] * 8 + frag_col(i);
        if (r >= p.rows || col >= c) continue;
        const size_t o = static_cast<size_t>(r) * c + col;
        if (aud_next) aud_next[o] = aud_i[o] + rs[j][0][i] + b_rs[col];
        skip[o] = (p.first ? 0.f : skip[o]) + rs[j][1][i] + b_rs[c + col];
      }
    }
  }
  if (!p.last) return;
  const uint32_t* end_planes = p.end_planes + run * fwd_words(P, p.n_layers);
  const float* b_end = p.b_end + static_cast<size_t>(run) * 2 * p.h;
  float* y = p.y + static_cast<size_t>(run) * p.rows * 2 * p.h;
  for (int n0 = 0; n0 < 2 * p.h; n0 += RT_END_COLS) {
    const int nc = min(RT_END_COLS, 2 * p.h - n0);
    int eu[RT_NQ], tile[RT_NQ][1];
    const int ne = rt_units<MT>(0, 1, (nc + 7) / 8, eu);
    float e[RT_NQ][1][4];
#pragma unroll
    for (int j = 0; j < RT_NQ; ++j) {
      tile[j][0] = eu[j];
#pragma unroll
      for (int i = 0; i < 4; ++i) e[j][0][i] = 0.f;
    }
    rt_phase<1, MT>(e, p.a_skip, end_planes + static_cast<size_t>(n0) * P.kr,
                    end_planes + static_cast<size_t>(P.ep + n0) * P.kr, P.kr, round8(nc), c, r0,
                    p.rows, p.t_len, p.d, aud_i, tile, ne, smem, run);
#pragma unroll
    for (int j = 0; j < RT_NQ; ++j) {
      if (j >= ne) continue;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = r0 + frag_row<MT>(i);
        const int col = eu[j] * 8 + frag_col(i);
        if (r < p.rows && col < nc)
          y[static_cast<size_t>(r) * 2 * p.h + n0 + col] = e[j][0][i] + b_end[n0 + col];
      }
    }
  }
}

// out[e] = sum_s partial[s][e], s in order: the same bits on every call;
// blockIdx.y is the run (its partials nsplit * count floats apart, its out
// out_rs).
__global__ void __launch_bounds__(NTHREADS)
reduce_partials_kernel(const float* __restrict__ partial, int nsplit, int count,
                       float* __restrict__ out, long long out_rs) {
  partial += static_cast<size_t>(blockIdx.y) * nsplit * count;
  out += blockIdx.y * out_rs;
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

// ``runs`` runs of the row product (blockIdx.z), each operand's runs its
// run stride (in floats) apart; out16 (n <= CMAX): also out's bf16 copy,
// its runs out16_rs values apart.
template <bool BF16>
cudaError_t rowgemm(const float* a, long long a_rs, const float* w, long long w_rs,
                    const float* bias, long long bias_rs, float* out, long long out_rs, int rows,
                    int k, int n, int accumulate, int runs, cudaStream_t stream,
                    uint16_t* out16 = nullptr, long long out16_rs = 0) {
  if (out16 && n > CMAX) return cudaErrorInvalidValue;
  cudaError_t e = allow_smem(rowgemm_kernel<BF16>, GEMM_SMEM);
  if (e != cudaSuccess) return e;
  rowgemm_kernel<BF16><<<dim3(tiles(rows), col_chunks(n), runs), NTHREADS, GEMM_SMEM, stream>>>(
      a, w, bias, out, rows, k, n, accumulate, a_rs, w_rs, bias_rs, out_rs, out16, out16_rs);
  return cudaGetLastError();
}

// The weight gradient of every run: the partials of run r's slices at
// partial + r * n_splits * count, its sum at out + r * out_rs.
cudaError_t wgrad(const WGrad& p, float* partial, float* out, long long out_rs, int runs,
                  cudaStream_t stream) {
  const int nsplit = n_splits(p);
  const dim3 grid((p.a.cols + WG_KT - 1) / WG_KT, (p.b.cols + WG_NT - 1) / WG_NT, runs * nsplit);
  // the one-run call takes the RUNS = false instance (no run offsets); the
  // caller has set both instances' shared memory
  auto kernel = runs > 1 ? wgrad_kernel<true> : wgrad_kernel<false>;
  kernel<<<grid, WG_THREADS, WG_SMEM, stream>>>(p, partial);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int count = p.a.cols * p.b.cols;
  const int blocks = (count + NTHREADS - 1) / NTHREADS;
  reduce_partials_kernel<<<dim3(blocks, runs), NTHREADS, 0, stream>>>(partial, nsplit, count, out,
                                                                     out_rs);
  return cudaGetLastError();
}

// The current device's SM count, read once a device.
cudaError_t current_sms(int& sms) {
  constexpr int kMaxDevices = 64;
  static int cached[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kMaxDevices && cached[dev] > 0) {
    sms = cached[dev];
    return cudaSuccess;
  }
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess && dev < kMaxDevices) cached[dev] = sms;
  return e;
}

// m16 tiles a row tile of the forward: RT_MT, halved while the smaller tiles
// still fit one wave of a block an SM (on an H100, PERF.md: at VendCoffee's
// 2,400 rows 32-row tiles took 0.67-0.71 ms, 64-row 0.92 and 16-row, two
// waves, 1.06-1.08; at VendGunPoint's 6,000 rows 64-row tiles 0.82 ms,
// 32-row 1.09-1.14); chosen from one run's rows, so each run takes the
// one-run call's tiles.
cudaError_t fwd_row_tile(int rows, int& mt) {
  int sms = 0;
  const cudaError_t e = current_sms(sms);
  mt = RT_MT;
  while (mt > 1 && (rows + 8 * mt - 1) / (8 * mt) <= sms) mt /= 2;
  return e;
}

// The geometry the kernels take; wn_fused.py check_geometry states the same.
bool bad_geometry(int rows, int t_len, int h, int c, int n_layers) {
  return rows < 1 || t_len < 1 || rows % t_len != 0 || h < 1 || c < 1 || c > CMAX ||
         n_layers < 1 || n_layers > 30;
}

// Forward of ``runs`` independent WNs of one geometry: every tensor below
// holds the runs one after the other (x (runs, R, H), w_in (runs, L, 3, C,
// 2C), ...), each run's arithmetic the one-run call's; the run rides on a
// grid axis of every kernel, so the launches are those of one run.  Per
// run: y (R, 2H), aud (L, R, C), skip (R, C).  b_z = b_in + b_cond as (L,
// 2C).  Scratch: acts (runs, R, C), wsplit (runs * wn_fwd_wsplit_words).  2
// + L kernel launches.  They replace the vmapped Pallas kernel of the JAX
// package's multi-run training (train/multirun.py), where jax.vmap adds a
// grid axis.  bf16 != 0 takes wn_fwd_bf16.cuh's kernels (3 + L launches):
// acts unused, and wsplit the bf16 work area of wn_fwd_wsplit_words(...,
// bf16 = 1).
cudaError_t fwd_runs(const float* x, const float* w_start, const float* b_start,
                     const float* w_cond, const float* b_z, const float* w_in, const float* w_rs,
                     const float* b_rs, const float* w_end, const float* b_end, float* y,
                     float* aud, float* skip, float* acts, void* wsplit, int runs, int rows,
                     int t_len, int h, int c, int n_layers, cudaStream_t stream) {
  const FPlanes P = fplanes(c, h);
  uint32_t* planes = static_cast<uint32_t*>(wsplit);
  wsplit_fwd_kernel<<<dim3(max(2 * P.cp, P.ep), 3, runs * n_layers), NTHREADS, 0, stream>>>(
      w_in, w_cond, w_rs, w_end, planes, c, h, n_layers);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long rc = static_cast<long long>(rows) * c;
  e = rowgemm<false>(x, static_cast<long long>(rows) * h, w_start, static_cast<long long>(h) * c,
                     b_start, c, aud, n_layers * rc, rows, h, c, 0, runs, stream);
  if (e != cudaSuccess) return e;
  int mt = 0;
  e = fwd_row_tile(rows, mt);
  if (e != cudaSuccess) return e;
  const bool many = runs > 1;
  auto kernel =
      mt == 4 ? (many ? wn_layer_fwd_kernel<4, true> : wn_layer_fwd_kernel<4, false>)
      : mt == 2 ? (many ? wn_layer_fwd_kernel<2, true> : wn_layer_fwd_kernel<2, false>)
                : (many ? wn_layer_fwd_kernel<1, true> : wn_layer_fwd_kernel<1, false>);
  e = allow_smem(kernel, RT_SMEM);
  if (e != cudaSuccess) return e;
  const int tiles_fwd = (rows + 16 * mt - 1) / (16 * mt);
  const long long aud_rs = n_layers * rc;
  for (int i = 0; i < n_layers; ++i) {
    const int d = 1 << i;
    const float* aud_i = aud + i * rc;
    const bool last = i == n_layers - 1;
    const FwdArgs p{
        operand({rows_of(aud_i, c, aud_rs, -d, kLo), rows_of(aud_i, c, aud_rs),
                 rows_of(aud_i, c, aud_rs, d, kHi), rows_of(x, h, static_cast<long long>(rows) * h)}),
        operand({rows_of(acts, c, rc)}), operand({rows_of(skip, c, rc)}), planes + i * P.layer,
        planes + n_layers * P.layer, aud_i, b_z + static_cast<size_t>(i) * 2 * c,
        b_rs + static_cast<size_t>(i) * 2 * c, b_end, acts, last ? nullptr : aud + (i + 1) * rc,
        skip, y, rows, t_len, h, c, d, i == 0, last, n_layers};
    kernel<<<dim3(tiles_fwd, runs), RT_THREADS, RT_SMEM, stream>>>(p);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

}  // namespace

// Backward of ``runs`` independent WNs of one geometry (every tensor holds
// the runs one after the other, as wn_fwd_runs; weight gradients are per
// run and never summed across runs), from g = dL/dy.  Per run: inputs x (R,
// H), g (R, 2H), aud (L, R, C); outputs gx (R, H); g_in (L, 3C+H+1, 2C) =
// per layer [gwi (3C rows) | gwc slice (H rows) | gbi]; g_rs (L, C+1, 2C) =
// per layer [gwr | gbr]; g_start (H+1, C) = [gws | gbs].  Transposed
// weights: w_start_t (C, H), w_end_t (2H, C).  Scratch per run: ga (2, R,
// C), gskip (R, C), gz (R, 2C), acts (R, C), partial (ceil(R/split_rows) *
// (3C+H+1) * 2C), wsplit (wn_bwd_wsplit_words).  5 + 6L kernel launches.
// bf16 != 0 takes wn_bwd_bf16.cuh's kernels (6 + 6L launches): ga and
// partial as here, split_rows a multiple of 64, gskip, gz and acts unused,
// and wsplit the bf16 work area of wn_bwd_wsplit_words(..., bf16 = 1).
namespace {

cudaError_t bwd_runs(const float* x, const float* g, const float* aud, const float* w_cond,
                     const float* w_in, const float* b_z, const float* w_rs,
                     const float* w_start_t, const float* w_end_t, float* gx, float* g_in,
                     float* g_rs, float* g_start, float* ga, float* gskip, float* gz, float* acts,
                     float* partial, void* wsplit, int runs, int rows, int t_len, int h, int c,
                     int n_layers, int split_rows, cudaStream_t stream) {
  const WPlanes P = wplanes(c, h);
  uint32_t* planes = static_cast<uint32_t*>(wsplit);
  wsplit_kernel<<<dim3(max(2 * P.cp, P.hp), 4, runs * n_layers), NTHREADS, 0, stream>>>(
      w_in, w_cond, w_rs, planes, c, h, n_layers);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long rc = static_cast<long long>(rows) * c;
  const long long rh = static_cast<long long>(rows) * h;
  e = rowgemm<false>(g, 2 * rh, w_end_t, 2LL * h * c, nullptr, 0, gskip, rc, rows, 2 * h, c, 0,
                     runs, stream);
  if (e != cudaSuccess) return e;
  // the one-run call takes the RUNS = false instances (no run offsets)
  auto gz_kernel = runs > 1 ? wn_layer_gz_kernel<true> : wn_layer_gz_kernel<false>;
  auto ga_kernel = runs > 1 ? wn_layer_ga_kernel<true> : wn_layer_ga_kernel<false>;
  e = allow_smem(gz_kernel, RT_SMEM);
  if (e != cudaSuccess) return e;
  e = allow_smem(ga_kernel, RT_SMEM);
  if (e != cudaSuccess) return e;
  auto wg_kernel = runs > 1 ? wgrad_kernel<true> : wgrad_kernel<false>;
  e = allow_smem(wg_kernel, WG_SMEM);
  if (e != cudaSuccess) return e;
  int sms = 0;
  e = current_sms(sms);
  if (e != cudaSuccess) return e;
  // row tiles, and the share of column units a block takes: 1, 2 or 4
  // blocks a tile, so that short series still give the card a block an SM
  // (chosen from one run's rows: each run takes the one-run call's shares)
  const int rt = (rows + RT_M - 1) / RT_M;
  int ny = 1;
  while (ny < 4 && rt * ny < sms) ny *= 2;
  const int k_in = 3 * c + h + 1;
  const long long aud_rs = n_layers * rc;
  const long long gin_rs = static_cast<long long>(n_layers) * k_in * 2 * c;
  const long long grs_rs = static_cast<long long>(n_layers) * (c + 1) * 2 * c;
  const float* ga_next = nullptr;
  for (int i = n_layers - 1; i >= 0; --i) {
    const int d = 1 << i;
    const float* aud_i = aud + i * rc;
    float* ga_out = ga + (i % 2) * rc;
    const uint32_t* planes_i = planes + i * P.layer;
    const GzArgs gzp{
        operand({rows_of(aud_i, c, aud_rs, -d, kLo), rows_of(aud_i, c, aud_rs),
                 rows_of(aud_i, c, aud_rs, d, kHi), rows_of(x, h, rh)}),
        operand({rows_of(ga_next, c, 2 * rc), rows_of(gskip, c, rc)}), planes_i,
        b_z + static_cast<size_t>(i) * 2 * c, gz, acts, rows, t_len, h, c, d, n_layers};
    gz_kernel<<<dim3(rt, ny, runs), RT_THREADS, RT_SMEM, stream>>>(gzp);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    const WGrad rs{operand({rows_of(acts, c, rc), ones()}),
                   operand({rows_of(ga_next, c, 2 * rc), rows_of(gskip, c, rc)}), x, rows, t_len,
                   d, split_rows};
    e = wgrad(rs, partial, g_rs + static_cast<size_t>(i) * (c + 1) * 2 * c, grs_rs, runs, stream);
    if (e != cudaSuccess) return e;
    const WGrad in{operand({rows_of(aud_i, c, aud_rs, -d, kLo), rows_of(aud_i, c, aud_rs),
                            rows_of(aud_i, c, aud_rs, d, kHi), rows_of(x, h, rh), ones()}),
                   operand({rows_of(gz, 2 * c, 2 * rc)}), x, rows, t_len, d, split_rows};
    e = wgrad(in, partial, g_in + static_cast<size_t>(i) * k_in * 2 * c, gin_rs, runs, stream);
    if (e != cudaSuccess) return e;
    const GaArgs gap{
        operand({rows_of(gz, 2 * c, 2 * rc, d, kHi), rows_of(gz, 2 * c, 2 * rc),
                 rows_of(gz, 2 * c, 2 * rc, -d, kLo)}),
        operand({rows_of(gz, 2 * c, 2 * rc)}), planes_i, ga_next, ga_out, gx, rows, t_len, h, c, d,
        i == n_layers - 1, ny, n_layers};
    ga_kernel<<<dim3(rt, (1 + col_chunks(h)) * ny, runs), RT_THREADS, RT_SMEM, stream>>>(gap);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    ga_next = ga_out;
  }
  const WGrad st{operand({rows_of(x, h, rh), ones()}), operand({rows_of(ga_next, c, 2 * rc)}), x,
                 rows, t_len, 1, split_rows};
  e = wgrad(st, partial, g_start, static_cast<long long>(h + 1) * c, runs, stream);
  if (e != cudaSuccess) return e;
  return rowgemm<false>(ga_next, 2 * rc, w_start_t, static_cast<long long>(c) * h, nullptr, 0, gx,
                        rh, rows, c, h, 1, runs, stream);
}

}  // namespace

#include "wn_bwd_bf16.cuh"
#include "wn_fwd_bf16.cuh"

extern "C" int wn_fwd_runs(const float* x, const float* w_start, const float* b_start,
                           const float* w_cond, const float* b_z, const float* w_in,
                           const float* w_rs, const float* b_rs, const float* w_end,
                           const float* b_end, float* y, float* aud, float* skip, float* acts,
                           void* wsplit, int runs, int rows, int t_len, int h, int c,
                           int n_layers, int bf16, void* stream_ptr) {
  if (bad_geometry(rows, t_len, h, c, n_layers) || runs < 1 || runs > 65535)
    return cudaErrorInvalidValue;
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (bf16)
    return fwd16_runs(x, w_start, b_start, w_cond, b_z, w_in, w_rs, b_rs, w_end, b_end, y, aud,
                      skip, wsplit, runs, rows, t_len, h, c, n_layers, stream);
  return fwd_runs(x, w_start, b_start, w_cond, b_z, w_in, w_rs, b_rs, w_end, b_end, y, aud, skip,
                  acts, wsplit, runs, rows, t_len, h, c, n_layers, stream);
}

// 32-bit words of wn_fwd's wsplit scratch for one run of ``rows`` rows: the
// split weights of every layer and the end projection; bf16: the bf16 work
// area (FArea16: the bf16 planes and the operand copies).
extern "C" size_t wn_fwd_wsplit_words(int rows, int c, int h, int n_layers, int bf16) {
  if (bf16) return farea16(rows, c, h, n_layers).words;
  return fwd_words(fplanes(c, h), n_layers);
}

// 32-bit words of wn_bwd's wsplit scratch for one run of ``rows`` rows: the
// split weights of every layer; bf16: the bf16 work area (Area16: the bf16
// planes, the operand copies and the tile sums).
extern "C" size_t wn_bwd_wsplit_words(int rows, int c, int h, int n_layers, int bf16) {
  if (bf16) return area16(rows, c, h, n_layers).words;
  return static_cast<size_t>(n_layers) * wplanes(c, h).layer;
}

extern "C" int wn_bwd_runs(const float* x, const float* g, const float* aud,
                           const float* w_cond, const float* w_in, const float* b_z,
                           const float* w_rs, const float* w_start_t, const float* w_end_t,
                           float* gx, float* g_in, float* g_rs, float* g_start, float* ga,
                           float* gskip, float* gz, float* acts, float* partial, void* wsplit,
                           int runs, int rows, int t_len, int h, int c, int n_layers,
                           int split_rows, int bf16, void* stream_ptr) {
  const int stage = bf16 ? H_TILE : WG_RB;  // a slice is whole stages (bf16: whole tiles)
  if (bad_geometry(rows, t_len, h, c, n_layers) || split_rows < stage || split_rows % stage ||
      runs < 1 || runs > 65535)
    return cudaErrorInvalidValue;
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (bf16)
    return bwd16_runs(x, g, aud, w_cond, w_in, b_z, w_rs, w_start_t, w_end_t, gx, g_in, g_rs,
                      g_start, ga, partial, wsplit, runs, rows, t_len, h, c, n_layers, split_rows,
                      stream);
  return bwd_runs(x, g, aud, w_cond, w_in, b_z, w_rs, w_start_t, w_end_t, gx, g_in, g_rs, g_start,
                  ga, gskip, gz, acts, partial, wsplit, runs, rows, t_len, h, c, n_layers,
                  split_rows, stream);
}

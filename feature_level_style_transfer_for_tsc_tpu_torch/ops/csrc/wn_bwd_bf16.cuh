// The WN backward on bf16 operands, for Hopper (sm_90a): wn_bwd_runs with
// bf16 != 0, the counterpart of the JAX package's _wn_bwd_kernel with
// bf16=True (feature_level_style_transfer_for_tsc_tpu/ops/wn_fused.py:195,
// its products through _dot, :83-87, under FLSTTSC_WN_MXU=bf16).  Every
// product rounds both operands to bf16 (to nearest, ties to even); the
// products are exact and the sums f32.  The gate derivatives, the tap masks,
// the residual chain g_audio, the running g_x and the bias gradients stay
// f32 sums of f32 values and never pass through a bf16 operand.
//
// Bound: operations, at the dense BF16 tensor-core peak (989 TFLOP/s on an
// H100 SXM): about 5.2 MFLOP a row against about 4.4 KB a row at the training
// shapes (n_half 25, C 120, 8 layers).
//
// Design (wn_fused.cu's f32 backward, with the bf16 pieces of the OS conv's
// tap_gemm_bf16.cuh):
// * bf16 operand copies, rounded once, in the caller's scratch (Area16): aud
//   and x by one pass at the start of a call (bf16_copies_kernel), g_skip by
//   the epilogue of its product (gskip16_kernel), g_z and acts by that of
//   wn_layer_gz16_kernel, g_audio (beside its f32 residual chain) by that of
//   wn_layer_ga16_kernel.  Each row is padded with zeros to Cp = C rounded up
//   to 8 (Hp for x), and g_z's two halves each to Cp, so every row segment is
//   whole 16-byte chunks and stages by 16-byte cp.async as it lies.
// * bf16 weight planes (wsplit16_kernel, once a call): laid out (output
//   column, reduction) with the reduction in the padded layout of the
//   operand it meets (zeros in the padding) and padded to a whole stage.
// * Row-tile products (rt16_phase: z and g_acts in wn_layer_gz16_kernel, the
//   transposed taps and g_x in wn_layer_ga16_kernel): 64-row tiles, 16 warps
//   as the f32 kernels (rt_units, the gate pairs), native
//   mma.sync.m16n8k16 bf16 with f32 accumulators; a stage copies 128
//   columns of A and of the planes straight into the layout that ldmatrix
//   reads (double-buffered, one barrier a stage, no rounding pass).  128-deep
//   stages (H_KS, H_RB) were 6% faster than 64-deep ones at pair + infer on
//   an H100 (experiments/wn_bwd16_variants.py), the same accuracy.
// * Weight gradients (wgrad16_kernel, A^T B over a slice of rows): both
//   operands stage as bf16 rows as they lie in memory, 128 rows a stage, and
//   ldmatrix .trans reads them as the mma's fragments of A^T and B.  The
//   bias gradients leave the GEMM: the gz and ga epilogues (and gskip16's)
//   write the f32 column sums of each 64-row tile in a fixed order
//   (tile_col_sums), the block of the first column tile of a slice adds its
//   tiles' sums in order into the slice's bias row, and
//   reduce_partials_kernel adds the slices in order: no float atomics, two
//   calls give the same bits.  Slices are whole 64-row tiles
//   (wn_fused.py wgrad_split_rows with bf16), a stage's rows past a slice
//   zero.
// * Each stage sums into zeroed registers, added to the running sum with
//   one rounded f32 add: the tensor core's accumulate truncates.
// * Runs ride on the grid's z axis with pointer offsets only, as in the f32
//   kernels: each run of a run-axis call is the one-run call's bits, and a
//   one-run call takes the RUNS = false instances.
// * Launches: 6 + 6L a call (wn_fused.py global_launches): the copies, the
//   planes, g_skip; per layer gz, two weight gradients each with its
//   reduction, ga; the start's weight gradient, its reduction and the
//   start's input gradient (rowgemm, FP32 FMA on bf16-rounded operands).

#pragma once

// Included by wn_fused.cu after its shared pieces (the constants, Seg kinds,
// tile_gemm, pair_col, rt_units, frag_row / frag_col, reduce_partials_kernel,
// rowgemm, allow_smem, current_sms), whose anonymous namespace it reopens;
// wn_fused.cu includes mma_tf32.cuh and mma_bf16.cuh first.

namespace {

using bf16mma::cp_async16_n;
using bf16mma::ldmatrix_x4_trans;
using bf16mma::mma_bf16;
using tf32x3::cp_async16;
using tf32x3::cp_async_commit;
using tf32x3::cp_async_wait_all;
using tf32x3::ldmatrix_x2;
using tf32x3::ldmatrix_x4;

constexpr int H_CH = 8;                // bf16 values a 16-byte chunk
constexpr int H_KS = 128;              // reduction columns a stage of the row-tile products: 8 k16 steps
constexpr int H_AS = H_KS + H_CH;      // their staged row stride (bf16): ldmatrix's 8 rows hit 32 banks
constexpr int H_RB = 128;              // input rows a stage of the weight gradients: 8 k16 steps
constexpr int H_WAS = WG_KT + H_CH;    // the weight gradients' staged A row stride (bf16)
constexpr int H_WBS = WG_NT + H_CH;    // and B's
constexpr int H_TILE = RT_M;           // rows of a tile sum: the row-tile products' tile
constexpr int H_SEGS = 6;              // segments of an operand: the transposed taps' 3 x 2 halves
constexpr size_t H_RT_SMEM = 2 * static_cast<size_t>(RT_M + RT_NMAX) * H_AS * sizeof(uint16_t);
constexpr size_t H_WG_SMEM = 2 * static_cast<size_t>(H_RB) * (H_WAS + H_WBS) * sizeof(uint16_t);
static_assert(RT_M * (H_KS / H_CH) % RT_THREADS == 0, "whole A chunks a thread a stage");
static_assert(H_RB * (WG_KT / H_CH) % WG_THREADS == 0, "whole A chunks a thread a stage");
static_assert(TR == H_TILE, "gskip16_kernel's blocks are tiles");

__host__ __device__ inline int round_h(int v) { return (v + H_KS - 1) / H_KS * H_KS; }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16;
}

// One layer's bf16 weight planes, in bf16 values: per matrix (rows, k) with
// k the padded reduction, a whole number of stages: z (2Cp, 3Cp + Hp) in the
// gate-pair layout, g_acts (Cp, 2Cp), the transposed taps (Cp, 6Cp), the cond
// input gradient (Hp, 2Cp).
struct WPlanes16 {
  int cp, hp, kz, kg, kt, kc;
  size_t z, g, t, x, layer;
};
__host__ __device__ inline WPlanes16 wplanes16(int c, int h) {
  WPlanes16 p;
  p.cp = round8(c);
  p.hp = round8(h);
  p.kz = round_h(3 * p.cp + p.hp);
  p.kg = p.kc = round_h(2 * p.cp);
  p.kt = round_h(6 * p.cp);
  p.z = 0;
  p.g = p.z + static_cast<size_t>(2 * p.cp) * p.kz;
  p.t = p.g + static_cast<size_t>(p.cp) * p.kg;
  p.x = p.t + static_cast<size_t>(p.cp) * p.kt;
  p.layer = p.x + static_cast<size_t>(p.hp) * p.kc;
  return p;
}

// One run's bf16 work area in the caller's wsplit scratch (wn_bwd_wsplit_words
// with bf16 gives its size; wn_fused.py bwd16_area_words mirrors it): bf16
// values at these offsets (each a multiple of 8: 16-byte rows), the planes of
// every layer, aud (L, R, Cp), x (R, Hp), g_skip (R, Cp), g_audio (R, Cp),
// g_z (R, 2Cp), acts (R, Cp); then, in floats from the area's start, the f32
// column sums of each 64-row tile of g_z (tiles, 2C), g_audio (tiles, C) and
// g_skip (tiles, C).  A run's area is ``words`` 32-bit words (a multiple of
// 4), the runs one after the other.
struct Area16 {
  size_t aud, x, gskip, ga, gz, acts;  // bf16 values
  size_t bpz, bpa, bps;                // floats
  size_t words;
  int tiles;
};
inline Area16 area16(int rows, int c, int h, int n_layers) {
  const WPlanes16 P = wplanes16(c, h);
  const size_t r = static_cast<size_t>(rows);
  Area16 a;
  a.aud = n_layers * P.layer;
  a.x = a.aud + n_layers * r * P.cp;
  a.gskip = a.x + r * P.hp;
  a.ga = a.gskip + r * P.cp;
  a.gz = a.ga + r * P.cp;
  a.acts = a.gz + r * 2 * P.cp;
  a.tiles = (rows + H_TILE - 1) / H_TILE;
  a.bpz = (a.acts + r * P.cp) / 2;
  a.bpa = a.bpz + static_cast<size_t>(a.tiles) * 2 * c;
  a.bps = a.bpa + static_cast<size_t>(a.tiles) * c;
  a.words = (a.bps + static_cast<size_t>(a.tiles) * c + 3) / 4 * 4;
  return a;
}

// A segment of an operand's columns: rows of a row-major bf16 matrix (row
// stride ld, a multiple of 8), ``width`` real columns padded to ``pwidth``,
// the row shifted by ``shift`` and masked by ``kind`` as Seg; a zero block
// where src is null.  ``sums``: a weight gradient's B, the f32 column sums of
// this segment over each 64-row tile (a tile's row at sums + t * sums_ld).
// Run r's rows start at src + r * rs, its sums at sums + r * sums_rs.
struct Seg16 {
  const uint16_t* src;
  long long rs;
  const float* sums;
  long long sums_rs;
  int ld, width, pwidth, shift, kind, sums_ld;
};
struct Op16 {
  Seg16 seg[H_SEGS];
  int nseg, cols, pcols;  // real and padded columns
};

inline Seg16 seg16(const uint16_t* src, int ld, int width, long long rs, int shift = 0,
                   int kind = kRows) {
  return Seg16{src, rs, nullptr, 0, ld, width, round8(width), shift, src ? kind : kZero, 0};
}
inline Seg16 with_sums(Seg16 g, const float* sums, int ld, long long rs) {
  if (g.kind != kZero) {
    g.sums = sums;
    g.sums_ld = ld;
    g.sums_rs = rs;
  }
  return g;
}
inline Seg16 shifted(Seg16 g, int shift, int kind) {
  g.shift = shift;
  g.kind = g.kind == kZero ? kZero : kind;
  g.sums = nullptr;
  return g;
}
inline Op16 op16(std::initializer_list<Seg16> segs) {
  Op16 op{};
  for (const Seg16& g : segs) {
    op.seg[op.nseg++] = g;
    op.cols += g.width;
    op.pcols += g.pwidth;
  }
  return op;
}

// The 16-byte chunk at padded column k (a multiple of 8) of row r of run
// ``run``'s operand into dst, by one cp.async: zero-filled past the operand,
// where row_ok is false, in a zero block, or where the segment's row mask is
// off (kLo: pos(r) >= d, kHi: pos(r) < T - d).
__device__ __forceinline__ void stage16(const Op16& op, const void* any, int k, int r, bool row_ok,
                                        int pos, int d, int t_len, uint16_t* dst, int run) {
  const uint16_t* src = nullptr;
  int base = 0;
#pragma unroll
  for (int s = 0; s < H_SEGS; ++s) {
    if (s < op.nseg) {
      const Seg16& g = op.seg[s];
      if (k >= base && k < base + g.pwidth && g.kind != kZero && row_ok &&
          (g.kind != kLo || pos >= d) && (g.kind != kHi || pos < t_len - d))
        src = g.src + run * g.rs + static_cast<long long>(r + g.shift) * g.ld + (k - base);
      base += g.pwidth;
    }
  }
  cp_async16_n(dst, src ? static_cast<const void*>(src) : any, src ? 16 : 0);
}

// The operand's real column at padded column k (-1 in the padding or past
// the operand), with its segment and its column in the segment.
__device__ __forceinline__ int real_col(const Op16& op, int k, int& seg, int& off) {
  int base = 0, pbase = 0, col = -1;
#pragma unroll
  for (int s = 0; s < H_SEGS; ++s) {
    if (s < op.nseg) {
      const Seg16& g = op.seg[s];
      if (k >= pbase && k - pbase < g.width) {
        col = base + k - pbase;
        seg = s;
        off = k - pbase;
      }
      base += g.width;
      pbase += g.pwidth;
    }
  }
  return col;
}

// ------------------------------------------------- row-tile products ----

// acc[j][t] += A(tile rows, :) @ W(:, n8 tile tiles[j][t]) for the units j <
// nu of this warp over a tile of 16 * MT rows (warp % MT its m16 tile; the
// forward takes MT 2 or 1 on short series).  W is a bf16 plane, row n at w +
// n * k_pad (k_pad a whole number of stages, zero past A's padded columns);
// a stage copies its rows [0, w_rows).  NTU = 2: the two tiles of a unit
// load by one ldmatrix.x4 (lanes 16-31 address the second).  k16 steps past
// A's padded columns are not issued.
template <int NTU, int MT = RT_MT>
__device__ __forceinline__ void rt16_phase(float (&acc)[RT_NQ][NTU][4], const Op16& a,
                                           const uint16_t* w, int k_pad, int w_rows, int r0,
                                           int rows, int t_len, int d, const void* any,
                                           const int (&tiles)[RT_NQ][NTU], int nu,
                                           unsigned char* smem, int run) {
  static_assert(NTU == 1 || NTU == 2, "a unit is one n8 tile or a gate pair");
  uint16_t* const as = reinterpret_cast<uint16_t*>(smem);  // 2 x [RT_M][H_AS]
  uint16_t* const ws = as + 2 * RT_M * H_AS;               // 2 x [RT_NMAX][H_AS]
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int k_dim = a.pcols;
  const int n_stages = (k_dim + H_KS - 1) / H_KS;

  auto load = [&](int s, int buf) {
    const int k0 = s * H_KS;
#pragma unroll
    for (int e = tid; e < 16 * MT * (H_KS / H_CH); e += RT_THREADS) {  // A
      const int rr = e / (H_KS / H_CH);
      const int q = e % (H_KS / H_CH);
      const int r = r0 + rr;
      const bool ok = r < rows;
      stage16(a, any, k0 + H_CH * q, r, ok, ok ? r % t_len : 0, d, t_len,
              as + (buf * RT_M + rr) * H_AS + H_CH * q, run);
    }
    uint16_t* wb = ws + buf * RT_NMAX * H_AS;
    for (int e = tid; e < w_rows * (H_KS / H_CH); e += RT_THREADS) {
      const int n = e / (H_KS / H_CH);
      const int qq = e % (H_KS / H_CH);
      cp_async16(wb + n * H_AS + H_CH * qq, w + static_cast<size_t>(n) * k_pad + k0 + H_CH * qq,
                 true);
    }
  };

  // ldmatrix rows of this lane: A rows 0-7 / 8-15 of the warp's m16 tile at
  // k 0-7 / 8-15; W rows 0-7 of an n8 tile at k 0-7 (lanes 0-7, 16-23) or
  // 8-15 (lanes 8-15, 24-31)
  const int a_off = ((warp % MT) * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * H_AS +
                    (lane >> 4) * H_CH;
  const int b_off = (lane & 7) * H_AS + ((lane >> 3) & 1) * H_CH;

  __syncthreads();  // every warp is done with an earlier phase of the block
  if (n_stages > 0) {
    load(0, 0);
    cp_async_commit();
  }
  for (int s = 0; s < n_stages; ++s) {
    cp_async_wait_all();
    __syncthreads();  // stage s landed; every warp is done with stage s - 1
    if (s + 1 < n_stages) {
      load(s + 1, (s + 1) & 1);
      cp_async_commit();
    }
    const uint16_t* xa = as + (s & 1) * RT_M * H_AS + a_off;
    const uint16_t* wb = ws + (s & 1) * RT_NMAX * H_AS + b_off;
    const int live = min(H_KS / 16, (k_dim - s * H_KS + 15) / 16);
    float part[RT_NQ][NTU][4];
#pragma unroll
    for (int j = 0; j < RT_NQ; ++j)
#pragma unroll
      for (int t = 0; t < NTU; ++t)
#pragma unroll
        for (int i = 0; i < 4; ++i) part[j][t][i] = 0.f;
#pragma unroll
    for (int kb = 0; kb < H_KS / 16; ++kb) {
      if (kb < live) {
        uint32_t fa[4];
        ldmatrix_x4(fa, reinterpret_cast<const uint32_t*>(xa + kb * 16));
#pragma unroll
        for (int j = 0; j < RT_NQ; ++j) {
          if (j < nu) {
            if constexpr (NTU == 2) {
              uint32_t fb[4];
              const int tile = lane < 16 ? tiles[j][0] : tiles[j][1];
              ldmatrix_x4(fb, reinterpret_cast<const uint32_t*>(wb + tile * 8 * H_AS + kb * 16));
              mma_bf16(part[j][0], fa, fb[0], fb[1]);
              mma_bf16(part[j][1], fa, fb[2], fb[3]);
            } else {
              uint32_t fb[2];
              ldmatrix_x2(fb,
                          reinterpret_cast<const uint32_t*>(wb + tiles[j][0] * 8 * H_AS + kb * 16));
              mma_bf16(part[j][0], fa, fb[0], fb[1]);
            }
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

// out[col] = the f32 sum over the block's RT_M rows of v, this warp's C
// fragment values of the n8 tiles unit[j], j < nu (zero where there is no
// row), col = unit[j] * 8 + the fragment's column, for col < ncols.  A fixed
// order, the same bits every call: a thread's two rows, the warp's eight row
// pairs by shuffles (each lane ends with the same bits), then the RT_MT m16
// tiles in order through shared memory (RT_MT x CMAX floats over the stage
// buffers, after a barrier), added by the warps of m16 tile 0.
__device__ __forceinline__ void tile_col_sums(const float (&v)[RT_NQ][4], const int (&unit)[RT_NQ],
                                              int nu, unsigned char* smem, float* out, int ncols) {
  float* red = reinterpret_cast<float*>(smem);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int mt = warp % RT_MT;
  float s[RT_NQ][2];
#pragma unroll
  for (int j = 0; j < RT_NQ; ++j) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      float x = v[j][q] + v[j][q + 2];
      x += __shfl_xor_sync(0xffffffffu, x, 4);
      x += __shfl_xor_sync(0xffffffffu, x, 8);
      x += __shfl_xor_sync(0xffffffffu, x, 16);
      s[j][q] = x;
    }
  }
  __syncthreads();  // every warp is done with the shared memory that red overlays
  if (lane < 4) {
#pragma unroll
    for (int j = 0; j < RT_NQ; ++j)
      if (j < nu)
#pragma unroll
        for (int q = 0; q < 2; ++q) red[mt * CMAX + unit[j] * 8 + 2 * lane + q] = s[j][q];
  }
  __syncthreads();
  if (mt == 0 && lane < 4) {
#pragma unroll
    for (int j = 0; j < RT_NQ; ++j) {
      if (j >= nu) continue;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int col = unit[j] * 8 + 2 * lane + q;
        if (col >= ncols) continue;
        float t = red[col];
#pragma unroll
        for (int m = 1; m < RT_MT; ++m) t += red[m * CMAX + col];
        out[col] = t;
      }
    }
  }
}

// Layer i, first half (wn_layer_gz_kernel's arithmetic on bf16 operands): z
// = [taps of aud | x] @ [w_in[i]; w_cond_i], g_acts = [g_audio_{i+1} |
// g_skip] @ w_rs[i]^T, then g_z, written as its bf16 copy (two halves of Cp)
// with the f32 column sums of the tile, and acts as its bf16 copy.
// blockIdx.y deals the gate pairs, blockIdx.z is the run.
struct Gz16Args {
  Op16 a_z, a_grs;
  const uint16_t* planes;  // run 0's planes of layer i
  const float* b_z;        // run 0's b_z of layer i
  uint16_t* gz16;          // run 0's (R, 2Cp)
  uint16_t* acts16;        // run 0's (R, Cp)
  float* sums;             // run 0's tile sums of g_z (tiles, 2C)
  long long area_rs, sums_rs;  // a run's area in bf16 values and in floats
  const void* any;
  int rows, t_len, h, c, d, n_layers;
};

template <bool RUNS>
__global__ void __launch_bounds__(RT_THREADS, 1) wn_layer_gz16_kernel(Gz16Args p) {
  extern __shared__ float4 smem4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem4);
  const int r0 = blockIdx.x * RT_M;
  const int c = p.c;
  const WPlanes16 P = wplanes16(c, p.h);
  const int cp = P.cp;
  const int run = RUNS ? blockIdx.z : 0;  // RUNS = false: one run, its offsets fold away
  const uint16_t* planes = p.planes + run * p.area_rs;
  const float* b_z = p.b_z + static_cast<size_t>(run) * p.n_layers * 2 * c;
  int unit[RT_NQ];
  const int nu = rt_units(blockIdx.y, gridDim.y, cp / 8, unit);
  int pair[RT_NQ][2], one[RT_NQ][1];
#pragma unroll
  for (int j = 0; j < RT_NQ; ++j) {
    pair[j][0] = one[j][0] = unit[j];
    pair[j][1] = unit[j] + cp / 8;
  }
  float t_[RT_NQ][4], s_[RT_NQ][4];  // tanh and sigmoid of the z pairs
  {
    float z[RT_NQ][2][4];
#pragma unroll
    for (int j = 0; j < RT_NQ; ++j)
#pragma unroll
      for (int i = 0; i < 8; ++i) z[j][i >> 2][i & 3] = 0.f;
    rt16_phase<2>(z, p.a_z, planes + P.z, P.kz, 2 * cp, r0, p.rows, p.t_len, p.d, p.any, pair, nu,
                  smem, run);
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
  rt16_phase<1>(g, p.a_grs, planes + P.g, P.kg, cp, r0, p.rows, p.t_len, p.d, p.any, one, nu,
                smem, run);
  float za[RT_NQ][4], zb[RT_NQ][4];  // g_z's two halves, zero past the rows and in the padding
#pragma unroll
  for (int j = 0; j < RT_NQ; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool live = j < nu && r0 + frag_row(i) < p.rows && unit[j] * 8 + frag_col(i) < c;
      const float t = t_[j][i];
      const float s = s_[j][i];
      za[j][i] = live ? g[j][0][i] * s * (1.f - t * t) : 0.f;
      zb[j][i] = live ? g[j][0][i] * t * s * (1.f - s) : 0.f;
      t_[j][i] = live ? t * s : 0.f;  // acts
    }
  }
  uint16_t* gz16 = p.gz16 + run * p.area_rs;
  uint16_t* acts16 = p.acts16 + run * p.area_rs;
#pragma unroll
  for (int j = 0; j < RT_NQ; ++j) {
    if (j >= nu) continue;
#pragma unroll
    for (int i = 0; i < 4; i += 2) {  // elements i and i + 1: neighbouring columns of one row
      const int r = r0 + frag_row(i);
      const int col = unit[j] * 8 + frag_col(i);
      if (r >= p.rows) continue;
      const size_t o = static_cast<size_t>(r) * 2 * cp + col;
      *reinterpret_cast<uint32_t*>(gz16 + o) = pack_bf16(za[j][i], za[j][i + 1]);
      *reinterpret_cast<uint32_t*>(gz16 + o + cp) = pack_bf16(zb[j][i], zb[j][i + 1]);
      *reinterpret_cast<uint32_t*>(acts16 + static_cast<size_t>(r) * cp + col) =
          pack_bf16(t_[j][i], t_[j][i + 1]);
    }
  }
  float* sums = p.sums + run * p.sums_rs + static_cast<size_t>(blockIdx.x) * 2 * c;
  tile_col_sums(za, unit, nu, smem, sums, c);
  tile_col_sums(zb, unit, nu, smem, sums + c, c);
}

// Layer i, second half (wn_layer_ga_kernel's arithmetic on bf16 operands).
// Part blockIdx.y / ny == 0: g_audio_i = g_audio_{i+1} + [g_z[u+d] | g_z[u]
// | g_z[u-d]] @ w_in[i]^T, each tap masked at its source row, kept f32 and
// written as its bf16 copy with the f32 column sums of the tile.  Part 1 +
// j: g_x[:, jCMAX:(j+1)CMAX] += g_z @ w_cond_i^T.  blockIdx.y % ny deals the
// n8 tiles, blockIdx.z is the run.
struct Ga16Args {
  Op16 a_taps, a_gz;
  const uint16_t* planes;  // run 0's planes of layer i
  const float* ga_next;    // run 0's f32 g_audio_{i+1} (null in the top layer)
  float* ga_out;           // run 0's f32 g_audio_i; runs 2 R C apart (the ping-pong)
  uint16_t* ga16;          // run 0's bf16 copy of it (R, Cp)
  float* gx;
  float* sums;             // run 0's tile sums of g_audio_i (tiles, C)
  long long area_rs, sums_rs;
  const void* any;
  int rows, t_len, h, c, d, first, ny, n_layers;
};

template <bool RUNS>
__global__ void __launch_bounds__(RT_THREADS, 1) wn_layer_ga16_kernel(Ga16Args p) {
  extern __shared__ float4 smem4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem4);
  const int r0 = blockIdx.x * RT_M;
  const WPlanes16 P = wplanes16(p.c, p.h);
  const int run = RUNS ? blockIdx.z : 0;  // RUNS = false: one run, its offsets fold away
  const uint16_t* planes = p.planes + run * p.area_rs;
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
  if (part == 0) {
    rt16_phase<1>(acc, p.a_taps, planes + P.t, P.kt, P.cp, r0, p.rows, p.t_len, p.d, p.any, tile,
                  nu, smem, run);
  } else {
    rt16_phase<1>(acc, p.a_gz, planes + P.x + static_cast<size_t>(n0) * P.kc, P.kc, round8(nc), r0,
                  p.rows, p.t_len, p.d, p.any, tile, nu, smem, run);
  }
  if (part == 0) {
    const size_t rc2 = 2 * static_cast<size_t>(p.rows) * p.c;  // a run's g_audio ping-pong
    const float* ga_next = p.ga_next ? p.ga_next + run * rc2 : nullptr;
    float* ga_out = p.ga_out + run * rc2;
    uint16_t* ga16 = p.ga16 + run * p.area_rs;
    float v[RT_NQ][4];
#pragma unroll
    for (int j = 0; j < RT_NQ; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int u = r0 + frag_row(i);
        const int n = tile[j][0] * 8 + frag_col(i);
        v[j][i] = 0.f;
        if (j < nu && u < p.rows && n < p.c) {
          const size_t o = static_cast<size_t>(u) * p.c + n;
          v[j][i] = (ga_next ? ga_next[o] : 0.f) + acc[j][0][i];
          ga_out[o] = v[j][i];
        }
      }
    }
#pragma unroll
    for (int j = 0; j < RT_NQ; ++j) {
      if (j >= nu) continue;
#pragma unroll
      for (int i = 0; i < 4; i += 2) {
        const int u = r0 + frag_row(i);
        if (u < p.rows)
          *reinterpret_cast<uint32_t*>(ga16 + static_cast<size_t>(u) * P.cp + tile[j][0] * 8 +
                                       frag_col(i)) = pack_bf16(v[j][i], v[j][i + 1]);
      }
    }
    tile_col_sums(v, unit, nu, smem, p.sums + run * p.sums_rs + static_cast<size_t>(blockIdx.x) * p.c,
                  p.c);
  } else {
    float* gx = p.gx + static_cast<size_t>(run) * p.rows * p.h;
#pragma unroll
    for (int j = 0; j < RT_NQ; ++j) {
      if (j >= nu) continue;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int u = r0 + frag_row(i);
        const int n = tile[j][0] * 8 + frag_col(i);
        if (u >= p.rows || n >= nc) continue;
        const size_t o = static_cast<size_t>(u) * p.h + n0 + n;
        gx[o] = (p.first ? 0.f : gx[o]) + acc[j][0][i];
      }
    }
  }
}

// ------------------------------------------------- weight gradients ----

// P[s][k][n] = sum over the rows r of slice s of A(r, k) B(r, n), A and B
// bf16 operands of up to H_SEGS segments; out row a.cols of P[s] (the bias
// gradient) the sum of B's f32 tile column sums over the slice's tiles.
struct WGrad16 {
  Op16 a, b;
  const void* any;
  int rows, t_len, d, split_rows;
};

// One block a (64-column, 256-column) tile of P[s] in the padded columns of
// A and B, for slice s of run r (blockIdx.z = r * n_splits + s): 16 warps of
// 32 x 32 (2 x 4 mma tiles).  A stage copies H_RB rows of the tile's columns of
// both operands as they lie (16-byte cp.async, double-buffered, one barrier
// a stage), and ldmatrix .trans reads the mma fragments of A^T and B from
// those rows.  The epilogue writes P[s] in the real columns (the padding
// dropped); the blocks of column tile 0 add the bias row.
template <bool RUNS>
__global__ void __launch_bounds__(WG_THREADS, 1)
wgrad16_kernel(WGrad16 p, float* __restrict__ partial) {
  extern __shared__ float4 smem4[];
  uint16_t* const raw = reinterpret_cast<uint16_t*>(smem4);
  auto as_ = [&](int buf) { return raw + buf * H_RB * (H_WAS + H_WBS); };
  auto bs_ = [&](int buf) { return as_(buf) + H_RB * H_WAS; };

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int k0 = blockIdx.x * WG_KT;
  const int n0 = blockIdx.y * WG_NT;
  const int nsplit = (p.rows + p.split_rows - 1) / p.split_rows;
  const int run = RUNS ? blockIdx.z / nsplit : 0;  // RUNS = false: one run, its offsets fold away
  const int rs = (blockIdx.z - run * nsplit) * p.split_rows;
  const int re = min(rs + p.split_rows, p.rows);
  const int n_stages = (re - rs + H_RB - 1) / H_RB;
  const int wm0 = (warp & 1) * 32;
  const int wn0 = (warp >> 1) * 32;
  // mma tiles past the operands' padded columns are not issued (warp-uniform)
  const int m_live = min(2, max(0, (p.a.pcols - k0 - wm0 + 15) / 16));
  const int n_live = min(4, max(0, (p.b.pcols - n0 - wn0 + 7) / 8));

  auto load = [&](int s, int buf) {
    const int rb = rs + s * H_RB;
#pragma unroll
    for (int e = tid; e < H_RB * (WG_KT / H_CH); e += WG_THREADS) {  // A
      const int rr = e / (WG_KT / H_CH);
      const int q = e % (WG_KT / H_CH);
      const int r = rb + rr;
      const bool ok = r < re;
      stage16(p.a, p.any, k0 + H_CH * q, r, ok, ok ? r % p.t_len : 0, p.d, p.t_len,
              as_(buf) + rr * H_WAS + H_CH * q, run);
    }
#pragma unroll
    for (int i = 0; i < H_RB * (WG_NT / H_CH) / WG_THREADS; ++i) {  // B
      const int e = tid + i * WG_THREADS;
      const int rr = e / (WG_NT / H_CH);
      const int q = e % (WG_NT / H_CH);
      const int r = rb + rr;
      stage16(p.b, p.any, n0 + H_CH * q, r, r < re, 0, p.d, p.t_len,
              bs_(buf) + rr * H_WBS + H_CH * q, run);
    }
  };

  float acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
  // ldmatrix .trans rows (input rows of the stage) and columns of this lane:
  // A's matrices (k 0-7, r 0-7), (k 8-15, r 0-7), (k 0-7, r 8-15), (k 8-15,
  // r 8-15) of an m16 tile; B's (r 0-7), (r 8-15) of two n8 tiles
  const int a_off = ((lane >> 4) * 8 + (lane & 7)) * H_WAS + wm0 + ((lane >> 3) & 1) * 8;
  const int b_off = (((lane >> 3) & 1) * 8 + (lane & 7)) * H_WBS + wn0 + (lane >> 4) * 8;

  if (n_stages > 0) {
    load(0, 0);
    cp_async_commit();
  }
  for (int s = 0; s < n_stages; ++s) {
    cp_async_wait_all();
    __syncthreads();  // stage s landed; every warp is done with stage s - 1
    if (s + 1 < n_stages) {
      load(s + 1, (s + 1) & 1);
      cp_async_commit();
    }
    const uint16_t* xa = as_(s & 1) + a_off;
    const uint16_t* xb = bs_(s & 1) + b_off;
    float part[2][4][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) part[mt][nt][i] = 0.f;
#pragma unroll
    for (int kb = 0; kb < H_RB / 16; ++kb) {
      uint32_t fa[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        if (mt < m_live) ldmatrix_x4_trans(fa[mt], xa + kb * 16 * H_WAS + mt * 16);
#pragma unroll
      for (int np = 0; np < 2; ++np) {  // n8 tiles 2np and 2np + 1
        if (2 * np < n_live) {
          uint32_t fb[4];
          ldmatrix_x4_trans(fb, xb + kb * 16 * H_WBS + np * 16);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            if (mt < m_live) {
              mma_bf16(part[mt][2 * np], fa[mt], fb[0], fb[1]);
              if (2 * np + 1 < n_live) mma_bf16(part[mt][2 * np + 1], fa[mt], fb[2], fb[3]);
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

  float* out = partial + static_cast<size_t>(blockIdx.z) * (p.a.cols + 1) * p.b.cols;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  int seg = 0, off = 0;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int k = real_col(p.a, k0 + wm0 + mt * 16 + gid + half * 8, seg, off);
      if (k < 0) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int n = real_col(p.b, n0 + wn0 + nt * 8 + 2 * tig + q, seg, off);
          if (n >= 0) out[static_cast<size_t>(k) * p.b.cols + n] = acc[mt][nt][half * 2 + q];
        }
      }
    }
  }
  if (blockIdx.x != 0) return;
  // the bias row: B's tile sums over the slice's tiles, in order
  const int t0 = rs / H_TILE;
  const int t1 = (re + H_TILE - 1) / H_TILE;
  for (int e = tid; e < WG_NT; e += WG_THREADS) {
    const int n = real_col(p.b, n0 + e, seg, off);
    if (n < 0) continue;
    float sum = 0.f;
#pragma unroll
    for (int s = 0; s < H_SEGS; ++s) {
      if (s < p.b.nseg && s == seg && p.b.seg[s].sums) {
        const float* sp = p.b.seg[s].sums + run * p.b.seg[s].sums_rs + off;
        for (int t = t0; t < t1; ++t) sum += sp[static_cast<size_t>(t) * p.b.seg[s].sums_ld];
      }
    }
    out[static_cast<size_t>(p.a.cols) * p.b.cols + n] = sum;
  }
}

// --------------------------------------------------- the other passes ----

// The bf16 copies of the operands that the backward only multiplies, each
// rounded once: aud (runs, L, R, C) into each run's (L, R, Cp) and x (runs,
// R, H) into its (R, Hp), the padding zero.  A thread a 16-byte chunk of 8
// values, grid-stride.
__global__ void __launch_bounds__(NTHREADS)
bf16_copies_kernel(const float* __restrict__ aud, const float* __restrict__ x,
                   uint16_t* __restrict__ area, long long area_rs, size_t aud_off, size_t x_off,
                   int runs, int rows, int c, int h, int n_layers) {
  const int cq = round8(c) / H_CH;
  const int hq = round8(h) / H_CH;
  const long long lr = static_cast<long long>(n_layers) * rows;
  const long long aud_chunks = runs * lr * cq;
  const long long total = aud_chunks + static_cast<long long>(runs) * rows * hq;
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; e < total;
       e += static_cast<long long>(gridDim.x) * blockDim.x) {
    const float* src;
    uint16_t* dst;
    int w;
    if (e < aud_chunks) {
      const long long row = e / cq;  // run * L * R + layer * R + r
      const int q = static_cast<int>(e - row * cq);
      const long long run = row / lr;
      src = aud + row * c + H_CH * q;
      dst = area + run * area_rs + aud_off + (row - run * lr) * (cq * H_CH) + H_CH * q;
      w = c - H_CH * q;
    } else {
      const long long row = (e - aud_chunks) / hq;  // run * R + r
      const int q = static_cast<int>((e - aud_chunks) - row * hq);
      const long long run = row / rows;
      src = x + row * h + H_CH * q;
      dst = area + run * area_rs + x_off + (row - run * rows) * (hq * H_CH) + H_CH * q;
      w = h - H_CH * q;
    }
    uint32_t wd[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wd[j] = pack_bf16(2 * j < w ? src[2 * j] : 0.f, 2 * j + 1 < w ? src[2 * j + 1] : 0.f);
    *reinterpret_cast<uint4*>(dst) = make_uint4(wd[0], wd[1], wd[2], wd[3]);
  }
}

// W(k, col) of layer i's z product in the padded layout of its operand
// [aud[r-d] | aud[r] | aud[r+d] (Cp each) | x (Hp)]: k < 3Cp is tap k / Cp,
// channel k % Cp of w_in[i]; then channel k - 3Cp of w_cond[:, 2Ci:2C(i+1)];
// zero in the padding and for col = -1.  Both directions' planes take it.
__device__ __forceinline__ float z_weight16(const float* w_in, const float* w_cond, int c, int h,
                                            int cp, int n_layers, int i, int col, int k) {
  const int kr = k < 3 * cp ? (k % cp < c ? k / cp * c + k % cp : -1)
                            : (k - 3 * cp < h ? 3 * c + k - 3 * cp : -1);
  return kr < 0 ? 0.f : z_weight(w_in, w_cond, c, h, n_layers, i, col, kr);
}

// W(k, n) of every run and layer (blockIdx.z = run * L + layer) and matrix
// (blockIdx.y: z, g_acts, the transposed taps, the cond input gradient)
// rounded to bf16 into its plane, one block a plane row n (blockIdx.x), k in
// the padded layout of the operand it meets, zero in the padding and past W
// (pair_col maps a padded column of [a (Cp) | b (Cp)] to its real column):
//   z:      k < 3Cp: tap k / Cp, channel k % Cp of w_in[i]; then channel k -
//           3Cp of w_cond[:, 2Ci:2C(i+1)]; plane row n the gate-pair column
//   g_acts: W(k, n) = w_rs[i][n][pair_col(k)]
//   taps:   W(k, n) = w_in[i][k / 2Cp][n][pair_col(k % 2Cp)]
//   g_x:    W(k, n) = w_cond[n][2Ci + pair_col(k)]
__global__ void __launch_bounds__(NTHREADS)
wsplit16_kernel(const float* __restrict__ w_in, const float* __restrict__ w_cond,
                const float* __restrict__ w_rs, uint16_t* __restrict__ area, long long area_rs,
                int c, int h, int n_layers) {
  const int run = blockIdx.z / n_layers;
  const int i = blockIdx.z - run * n_layers;
  const int m = blockIdx.y;
  const int n = blockIdx.x;
  const WPlanes16 P = wplanes16(c, h);
  const int cp = P.cp;
  w_in += static_cast<size_t>(run) * n_layers * 3 * c * 2 * c;
  w_cond += static_cast<size_t>(run) * h * 2 * c * n_layers;
  w_rs += static_cast<size_t>(run) * n_layers * c * 2 * c;
  const int rows_m = m == 0 ? 2 * cp : m == 3 ? P.hp : cp;
  if (n >= rows_m) return;
  const int k_pad = m == 0 ? P.kz : m == 1 ? P.kg : m == 2 ? P.kt : P.kc;
  const size_t off = m == 0 ? P.z : m == 1 ? P.g : m == 2 ? P.t : P.x;
  uint32_t* row = reinterpret_cast<uint32_t*>(area + run * area_rs + i * P.layer + off +
                                              static_cast<size_t>(n) * k_pad);
  const int zcol = pair_col(n, c, cp);
  const size_t ldc = static_cast<size_t>(2 * c) * n_layers;
  auto weight = [&](int k) {
    if (m == 0) return z_weight16(w_in, w_cond, c, h, cp, n_layers, i, zcol, k);
    if (m == 1) {
      const int col = pair_col(k, c, cp);
      return n < c && col >= 0 ? w_rs[(static_cast<size_t>(i) * c + n) * 2 * c + col] : 0.f;
    }
    if (m == 2) {
      const int col = k < 6 * cp ? pair_col(k % (2 * cp), c, cp) : -1;
      return n < c && col >= 0
                 ? w_in[((static_cast<size_t>(i) * 3 + k / (2 * cp)) * c + n) * 2 * c + col]
                 : 0.f;
    }
    const int col = pair_col(k, c, cp);
    return n < h && col >= 0 ? w_cond[n * ldc + 2 * c * i + col] : 0.f;
  };
  for (int kk = threadIdx.x; kk < k_pad / 2; kk += NTHREADS)
    row[kk] = pack_bf16(weight(2 * kk), weight(2 * kk + 1));
}

// g_skip = g @ w_end^T of run blockIdx.z on bf16-rounded operands with f32
// sums (tile_gemm, as rowgemm_kernel<true>), n = C <= CMAX columns: written
// only as its bf16 copy (R, Cp), with the f32 column sums of the block's 64
// rows in a fixed order (a thread's rows, then the thread rows in order).
__global__ void __launch_bounds__(NTHREADS)
gskip16_kernel(const float* __restrict__ g, const float* __restrict__ w, uint16_t* __restrict__ out,
               float* __restrict__ sums, int rows, int k, int n, long long g_rs, long long w_rs,
               long long area_rs, long long sums_rs) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const long long run = blockIdx.z;
  g += run * g_rs;
  w += run * w_rs;
  out += run * area_rs;
  sums += run * sums_rs + static_cast<size_t>(blockIdx.x) * n;
  const int tx = threadIdx.x % NTX;
  const int ty = threadIdx.x / NTX;
  const int r0 = blockIdx.x * TR;
  const int np = round8(n);
  int col[CP];
#pragma unroll
  for (int q = 0; q < CP; ++q) col[q] = tx + NTX * q;
  float acc[RM][CP];
  zero(acc);
  tile_gemm<true>(acc, col, k, n, RowA{g, r0, rows, k}, RowW{w, n}, smem);
  float colsum[CP];
#pragma unroll
  for (int q = 0; q < CP; ++q) {
    colsum[q] = 0.f;
#pragma unroll
    for (int m = 0; m < RM; ++m) {
      const int r = r0 + ty * RM + m;
      const float v = r < rows && col[q] < n ? acc[m][q] : 0.f;
      colsum[q] += v;
      if (r < rows && col[q] < np)
        out[static_cast<size_t>(r) * np + col[q]] = __bfloat16_as_ushort(__float2bfloat16_rn(v));
    }
  }
  __syncthreads();  // every thread is done with tile_gemm's shared memory
#pragma unroll
  for (int q = 0; q < CP; ++q) smem[ty * CMAX + col[q]] = colsum[q];
  __syncthreads();
  if (ty == 0) {
#pragma unroll
    for (int q = 0; q < CP; ++q) {
      if (col[q] >= n) continue;
      float t = smem[col[q]];
      for (int y = 1; y < NTHREADS / NTX; ++y) t += smem[y * CMAX + col[q]];
      sums[col[q]] = t;
    }
  }
}

// ------------------------------------------------------------ launches ----

// The weight gradient of every run from bf16 operands: P of run r's slices
// at partial + r * n_splits * count, its sum at out + r * out_rs.
cudaError_t wgrad16(const WGrad16& p, float* partial, float* out, long long out_rs, int runs,
                    cudaStream_t stream) {
  const int nsplit = (p.rows + p.split_rows - 1) / p.split_rows;
  const dim3 grid((p.a.pcols + WG_KT - 1) / WG_KT, (p.b.pcols + WG_NT - 1) / WG_NT, runs * nsplit);
  // the one-run call takes the RUNS = false instance; the caller has set both
  // instances' shared memory
  auto kernel = runs > 1 ? wgrad16_kernel<true> : wgrad16_kernel<false>;
  kernel<<<grid, WG_THREADS, H_WG_SMEM, stream>>>(p, partial);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int count = (p.a.cols + 1) * p.b.cols;
  const int blocks = (count + NTHREADS - 1) / NTHREADS;
  reduce_partials_kernel<<<dim3(blocks, runs), NTHREADS, 0, stream>>>(partial, nsplit, count, out,
                                                                     out_rs);
  return cudaGetLastError();
}

// The backward of ``runs`` WNs on bf16 operands: wn_bwd_runs's contract with
// bf16 != 0 (wn_fused.cu says the layouts).  Scratch: ga (runs, 2, R, C) f32,
// the f32 g_audio ping-pong; partial as the f32 call's, with split_rows a
// multiple of 64; work = runs * wn_bwd_wsplit_words(rows, c, h, L, 1) words,
// each run's Area16.  6 + 6L kernel launches.
cudaError_t bwd16_runs(const float* x, const float* g, const float* aud, const float* w_cond,
                       const float* w_in, const float* b_z, const float* w_rs,
                       const float* w_start_t, const float* w_end_t, float* gx, float* g_in,
                       float* g_rs, float* g_start, float* ga, float* partial, void* work,
                       int runs, int rows, int t_len, int h, int c, int n_layers, int split_rows,
                       cudaStream_t stream) {
  const WPlanes16 P = wplanes16(c, h);
  const Area16 A = area16(rows, c, h, n_layers);
  const int cp = P.cp;
  uint16_t* const area = static_cast<uint16_t*>(work);
  float* const fl = static_cast<float*>(work);
  const long long area_rs = 2 * static_cast<long long>(A.words);  // bf16 values
  const long long sums_rs = static_cast<long long>(A.words);      // floats
  int sms = 0;
  cudaError_t e = current_sms(sms);
  if (e != cudaSuccess) return e;
  const long long chunks = static_cast<long long>(runs) * rows *
                           (static_cast<long long>(n_layers) * cp + P.hp) / H_CH;
  const long long want = (chunks + NTHREADS - 1) / NTHREADS;
  const int copy_blocks = static_cast<int>(want < 16LL * sms ? want : 16LL * sms);
  bf16_copies_kernel<<<copy_blocks, NTHREADS, 0, stream>>>(aud, x, area, area_rs, A.aud, A.x, runs,
                                                           rows, c, h, n_layers);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  wsplit16_kernel<<<dim3(max(2 * cp, P.hp), 4, runs * n_layers), NTHREADS, 0, stream>>>(
      w_in, w_cond, w_rs, area, area_rs, c, h, n_layers);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  e = allow_smem(gskip16_kernel, GEMM_SMEM);
  if (e != cudaSuccess) return e;
  gskip16_kernel<<<dim3(tiles(rows), 1, runs), NTHREADS, GEMM_SMEM, stream>>>(
      g, w_end_t, area + A.gskip, fl + A.bps, rows, 2 * h, c, 2LL * rows * h, 2LL * h * c, area_rs,
      sums_rs);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  // the one-run call takes the RUNS = false instances (no run offsets)
  auto gz_kernel = runs > 1 ? wn_layer_gz16_kernel<true> : wn_layer_gz16_kernel<false>;
  auto ga_kernel = runs > 1 ? wn_layer_ga16_kernel<true> : wn_layer_ga16_kernel<false>;
  e = allow_smem(gz_kernel, H_RT_SMEM);
  if (e != cudaSuccess) return e;
  e = allow_smem(ga_kernel, H_RT_SMEM);
  if (e != cudaSuccess) return e;
  e = allow_smem(runs > 1 ? wgrad16_kernel<true> : wgrad16_kernel<false>, H_WG_SMEM);
  if (e != cudaSuccess) return e;
  // row tiles, and the share of column units a block takes, as the f32 call
  const int rt = (rows + RT_M - 1) / RT_M;
  int ny = 1;
  while (ny < 4 && rt * ny < sms) ny *= 2;
  const int k_in = 3 * c + h + 1;
  const long long rc = static_cast<long long>(rows) * c;
  const long long gin_rs = static_cast<long long>(n_layers) * k_in * 2 * c;
  const long long grs_rs = static_cast<long long>(n_layers) * (c + 1) * 2 * c;
  const uint16_t* const x16 = area + A.x;
  uint16_t* const gskip16 = area + A.gskip;
  uint16_t* const ga16 = area + A.ga;
  uint16_t* const gz16 = area + A.gz;
  uint16_t* const acts16 = area + A.acts;
  const Seg16 sk = with_sums(seg16(gskip16, cp, c, area_rs), fl + A.bps, c, sums_rs);
  const Seg16 za = with_sums(seg16(gz16, 2 * cp, c, area_rs), fl + A.bpz, 2 * c, sums_rs);
  const Seg16 zb = with_sums(seg16(gz16 + cp, 2 * cp, c, area_rs), fl + A.bpz + c, 2 * c, sums_rs);
  const Op16 a_gz = op16({za, zb});
  const float* ga_next = nullptr;
  for (int i = n_layers - 1; i >= 0; --i) {
    const int d = 1 << i;
    const uint16_t* aud_i = area + A.aud + static_cast<size_t>(i) * rows * cp;
    const uint16_t* planes_i = area + i * P.layer;
    float* ga_out = ga + (i % 2) * rc;
    const Op16 a_z = op16({seg16(aud_i, cp, c, area_rs, -d, kLo), seg16(aud_i, cp, c, area_rs),
                           seg16(aud_i, cp, c, area_rs, d, kHi), seg16(x16, P.hp, h, area_rs)});
    const Op16 g_rs_op =
        op16({with_sums(seg16(ga_next ? ga16 : nullptr, cp, c, area_rs), fl + A.bpa, c, sums_rs),
              sk});
    const Gz16Args gzp{a_z, g_rs_op, planes_i, b_z + static_cast<size_t>(i) * 2 * c, gz16, acts16,
                       fl + A.bpz, area_rs, sums_rs, x, rows, t_len, h, c, d, n_layers};
    gz_kernel<<<dim3(rt, ny, runs), RT_THREADS, H_RT_SMEM, stream>>>(gzp);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    const WGrad16 rs{op16({seg16(acts16, cp, c, area_rs)}), g_rs_op, x, rows, t_len, d, split_rows};
    e = wgrad16(rs, partial, g_rs + static_cast<size_t>(i) * (c + 1) * 2 * c, grs_rs, runs, stream);
    if (e != cudaSuccess) return e;
    const WGrad16 in{a_z, a_gz, x, rows, t_len, d, split_rows};
    e = wgrad16(in, partial, g_in + static_cast<size_t>(i) * k_in * 2 * c, gin_rs, runs, stream);
    if (e != cudaSuccess) return e;
    const Ga16Args gap{
        op16({shifted(za, d, kHi), shifted(zb, d, kHi), za, zb, shifted(za, -d, kLo),
              shifted(zb, -d, kLo)}),
        a_gz, planes_i, ga_next, ga_out, ga16, gx, fl + A.bpa, area_rs, sums_rs, x, rows, t_len, h,
        c, d, i == n_layers - 1, ny, n_layers};
    ga_kernel<<<dim3(rt, (1 + col_chunks(h)) * ny, runs), RT_THREADS, H_RT_SMEM, stream>>>(gap);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    ga_next = ga_out;
  }
  const WGrad16 st{op16({seg16(x16, P.hp, h, area_rs)}),
                   op16({with_sums(seg16(ga16, cp, c, area_rs), fl + A.bpa, c, sums_rs)}), x, rows,
                   t_len, 1, split_rows};
  e = wgrad16(st, partial, g_start, static_cast<long long>(h + 1) * c, runs, stream);
  if (e != cudaSuccess) return e;
  return rowgemm<true>(ga_next, 2 * rc, w_start_t, static_cast<long long>(c) * h, nullptr, 0, gx,
                       static_cast<long long>(rows) * h, rows, c, h, 1, runs, stream);
}

}  // namespace

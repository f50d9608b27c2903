// The WN forward on bf16 operands, for Hopper (sm_90a): wn_fwd_runs with
// bf16 != 0, the counterpart of the JAX package's _wn_fwd_kernel with
// bf16=True (feature_level_style_transfer_for_tsc_tpu/ops/wn_fused.py:164,
// its products through _dot, :83-87, under FLSTTSC_WN_MXU=bf16).  Every
// product rounds both operands to bf16 (to nearest, ties to even); the
// products are exact and the sums f32.  The biases, the gate, the tap masks,
// the residual chain and the skip sum stay f32 and never pass through a
// bf16 operand.  The outputs are the f32 forward's: y (R, 2H), aud (L, R, C)
// and skip (R, C), all f32.
//
// Bound: operations, at the dense BF16 tensor-core peak (989 TFLOP/s on an
// H100 SXM): about 1.9 MFLOP a row against about 4.6 KB a row written at
// the training shapes (n_half 25, C 120, 8 layers).
//
// Design (wn_fused.cu's f32 forward, on wn_bwd_bf16.cuh's bf16 pieces):
// * bf16 operand copies in the caller's scratch (FArea16), each written once
//   by the pass or epilogue that makes the value, each row padded with zeros
//   to Cp = C rounded up to 8 (Hp for x), so every row segment, the masked
//   taps included, is whole 16-byte chunks and stages by one cp.async each:
//   x by a pass at the start of a call (bf16_copies_kernel with no aud),
//   aud_0 by the start projection's epilogue (rowgemm, FP32 FMA on bf16
//   operands: under 1% of the FLOPs), aud_{i+1} by layer i's res/skip
//   epilogue beside the f32 aud it writes (a ping-pong of two copies: layer
//   i reads copy i % 2 at its halo rows and writes copy (i + 1) % 2 at its
//   own), acts by the gate's epilogue, skip by the last layer's epilogue.
//   Rounding once at write gives the bits of rounding at use.
// * bf16 weight planes once a call (wsplit16_fwd_kernel), laid out (output
//   column, reduction) with the reduction in the padded layout of the
//   operand each meets, a whole number of 128-deep stages: z in the
//   gate-pair layout of wn_bwd_bf16.cuh's z (z_weight16), res/skip in the
//   gate-pair layout of the f32 FPlanes (audio column j and skip column C + j
//   in one thread), the end projection (Ep, kr).  No lo plane.
// * One launch a layer (wn_layer_fwd16_kernel; the halo of +-2^i rows needs
//   the grid-wide barrier between layers): over a tile of 16 * MT rows with
//   16 warps, rt16_phase for z over [lo*aud[r-d] | aud[r] | hi*aud[r+d] |
//   x[r]] (gate pairs), the gate, rt16_phase for res/skip over the acts
//   tile, the f32 aud_next / skip epilogue and its bf16 copies; in the last
//   layer rt16_phase for the end projection over the skip tile, in passes of
//   RT_END_COLS columns.  A block reads its own rows' acts and skip back
//   (the phase's opening barrier orders the writes before the copies).
//   Native mma.sync.m16n8k16 bf16, 128-deep stages copied straight into
//   ldmatrix's layout (double-buffered, one barrier a stage, no rounding
//   pass), each stage summed into zeroed registers and added to the running
//   sum with one rounded f32 add (the tensor core's accumulate truncates).
// * Short series: the f32 forward's row-tile rule (fwd_row_tile): tiles of
//   64, 32 or 16 rows (MT 4, 2, 1) while the smaller tile still fills one
//   wave of a block an SM.
// * Runs ride on the grid's y axis with pointer offsets only: each run of a
//   run-axis call is the one-run call's bits, and a one-run call takes the
//   RUNS = false instances.
// * Launches: 3 + L a call (wn_fused.py global_kernels): the x copy, the
//   planes, the start projection, one a layer.

#pragma once

// Included by wn_fused.cu after wn_bwd_bf16.cuh, whose pieces it takes
// (H_* constants, Op16 / seg16 / stage16, rt16_phase, pack_bf16,
// bf16_copies_kernel, z_weight16), in the same anonymous namespace.

namespace {

// One layer's bf16 forward planes, in bf16 values, (rows, k) with k the
// padded reduction, a whole number of stages: z (2Cp, 3Cp + Hp) as
// WPlanes16's z, res/skip (2Cp, Cp); after every layer, once, the end
// projection (Ep, Cp), Ep = 2H rounded up to 8.
struct FPlanes16 {
  int cp, hp, ep, kz, kr;
  size_t z, rs, layer;
};
__host__ __device__ inline FPlanes16 fplanes16(int c, int h) {
  FPlanes16 p;
  p.cp = round8(c);
  p.hp = round8(h);
  p.ep = round8(2 * h);
  p.kz = round_h(3 * p.cp + p.hp);
  p.kr = round_h(p.cp);
  p.z = 0;
  p.rs = p.z + static_cast<size_t>(2 * p.cp) * p.kz;
  p.layer = p.rs + static_cast<size_t>(2 * p.cp) * p.kr;
  return p;
}

// One run's bf16 work area of the forward in the caller's wsplit scratch
// (wn_fwd_wsplit_words with bf16 gives its size; wn_fused.py
// fwd_wsplit_words mirrors it): bf16 values at these offsets (each a
// multiple of 8: 16-byte rows), the planes of every layer, the end
// projection's plane, x (R, Hp), the aud ping-pong (2, R, Cp), acts (R, Cp),
// skip (R, Cp).  A run's area is ``words`` 32-bit words (a multiple of 4),
// the runs one after the other.
struct FArea16 {
  size_t end, x, aud, acts, skip;  // bf16 values
  size_t words;
};
inline FArea16 farea16(int rows, int c, int h, int n_layers) {
  const FPlanes16 P = fplanes16(c, h);
  const size_t r = static_cast<size_t>(rows);
  FArea16 a;
  a.end = n_layers * P.layer;
  a.x = a.end + static_cast<size_t>(P.ep) * P.kr;
  a.aud = a.x + r * P.hp;
  a.acts = a.aud + 2 * r * P.cp;
  a.skip = a.acts + r * P.cp;
  a.words = (a.skip + r * P.cp + 7) / 8 * 4;
  return a;
}

// The forward's W(k, n) of every run and layer (blockIdx.z = run * L +
// layer) and matrix (blockIdx.y: z, res/skip, the run's end projection)
// rounded to bf16 into its plane, one block a plane row n (blockIdx.x), k in
// the padded layout of the operand it meets, zero in the padding and past W:
//   z:        z_weight16, plane row n the gate-pair column pair_col(n)
//   res/skip: W(k, n) = w_rs[i][k][pair_col(n)], k < C
//   end:      W(k, n) = w_end[k][n], k < C, n < 2H
__global__ void __launch_bounds__(NTHREADS)
wsplit16_fwd_kernel(const float* __restrict__ w_in, const float* __restrict__ w_cond,
                    const float* __restrict__ w_rs, const float* __restrict__ w_end,
                    uint16_t* __restrict__ area, long long area_rs, int c, int h, int n_layers) {
  const int run = blockIdx.z / n_layers;
  const int i = blockIdx.z - run * n_layers;
  const int m = blockIdx.y;
  const int n = blockIdx.x;
  const FPlanes16 P = fplanes16(c, h);
  w_in += static_cast<size_t>(run) * n_layers * 3 * c * 2 * c;
  w_cond += static_cast<size_t>(run) * h * 2 * c * n_layers;
  w_rs += static_cast<size_t>(run) * n_layers * c * 2 * c;
  w_end += static_cast<size_t>(run) * c * 2 * h;
  if (m == 2 && i > 0) return;
  const int rows_m = m == 2 ? P.ep : 2 * P.cp;
  if (n >= rows_m) return;
  const int k_pad = m == 0 ? P.kz : P.kr;
  const size_t off = m == 2 ? n_layers * P.layer : i * P.layer + (m == 0 ? P.z : P.rs);
  uint32_t* row = reinterpret_cast<uint32_t*>(area + run * area_rs + off +
                                              static_cast<size_t>(n) * k_pad);
  const int col = pair_col(n, c, P.cp);
  auto weight = [&](int k) {
    if (m == 0) return z_weight16(w_in, w_cond, c, h, P.cp, n_layers, i, col, k);
    if (m == 1) return col >= 0 && k < c ? w_rs[(static_cast<size_t>(i) * c + k) * 2 * c + col] : 0.f;
    return n < 2 * h && k < c ? w_end[static_cast<size_t>(k) * 2 * h + n] : 0.f;
  };
  for (int kk = threadIdx.x; kk < k_pad / 2; kk += NTHREADS)
    row[kk] = pack_bf16(weight(2 * kk), weight(2 * kk + 1));
}

// One forward layer on bf16 operands over a tile of 16 * MT rows
// (wn_layer_fwd_kernel's arithmetic): z = [taps of aud_i | x] @ [w_in[i];
// w_cond_i] + b_z, acts = tanh(z[:, :C]) * sigmoid(z[:, C:]) written as its
// bf16 copy; rs = acts @ w_rs[i]: aud_next = aud_i + (rs[:, :C] + b_rs) and
// skip (+)= rs[:, C:] + b_rs in f32 with the bf16 copy of aud_next (and, in
// the last layer, of skip); in the last layer y = skip @ w_end + b_end.
// blockIdx.y is the run: the pointers are run 0's, every run's own offset
// by its share (f32 tensors by their run strides, the work area by
// area_rs).
struct Fwd16Args {
  Op16 a_z, a_acts, a_skip;
  const uint16_t* planes;      // run 0's planes of layer i
  const uint16_t* end_planes;  // run 0's end projection plane
  const float* aud_i;          // run 0's f32 aud_i; runs L R C apart
  const float* b_z;            // run 0's of layer i; runs 2 L C apart
  const float* b_rs;
  const float* b_end;
  float* aud_next;      // run 0's f32 aud_{i+1}, null in the last layer
  uint16_t* aud16_next;  // its bf16 copy (R, Cp), null in the last layer
  uint16_t* acts16;     // (R, Cp)
  uint16_t* skip16;     // (R, Cp), written in the last layer
  float* skip;
  float* y;
  long long area_rs;  // a run's work area in bf16 values
  const void* any;
  int rows, t_len, h, c, d, first, last, n_layers;
};

template <int MT, bool RUNS>
__global__ void __launch_bounds__(RT_THREADS, 1) wn_layer_fwd16_kernel(Fwd16Args p) {
  extern __shared__ float4 smem4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem4);
  const int r0 = blockIdx.x * 16 * MT;
  const int c = p.c;
  const FPlanes16 P = fplanes16(c, p.h);
  const int cp = P.cp;
  const int run = RUNS ? blockIdx.y : 0;  // RUNS = false: one run, its offsets fold away
  const size_t rc = static_cast<size_t>(p.rows) * c;
  const uint16_t* planes = p.planes + run * p.area_rs;
  int unit[RT_NQ], pair[RT_NQ][2];
  const int nu = rt_units<MT>(0, 1, cp / 8, unit);
#pragma unroll
  for (int j = 0; j < RT_NQ; ++j) {
    pair[j][0] = unit[j];
    pair[j][1] = unit[j] + cp / 8;
  }
  {
    float z[RT_NQ][2][4];
#pragma unroll
    for (int j = 0; j < RT_NQ; ++j)
#pragma unroll
      for (int i = 0; i < 8; ++i) z[j][i >> 2][i & 3] = 0.f;
    rt16_phase<2, MT>(z, p.a_z, planes + P.z, P.kz, 2 * cp, r0, p.rows, p.t_len, p.d, p.any, pair,
                      nu, smem, run);
    const float* b_z = p.b_z + static_cast<size_t>(run) * p.n_layers * 2 * c;
    uint16_t* acts16 = p.acts16 + run * p.area_rs;
    // the biases of this thread's two columns a unit, loaded together before
    // any store (one round trip, not one a value)
    float bz[RT_NQ][2][2];
#pragma unroll
    for (int j = 0; j < RT_NQ; ++j) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int col = unit[j] * 8 + frag_col(q);
        const bool live = j < nu && col < c;
        bz[j][0][q] = live ? b_z[col] : 0.f;
        bz[j][1][q] = live ? b_z[c + col] : 0.f;
      }
    }
#pragma unroll
    for (int j = 0; j < RT_NQ; ++j) {
      if (j >= nu) continue;
#pragma unroll
      for (int i = 0; i < 4; i += 2) {  // elements i and i + 1: neighbouring columns of one row
        const int r = r0 + frag_row<MT>(i);
        if (r >= p.rows) continue;
        float a[2];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int col = unit[j] * 8 + frag_col(i + q);
          a[q] = col < c ? tanhf(z[j][0][i + q] + bz[j][0][q]) * sigmoidf_(z[j][1][i + q] + bz[j][1][q])
                         : 0.f;
        }
        *reinterpret_cast<uint32_t*>(acts16 + static_cast<size_t>(r) * cp + unit[j] * 8 +
                                     frag_col(i)) = pack_bf16(a[0], a[1]);
      }
    }
  }
  {
    float rs[RT_NQ][2][4];
#pragma unroll
    for (int j = 0; j < RT_NQ; ++j)
#pragma unroll
      for (int i = 0; i < 8; ++i) rs[j][i >> 2][i & 3] = 0.f;
    rt16_phase<2, MT>(rs, p.a_acts, planes + P.rs, P.kr, 2 * cp, r0, p.rows, p.t_len, p.d, p.any,
                      pair, nu, smem, run);
    const float* b_rs = p.b_rs + static_cast<size_t>(run) * p.n_layers * 2 * c;
    const float* aud_i = p.aud_i + run * p.n_layers * rc;
    float* aud_next = p.aud_next ? p.aud_next + run * p.n_layers * rc : nullptr;
    uint16_t* aud16_next = p.aud16_next ? p.aud16_next + run * p.area_rs : nullptr;
    uint16_t* skip16 = p.skip16 + run * p.area_rs;
    float* skip = p.skip + run * rc;
    // every f32 value the epilogue reads (aud_i, the running skip, the
    // biases), two units at a time, loaded together before their stores: one
    // round trip for them, not one a value; zero past the rows and in the
    // padding
#pragma unroll
    for (int j0 = 0; j0 < RT_NQ; j0 += 2) {
      float an[2][4], sk[2][4], br[2][2][2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int j = j0 + u;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = r0 + frag_row<MT>(i);
          const int col = unit[j] * 8 + frag_col(i);
          const bool live = j < nu && r < p.rows && col < c;
          const size_t o = static_cast<size_t>(r) * c + col;
          an[u][i] = live && aud_next ? aud_i[o] : 0.f;
          sk[u][i] = live && !p.first ? skip[o] : 0.f;
        }
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int col = unit[j] * 8 + frag_col(q);
          const bool live = j < nu && col < c;
          br[u][0][q] = live ? b_rs[col] : 0.f;
          br[u][1][q] = live ? b_rs[c + col] : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int j = j0 + u;
        if (j >= nu) continue;
#pragma unroll
        for (int i = 0; i < 4; i += 2) {  // elements i and i + 1: neighbouring columns of one row
          const int r = r0 + frag_row<MT>(i);
          if (r >= p.rows) continue;
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int col = unit[j] * 8 + frag_col(i + q);
            if (col >= c) continue;
            const size_t o = static_cast<size_t>(r) * c + col;
            an[u][i + q] += rs[j][0][i + q] + br[u][0][q];
            sk[u][i + q] += rs[j][1][i + q] + br[u][1][q];
            if (aud_next) aud_next[o] = an[u][i + q];
            skip[o] = sk[u][i + q];
          }
          const size_t o16 = static_cast<size_t>(r) * cp + unit[j] * 8 + frag_col(i);
          if (aud16_next)
            *reinterpret_cast<uint32_t*>(aud16_next + o16) = pack_bf16(an[u][i], an[u][i + 1]);
          if (p.last)
            *reinterpret_cast<uint32_t*>(skip16 + o16) = pack_bf16(sk[u][i], sk[u][i + 1]);
        }
      }
    }
  }
  if (!p.last) return;
  const uint16_t* end_planes = p.end_planes + run * p.area_rs;
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
    rt16_phase<1, MT>(e, p.a_skip, end_planes + static_cast<size_t>(n0) * P.kr, P.kr, round8(nc),
                      r0, p.rows, p.t_len, p.d, p.any, tile, ne, smem, run);
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

// ------------------------------------------------------------ launches ----

// The forward of ``runs`` WNs on bf16 operands: wn_fwd_runs's contract with
// bf16 != 0 (wn_fused.cu says the layouts); work = runs *
// wn_fwd_wsplit_words(rows, c, h, L, 1) words, each run's FArea16.  3 + L
// kernel launches.
cudaError_t fwd16_runs(const float* x, const float* w_start, const float* b_start,
                       const float* w_cond, const float* b_z, const float* w_in, const float* w_rs,
                       const float* b_rs, const float* w_end, const float* b_end, float* y,
                       float* aud, float* skip, void* work, int runs, int rows, int t_len, int h,
                       int c, int n_layers, cudaStream_t stream) {
  const FPlanes16 P = fplanes16(c, h);
  const FArea16 A = farea16(rows, c, h, n_layers);
  const int cp = P.cp;
  uint16_t* const area = static_cast<uint16_t*>(work);
  const long long area_rs = 2 * static_cast<long long>(A.words);  // bf16 values
  int sms = 0;
  cudaError_t e = current_sms(sms);
  if (e != cudaSuccess) return e;
  const long long chunks = static_cast<long long>(runs) * rows * P.hp / H_CH;
  const long long want = (chunks + NTHREADS - 1) / NTHREADS;
  const int copy_blocks = static_cast<int>(want < 16LL * sms ? want : 16LL * sms);
  bf16_copies_kernel<<<copy_blocks, NTHREADS, 0, stream>>>(nullptr, x, area, area_rs, 0, A.x, runs,
                                                           rows, c, h, 0);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  wsplit16_fwd_kernel<<<dim3(max(2 * cp, P.ep), 3, runs * n_layers), NTHREADS, 0, stream>>>(
      w_in, w_cond, w_rs, w_end, area, area_rs, c, h, n_layers);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long rc = static_cast<long long>(rows) * c;
  const long long aud_rs = n_layers * rc;
  uint16_t* const aud16 = area + A.aud;  // the ping-pong: copy i % 2 holds aud_i
  e = rowgemm<true>(x, static_cast<long long>(rows) * h, w_start, static_cast<long long>(h) * c,
                    b_start, c, aud, aud_rs, rows, h, c, 0, runs, stream, aud16, area_rs);
  if (e != cudaSuccess) return e;
  int mt = 0;
  e = fwd_row_tile(rows, mt);
  if (e != cudaSuccess) return e;
  const bool many = runs > 1;
  auto kernel =
      mt == 4 ? (many ? wn_layer_fwd16_kernel<4, true> : wn_layer_fwd16_kernel<4, false>)
      : mt == 2 ? (many ? wn_layer_fwd16_kernel<2, true> : wn_layer_fwd16_kernel<2, false>)
                : (many ? wn_layer_fwd16_kernel<1, true> : wn_layer_fwd16_kernel<1, false>);
  e = allow_smem(kernel, H_RT_SMEM);
  if (e != cudaSuccess) return e;
  const int tiles_fwd = (rows + 16 * mt - 1) / (16 * mt);
  const uint16_t* const x16 = area + A.x;
  uint16_t* const acts16 = area + A.acts;
  uint16_t* const skip16 = area + A.skip;
  const size_t rcp = static_cast<size_t>(rows) * cp;
  for (int i = 0; i < n_layers; ++i) {
    const int d = 1 << i;
    const uint16_t* aud16_i = aud16 + (i % 2) * rcp;
    const bool last = i == n_layers - 1;
    const Fwd16Args p{
        op16({seg16(aud16_i, cp, c, area_rs, -d, kLo), seg16(aud16_i, cp, c, area_rs),
              seg16(aud16_i, cp, c, area_rs, d, kHi), seg16(x16, P.hp, h, area_rs)}),
        op16({seg16(acts16, cp, c, area_rs)}), op16({seg16(skip16, cp, c, area_rs)}),
        area + i * P.layer, area + A.end, aud + i * rc, b_z + static_cast<size_t>(i) * 2 * c,
        b_rs + static_cast<size_t>(i) * 2 * c, b_end, last ? nullptr : aud + (i + 1) * rc,
        last ? nullptr : aud16 + ((i + 1) % 2) * rcp, acts16, skip16, skip, y, area_rs, x, rows,
        t_len, h, c, d, i == 0, last, n_layers};
    kernel<<<dim3(tiles_fwd, runs), RT_THREADS, H_RT_SMEM, stream>>>(p);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

}  // namespace

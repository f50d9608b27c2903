// The tap GEMM shared by os_conv.cu and tap_conv.cu, for Hopper (sm_90a):
//
//     y[b, t, n] = sum_{j in window(n)} sum_i x_pad[b, t + j*d, i] * w[j, i, n],  t < t_out
//
// with x_pad (B, t_pad, C_in), w (K, C_in, C_out), y (B, t_out, C_out), all
// row-major float32, t_out = t_pad - (K-1)*d.  window(n) is the tap range
// [lo, hi) of n's group of 8 output columns; without windows every group
// takes all K taps.
//
// Bound: operations.  At the serving OS convs and the WN tap convs these are
// hundreds of operations per byte.  The results must stay exact-f32
// equivalent, so the ceiling is not the 67 TFLOP/s of the FP32 pipes but the
// tensor cores at f32 accuracy: 3xTF32, three TF32 products a term.
//
// Design, two kernel launches on one stream, no host sync between them:
// * prep_kernel reads w once, one block per (tap, 8 input channels), and
//   writes into the caller's scratch its TF32 split: hi = cvt.rna.tf32(v)
//   and lo = cvt.rna.tf32(v - hi), two planes laid out (K, C_in/8, C_out, 8)
//   with C_in padded to 8 and C_out to 64 by zeros, so the main kernel loads
//   them with unpredicated 16-byte cp.async and reads B fragments with
//   ldmatrix; for the OS conv also the tap window of each group of 8
//   columns, the span of taps at which any w[j, :, group] is nonzero
//   (ops/osconv.py:tap_windows_plain is its plain mirror), folded by atomics
//   into two arrays that one cudaMemsetAsync zeroes first.
// * tap_gemm_kernel: tensor cores through mma.sync.aligned.m16n8k8 (TF32
//   in, f32 accumulate); each product is lo*hi + hi*lo + hi*hi, small terms
//   first (the dropped lo*lo is below f32 rounding).  One-pass TF32 keeps
//   about 3 decimal digits; this keeps f32's.  Nothing here reads torch's
//   allow_tf32 switches.  The tensor core's accumulate truncates, and its
//   error grows with the number of mmas summed into one register (1.7-2.2e-8
//   of max|y| an mma, measured on an H100), so each stage sums into zeroed
//   registers that are added to the running sum with one rounded f32 add.
//   A non-finite input is not carried through as f32 would carry it (hi =
//   inf gives lo = NaN): the contract is for finite inputs.
// * runs: one call takes R independent convs of one shape (x_pad (R, B,
//   t_pad, C_in), w (R, K, C_in, C_out)); the prep grid's y and the main
//   grid's z (= run * B + b) carry the run, which offsets the weights, the
//   split, the windows and the epilogue vectors, nothing else.
// * one block per (TM time rows, TN output columns, batch element); warps
//   WM x WN x WK, each with a 32 x 32 tile (2 x 4 mma tiles).  WK > 1 splits
//   each stage's taps among warp groups, summed through shared memory at the
//   end: it fills the card where the grid is small (narrow or short-kernel
//   layers) without staging anything twice.
// * a stage is JG taps x KS input channels (KS a multiple of the mma's k, 8:
//   8 taps x 8 channels for long kernels, all taps x 16 channels for short
//   ones; launch_taps says why).  It stages the x rows [t0 + j0*d, t0 +
//   j0*d + TM + (jn-1)*d) of those channels once (cp.async, 16 bytes where
//   C_in and the base allow, 4 otherwise), splits each element once into hi
//   and lo planes in shared memory, and tap jj
//   reads them shifted by jj*d rows (for d = 1 one window serves all taps of
//   the stage); and w's split rows of the stage's taps and channels.  A and
//   B fragments come by ldmatrix (x rows padded by 4 words, w rows swizzled
//   by 16-byte halves: both conflict-free).  Double-buffered: the copies of
//   stage s+1 run while stage s splits and issues its mmas.  Ragged time and
//   channel edges are zero-filled on load (cp.async's src-size 0) and
//   ragged rows and columns masked on store.
// * dead taps: the block walks only the union of its column groups'
//   windows, a warp only the union of its own, and an mma tile only its
//   group's window.  Only products with an exact-zero weight are skipped,
//   so for finite x the sum is the dense one; the 0*inf terms of dead taps
//   are not formed (the plain version and the JAX kernel form them).
// * the epilogue (folded BatchNorm affine and optional ReLU) runs on the
//   accumulators before the one store.
// * bf16 (the OS conv of PipelineConfig.compute_dtype="bfloat16") is a kernel
//   of its own, tap_gemm_bf16.cuh: native bf16 m16n8k16 products on bf16
//   staging.  This header's kernels take float32 only.
//
// Why mma.sync and not wgmma: tap j's A operand is the staged x tile
// shifted by j*d rows, and wgmma's shared-memory descriptors need a base
// aligned to the swizzle atom, so a one-row shift breaks them unless every
// tap is restaged; and TF32 wgmma takes only K-major operands, while w[j] is
// N-major ((C_in, C_out) row-major).  Both can be solved (restage per tap
// with TMA, transpose w once per call): that is the next step.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "mma_tf32.cuh"

// Internal linkage: each library that includes this header (os_conv,
// tap_conv) keeps its own kernels and its own per-device caches below; as
// inline functions' statics they would be one object for the whole process.
namespace tap_gemm {
namespace {

using namespace tf32x3;  // split_tf32, mma_tf32, ldmatrix_x4, cp_async*

constexpr int MT = 2;       // m16 tiles per warp: 32 rows
constexpr int NT = 4;       // n8 tiles per warp: 32 columns
constexpr int KC = 8;       // the mma's k: channels a k-step, and the weights' chunk
constexpr int GROUP = 8;    // output columns per tap window
constexpr int PAD_N = 64;   // C_out padding of the split weights: a multiple of every TN
constexpr int THREADS = 256;
constexpr int MIN_BLOCKS = 2;  // blocks an SM
constexpr size_t kSmemCap = 110 * 1024;  // leaves room for two blocks an SM
// Stage shapes (launch_taps says why): taps x channels of a long kernel's
// stage, and the channels of a short one's (K <= 4).  Measured on an H100
// with experiments/conv_kernel_time.py (PERF.md): 8 taps beat 4 for the OS
// conv (2.14 against 2.56-2.59 ms a serving batch), 16 channels beat 8 for
// the tap conv (6.11 against 6.51 ms for a WN's 16 convs); a 3- or 4-deep
// copy ring beat double buffering in neither.
constexpr int LONG_JG = 8;
constexpr int SHORT_KS = 16;

enum Epilogue { kNone = 0, kAffine = 1, kAffineRelu = 2 };

__host__ __device__ inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

// 32-bit words of one run's split weights (two planes).
__host__ __device__ inline size_t split_words(int k, int c_in, int c_out) {
  return 2 * static_cast<size_t>(k) * round_up(c_in, KC) * round_up(c_out, PAD_N);
}

// 32-bit words of the caller's scratch for one run: the split weights, then
// 2 ints a column group for the windows (ops/osconv.py:_work mirrors it).
// With R runs the scratch is R times this: the R runs' split weights, then
// the R runs' windows, so one memset clears every window.
inline size_t work_words(int k, int c_in, int c_out) {
  return split_words(k, c_in, c_out) + 2 * static_cast<size_t>((c_out + GROUP - 1) / GROUP);
}

// Word of half h (k 0-3 or 4-7) of row n in a block of 8-word rows: the halves
// of rows n and n + 4 trade places, so ldmatrix's 8 rows hit 32 banks.
__device__ __forceinline__ int swizzled(int n, int h) { return n * 8 + ((h ^ (n >> 2)) & 1) * 4; }

// One block per (tap j, chunk of 8 input channels) and run (blockIdx.y: w,
// the split and the windows offset by the run's share), one thread per
// column n of the padded width: the thread reads w[j, chunk, n] (8 values, each warp
// reading 32 neighbouring columns) and writes their split as two 16-byte
// halves per plane.  With ``win`` (2 * n_groups ints, zeroed before the
// launch) it also folds j into the window of n's column group when any of
// its 8 weights is nonzero, as win[g] = max(K - j) and win[n_groups + g] =
// max(j + 1): the window is [K - win[g], win[n_groups + g]), empty (K, 0)
// for a group without a nonzero weight.
__global__ void __launch_bounds__(THREADS)
prep_kernel(const float* __restrict__ w, int k, int c_in, int c_out,
            uint32_t* __restrict__ split, int* __restrict__ win) {
  const int c_in_pad = round_up(c_in, KC);
  const int c_out_pad = round_up(c_out, PAD_N);
  const size_t plane = static_cast<size_t>(k) * c_in_pad * c_out_pad;
  const int run = blockIdx.y;
  const size_t w0 = static_cast<size_t>(run) * k * c_in * c_out;
  split += run * split_words(k, c_in, c_out);
  if (win != nullptr) win += run * 2 * ((c_out + GROUP - 1) / GROUP);
  const int chunk = blockIdx.x;  // j * c_in_pad / KC + c
  const int j = chunk / (c_in_pad / KC);
  const int i0 = (chunk - j * (c_in_pad / KC)) * KC;
  for (int n0 = 0; n0 < c_out_pad; n0 += THREADS) {  // block-uniform
    const int n = n0 + threadIdx.x;
    bool live = false;
    if (n < c_out_pad) {
      uint32_t h[KC], l[KC];
#pragma unroll
      for (int q = 0; q < KC; ++q) {
        const int i = i0 + q;
        const float v =
            i < c_in && n < c_out ? w[w0 + (static_cast<size_t>(j) * c_in + i) * c_out + n] : 0.f;
        live |= v != 0.f;
        split_tf32(v, h[q], l[q]);
      }
      uint4* hi = reinterpret_cast<uint4*>(split + (static_cast<size_t>(chunk) * c_out_pad + n) * KC);
      uint4* lo = reinterpret_cast<uint4*>(split + plane + (static_cast<size_t>(chunk) * c_out_pad + n) * KC);
      hi[0] = make_uint4(h[0], h[1], h[2], h[3]);
      hi[1] = make_uint4(h[4], h[5], h[6], h[7]);
      lo[0] = make_uint4(l[0], l[1], l[2], l[3]);
      lo[1] = make_uint4(l[4], l[5], l[6], l[7]);
    }
    if (win == nullptr) continue;
    // one lane of each 8 columns folds the group's liveness into its window
    const unsigned any = __ballot_sync(0xffffffffu, live);
    const int lane = threadIdx.x & 31;
    if ((lane & 7) == 0 && (any >> lane & 0xffu) != 0 && n < c_out) {
      const int n_groups = (c_out + GROUP - 1) / GROUP;
      atomicMax(win + n / GROUP, k - j);
      atomicMax(win + n_groups + n / GROUP, j + 1);
    }
  }
}

// Window of column group g: [lo, hi), empty as lo >= hi.
__device__ __forceinline__ void group_window(const int* win, int g, int n_groups, int k, int& lo,
                                             int& hi) {
  if (g >= n_groups) {
    lo = k;
    hi = 0;
  } else if (win == nullptr) {
    lo = 0;
    hi = k;
  } else {
    lo = k - win[g];
    hi = win[n_groups + g];
  }
}

// Shared memory (words): two raw x buffers, the x hi and lo planes, two w
// buffers of hi and lo planes; the WK - 1 partial sums of the split-K
// reduction reuse it.
template <int WM, int WN, int WK, int KS>
__host__ __device__ inline size_t smem_words(int xrows, int jgs) {
  constexpr int TN = WN * NT * 8;
  const size_t stages = 4 * static_cast<size_t>(xrows) * (KS + 4) +
                        4 * static_cast<size_t>(jgs) * TN * KS;
  const size_t reduce = static_cast<size_t>(WK - 1) * WM * WN * 32 * MT * NT * 4;
  return stages > reduce ? stages : reduce;
}

// KS input channels a stage (a multiple of the mma's k, 8), JG taps.
// blockIdx.z = run * batch + b: x_pad and y hold the runs' batches one after
// the other, and the run picks its split weights, windows, scale and shift;
// a run's arithmetic is the one-run kernel's.
template <int WM, int WN, int WK, int JG, int KS>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
tap_gemm_kernel(const float* __restrict__ x_pad, const uint32_t* __restrict__ split,
                const int* __restrict__ win, const float* __restrict__ scale,
                const float* __restrict__ shift, int epilogue, float* __restrict__ y,
                int batch, int t_pad, int c_in, int k, int c_out, int d, int xrows, int jgs) {
  static_assert(WM * WN * WK * 32 == THREADS, "one warp a (WM, WN, WK) slot");
  static_assert(KS % KC == 0 && (KS == 8 || KS == 16 || KS == 32), "8, 16 or 32 channels");
  constexpr int TM = WM * MT * 16;
  constexpr int TN = WN * NT * 8;
  constexpr int XS = KS + 4;  // x row stride: ldmatrix's 8 rows hit 32 banks
  constexpr int KB = KS / KC;  // mma k-steps a tap
  extern __shared__ float4 smem4[];
  uint32_t* smem = reinterpret_cast<uint32_t*>(smem4);
  const int xwords = xrows * XS;
  const int wwords = jgs * TN * KS;  // one plane of one buffer
  uint32_t* const xh = smem + 2 * xwords;
  uint32_t* const xl = smem + 3 * xwords;
  auto x_raw = [&](int buf) { return reinterpret_cast<float*>(smem + buf * xwords); };
  auto w_hi = [&](int buf) { return smem + 4 * xwords + 2 * buf * wwords; };

  const int t_out = t_pad - (k - 1) * d;
  const int t0 = blockIdx.x * TM;
  const int n0 = blockIdx.y * TN;
  const int b = blockIdx.z;  // run * batch + the run's batch element
  const int run = b / batch;
  split += run * split_words(k, c_in, c_out);
  if (win != nullptr) win += run * 2 * ((c_out + GROUP - 1) / GROUP);
  if (epilogue != kNone) {
    scale += static_cast<size_t>(run) * c_out;
    shift += static_cast<size_t>(run) * c_out;
  }
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int wm = warp % WM;
  const int wn = (warp / WM) % WN;
  const int wk = warp / (WM * WN);
  const int wm0 = wm * MT * 16;
  const int wn0 = wn * NT * 8;
  const float* xb = x_pad + static_cast<size_t>(b) * t_pad * c_in;
  const int c_in_pad = round_up(c_in, KC);
  const int c_out_pad = round_up(c_out, PAD_N);
  const size_t plane = static_cast<size_t>(k) * c_in_pad * c_out_pad;

  // tap windows: the block's union, the warp's union, each mma tile's own
  const int n_groups = (c_out + GROUP - 1) / GROUP;
  int blo = k, bhi = 0;
#pragma unroll
  for (int g = 0; g < TN / GROUP; ++g) {
    int lo, hi;
    group_window(win, n0 / GROUP + g, n_groups, k, lo, hi);
    if (hi > lo) {
      blo = min(blo, lo);
      bhi = max(bhi, hi);
    }
  }
  int lo_nt[NT], hi_nt[NT];
  int wlo = k, whi = 0;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    group_window(win, (n0 + wn0) / GROUP + nt, n_groups, k, lo_nt[nt], hi_nt[nt]);
    if (hi_nt[nt] > lo_nt[nt]) {
      wlo = min(wlo, lo_nt[nt]);
      whi = max(whi, hi_nt[nt]);
    }
  }

  const int n_chunks = (c_in_pad + KS - 1) / KS;
  const int n_stages = bhi > blo ? (bhi - blo + JG - 1) / JG * n_chunks : 0;
  const bool x_vec = c_in % 4 == 0 && reinterpret_cast<uintptr_t>(x_pad) % 16 == 0;

  // stage s: taps [j0, j0 + jn), channels [c0, c0 + KS) of which kn k-steps exist
  auto stage = [&](int s, int& j0, int& jn, int& c0, int& kn) {
    const int g = s / n_chunks;
    c0 = (s - g * n_chunks) * KS;
    j0 = blo + g * JG;
    jn = min(JG, bhi - j0);
    kn = min(KB, (c_in_pad - c0) / KC);
  };
  auto load = [&](int s, int buf) {
    int j0, jn, c0, kn;
    stage(s, j0, jn, c0, kn);
    const int rows = TM + (jn - 1) * d;
    const int tb = t0 + j0 * d;  // time of staged row 0
    if (x_vec) {
      float* xs = x_raw(buf);
      for (int e = tid; e < rows * (KS / 4); e += THREADS) {
        const int r = e / (KS / 4);
        const int q = (e % (KS / 4)) * 4;
        const int t = tb + r;
        const bool ok = t < t_pad && c0 + q < c_in;
        cp_async16(xs + r * XS + q, ok ? xb + static_cast<size_t>(t) * c_in + c0 + q : xb, ok);
      }
    } else {
      float* xs = x_raw(buf);
      for (int e = tid; e < rows * KS; e += THREADS) {
        const int r = e / KS;
        const int q = e % KS;
        const int t = tb + r;
        const bool ok = t < t_pad && c0 + q < c_in;
        cp_async4(xs + r * XS + q, ok ? xb + static_cast<size_t>(t) * c_in + c0 + q : xb, ok);
      }
    }
    // w: per plane, tap and k-step, TN rows of 8
    // words: 2 * TN copies of 16 bytes
    const uint32_t* src =
        split + ((static_cast<size_t>(j0) * (c_in_pad / KC) + c0 / KC) * c_out_pad + n0) * KC;
    const size_t tap_stride = static_cast<size_t>(c_in_pad / KC) * c_out_pad * KC;
    uint32_t* ws = w_hi(buf);
    for (int e = tid; e < 2 * 2 * jn * kn * TN; e += THREADS) {
      const int h = e & 1;
      const int n = (e >> 1) % TN;
      const int blk = (e >> 1) / TN;  // (p * jn + jj) * kn + kb
      const int kb = blk % kn;
      const int pj = blk / kn;
      const int p = pj >= jn;
      const int jj = pj - p * jn;
      cp_async16(ws + p * wwords + (jj * KB + kb) * TN * KC + swizzled(n, h),
                 src + p * plane + jj * tap_stride + (static_cast<size_t>(kb) * c_out_pad + n) * KC +
                     h * 4,
                 true);
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
    }
  }

  // ldmatrix rows of this lane: A (x) rows of an m16 tile, B (w) rows of two n8 tiles
  const int a_row = wm0 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_col = (lane >> 4) * 4;
  const int b_row = wn0 + (lane >> 4) * 8 + (lane & 7);
  const int b_half = (lane >> 3) & 1;

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
    int j0, jn, c0, kn;
    stage(s, j0, jn, c0, kn);
    for (int e = tid; e < (TM + (jn - 1) * d) * KS; e += THREADS) {
      const int i = (e / KS) * XS + e % KS;
      split_tf32(x_raw(s & 1)[i], xh[i], xl[i]);
    }
    __syncthreads();  // the split x of stage s is in shared memory

    const uint32_t* wh = w_hi(s & 1);
    const uint32_t* wl = wh + wwords;
    float part[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) part[mt][nt][i] = 0.f;
      }
    }
#pragma unroll
    for (int jj0 = 0; jj0 < JG; jj0 += WK) {
      const int jj = jj0 + wk;  // this warp's split-K share of the stage's taps
      const int j = j0 + jj;
      if (jj < jn && j >= wlo && j < whi) {
#pragma unroll
        for (int kb = 0; kb < KB; ++kb) {
          if (KB == 1 || kb < kn) {  // a stage of one k-step has it
            uint32_t ah[MT][4], al[MT][4];
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              const int i = (a_row + mt * 16 + jj * d) * XS + kb * KC + a_col;
              ldmatrix_x4(ah[mt], xh + i);
              ldmatrix_x4(al[mt], xl + i);
            }
#pragma unroll
            for (int np = 0; np < NT / 2; ++np) {  // n8 tiles 2np and 2np + 1
              const bool live0 = j >= lo_nt[2 * np] && j < hi_nt[2 * np];
              const bool live1 = j >= lo_nt[2 * np + 1] && j < hi_nt[2 * np + 1];
              if (live0 || live1) {
                const int i = (jj * KB + kb) * TN * KC + swizzled(b_row + np * 16, b_half);
                uint32_t bh[4], bl[4];
                ldmatrix_x4(bh, wh + i);
                ldmatrix_x4(bl, wl + i);
#pragma unroll
                for (int mt = 0; mt < MT; ++mt) {
                  if (live0) {
                    mma_tf32(part[mt][2 * np], al[mt], bh[0], bh[1]);
                    mma_tf32(part[mt][2 * np], ah[mt], bl[0], bl[1]);
                    mma_tf32(part[mt][2 * np], ah[mt], bh[0], bh[1]);
                  }
                  if (live1) {
                    mma_tf32(part[mt][2 * np + 1], al[mt], bh[2], bh[3]);
                    mma_tf32(part[mt][2 * np + 1], ah[mt], bl[2], bl[3]);
                    mma_tf32(part[mt][2 * np + 1], ah[mt], bh[2], bh[3]);
                  }
                }
              }
            }
          }
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] += part[mt][nt][i];
      }
    }
  }

  if (WK > 1) {  // the split-K groups' sums, in a fixed order, into group 0
    float* red = reinterpret_cast<float*>(smem);
    constexpr int SLOT = MT * NT * 4 * 32;  // one warp's accumulators
    __syncthreads();  // every warp is done with the stage buffers
    if (wk > 0) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            red[((wk - 1) * WM * WN + wn * WM + wm) * SLOT + ((mt * NT + nt) * 4 + i) * 32 +
                lane] = acc[mt][nt][i];
        }
      }
    }
    __syncthreads();
    if (wk > 0) return;
    for (int g = 1; g < WK; ++g) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            acc[mt][nt][i] += red[((g - 1) * WM * WN + wn * WM + wm) * SLOT +
                                  ((mt * NT + nt) * 4 + i) * 32 + lane];
        }
      }
    }
  }

#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int col = n0 + wn0 + nt * 8 + tig * 2 + q;
      if (col >= c_out) continue;
      const bool affine = epilogue != kNone;
      const float sc = affine ? scale[col] : 1.f;
      const float sh = affine ? shift[col] : 0.f;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int t = t0 + wm0 + mt * 16 + gid + half * 8;
          if (t >= t_out) continue;
          float v = acc[mt][nt][half * 2 + q];
          if (affine) {
            v = v * sc + sh;
            if (epilogue == kAffineRelu) v = fmaxf(v, 0.f);
          }
          y[(static_cast<size_t>(b) * t_out + t) * c_out + col] = v;
        }
      }
    }
  }
}

// Device of the current context, and per device the number of SMs and the
// largest dynamic shared memory set for each kernel so far: read and set
// once, not at every call.
constexpr int kMaxDevices = 64;

inline cudaError_t current_sms(int& dev, int& sms) {
  static int cached[kMaxDevices] = {};
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

struct Call {
  const float* x_pad;
  const uint32_t* split;
  const int* win;
  const float* scale;
  const float* shift;
  int epilogue;
  float* y;
  int runs, batch, t_pad, c_in, k, c_out, d, dev;
  cudaStream_t stream;
};

template <int WM, int WN, int WK, int JG, int KS>
cudaError_t launch(const Call& c) {
  constexpr int TM = WM * MT * 16;
  constexpr int TN = WN * NT * 8;
  const int jgs = c.k < JG ? c.k : JG;
  const int xrows = TM + (jgs - 1) * c.d;
  const size_t smem = smem_words<WM, WN, WK, KS>(xrows, jgs) * 4;
  auto kernel = tap_gemm_kernel<WM, WN, WK, JG, KS>;
  static size_t opted_in[kMaxDevices] = {};
  if (smem > 48 * 1024 && (c.dev >= kMaxDevices || smem > opted_in[c.dev])) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    if (c.dev < kMaxDevices) opted_in[c.dev] = smem;
  }
  const int t_out = c.t_pad - (c.k - 1) * c.d;
  const dim3 grid((t_out + TM - 1) / TM, (c.c_out + TN - 1) / TN, c.runs * c.batch);
  kernel<<<grid, THREADS, smem, c.stream>>>(c.x_pad, c.split, c.win, c.scale, c.shift,
                                            c.epilogue, c.y, c.batch, c.t_pad, c.c_in, c.k,
                                            c.c_out, c.d, xrows, jgs);
  return cudaGetLastError();
}

// Taps and channels a stage: a stage must hold enough mma work to pay for
// its barriers and its x split.  Long kernels (the OS conv's K up to 89)
// take up to LONG_JG taps of 8 channels, which share one staged x window;
// short ones (the tap conv's K = 3, the OS conv's last K = 2) all their
// taps and SHORT_KS channels; one tap where a wide dilation's window would
// not fit in kSmemCap.
template <int WM, int WN, int WK>
cudaError_t launch_taps(const Call& c) {
  constexpr int TM = WM * MT * 16;
  const int jgs = c.k > 4 ? (c.k < LONG_JG ? c.k : LONG_JG) : c.k;
  const size_t smem = c.k > 4 ? smem_words<WM, WN, WK, KC>(TM + (jgs - 1) * c.d, jgs)
                              : smem_words<WM, WN, WK, SHORT_KS>(TM + (jgs - 1) * c.d, jgs);
  if (c.k == 1 || smem * 4 > kSmemCap) return launch<WM, WN, WK, 1, SHORT_KS>(c);
  if (c.k > 4) return launch<WM, WN, WK, LONG_JG, KC>(c);
  const int jg = c.k == 2 ? 2 : 4;
  if (jg == 2) return launch<WM, WN, WK, 2, SHORT_KS>(c);
  return launch<WM, WN, WK, 4, SHORT_KS>(c);
}

// y = the tap conv, windowed when ``with_windows``, of ``runs`` independent
// runs at once: x_pad (runs, batch, t_pad, c_in), w (runs, k, c_in, c_out),
// scale and shift (runs, c_out), y (runs, batch, t_out, c_out); two kernel
// launches (prep_kernel, tap_gemm_kernel) on ``stream``, after one memset of
// the windows, whatever the number of runs.  ``work`` is the caller's
// scratch of runs * work_words(k, c_in, c_out) 32-bit words.  Tiles, all of
// 8 warps: 128 x 64 where one run's grid fills two blocks an SM; else 64 x
// 64 with two split-K groups; narrow outputs (C_out <= 32) 64 x 32 with
// four.  The tiles are chosen from one run's batch, so each run of a
// many-run call takes the one-run call's tiles and gives its bits.
inline cudaError_t run(const float* x_pad, const float* w, void* work, bool with_windows,
                       const float* scale, const float* shift, int epilogue, float* y, int runs,
                       int batch, int t_pad, int c_in, int k, int c_out, int d,
                       cudaStream_t stream) {
  if (runs < 1 || batch < 1 || static_cast<long>(runs) * batch > 65535 || k < 1 || d < 1 ||
      c_in < 1 || c_out < 1 || t_pad - (k - 1) * d < 1)
    return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t e = current_sms(dev, sms);
  if (e != cudaSuccess) return e;
  uint32_t* split = static_cast<uint32_t*>(work);
  const int n_groups = (c_out + GROUP - 1) / GROUP;
  int* win = nullptr;
  if (with_windows) {
    win = reinterpret_cast<int*>(split + runs * split_words(k, c_in, c_out));
    e = cudaMemsetAsync(win, 0, static_cast<size_t>(runs) * 2 * n_groups * sizeof(int), stream);
    if (e != cudaSuccess) return e;
  }
  prep_kernel<<<dim3(k * (round_up(c_in, KC) / KC), runs), THREADS, 0, stream>>>(
      w, k, c_in, c_out, split, win);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const Call c{x_pad, split, win, scale, shift, epilogue, y, runs, batch, t_pad, c_in, k, c_out,
               d, dev, stream};
  const int t_out = t_pad - (k - 1) * d;
  if (c_out <= 32) return launch_taps<2, 1, 4>(c);
  const long wide_blocks = static_cast<long>((t_out + 127) / 128) * ((c_out + 63) / 64) * batch;
  if (wide_blocks >= static_cast<long>(MIN_BLOCKS) * sms) return launch_taps<4, 2, 1>(c);
  return launch_taps<2, 2, 2>(c);
}

}  // namespace
}  // namespace tap_gemm

// The OS conv's tap GEMM on bf16 operands, for Hopper (sm_90a):
//
//     y[b, t, n] = bf16( sum_{j in window(n)} sum_i x_pad[b, t + j, i] * w[j, i, n] ),  t < t_out
//
// with x_pad (B, t_pad, C_in), w (K, C_in, C_out) and y (B, t_out, C_out)
// row-major bf16, t_out = t_pad - K + 1: the counterpart of the JAX package's
// bf16 conv under PipelineConfig.compute_dtype="bfloat16" (lax.conv on bf16
// operands with a bf16 output, ops/osconv.py:125-135, reached from _conv_core,
// :356-366).  Each product is exact (bf16 times bf16 fits in f32), the sums
// are f32, the output is rounded to bf16 (nearest, ties to even) once, at the
// store.  window(n) is the tap window of n's group of 8 output columns, found
// by the prep kernel as in tap_gemm.cuh, and dead taps are skipped per group.
//
// Bound: operations, at the dense BF16 tensor-core peak (989 TFLOP/s on an
// H100 SXM): the serving convs do hundreds of operations per byte.
//
// Design, two kernel launches after one memset of the windows, whatever the
// number of runs (run on the prep grid's y and the main grid's z, pointer
// offsets only, as tap_gemm.cuh):
// * prep_bf16_kernel writes w once a call as bf16 "chunks": a chunk is 8
//   input channels of one tap, C_in padded to 8, laid out (K, C_in/8, C_out
//   padded to 64, 8), so a chunk's row for column n is 16 bytes, the k-pairs
//   packed into 32-bit words as the mma's B fragment wants them; and the tap
//   windows (2 ints a column group, zeroed by the memset).
// * tap_gemm_bf16_kernel: mma.sync.aligned.m16n8k16 with bf16 operands and
//   f32 accumulators.  A k-step of 16 is two chunks, so the reduction over
//   (tap, channel) runs chunk by chunk in tap-major order: with C_in = 25
//   four chunks a tap (C_in padded to 32), with C_in = 7 one (two taps a
//   k-step, so a thin first layer pads to 8 channels, not to 16).  Each
//   lane gives ldmatrix its own row address, so the A fragment's two halves
//   may come from two taps, each shifted by its own j rows.
// * x is staged once a block for all of the block's taps (a "window": its
//   TM + taps rows of up to 64 channels; wider C_in or longer kernels are cut
//   into several windows, each staged once).  Every copy is a 16-byte
//   cp.async of the 16-byte granules that hold a row's channels, whatever
//   C_in: no serving layer has C_in a multiple of 8 (7, 25, 225, 50), and
//   cp.async copies no fewer than 4 aligned bytes.  One pass in shared memory
//   then moves each row's channels into 16-byte units (a funnel shift of two
//   words a channel pair; channels past C_in and rows past t_pad zero), unit
//   row * n_ch + chunk for a window of n_ch chunks, so that the A rows of the
//   window's chunk p for output row m sit at unit m * n_ch + p: linear in p,
//   no table and no division in the k-step loop.  An XOR swizzle of the
//   unit's low bits puts ldmatrix's 8 rows on 32 banks for every n_ch.  The
//   pass runs once a window, not once a stage.
// * the weights stream through two 32 KB stages of cp.async copies (32
//   chunks of 64 columns, or 64 of 32), the next stage's in flight while
//   this one is read, one __syncthreads a stage; a window's first stage
//   adds its x copy to the stage's copy group, and the pass and one more
//   __syncthreads.  A ring of three 16 KB stages keeps as many bytes in
//   flight with twice the barriers, and was slower on an H100.  Each stage sums into zeroed registers
//   added to the running sum with one rounded f32 add (tap_gemm.cuh says
//   why).
// * dead taps: the block walks only the union of its column groups' windows,
//   a warp only the k-steps that reach its own union and an mma tile (8
//   columns) only those that reach its group's window, each a range of
//   k-steps computed once a stage.  A k-step that straddles a window's edge
//   multiplies x by the exact-zero weights outside it: for finite x the sum
//   is the dense one (the contract is for finite inputs).
// * tiles as tap_gemm.cuh's, 8 warps of 32 x 32 (2 x 4 mma tiles): 128 x 64
//   where one run's grid fills two blocks an SM, else 64 x 64 with two
//   split-K groups, narrow outputs (C_out <= 32) 64 x 32 with four; a block
//   takes 71-100 KB of shared memory at the serving convs, so two share an
//   SM.  The column tiles run last first: the omni-scale mask gives the last
//   columns the widest windows, so the longest blocks start first.
// * the epilogue rounds the sums to bf16 into a tile in shared memory and
//   stores it a row at a time, consecutive threads on consecutive columns.
//
// Why mma.sync and not wgmma: as tap_gemm.cuh says, each tap's A operand is
// the staged window shifted by j rows, which breaks wgmma's swizzle-atom
// aligned descriptors unless each tap is restaged, and this kernel reads
// both halves of a k-step from two taps.  bf16 wgmma does take N-major B, so
// a per-tap TMA restage is what stands between this kernel and wgmma.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "mma_bf16.cuh"
#include "tap_gemm.cuh"

namespace tap_gemm {
namespace {

constexpr int CH = 8;                   // channels a chunk: one 16-byte row of bf16
constexpr int MAX_CS = 64;              // channels of a window
constexpr int RING = 2;                 // stages of the weight ring: double buffering
constexpr int STAGE_BYTES = 32 * 1024;  // one stage of the ring

// 32-bit words of one run's bf16 weight chunks.
__host__ __device__ inline size_t bf16_split_words(int k, int c_in, int c_out) {
  return static_cast<size_t>(k) * round_up(c_in, CH) * round_up(c_out, PAD_N) / 2;
}

// 32-bit words of the caller's scratch for one run: the chunks, then 2 ints
// a column group for the windows (ops/osconv.py:_work mirrors it).  R runs
// take R times this: the R runs' chunks, then the R runs' windows.
inline size_t bf16_work_words(int k, int c_in, int c_out) {
  return bf16_split_words(k, c_in, c_out) + 2 * static_cast<size_t>((c_out + GROUP - 1) / GROUP);
}

using bf16mma::cp_async16_n;  // shared with wn_bwd_bf16.cuh (mma_bf16.cuh)
using bf16mma::mma_bf16;

// One block per (tap j, chunk of 8 input channels) and run (blockIdx.y), one
// thread per column n of the padded width: the thread reads w[j, chunk, n]
// (8 values, each warp reading 32 neighbouring columns), writes them as one
// 16-byte row, and folds j into the window of n's column group when any of
// them is nonzero (prep_kernel of tap_gemm.cuh says how).
__global__ void __launch_bounds__(THREADS)
prep_bf16_kernel(const uint16_t* __restrict__ w, int k, int c_in, int c_out,
                 uint32_t* __restrict__ chunks, int* __restrict__ win) {
  const int n_chunks = round_up(c_in, CH) / CH;
  const int c_out_pad = round_up(c_out, PAD_N);
  const int n_groups = (c_out + GROUP - 1) / GROUP;
  const int run = blockIdx.y;
  w += static_cast<size_t>(run) * k * c_in * c_out;
  chunks += run * bf16_split_words(k, c_in, c_out);
  win += run * 2 * n_groups;
  const int chunk = blockIdx.x;  // j * n_chunks + c
  const int j = chunk / n_chunks;
  const int i0 = (chunk - j * n_chunks) * CH;
  for (int n0 = 0; n0 < c_out_pad; n0 += THREADS) {  // block-uniform
    const int n = n0 + threadIdx.x;
    bool live = false;
    if (n < c_out_pad) {
      uint32_t h[CH / 2];
#pragma unroll
      for (int q = 0; q < CH / 2; ++q) {
        uint32_t v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = i0 + 2 * q + e;
          v[e] = i < c_in && n < c_out ? w[(static_cast<size_t>(j) * c_in + i) * c_out + n] : 0u;
          live |= (v[e] & 0x7fffu) != 0;  // -0 is a zero
        }
        h[q] = v[0] | v[1] << 16;  // the lower k in the low half
      }
      *reinterpret_cast<uint4*>(chunks + (static_cast<size_t>(chunk) * c_out_pad + n) * (CH / 2)) =
          make_uint4(h[0], h[1], h[2], h[3]);
    }
    const unsigned any = __ballot_sync(0xffffffffu, live);
    const int lane = threadIdx.x & 31;
    if ((lane & 7) == 0 && (any >> lane & 0xffu) != 0 && n < c_out) {
      atomicMax(win + n / GROUP, k - j);
      atomicMax(win + n_groups + n / GROUP, j + 1);
    }
  }
}

// A window of the block's reduction: chunks [c0, c0 + n_ch) of each tap in
// [j0, j0 + taps), walked in tap-major order (``len`` chunks, in k-steps of
// two), in ``stages`` stages of the ring.
struct Window {
  int c0, n_ch, j0, taps, len, stages;
};

// 16-byte unit u of a staged window, where u = row * n_ch + chunk: the
// fragments' 8 rows of one chunk are n_ch units apart, which for an even
// n_ch would put them on the same banks; XOR-ing u's low 3 bits with the
// bits above n_ch's power of two spreads them over all 32 (odd n_ch: as
// they are).  Units stay inside their aligned group of 8.
__device__ __forceinline__ int swizzle(int u, int shift, int mask) {
  return u ^ ((u >> shift) & mask);
}

// blockIdx.z = run * batch + b, as tap_gemm_kernel.  ``cs`` channels and ``jw``
// taps a window at most, ``xrows`` = TM + jw rows of x staged.  One buffer
// holds a window's raw rows: the next window's copy is issued after the
// present one was unpacked (the ring copies one stage ahead).
template <int WM, int WN, int WK>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
tap_gemm_bf16_kernel(const uint16_t* __restrict__ x_pad, const uint32_t* __restrict__ chunks,
                     const int* __restrict__ win, uint16_t* __restrict__ y, int batch, int t_pad,
                     int c_in, int k, int c_out, int cs, int jw, int xrows, size_t x_elems) {
  static_assert(WM * WN * WK * 32 == THREADS, "one warp a (WM, WN, WK) slot");
  constexpr int TM = WM * MT * 16;
  constexpr int TN = WN * NT * 8;
  constexpr int PS = STAGE_BYTES / (TN * 16);  // chunks a stage
  constexpr int KSPS = PS / 2;                 // k-steps a stage
  static_assert(KSPS % WK == 0, "every split-K group the same k-steps");
  const int granules = cs / CH + 1;  // 16-byte granules of a raw row
  const int n_chunks = round_up(c_in, CH) / CH;
  const int c_out_pad = round_up(c_out, PAD_N);
  extern __shared__ float4 smem4[];
  unsigned char* const smem = reinterpret_cast<unsigned char*>(smem4);
  uint4* const xs = reinterpret_cast<uint4*>(smem + RING * STAGE_BYTES);  // 16-byte units
  unsigned char* const raw = reinterpret_cast<unsigned char*>(xs + round_up(xrows * (cs / CH), 8));

  const int t_out = t_pad - k + 1;
  const int t0 = blockIdx.x * TM;
  const int n0 = (gridDim.y - 1 - blockIdx.y) * TN;  // the wide windows of the last columns first
  const int b = blockIdx.z;  // run * batch + the run's batch element
  const int run = b / batch;
  chunks += run * bf16_split_words(k, c_in, c_out);
  win += run * 2 * ((c_out + GROUP - 1) / GROUP);
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
  const uint16_t* const xb = x_pad + static_cast<size_t>(b) * t_pad * c_in;
  const uintptr_t x_end = reinterpret_cast<uintptr_t>(x_pad + x_elems);

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

  // the windows: channel ranges of cs, each over tap ranges of jw
  const int span = bhi - blo;
  const int n_tw = span > 0 ? (span + jw - 1) / jw : 0;
  const int n_win = n_tw * ((n_chunks + cs / CH - 1) / (cs / CH));
  auto window = [&](int i) {
    Window w;
    const int tw = i % n_tw;
    w.c0 = i / n_tw * (cs / CH);
    w.n_ch = min(cs / CH, n_chunks - w.c0);
    w.j0 = blo + tw * jw;
    w.taps = min(jw, bhi - w.j0);
    w.len = w.taps * w.n_ch;
    w.stages = ((w.len + 1) / 2 + KSPS - 1) / KSPS;
    return w;
  };
  int n_stages = 0;
  for (int i = 0; i < n_win; ++i) n_stages += window(i).stages;

  // a cursor over the stages: window i (of ``stages`` stages), its stage s
  struct Cursor {
    int i, s, stages;
  };
  auto advance = [&](Cursor& c) {
    if (++c.s == c.stages) {
      c.s = 0;
      if (++c.i < n_win) c.stages = window(c.i).stages;
    }
  };
  // the address of row t's first channel of the window
  auto row_of = [&](int t, const Window& w) {
    return reinterpret_cast<uintptr_t>(xb + static_cast<size_t>(t) * c_in + w.c0 * CH);
  };

  auto load = [&](const Cursor& c, int buf) {
    const Window w = window(c.i);
    if (c.s == 0) {  // the window's x rows, as the 16-byte granules that hold them
      const int rows = TM + w.taps;  // one more than the taps need: a k-step's spare chunk
      const int valid = min(w.n_ch * CH, c_in - w.c0 * CH);
      for (int e = tid; e < rows * granules; e += THREADS) {
        const int r = e / granules;
        const int q = e - r * granules;
        const int t = t0 + w.j0 + r;
        if (t >= t_pad) continue;
        const uintptr_t a = row_of(t, w);
        if (q >= static_cast<int>(((a & 15) + 2 * valid + 15) >> 4)) continue;
        const uintptr_t src = (a & ~static_cast<uintptr_t>(15)) + 16 * q;
        const uintptr_t left = x_end - src;
        cp_async16_n(raw + (r * granules + q) * 16, reinterpret_cast<const void*>(src),
                     left < 16 ? static_cast<int>(left) : 16);
      }
    }
    // the stage's chunks [p0, p0 + PS) of the window, TN rows of 16 bytes each;
    // a k-step's spare chunk past the window (len odd) is zero-filled
    const int p0 = c.s * PS;
    const int n = min(PS, (w.len + 1) / 2 * 2 - p0);
    uint32_t* ws = reinterpret_cast<uint32_t*>(smem + buf * STAGE_BYTES);
    if (w.n_ch == n_chunks) {  // every channel: the window's chunk p is chunk j0 * n_chunks + p
      const uint32_t* src = chunks + (static_cast<size_t>(w.j0 * n_chunks + p0) * c_out_pad + n0) *
                                         (CH / 2);
      for (int e = tid; e < n * TN; e += THREADS) {
        const int pp = e / TN;
        const int col = e % TN;
        const bool ok = p0 + pp < w.len;
        cp_async16(ws + e * (CH / 2), ok ? src + (pp * c_out_pad + col) * (CH / 2) : chunks, ok);
      }
    } else {
      for (int e = tid; e < n * TN; e += THREADS) {
        const int pp = e / TN;
        const int col = e % TN;
        const int p = p0 + pp;
        const bool ok = p < w.len;
        const int tap = w.j0 + p / w.n_ch;
        const int ch = w.c0 + p % w.n_ch;
        cp_async16(ws + e * (CH / 2),
                   ok ? chunks + ((static_cast<size_t>(tap) * n_chunks + ch) * c_out_pad + n0 +
                                  col) * (CH / 2)
                      : chunks,
                   ok);
      }
    }
  };

  // a window's raw rows into its 16-byte units (unit row * n_ch + chunk, swizzled)
  auto unpack = [&](const Cursor& c) {
    const Window w = window(c.i);
    const int rows = TM + w.taps;
    const int valid = min(w.n_ch * CH, c_in - w.c0 * CH);
    const int words = w.n_ch * CH / 2;  // channel pairs a row
    const int shift = __ffs(w.n_ch) - 1, mask = w.n_ch & 1 ? 0 : 7;
    uint32_t* xw = reinterpret_cast<uint32_t*>(xs);
    for (int e = tid; e < rows * words; e += THREADS) {
      const int r = e / words;
      const int cw = e - r * words;
      const int t = t0 + w.j0 + r;
      uint32_t v = 0;
      if (t < t_pad && 2 * cw < valid) {
        const int el = static_cast<int>((row_of(t, w) & 15) >> 1) + 2 * cw;  // in the raw row
        const uint32_t* rw = reinterpret_cast<const uint32_t*>(raw + r * granules * 16);
        v = __byte_perm(rw[el >> 1], rw[(el >> 1) + 1], (el & 1) ? 0x5432 : 0x3210);
        if (2 * cw + 1 >= valid) v &= 0xffffu;
      }
      xw[swizzle(r * w.n_ch + (cw >> 2), shift, mask) * 4 + (cw & 3)] = v;
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

  // ldmatrix rows of this lane: A (x) rows 0-7 / 8-15 of an m16 tile, of
  // the k-step's first or second chunk; B (w) columns of two n8 tiles
  const int a_row = wm0 + ((lane >> 3) & 1) * 8 + (lane & 7);
  const int a_half = lane >> 4;
  const int b_col = wn0 + (lane >> 4) * 8 + (lane & 7);
  const int b_half = (lane >> 3) & 1;

  // the k-steps [a, b) of the window whose chunks reach taps [lo, hi)
  auto ksteps = [](const Window& w, int lo, int hi, int& a, int& b) {
    const int clo = min(max(lo - w.j0, 0) * w.n_ch, w.len);
    const int chi = min(max(hi - w.j0, 0) * w.n_ch, w.len);
    a = clo / 2;
    b = chi > clo ? (chi + 1) / 2 : a;
  };

  auto compute = [&](const Cursor& c, int buf) {
    const Window w = window(c.i);
    const uint16_t* ws = reinterpret_cast<const uint16_t*>(smem + buf * STAGE_BYTES);
    const int ks0 = c.s * KSPS;  // the stage's first k-step of the window
    int wa, wb, ta[NT], tb[NT];
    ksteps(w, wlo, whi, wa, wb);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) ksteps(w, lo_nt[nt], hi_nt[nt], ta[nt], tb[nt]);
    const int shift = __ffs(w.n_ch) - 1, mask = w.n_ch & 1 ? 0 : 7;
    const int u0 = a_row * w.n_ch + a_half;  // unit of this lane's A row and chunk at k-step 0
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
    for (int kk = 0; kk < KSPS; kk += WK) {
      const int ks = ks0 + kk + wk;  // this warp's split-K share of the stage's k-steps
      if (ks >= wa && ks < wb) {
        uint32_t a[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          ldmatrix_x4(a[mt], reinterpret_cast<const uint32_t*>(
                                 xs + swizzle(u0 + mt * 16 * w.n_ch + 2 * ks, shift, mask)));
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {  // n8 tiles 2np and 2np + 1
          const bool live0 = ks >= ta[2 * np] && ks < tb[2 * np];
          const bool live1 = ks >= ta[2 * np + 1] && ks < tb[2 * np + 1];
          if (live0 || live1) {
            uint32_t bf[4];
            ldmatrix_x4(bf, reinterpret_cast<const uint32_t*>(
                                ws + ((2 * (kk + wk) + b_half) * TN + b_col + np * 16) * CH));
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              if (live0) mma_bf16(part[mt][2 * np], a[mt], bf[0], bf[1]);
              if (live1) mma_bf16(part[mt][2 * np + 1], a[mt], bf[2], bf[3]);
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
  };

  // the ring: stage s + RING - 1 is copied while stage s is computed
  Cursor ld{0, 0, n_win > 0 ? window(0).stages : 0}, cur = ld;
  for (int s = 0; s < RING - 1; ++s) {
    if (s < n_stages) {
      load(ld, s);
      advance(ld);
    }
    cp_async_commit();
  }
  for (int s = 0; s < n_stages; ++s) {
    cp_async_wait_all();
    __syncthreads();  // stage s landed; every warp is done with stage s - 1
    if (cur.s == 0) {
      unpack(cur);
      __syncthreads();  // the window's rows are in shared memory
    }
    if (s + RING - 1 < n_stages) {
      load(ld, (s + RING - 1) % RING);
      advance(ld);
    }
    cp_async_commit();
    compute(cur, s % RING);
    advance(cur);
  }

  // the epilogue through shared memory: the split-K groups' sums in a fixed
  // order, the bf16 tile, then stores of consecutive columns
  constexpr int SLOT = MT * NT * 4 * 32;  // one warp's accumulators
  constexpr int RED = (WK - 1) * WM * WN * SLOT;
  constexpr int YS = TN + 8;  // bf16 a row of the output tile: 8 rows of a fragment hit 32 banks
  float* red = reinterpret_cast<float*>(smem);
  uint32_t* ys = reinterpret_cast<uint32_t*>(red + RED);
  cp_async_wait_all();
  __syncthreads();  // every warp is done with the stage buffers
  if (WK > 1) {
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
    if (wk == 0) {
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
  }
  if (wk == 0) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = wm0 + mt * 16 + gid + half * 8;
          const uint32_t lo = __bfloat16_as_ushort(__float2bfloat16_rn(acc[mt][nt][half * 2]));
          const uint32_t hi = __bfloat16_as_ushort(__float2bfloat16_rn(acc[mt][nt][half * 2 + 1]));
          ys[(r * YS + wn0 + nt * 8 + tig * 2) / 2] = lo | hi << 16;
        }
      }
    }
  }
  __syncthreads();
  const uint16_t* yh = reinterpret_cast<const uint16_t*>(ys);
  for (int e = tid; e < TM * TN; e += THREADS) {
    const int r = e / TN;
    const int col = e % TN;
    const int t = t0 + r;
    if (t < t_out && n0 + col < c_out)
      y[(static_cast<size_t>(b) * t_out + t) * c_out + n0 + col] = yh[r * YS + col];
  }
}

struct Call16 {
  const uint16_t* x_pad;
  const uint32_t* chunks;
  const int* win;
  uint16_t* y;
  int runs, batch, t_pad, c_in, k, c_out, dev;
  cudaStream_t stream;
};

// Shared memory (bytes) of a block with windows of ``cs`` channels and ``jw`` taps.
template <int WM, int WN, int WK>
size_t bf16_smem(int cs, int jw) {
  constexpr int TM = WM * MT * 16;
  constexpr int TN = WN * NT * 8;
  const size_t rows = TM + jw;
  const size_t stages = RING * static_cast<size_t>(STAGE_BYTES) +
                        round_up(static_cast<int>(rows) * (cs / CH), 8) * 16 +
                        rows * (cs / CH + 1) * 16;
  const size_t epilogue = static_cast<size_t>(WK - 1) * WM * WN * 32 * MT * NT * 4 * 4 +
                          static_cast<size_t>(TM) * (TN + 8) * 2;
  return stages > epilogue ? stages : epilogue;
}

// Windows of up to MAX_CS channels and all K taps, narrowed (channels to 16,
// then taps) until two blocks fit an SM.
template <int WM, int WN, int WK>
cudaError_t launch_bf16(const Call16& c) {
  constexpr int TM = WM * MT * 16;
  constexpr int TN = WN * NT * 8;
  const int cp8 = round_up(c.c_in, CH);
  int cs = cp8 < MAX_CS ? cp8 : MAX_CS, jw = c.k;
  while (bf16_smem<WM, WN, WK>(cs, jw) > kSmemCap) {
    if (cs > 16) {
      cs = round_up(cs / 2, CH);
    } else if (jw > 1) {
      jw = (jw + 1) / 2;
    } else {
      break;
    }
  }
  const size_t smem = bf16_smem<WM, WN, WK>(cs, jw);
  auto kernel = tap_gemm_bf16_kernel<WM, WN, WK>;
  static size_t opted_in[kMaxDevices] = {};
  if (smem > 48 * 1024 && (c.dev >= kMaxDevices || smem > opted_in[c.dev])) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    if (c.dev < kMaxDevices) opted_in[c.dev] = smem;
  }
  const int t_out = c.t_pad - c.k + 1;
  const dim3 grid((t_out + TM - 1) / TM, (c.c_out + TN - 1) / TN, c.runs * c.batch);
  const size_t x_elems = static_cast<size_t>(c.runs) * c.batch * c.t_pad * c.c_in;
  kernel<<<grid, THREADS, smem, c.stream>>>(c.x_pad, c.chunks, c.win, c.y, c.batch, c.t_pad,
                                            c.c_in, c.k, c.c_out, cs, jw, TM + jw, x_elems);
  return cudaGetLastError();
}

// y = the bf16 OS conv of ``runs`` independent runs at once: x_pad (runs,
// batch, t_pad, c_in), w (runs, k, c_in, c_out), y (runs, batch, t_out,
// c_out), all bf16; ``work`` is the caller's scratch of runs *
// bf16_work_words(k, c_in, c_out) 32-bit words.  One memset and two kernel
// launches on ``stream``, whatever the number of runs; the tiles are chosen
// from one run's batch (as tap_gemm::run), so each run of a many-run call
// gives the one-run call's bits.
inline cudaError_t run_bf16(const uint16_t* x_pad, const uint16_t* w, void* work, uint16_t* y,
                            int runs, int batch, int t_pad, int c_in, int k, int c_out,
                            cudaStream_t stream) {
  if (runs < 1 || batch < 1 || static_cast<long>(runs) * batch > 65535 || k < 1 || c_in < 1 ||
      c_out < 1 || t_pad - k + 1 < 1)
    return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t e = current_sms(dev, sms);
  if (e != cudaSuccess) return e;
  uint32_t* chunks = static_cast<uint32_t*>(work);
  const int n_groups = (c_out + GROUP - 1) / GROUP;
  int* win = reinterpret_cast<int*>(chunks + runs * bf16_split_words(k, c_in, c_out));
  e = cudaMemsetAsync(win, 0, static_cast<size_t>(runs) * 2 * n_groups * sizeof(int), stream);
  if (e != cudaSuccess) return e;
  prep_bf16_kernel<<<dim3(k * (round_up(c_in, CH) / CH), runs), THREADS, 0, stream>>>(
      w, k, c_in, c_out, chunks, win);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const Call16 c{x_pad, chunks, win, y, runs, batch, t_pad, c_in, k, c_out, dev, stream};
  const int t_out = t_pad - k + 1;
  if (c_out <= 32) return launch_bf16<2, 1, 4>(c);
  const long wide_blocks = static_cast<long>((t_out + 127) / 128) * ((c_out + 63) / 64) * batch;
  if (wide_blocks >= static_cast<long>(MIN_BLOCKS) * sms) return launch_bf16<4, 2, 1>(c);
  return launch_bf16<2, 2, 2>(c);
}

}  // namespace
}  // namespace tap_gemm

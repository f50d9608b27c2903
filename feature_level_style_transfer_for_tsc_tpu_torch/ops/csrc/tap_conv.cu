// VALID dilated conv1d as k taps, for Hopper (sm_90a), f32 accuracy on the
// tensor cores (3xTF32).
//
// Replaces the TPU kernel of feature_level_style_transfer_for_tsc_tpu/ops/osconv.py:
//   _tap_conv_kernel  (osconv.py:158)  ->  tap_conv_fwd, and tap_conv_fwd_runs (R runs)
//       y[b, t, o] = sum_{j<k} sum_i x_pad[b, t + j*d, i] * w[j, i, o],  t < t_out
// with x_pad (B, t_pad, C_in), w (k, C_in, C_out), y (B, t_out, C_out), all
// row-major float32, t_out = t_pad - (k-1)*d.  The op-by-op WaveNet coupling
// net runs it for every dilated conv of its layers (k = 3, d = 2^i, C_in 120
// -> C_out 240) and, through the hand-written backward, for their input
// gradients (240 -> 120, the taps flipped and transposed).
//
// Bound on an H100 SXM: operations.  One forward layer at the pair shape (B*T
// = 46,080 rows) does 2*46,080*3*120*240 = 7.96 GFLOP on about 66 MB, about
// 120 operations per byte.  f32-accurate products on the tensor cores cost
// three TF32 products each, so the bound is 3 * 7.96 GFLOP at 494.7 TFLOP/s,
// 0.048 ms; the bytes need 0.020 ms.
//
// Design: the tap GEMM of tap_gemm.cuh without windows (every tap live):
// its prep kernel splits w, then a stage stages the rows [t0 + j0*d, t0 +
// j0*d + TM + 2d) of 8 input channels once and tap j reads them j*d rows
// further; a dilation so wide that this window would crowd shared memory
// stages one tap at a time.
// Unlike the TPU kernel the batch is not collapsed into rows and no rolled
// row is computed and discarded (pltpu.roll), and t_pad is not padded to a
// multiple of 8 (a TPU sublane rule): each block reads the rows it needs.

#include <cuda_runtime.h>

#include "tap_gemm.cuh"

// y = the k-tap conv of x_pad at dilation d; 2 kernel launches.  ``work`` is
// the caller's scratch of tap_gemm::work_words(k, C_in, C_out) 32-bit words.
extern "C" int tap_conv_fwd(const float* x_pad, const float* w, void* work, float* y, int b,
                            int t_pad, int c_in, int k, int c_out, int dilation,
                            void* stream_ptr) {
  return static_cast<int>(tap_gemm::run(x_pad, w, work, false, nullptr, nullptr,
                                        tap_gemm::kNone, y, 1, b, t_pad, c_in, k, c_out, dilation,
                                        static_cast<cudaStream_t>(stream_ptr)));
}

// R runs of one shape at once: x_pad (R, B, t_pad, C_in), w (R, k, C_in, C_out),
// y (R, B, t_out, C_out), work R * tap_gemm::work_words(k, C_in, C_out) words.
// The same two kernel launches whatever R, with the run on the main grid's z
// (tap_gemm.cuh), whose limit asks R * B <= 65535 (the caller splits larger
// calls); the tiles are chosen from one run's batch, so each run's arithmetic
// and bits are the one-run call's.  The counterpart of the JAX package's
// vmapped _tap_conv_kernel (its multi-run training, train/multirun.py, on the
// op-by-op WaveNet route), where jax.vmap adds a grid axis.
extern "C" int tap_conv_fwd_runs(const float* x_pad, const float* w, void* work, float* y,
                                 int runs, int b, int t_pad, int c_in, int k, int c_out,
                                 int dilation, void* stream_ptr) {
  return static_cast<int>(tap_gemm::run(x_pad, w, work, false, nullptr, nullptr,
                                        tap_gemm::kNone, y, runs, b, t_pad, c_in, k, c_out,
                                        dilation, static_cast<cudaStream_t>(stream_ptr)));
}

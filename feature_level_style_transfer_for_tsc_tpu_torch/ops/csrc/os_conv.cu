// Masked omni-scale conv1d forward for Hopper (sm_90a), f32 accuracy on the
// tensor cores (3xTF32), and a bf16 kernel (native bf16 tensor-core products).
//
// Replaces the TPU kernels of feature_level_style_transfer_for_tsc_tpu/ops/osconv.py:
//   _os_conv_kernel        (osconv.py:258)  ->  os_conv_fwd_runs (one run: os_conv_fwd)
//       y[b, t, o] = sum_{j<K} sum_i x_pad[b, t + j, i] * w[j, i, o]
//   _os_conv_fused_kernel  (osconv.py:288)  ->  os_conv_fused_fwd_runs (os_conv_fused_fwd)
//       y[b, t, o] = relu?(conv[b, t, o] * scale[o] + shift[o])
// with x_pad (B, T+K-1, C_in), w (K, C_in, C_out) already masked, y (B, T, C_out),
// scale and shift (C_out,), all row-major float32.  The conv bias stays outside
// os_conv_fwd (it is folded into shift for the fused kernel), as in the JAX
// package.  ``work`` is the caller's scratch of tap_gemm::work_words(K, C_in,
// C_out) 32-bit words.
//
// Bound on an H100 SXM: operations.  At the serving shapes (T=1152, K=89, C
// up to 225) the conv does 2*B*T*C_in*live_taps operations on about
// 4*B*T*(C_in+C_out) bytes.  Most of the K*C_out taps are zeros of the
// omni-scale mask (24.1 of 54.1 dense GFLOP live a serving batch), and the
// f32-accurate products run on the tensor cores as three TF32 products.
//
// Design (float32): the tap GEMM of tap_gemm.cuh at d = 1, with windows: its prep
// kernel splits w and writes, for each group of 8 output columns, the span
// [lo, hi) of taps at which any w[j, :, group] is nonzero (the plain mirror
// is ops/osconv.py:tap_windows_plain); the GEMM then issues mmas only inside
// each group's window (one staged x window serves all taps of a stage),
// without a host sync.  Unlike the TPU kernel there is no roll: each block
// reads the rows it needs.

#include <cuda_runtime.h>

#include "tap_gemm.cuh"
#include "tap_gemm_bf16.cuh"

// R runs of one shape at once (R = 1 for a one-run call): x_pad (R, B, T+K-1,
// C_in), w (R, K, C_in, C_out), y (R, B, T, C_out), scale and shift (R,
// C_out), work R * tap_gemm::work_words(K, C_in, C_out) words.  The same two
// kernel launches whatever R, with the run on the grid (tap_gemm.cuh); each
// run's arithmetic is the one-run call's.  For R > 1 they are the JAX
// package's vmapped kernels of its multi-run training (train/multirun.py),
// where jax.vmap adds a grid axis.
//
// bf16 != 0 (os_conv_fwd_runs only): x_pad, w and y are bf16, the
// counterpart of the JAX package's bf16 conv under PipelineConfig.compute_dtype
// = "bfloat16" (XLA's conv with a bf16 output, osconv.py:356-366; its Pallas
// kernels take f32 only): each product exact, the sum f32, rounded to bf16
// at the store, by the bf16 tap GEMM of tap_gemm_bf16.cuh (bf16 staging,
// mma.sync m16n8k16 on bf16 operands); ``work`` is then R *
// tap_gemm::bf16_work_words(K, C_in, C_out) words.  The same launches.
extern "C" int os_conv_fwd_runs(const void* x_pad, const void* w, void* work, void* y, int runs,
                                int batch, int t_pad, int c_in, int k, int c_out, int bf16,
                                void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return static_cast<int>(tap_gemm::run_bf16(
        static_cast<const uint16_t*>(x_pad), static_cast<const uint16_t*>(w), work,
        static_cast<uint16_t*>(y), runs, batch, t_pad, c_in, k, c_out, s));
  return static_cast<int>(tap_gemm::run(static_cast<const float*>(x_pad),
                                        static_cast<const float*>(w), work, true, nullptr, nullptr,
                                        tap_gemm::kNone, static_cast<float*>(y), runs, batch,
                                        t_pad, c_in, k, c_out, 1, s));
}

extern "C" int os_conv_fused_fwd_runs(const float* x_pad, const float* w, void* work,
                                      const float* scale, const float* shift, int relu, float* y,
                                      int runs, int batch, int t_pad, int c_in, int k, int c_out,
                                      void* stream) {
  return static_cast<int>(tap_gemm::run(x_pad, w, work, true, scale, shift,
                                               relu ? tap_gemm::kAffineRelu : tap_gemm::kAffine,
                                               y, runs, batch, t_pad, c_in, k, c_out, 1,
                                               static_cast<cudaStream_t>(stream)));
}

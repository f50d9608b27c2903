// VALID dilated conv1d as k taps, for Hopper (sm_90a), exact float32.
//
// Replaces the TPU kernel of feature_level_style_transfer_for_tsc_tpu/ops/osconv.py:
//   _tap_conv_kernel  (osconv.py:158)  ->  tap_conv_fwd
//       y[b, t, o] = sum_{j<k} sum_i x_pad[b, t + j*d, i] * w[j, i, o],  t < t_out
// with x_pad (B, t_pad, C_in), w (k, C_in, C_out), y (B, t_out, C_out), all
// row-major float32, t_out = t_pad - (k-1)*d.  The op-by-op WaveNet coupling
// net runs it for every dilated conv of its layers (k = 3, d = 2^i, C_in 120
// -> C_out 240) and, through the hand-written backward, for their input
// gradients (240 -> 120, the taps flipped and transposed).
//
// Bound on an H100 SXM: operations.  One forward layer at the pair shape (B*T
// = 46,080 rows) does 2*46,080*3*120*240 = 7.96 GFLOP on about 66 MB, about
// 120 operations per byte, so the FP32 pipes' 67 TFLOP/s (exact f32, no
// tensor cores) bound it at 0.119 ms; the bytes need 0.020 ms.
//
// Design, simple and exact first (tensor cores, TMA and wgmma are later work):
// * a tiled FP32 GEMM over the (tap, input channel) reduction: one block per
//   (TM time rows, TN output columns, batch element); each of its 256 threads
//   owns a 4x4 register tile of outputs and accumulates with f32 FMA;
// * per pass, KC input channels of one tap are staged: the A tile reads rows
//   t0 + m + j*d of the same series directly (transposed into shared memory,
//   so a thread reads its 4 rows as one float4), the W tile rows of w[j];
// * ragged time, channel and column edges are zero-filled on load and masked
//   on store.
// Unlike the TPU kernel the batch is not collapsed into rows and no rolled
// row is computed and discarded (pltpu.roll), and t_pad is not padded to a
// multiple of 8 (a TPU sublane rule): each block reads the rows it needs.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int TM = 64;        // time rows per block
constexpr int TN = 64;        // output columns per block
constexpr int KC = 16;        // input channels staged per pass
constexpr int NTX = TN / 4;   // threads along the columns
constexpr int NTHREADS = (TM / 4) * NTX;
constexpr int AS_STRIDE = TM + 4;  // keeps float4 alignment, spreads the transposed stores

__global__ void __launch_bounds__(NTHREADS)
tap_conv_kernel(const float* __restrict__ x_pad, const float* __restrict__ w,
                float* __restrict__ y, int t_pad, int c_in, int k, int c_out, int d) {
  __shared__ __align__(16) float as[KC][AS_STRIDE];
  __shared__ __align__(16) float ws[KC][TN];
  const int t_out = t_pad - (k - 1) * d;
  const int t0 = blockIdx.x * TM;
  const int n0 = blockIdx.y * TN;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid % NTX;
  const int ty = tid / NTX;
  const float* xb = x_pad + static_cast<size_t>(b) * t_pad * c_in;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[i][q] = 0.f;
  }

  for (int j = 0; j < k; ++j) {
    const float* xj = xb + static_cast<size_t>(j) * d * c_in;  // row t of tap j is t + j*d
    const float* wj = w + static_cast<size_t>(j) * c_in * c_out;
    for (int c0 = 0; c0 < c_in; c0 += KC) {
      __syncthreads();  // the previous pass is done reading as and ws
      for (int e = tid; e < TM * KC; e += NTHREADS) {
        const int m = e / KC;
        const int kk = e - m * KC;
        const int t = t0 + m;
        const int ch = c0 + kk;
        as[kk][m] = (t < t_out && ch < c_in) ? xj[static_cast<size_t>(t) * c_in + ch] : 0.f;
      }
      for (int e = tid; e < KC * TN; e += NTHREADS) {
        const int kk = e / TN;
        const int nn = e - kk * TN;
        const int ch = c0 + kk;
        const int o = n0 + nn;
        ws[kk][nn] = (ch < c_in && o < c_out) ? wj[static_cast<size_t>(ch) * c_out + o] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < KC; ++kk) {
        const float4 av = *reinterpret_cast<const float4*>(&as[kk][ty * 4]);
        const float4 bv = *reinterpret_cast<const float4*>(&ws[kk][tx * 4]);
        const float a[4] = {av.x, av.y, av.z, av.w};
        const float bb[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[i][q] = fmaf(a[i], bb[q], acc[i][q]);
        }
      }
    }
  }

  float* yb = y + static_cast<size_t>(b) * t_out * c_out;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + ty * 4 + i;
    if (t >= t_out) break;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int o = n0 + tx * 4 + q;
      if (o < c_out) yb[static_cast<size_t>(t) * c_out + o] = acc[i][q];
    }
  }
}

}  // namespace

// y = the k-tap conv of x_pad at dilation d; 1 kernel launch.
extern "C" int tap_conv_fwd(const float* x_pad, const float* w, float* y, int b, int t_pad,
                            int c_in, int k, int c_out, int dilation, void* stream_ptr) {
  if (b < 1 || b > 65535 || c_in < 1 || c_out < 1 || k < 1 || dilation < 1 ||
      t_pad - (k - 1) * dilation < 1)
    return cudaErrorInvalidValue;
  const int t_out = t_pad - (k - 1) * dilation;
  const dim3 grid((t_out + TM - 1) / TM, (c_out + TN - 1) / TN, b);
  tap_conv_kernel<<<grid, NTHREADS, 0, static_cast<cudaStream_t>(stream_ptr)>>>(
      x_pad, w, y, t_pad, c_in, k, c_out, dilation);
  return cudaGetLastError();
}

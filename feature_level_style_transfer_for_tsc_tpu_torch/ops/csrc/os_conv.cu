// Masked omni-scale conv1d forward for Hopper (sm_90a), exact float32.
//
// Replaces the TPU kernels of feature_level_style_transfer_for_tsc_tpu/ops/osconv.py:
//   _os_conv_kernel        (osconv.py:258)  ->  os_conv_fwd
//       y[b, t, o] = sum_{j<K} sum_i x_pad[b, t + j, i] * w[j, i, o]
//   _os_conv_fused_kernel  (osconv.py:288)  ->  os_conv_fused_fwd
//       y[b, t, o] = relu?(conv[b, t, o] * scale[o] + shift[o])
// with x_pad (B, T+K-1, C_in), w (K, C_in, C_out) already masked, y (B, T, C_out),
// scale and shift (C_out,), all row-major float32.  The conv bias stays outside
// os_conv_fwd (it is folded into shift for the fused kernel), as in the JAX
// package.
//
// Bound on an H100 SXM.  At the serving shapes (T=1152, K=89, C up to 225) the
// conv does 2*B*T*K*C_in*C_out operations on about 4*B*T*(C_in+C_out) bytes:
// hundreds to thousands of operations per byte, so it is bound by operations,
// not by memory.  Serving is exact float32 (no TF32), so the ceiling is the
// 67 TFLOP/s of the FP32 pipes, not the tensor cores.
//
// Design, simple and exact first (tensor cores, skipping the mask's zero taps,
// TMA and wgmma are later work):
// * one block per (time tile of TT rows, C_out tile of TC columns, batch
//   element); each of its (TT/4)*(TC/4) threads owns a 4x4 register tile of
//   outputs and accumulates with f32 FMA;
// * per pass over CI=16 input channels, the x_pad rows [t0, t0+TT+K-1) of that
//   chunk are staged in shared memory once, channel-major, so a thread's taps
//   read a sliding window of one row: JG+3 values in registers serve all JG
//   taps of a group (each value is reused across taps instead of reloaded);
// * w[j0:j0+JG, chunk, tile] is streamed through shared memory JG taps at a
//   time and read as float4 along C_out;
// * ragged time, channel, tap and C_out edges are zero-filled on load and
//   masked on store; the epilogue runs on the registers before the one store.
// Unlike the TPU kernel there is no roll: the rolled rows that wrapped around
// were discarded work there, forced by Mosaic; here each block reads the rows
// it needs.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int CI = 16;  // input channels staged per pass

enum Epilogue { kNone = 0, kAffine = 1, kAffineRelu = 2 };

template <int TT, int TC, int JG>
__global__ void __launch_bounds__((TT / 4) * (TC / 4))
os_conv_kernel(const float* __restrict__ x_pad, const float* __restrict__ w,
               const float* __restrict__ scale, const float* __restrict__ shift,
               int epilogue, float* __restrict__ y, int t_pad, int c_in, int k,
               int c_out) {
  constexpr int NTX = TC / 4;         // threads along C_out
  constexpr int NT = (TT / 4) * NTX;  // threads per block
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  // staged x rows, with the slack that the last tap group's window reads
  const int rows = TT + k - 1 + JG;
  const int xs_stride = rows | 1;  // odd: the CI channel rows fall in distinct banks
  float* xs = smem;                     // [CI][xs_stride]
  float* ws = smem + CI * xs_stride;    // [JG][CI][TC], 64-byte aligned

  const int t_out = t_pad - k + 1;
  const int t0 = blockIdx.x * TT;
  const int co0 = blockIdx.y * TC;
  const int b = blockIdx.z;
  const int tx = threadIdx.x % NTX;
  const int ty = threadIdx.x / NTX;
  const float* xb = x_pad + static_cast<size_t>(b) * t_pad * c_in;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[i][q] = 0.f;
  }

  for (int ci0 = 0; ci0 < c_in; ci0 += CI) {
    const int cn = min(CI, c_in - ci0);
    __syncthreads();  // the previous pass is done reading xs and ws
    for (int i = threadIdx.x; i < rows * CI; i += NT) {
      const int r = i / CI;
      const int c = i - r * CI;
      const int t = t0 + r;
      xs[c * xs_stride + r] =
          (c < cn && t < t_pad) ? xb[static_cast<size_t>(t) * c_in + ci0 + c] : 0.f;
    }
    for (int j0 = 0; j0 < k; j0 += JG) {
      const int jn = min(JG, k - j0);
      if (j0 > 0) __syncthreads();  // the previous tap group is done reading ws
      for (int i = threadIdx.x; i < JG * CI * TC; i += NT) {
        const int o = i % TC;
        const int c = (i / TC) % CI;
        const int jj = i / (TC * CI);
        ws[i] = (jj < jn && c < cn && co0 + o < c_out)
                    ? w[(static_cast<size_t>(j0 + jj) * c_in + ci0 + c) * c_out + co0 + o]
                    : 0.f;
      }
      __syncthreads();
      for (int c = 0; c < cn; ++c) {
        const float* xr = xs + c * xs_stride + ty * 4 + j0;
        float a[JG + 3];
#pragma unroll
        for (int m = 0; m < JG + 3; ++m) a[m] = xr[m];
        const float* wr = ws + c * TC + tx * 4;
#pragma unroll
        for (int jj = 0; jj < JG; ++jj) {
          if (jj < jn) {
            const float4 bv = *reinterpret_cast<const float4*>(wr + jj * CI * TC);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              acc[i][0] = fmaf(a[jj + i], bv.x, acc[i][0]);
              acc[i][1] = fmaf(a[jj + i], bv.y, acc[i][1]);
              acc[i][2] = fmaf(a[jj + i], bv.z, acc[i][2]);
              acc[i][3] = fmaf(a[jj + i], bv.w, acc[i][3]);
            }
          }
        }
      }
    }
  }

  const int o0 = co0 + tx * 4;
  float sc[4], sh[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const bool live = epilogue != kNone && o0 + q < c_out;
    sc[q] = live ? scale[o0 + q] : 1.f;
    sh[q] = live ? shift[o0 + q] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + ty * 4 + i;
    if (t >= t_out) break;
    float* yr = y + (static_cast<size_t>(b) * t_out + t) * c_out;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (o0 + q >= c_out) break;
      float v = acc[i][q];
      if (epilogue != kNone) {
        v = v * sc[q] + sh[q];
        if (epilogue == kAffineRelu) v = fmaxf(v, 0.f);
      }
      yr[o0 + q] = v;
    }
  }
}

template <int TT, int TC, int JG>
cudaError_t launch(const float* x_pad, const float* w, const float* scale,
                   const float* shift, int epilogue, float* y, int batch,
                   int t_pad, int c_in, int k, int c_out, cudaStream_t stream) {
  const int t_out = t_pad - k + 1;
  const size_t smem =
      (static_cast<size_t>(CI) * ((TT + k - 1 + JG) | 1) + static_cast<size_t>(JG) * CI * TC) *
      sizeof(float);
  auto kernel = os_conv_kernel<TT, TC, JG>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((t_out + TT - 1) / TT, (c_out + TC - 1) / TC, batch);
  kernel<<<grid, (TT / 4) * (TC / 4), smem, stream>>>(x_pad, w, scale, shift, epilogue,
                                                      y, t_pad, c_in, k, c_out);
  return cudaGetLastError();
}

// Tap group size: at most K, so short kernels (the K=2 last layer) waste no taps.
template <int TT, int TC>
cudaError_t launch_taps(const float* x_pad, const float* w, const float* scale,
                        const float* shift, int epilogue, float* y, int batch,
                        int t_pad, int c_in, int k, int c_out, cudaStream_t stream) {
  if (k >= 8)
    return launch<TT, TC, 8>(x_pad, w, scale, shift, epilogue, y, batch, t_pad, c_in, k,
                             c_out, stream);
  if (k >= 4)
    return launch<TT, TC, 4>(x_pad, w, scale, shift, epilogue, y, batch, t_pad, c_in, k,
                             c_out, stream);
  if (k >= 2)
    return launch<TT, TC, 2>(x_pad, w, scale, shift, epilogue, y, batch, t_pad, c_in, k,
                             c_out, stream);
  return launch<TT, TC, 1>(x_pad, w, scale, shift, epilogue, y, batch, t_pad, c_in, k,
                           c_out, stream);
}

// Tile shape: narrow layers (C_out <= 32) take a 128x32 tile so that most of
// each tile's columns are real channels.
cudaError_t dispatch(const float* x_pad, const float* w, const float* scale,
                     const float* shift, int epilogue, float* y, int batch, int t_pad,
                     int c_in, int k, int c_out, cudaStream_t stream) {
  if (batch < 1 || batch > 65535 || k < 1 || t_pad < k || c_in < 1 || c_out < 1)
    return cudaErrorInvalidValue;
  if (c_out <= 32)
    return launch_taps<128, 32>(x_pad, w, scale, shift, epilogue, y, batch, t_pad, c_in,
                                k, c_out, stream);
  return launch_taps<64, 64>(x_pad, w, scale, shift, epilogue, y, batch, t_pad, c_in, k,
                             c_out, stream);
}

}  // namespace

extern "C" int os_conv_fwd(const float* x_pad, const float* w, float* y, int batch,
                           int t_pad, int c_in, int k, int c_out, void* stream) {
  return static_cast<int>(dispatch(x_pad, w, nullptr, nullptr, kNone, y, batch, t_pad,
                                   c_in, k, c_out, static_cast<cudaStream_t>(stream)));
}

extern "C" int os_conv_fused_fwd(const float* x_pad, const float* w, const float* scale,
                                 const float* shift, int relu, float* y, int batch,
                                 int t_pad, int c_in, int k, int c_out, void* stream) {
  return static_cast<int>(dispatch(x_pad, w, scale, shift, relu ? kAffineRelu : kAffine, y,
                                   batch, t_pad, c_in, k, c_out,
                                   static_cast<cudaStream_t>(stream)));
}

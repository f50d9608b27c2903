// The fused WaveNet gate for Hopper (sm_90a), exact float32.
//
// Replaces the TPU kernel of feature_level_style_transfer_for_tsc_tpu/ops/gate.py:
//   _gate_kernel  (gate.py:28)  ->  gate_fwd
//       out[r, j] = tanh(a[r, j] + b[r, j]) * sigmoid(a[r, j + n] + b[r, j + n]),  j < n
// with a and b (M, 2n) row-strided views (row strides lda and ldb, unit column
// stride) and out (M, n) contiguous.  In the op-by-op WaveNet coupling net, a
// is the dilated conv's output and b a column slice of the cond projection,
// whose rows are 2*C*L floats apart: the stride is passed, the slice is never
// copied.
//
// Bound on an H100 SXM: bytes.  Each output element reads four floats and
// writes one, with two transcendentals, so the pass moves 20 bytes per output
// for a few dozen operations: far below the FP32 pipes' ratio of about 20
// operations per byte.  At the pair shape (M = 46,080 rows, n = 120) that is
// 110.6 MB, 0.033 ms at 3.35 TB/s.
//
// Design, simple first: one thread per output element in a grid-stride loop,
// neighbouring threads on neighbouring columns, so each warp reads contiguous
// runs of a, b (the tanh half and the sigmoid half) and writes a contiguous
// run of out.  Unlike the TPU kernel there are no row tiles in fast memory:
// nothing is reused, each value is read once.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int NTHREADS = 256;
constexpr int MAX_BLOCKS = 132 * 16;  // 16 resident blocks per SM of an H100

__global__ void __launch_bounds__(NTHREADS)
gate_kernel(const float* __restrict__ a, int64_t lda, const float* __restrict__ b, int64_t ldb,
            float* __restrict__ out, int64_t m, int n) {
  const int64_t total = m * n;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * NTHREADS + threadIdx.x; e < total;
       e += static_cast<int64_t>(gridDim.x) * NTHREADS) {
    const int64_t r = e / n;
    const int j = static_cast<int>(e - r * n);
    const float* ar = a + r * lda;
    const float* br = b + r * ldb;
    const float t = ar[j] + br[j];
    const float s = ar[j + n] + br[j + n];
    out[e] = tanhf(t) * (1.f / (1.f + expf(-s)));
  }
}

}  // namespace

// The gate over M rows; 1 kernel launch (none for M = 0).
extern "C" int gate_fwd(const float* a, int64_t lda, const float* b, int64_t ldb, float* out,
                        int64_t m, int n, void* stream_ptr) {
  if (m < 0 || n < 1 || (m > 1 && (lda < 2 * n || ldb < 2 * n))) return cudaErrorInvalidValue;
  if (m == 0) return cudaSuccess;
  const int64_t need = (m * n + NTHREADS - 1) / NTHREADS;
  const int blocks = static_cast<int>(need < MAX_BLOCKS ? need : MAX_BLOCKS);
  gate_kernel<<<blocks, NTHREADS, 0, static_cast<cudaStream_t>(stream_ptr)>>>(a, lda, b, ldb,
                                                                             out, m, n);
  return cudaGetLastError();
}

// Batched least-squares solve  x = argmin ||A x + b||_2  by streaming
// Householder QR (TSQR), one thread block per scenario.
//
// Replaces the Pallas TPU kernel `_tsqr_kernel` (boundmpc_tpu/ops/tsqr.py,
// launched by `tsqr_ls_solve`).  Same arithmetic: the rows of [A | b] stream
// in chunks of kRowsPerChunk rows and are folded, column by column, into an
// (n+1) x (n+1) upper-triangular factor R with the same Householder
// reflections (sign rule alpha = -norm when R[j,j] >= 0, beta = 2 / v^T v
// guarded by v^T v > 0, update restricted to columns k >= j).  After the
// last chunk R holds [R_A | Q^T b] and R_A x = -(Q^T b) is back-substituted.
// Everything accumulates in float32.
//
// What bounds it on an H100: not bytes.  A scenario reads its [A | b] once,
// about 178 KB at (m, n) = (550, 80), so about 45 MB for a batch of 256.
// The time goes into the serial chain of n dependent columns per chunk,
// each needing a block-wide reduction and three block barriers.  The design
// keeps R and the current chunk resident in shared memory (about 47 KB at
// n = 80), so device memory is touched once per element, and runs one block
// per scenario so that up to four blocks share an SM and hide each other's
// barrier latency.  Tensor cores (wgmma), TMA loads and warp-per-scenario
// mappings are left for later work.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerChunk = 64;
constexpr int kMaxCols = 128;  // largest supported n + 1

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

size_t smem_bytes(int n) {
  const size_t n1 = static_cast<size_t>(n) + 1;
  // R (n1 x n1), chunk C (rows x n1), dots d (n1), beta*w (n1), x (n)
  return sizeof(float) * (n1 * n1 + kRowsPerChunk * n1 + 2 * n1 + n);
}

__global__ void __launch_bounds__(kThreads)
tsqr_ls_solve_kernel(const float* __restrict__ A, const float* __restrict__ b,
                     float* __restrict__ x, int m, int n) {
  extern __shared__ float smem[];
  const int n1 = n + 1;
  const int ld = n1;  // row stride of R and C; n1 = 81 is odd: no bank conflicts
  float* R = smem;
  float* C = R + n1 * ld;
  float* d = C + kRowsPerChunk * ld;
  float* bw = d + n1;
  float* xs = bw + n1;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* As = A + static_cast<size_t>(blockIdx.x) * m * n;
  const float* bs = b + static_cast<size_t>(blockIdx.x) * m;

  for (int i = tid; i < n1 * ld; i += kThreads) R[i] = 0.f;

  for (int r0 = 0; r0 < m; r0 += kRowsPerChunk) {
    __syncthreads();  // R zeroed / previous chunk fully folded
    const int rows = min(kRowsPerChunk, m - r0);
    // The chunk's rows of A are contiguous: rows * n floats.  Rows past m
    // are zero, and a zero row leaves R unchanged.
    const float* Ac = As + static_cast<size_t>(r0) * n;
    for (int i = tid; i < kRowsPerChunk * n; i += kThreads) {
      const int r = i / n;
      const int k = i - r * n;
      C[r * ld + k] = r < rows ? Ac[i] : 0.f;
    }
    for (int r = tid; r < kRowsPerChunk; r += kThreads)
      C[r * ld + n] = r < rows ? bs[r0 + r] : 0.f;
    __syncthreads();

    for (int j = 0; j < n; ++j) {
      // R[j][j] is stable until the row-j update below.
      const float rjj = R[j * ld + j];
      // d[k] = sum_r C[r][j] C[r][k] for k >= j (one warp per column).
      for (int k = j + warp; k < n1; k += kWarps) {
        float acc = 0.f;
        for (int r = lane; r < kRowsPerChunk; r += 32)
          acc = fmaf(C[r * ld + j], C[r * ld + k], acc);
        acc = warp_sum(acc);
        if (lane == 0) d[k] = acc;
      }
      __syncthreads();

      // Householder vector v = [R[j][j] - alpha; C[:, j]], every thread
      // derives the same scalars.
      const float sigma = d[j];
      const float norm = sqrtf(rjj * rjj + sigma);
      const float alpha = rjj >= 0.f ? -norm : norm;
      const float v0 = rjj - alpha;
      const float vtv = v0 * v0 + sigma;
      const float beta = vtv > 0.f ? 2.f / vtv : 0.f;

      // w[k] = v0 R[j][k] + d[k];  R[j][k] -= v0 beta w[k]  (R[j][j] = alpha)
      for (int k = j + tid; k < n1; k += kThreads) {
        const float rjk = R[j * ld + k];
        const float bwk = beta * (v0 * rjk + d[k]);
        bw[k] = bwk;
        R[j * ld + k] = k == j ? alpha : rjk - v0 * bwk;
      }
      __syncthreads();

      // C[r][k] -= beta w[k] C[r][j] for k > j (column j is not read again).
      const int width = n1 - j - 1;
      for (int i = tid; i < kRowsPerChunk * width; i += kThreads) {
        const int r = i / width;
        const int k = j + 1 + (i - r * width);
        C[r * ld + k] -= bw[k] * C[r * ld + j];
      }
      __syncthreads();
    }
  }

  // Back-substitution R_A x = -(Q^T b) on one warp.
  if (warp == 0) {
    for (int i = n - 1; i >= 0; --i) {
      float acc = 0.f;
      for (int k = i + 1 + lane; k < n; k += 32) acc = fmaf(R[i * ld + k], xs[k], acc);
      acc = warp_sum(acc);
      const float xi = (-R[i * ld + n] - acc) / R[i * ld + i];
      if (lane == 0) xs[i] = xi;
      __syncwarp();
    }
    float* xo = x + static_cast<size_t>(blockIdx.x) * n;
    for (int k = lane; k < n; k += 32) xo[k] = xs[k];
  }
}

}  // namespace

extern "C" {

// Largest n + 1 the kernel takes.
int bmpc_tsqr_max_cols() { return kMaxCols; }

// A (batch, m, n), b (batch, m), x (batch, n): contiguous float32 on the
// device.  Launches on `stream`; returns cudaGetLastError() after the launch.
int bmpc_tsqr_ls_solve_f32(const float* A, const float* b, float* x, int batch,
                           int m, int n, void* stream) {
  if (batch < 1 || m < 1 || n < 1 || n + 1 > kMaxCols)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(n);
  cudaError_t err = cudaFuncSetAttribute(
      tsqr_ls_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  tsqr_ls_solve_kernel<<<batch, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(A, b, x, m, n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

// Batched least-squares solve  x = argmin ||A x + b||_2  by streaming
// Householder QR (TSQR), one thread block per scenario, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_tsqr_kernel` (boundmpc_tpu/ops/tsqr.py:37,
// launched by `tsqr_ls_solve`).  Same reflections: the rows of [A | b] are
// folded chunk by chunk into an (n+1) x (n+1) upper-triangular factor R
// (sign rule alpha = -norm when R[j,j] >= 0, beta = 2 / v^T v guarded by
// v^T v > 0, updates restricted to columns k > j), all in float32.  After
// the last chunk R holds [R_A | Q^T b] and R_A x = -(Q^T b) is
// back-substituted.  No Gram or Cholesky shortcut: the weighted rows span
// about 1e12 in weight.
//
// What bounds it on an H100.  At the solver's shape (B, m, n) = (256, 550,
// 80) the work is 2mn^2 - 2n^3/3 + 4mn - 2n^2 + n^2 = 6.87 MFLOP a scenario,
// 1.76 GFLOP a batch: 26.2 us at 67 TFLOP/s float32, against 13.6 us for the
// 45.7 MB of [A | b] and x at 3.35 TB/s.  So the bound is compute.  What
// holds the kernel back from it is the serial chain of dependent reflectors
// (each needs the previous one's update of its column, a norm and a
// reduction across the rows) and the shared-memory traffic of updating the
// trailing columns after each.
//
// The schedule kept (PERF.md has the measurements behind each choice):
//  * Tall chunks.  The rows per chunk `rc` come from the wrapper
//    (ops/tsqr.py::chunk_rows): the most rows, a multiple of 64 up to 576,
//    that fit the 232,448 bytes of dynamic shared memory a block may take.
//    At n = 80 that is 576, so the solver's m = 550 is one chunk.
//  * Fixed addresses, no predicates.  The lanes own the rows in pairs (lane
//    l holds rows 2l + 64q and 2l + 64q + 1), so a column moves with 8-byte
//    loads and stores, and the rows per lane are a compile-time constant
//    (fold_chunk<NR>, chosen per chunk; the last chunk is zero-padded to a
//    multiple of 64 rows): no index division and no predicate in the loop.
//  * Two reflectors per pass, one barrier per pair.  A trailing column is
//    loaded once, takes reflector j and then reflector j + 1 in registers,
//    and is stored once: 40 barriers and 40 passes over the chunk at n = 80
//    instead of 80 (and 720 with 64-row chunks).  The arithmetic is that of
//    two single steps, operation for operation.  The compact-WY form, which
//    takes both dot products from the loaded column and corrects the second
//    by bw_j (c_{j+1} . c_j), was about 9% faster but rounds differently,
//    and the float32 closed loop that chip_smoke.py's phase 5 holds to
//    float64 sits at the rounding noise floor (PERF.md).
//  * Look-ahead.  In the step of pair j one warp updates columns j + 2 and
//    j + 3 first (their reductions interleaved), then forms reflector
//    j + 2, applies it to column j + 3, forms reflector j + 3 and
//    publishes both, while the other warps share the remaining trailing
//    columns round-robin (balanced within one column).  Its chain of
//    dependent reductions is what the late steps, with few trailing
//    columns, wait for.
//  * 16 warps.  8 are slower, and 32 leave 64 registers a thread, which
//    spills.
//  * Asynchronous row loads, one buffer.  A chunk arrives by cp.async
//    (4-byte copies: the row length n is not a multiple of 16 bytes in
//    general, and the chunk is stored transposed, which rules out TMA's bulk
//    and tensor copies) straight into the column-major chunk.  Two buffers
//    of half the height, the next chunk loading while this one folds, were
//    slower at every m measured, 550 and 1100 included: the time goes with
//    the number of steps more than with the rows, so one tall chunk wins.
//  * Back-substitution on one warp, by columns: lane r holds the right-hand
//    side of rows r, r+32, ...; x_i is broadcast by a shuffle.
//  * Tensor cores are not used: a larger compact-WY block in 3xTF32 on
//    wgmma is the next step (ROADMAP), together with a persistent kernel
//    that loads the next scenario into retired columns.
//
// -DTSQR_PROFILE records clock64() stamps of block 0 (load, each pair step,
// back-substitution) for bmpc_tsqr_profile; ops/tsqr_bench.py reads them.
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

constexpr int kMaxCols = 128;        // largest supported n + 1
constexpr int kSmemLimit = 232448;   // dynamic shared memory a block may take
constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxRowsPerLane = 18;  // rows per chunk <= 32 * 18 = 576
constexpr int kMaxDevices = 64;

#ifdef TSQR_PROFILE
constexpr int kProfSteps = 128;
constexpr int kProfSlots = 8 + kProfSteps * (kWarps + 1);
__device__ long long g_prof[kProfSlots];
__device__ __forceinline__ long long stamp() {
  long long t;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t)::"memory");
  return t;
}
#define TSQR_STAMP(cond, slot)          \
  do {                                  \
    if (cond) g_prof[slot] = stamp();   \
  } while (0)
#else
#define TSQR_STAMP(cond, slot) \
  do {                         \
  } while (0)
#endif

// Row stride of R: odd, so that the back-substitution's column reads
// (lane r reads R[r][i]) hit 32 different banks.
__host__ __device__ inline int r_stride(int n1) { return n1 | 1; }

// Shared memory: a column-major chunk of n1 columns x (rc + 2) rows (an even
// stride keeps every column 8-byte aligned), R (n1 x r_stride), and two
// slots of 8 floats for a pair of reflectors.
size_t smem_bytes(int n, int rc) {
  const size_t n1 = static_cast<size_t>(n) + 1;
  return sizeof(float) * (n1 * (rc + 2) + n1 * r_stride(static_cast<int>(n1)) + 16);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Start copying rows [r0, r0 + rows) of [A | b] into the chunk C (column k at
// C + k * ldc) and zero its rows [rows, rows_pad).  One commit group.
__device__ void issue_chunk(float* C, int ldc, const float* As, const float* bs,
                            int r0, int rows, int rows_pad, int n) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float* Ac = As + static_cast<size_t>(r0) * n;
  for (int r = warp; r < rows; r += kWarps)
    for (int k = lane; k < n; k += 32)
      cp_async4(C + k * ldc + r, Ac + static_cast<size_t>(r) * n + k);
  for (int r = threadIdx.x; r < rows; r += kThreads) cp_async4(C + n * ldc + r, bs + r0 + r);
  for (int k = warp; k <= n; k += kWarps)
    for (int r = rows + lane; r < rows_pad; r += 32) C[k * ldc + r] = 0.f;
  cp_async_commit();
}

// A lane's NR rows of one column, as NR / 2 pairs.
template <int NR>
__device__ __forceinline__ void load_col(float2 (&v)[NR / 2], const float* col, int lane) {
  const float2* p = reinterpret_cast<const float2*>(col) + lane;
#pragma unroll
  for (int q = 0; q < NR / 2; ++q) v[q] = p[32 * q];
}
template <int NR>
__device__ __forceinline__ void store_col(const float2 (&v)[NR / 2], float* col, int lane) {
  float2* p = reinterpret_cast<float2*>(col) + lane;
#pragma unroll
  for (int q = 0; q < NR / 2; ++q) p[32 * q] = v[q];
}
// Sum over the warp of a lane-local dot product a . b: the .x and the .y
// rows in two partial sums, then a butterfly, so every lane holds the same
// bits.
template <int NP>
__device__ __forceinline__ float dot1(const float2 (&a)[NP], const float2 (&b)[NP]) {
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int q = 0; q < NP; ++q) {
    s0 = fmaf(a[q].x, b[q].x, s0);
    s1 = fmaf(a[q].y, b[q].y, s1);
  }
  float s = s0 + s1;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// a . b and c . d at once, each exactly as dot1 sums it; the two shuffle
// chains interleave.
template <int NP>
__device__ __forceinline__ float2 dot2(const float2 (&a)[NP], const float2 (&b)[NP],
                                       const float2 (&c)[NP], const float2 (&d)[NP]) {
  float s0 = 0.f, s1 = 0.f, t0 = 0.f, t1 = 0.f;
#pragma unroll
  for (int q = 0; q < NP; ++q) {
    s0 = fmaf(a[q].x, b[q].x, s0);
    s1 = fmaf(a[q].y, b[q].y, s1);
    t0 = fmaf(c[q].x, d[q].x, t0);
    t1 = fmaf(c[q].y, d[q].y, t1);
  }
  float s = s0 + s1, t = t0 + t1;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, o);
    t += __shfl_xor_sync(0xffffffffu, t, o);
  }
  return make_float2(s, t);
}

// Reflector scalars (v0, beta, alpha) for the column whose diagonal entry is
// rjj and whose chunk part has squared norm sigma, written to out[0..2].
__device__ __forceinline__ void reflector(float* out, float rjj, float sigma) {
  const float norm = sqrtf(rjj * rjj + sigma);
  const float alpha = rjj >= 0.f ? -norm : norm;
  const float v0 = rjj - alpha;
  const float vtv = v0 * v0 + sigma;
  out[0] = v0;
  out[1] = vtv > 0.f ? 2.f / vtv : 0.f;
  out[2] = alpha;
}

// Look-ahead for the pair of reflectors (p, p + 1), p even and < n, by one
// warp holding columns p and p + 1 in a and b, updated by every earlier
// reflector (p + 1 <= n always: column n is the b column).
// Forms reflector p, applies it to column p + 1 (and R[p][p + 1]), forms
// reflector p + 1, stores both columns and publishes slot = (v0, beta,
// alpha of p; v0, beta, alpha of p + 1).
template <int NR>
__device__ __forceinline__ void prepare_pair(float2 (&a)[NR / 2], float2 (&b)[NR / 2],
                                             float* C, int ldc, float* R, int ldr,
                                             float* slot, int p, int n, int lane) {
  constexpr int NP = NR / 2;
  const float2 ss = dot2<NP>(a, a, a, b);  // (|c_p|^2, c_p . c_{p+1})
  float ra[3];
  reflector(ra, R[p * ldr + p], ss.x);
  const float rpq = R[p * ldr + p + 1];
  const float bw = ra[1] * fmaf(ra[0], rpq, ss.y);
#pragma unroll
  for (int q = 0; q < NP; ++q) {
    b[q].x = fmaf(-bw, a[q].x, b[q].x);
    b[q].y = fmaf(-bw, a[q].y, b[q].y);
  }
  store_col<NR>(a, C + p * ldc, lane);
  store_col<NR>(b, C + (p + 1) * ldc, lane);
  float rb[3] = {0.f, 0.f, 0.f};
  if (p + 1 < n) reflector(rb, R[(p + 1) * ldr + p + 1], dot1<NP>(b, b));
  __syncwarp();  // every lane has read R[p][p + 1] before lane 0 writes it
  if (lane == 0) {
    R[p * ldr + p + 1] = rpq - ra[0] * bw;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      slot[i] = ra[i];
      slot[3 + i] = rb[i];
    }
  }
}

// Reflector j applied to the trailing columns k0 and k1 held in a and b,
// given da = cj . a and db = cj . b: w = v0 R[j][k] + d, R[j][k] -= v0 beta w,
// column -= beta w cj.
template <int NP>
__device__ __forceinline__ void apply1(float2 (&a)[NP], float2 (&b)[NP], float2 d,
                                       const float2 (&cj)[NP], float* R, int ldr, int j,
                                       int k0, int k1, float v0, float beta, int lane) {
  const float r0 = R[j * ldr + k0];
  const float r1 = R[j * ldr + k1];
  const float bw0 = beta * fmaf(v0, r0, d.x);
  const float bw1 = beta * fmaf(v0, r1, d.y);
  __syncwarp();  // every lane has read R[j][k0], R[j][k1] before lane 0 writes them
  if (lane == 0) {
    R[j * ldr + k0] = r0 - v0 * bw0;
    R[j * ldr + k1] = r1 - v0 * bw1;
  }
#pragma unroll
  for (int q = 0; q < NP; ++q) {
    a[q].x = fmaf(-bw0, cj[q].x, a[q].x);
    a[q].y = fmaf(-bw0, cj[q].y, a[q].y);
    b[q].x = fmaf(-bw1, cj[q].x, b[q].x);
    b[q].y = fmaf(-bw1, cj[q].y, b[q].y);
  }
}

// The same for one column: reflector j then reflector j + 1 on v, in
// registers, with the arithmetic of two single steps.
template <int NP>
__device__ __forceinline__ void apply_pair(float2 (&v)[NP], const float2 (&cj)[NP],
                                           const float2 (&cj1)[NP], float* R, int ldr, int j,
                                           int k, float v0a, float ba, float v0b, float bb,
                                           int lane) {
  const float ra = R[j * ldr + k];
  const float rb = R[(j + 1) * ldr + k];
  const float bwa = ba * fmaf(v0a, ra, dot1<NP>(cj, v));
#pragma unroll
  for (int q = 0; q < NP; ++q) {
    v[q].x = fmaf(-bwa, cj[q].x, v[q].x);
    v[q].y = fmaf(-bwa, cj[q].y, v[q].y);
  }
  const float bwb = bb * fmaf(v0b, rb, dot1<NP>(cj1, v));
#pragma unroll
  for (int q = 0; q < NP; ++q) {
    v[q].x = fmaf(-bwb, cj1[q].x, v[q].x);
    v[q].y = fmaf(-bwb, cj1[q].y, v[q].y);
  }
  __syncwarp();  // every lane has read R[j][k], R[j + 1][k] before lane 0 writes them
  if (lane == 0) {
    R[j * ldr + k] = ra - v0a * bwa;
    R[(j + 1) * ldr + k] = rb - v0b * bwb;
  }
}

// Fold one resident chunk of 32 * NR rows (zero past its last row) into R:
// the reflectors in pairs (j, j + 1), one barrier per pair.  In the step of
// pair j one warp, L, updates columns j + 2 and j + 3 and prepares the next
// pair from them (look-ahead); the other warps share the remaining trailing
// columns j + 4 .. n round-robin, so no warp holds more than one column
// above the mean.
template <int NR>
__device__ void fold_chunk(float* C, int ldc, float* R, int ldr, float* S, int n, bool prof) {
  constexpr int NP = NR / 2;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  if (warp == 0) {  // the first pair
    float2 a[NP], b[NP];
    load_col<NR>(a, C, lane);
    load_col<NR>(b, C + ldc, lane);
    prepare_pair<NR>(a, b, C, ldc, R, ldr, S, 0, n, lane);
  }
  __syncthreads();

  for (int j = 0; j < n; j += 2) {
    const float* Sj = S + ((j >> 1) & 1) * 8;
    const int L = ((j >> 1) + 1) % kWarps;
    const bool ahead = warp == L && j + 2 < n;
    int k = j + 2 < n ? j + 4 : j + 2;  // first column past the next pair
    k = warp == L ? n + 1 : k + (warp - L - 1 + kWarps) % kWarps;
    if (ahead || k <= n) {
      const float v0a = Sj[0], ba = Sj[1], v0b = Sj[3], bb = Sj[4];
      float2 cj[NP], cj1[NP], v[NP];
      load_col<NR>(cj, C + j * ldc, lane);
      load_col<NR>(cj1, C + (j + 1) * ldc, lane);
      if (ahead) {  // columns j + 2 and j + 3 together: their reductions interleave
        float2 a[NP];
        load_col<NR>(a, C + (j + 2) * ldc, lane);
        load_col<NR>(v, C + (j + 3) * ldc, lane);
        apply1<NP>(a, v, dot2<NP>(cj, a, cj, v), cj, R, ldr, j, j + 2, j + 3, v0a, ba, lane);
        apply1<NP>(a, v, dot2<NP>(cj1, a, cj1, v), cj1, R, ldr, j + 1, j + 2, j + 3, v0b, bb,
                   lane);
        prepare_pair<NR>(a, v, C, ldc, R, ldr, S + (((j >> 1) + 1) & 1) * 8, j + 2, n, lane);
      }
      for (; k <= n; k += kWarps - 1) {
        float* Ck = C + k * ldc;
        load_col<NR>(v, Ck, lane);
        apply_pair<NP>(v, cj, cj1, R, ldr, j, k, v0a, ba, v0b, bb, lane);
        store_col<NR>(v, Ck, lane);
      }
    }
    if (threadIdx.x == 0) {
      R[j * ldr + j] = Sj[2];
      if (j + 1 < n) R[(j + 1) * ldr + j + 1] = Sj[5];
    }
    TSQR_STAMP(prof && lane == 0 && (j >> 1) < kProfSteps, 8 + (j >> 1) * (kWarps + 1) + warp);
    __syncthreads();
    TSQR_STAMP(prof && threadIdx.x == 0 && (j >> 1) < kProfSteps,
               8 + (j >> 1) * (kWarps + 1) + kWarps);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
tsqr_ls_solve_kernel(const float* __restrict__ A, const float* __restrict__ b,
                     float* __restrict__ x, int m, int n, int rc) {
  extern __shared__ __align__(16) float smem[];
  const int n1 = n + 1;
  const int ldr = r_stride(n1);
  const int ldc = rc + 2;
  float* C = smem;
  float* R = C + n1 * ldc;
  float* S = R + n1 * ldr;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const bool prof = blockIdx.x == 0;
  TSQR_STAMP(prof && tid == 0, 0);
  const float* As = A + static_cast<size_t>(blockIdx.x) * m * n;
  const float* bs = b + static_cast<size_t>(blockIdx.x) * m;

  for (int i = tid; i < n1 * ldr; i += kThreads) R[i] = 0.f;

  for (int r0 = 0, ch = 0; r0 < m; r0 += rc, ++ch) {
    // The previous fold ended with a barrier, so the buffer is free.
    const int rows = min(rc, m - r0);
    const int rows_pad = (rows + 63) & ~63;
    issue_chunk(C, ldc, As, bs, r0, rows, rows_pad, n);
    cp_async_wait_all();
    __syncthreads();  // chunk resident; R zeroed or the previous fold done
    TSQR_STAMP(prof && tid == 0 && ch == 0, 1);
    const bool p = prof && ch == 0;
    switch (rows_pad >> 5) {  // rows per lane, even
      case 2: fold_chunk<2>(C, ldc, R, ldr, S, n, p); break;
      case 4: fold_chunk<4>(C, ldc, R, ldr, S, n, p); break;
      case 6: fold_chunk<6>(C, ldc, R, ldr, S, n, p); break;
      case 8: fold_chunk<8>(C, ldc, R, ldr, S, n, p); break;
      case 10: fold_chunk<10>(C, ldc, R, ldr, S, n, p); break;
      case 12: fold_chunk<12>(C, ldc, R, ldr, S, n, p); break;
      case 14: fold_chunk<14>(C, ldc, R, ldr, S, n, p); break;
      case 16: fold_chunk<16>(C, ldc, R, ldr, S, n, p); break;
      default: fold_chunk<kMaxRowsPerLane>(C, ldc, R, ldr, S, n, p); break;
    }
  }
  TSQR_STAMP(prof && tid == 0, 2);

  // Back-substitution R_A x = -(Q^T b) on one warp, by columns: lane owns
  // rows lane + 32 q; after x_i is known every row r < i drops R[r][i] x_i.
  if (warp == 0) {
    constexpr int kQ = (kMaxCols + 31) / 32;
    float rhs[kQ];
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const int r = lane + 32 * q;
      rhs[q] = r < n ? -R[r * ldr + n] : 0.f;
    }
    float* xo = x + static_cast<size_t>(blockIdx.x) * n;
    for (int i = n - 1; i >= 0; --i) {
      const int qi = i >> 5;
      float mine = rhs[0];
#pragma unroll
      for (int q = 1; q < kQ; ++q)
        if (q == qi) mine = rhs[q];
      const float xi = __shfl_sync(0xffffffffu, mine, i & 31) / R[i * ldr + i];
      if (lane == (i & 31)) xo[i] = xi;
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        const int r = lane + 32 * q;
        if (r < i) rhs[q] = fmaf(-R[r * ldr + i], xi, rhs[q]);
      }
    }
    TSQR_STAMP(prof && lane == 0, 3);
  }
}

std::atomic<bool> g_attr_set[kMaxDevices];

}  // namespace

extern "C" {

// Largest n + 1 the kernel takes.
int bmpc_tsqr_max_cols() { return kMaxCols; }

// Most rows a chunk may have (32 lanes times the most rows a lane holds).
int bmpc_tsqr_max_chunk_rows() { return 32 * kMaxRowsPerLane; }

// A (batch, m, n), b (batch, m), x (batch, n): contiguous float32 on the
// device.  rc: rows per chunk, a multiple of 64 up to the maximum above.
// Launches on `stream`; returns cudaGetLastError() after the launch.
int bmpc_tsqr_ls_solve_f32(const float* A, const float* b, float* x, int batch,
                           int m, int n, int rc, void* stream) {
  if (batch < 1 || m < 1 || n < 1 || n + 1 > kMaxCols || rc < 64 || rc % 64 != 0 ||
      rc > 32 * kMaxRowsPerLane)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(n, rc);
  if (smem > static_cast<size_t>(kSmemLimit)) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!g_attr_set[dev].load(std::memory_order_acquire)) {
    // Once per device and process: allow the largest dynamic shared memory.
    err = cudaFuncSetAttribute(tsqr_ls_solve_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (err != cudaSuccess) return static_cast<int>(err);
    g_attr_set[dev].store(true, std::memory_order_release);
  }
  tsqr_ls_solve_kernel<<<batch, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      A, b, x, m, n, rc);
  return static_cast<int>(cudaGetLastError());
}

#ifdef TSQR_PROFILE
// Copy block 0's clock64() stamps of the last launch into out[0, count):
// [0] start, [1] first chunk resident, [2] fold done, [3] back-substitution
// done, then for pair step s < 128 (reflectors 2s, 2s + 1) of the first chunk
// and warp w, [8 + s (kWarps + 1) + w] the warp's arrival at the step's
// barrier and [8 + s (kWarps + 1) + kWarps] the barrier's release.  Returns
// the number of warps, or a negative CUDA error.
int bmpc_tsqr_profile(long long* out, int count) {
  const int c = count < kProfSlots ? count : kProfSlots;
  cudaError_t err = cudaDeviceSynchronize();
  if (err == cudaSuccess) err = cudaMemcpyFromSymbol(out, g_prof, sizeof(long long) * c);
  return err == cudaSuccess ? kWarps : -static_cast<int>(err);
}
#endif

}  // extern "C"

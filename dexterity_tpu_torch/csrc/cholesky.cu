// Batched small dense Cholesky kernels for Hopper (sm_90a).
//
// Port of dexterity_tpu/physics/linalg_pallas.py:
//   MODE_SOLVE        <- _kernel               (cholesky_solve)
//   MODE_SOLVE_FACTOR <- _solve_factor_kernel  (cholesky_solve_factor)
//   MODE_RESOLVE      <- _resolve_kernel       (cholesky_resolve_const,
//                                               cholesky_resolve)
//   MODE_FACTOR       <- _factor_kernel        (cholesky_factor)
//
// Design (the "shared" design): one warp owns one (n, n) matrix, kept in
// shared memory with an odd row stride (no bank conflicts on column walks).
// Lane l owns rows l, l + 32, l + 64, ...  The right-looking factorisation
// applies one rank-1 trailing update per pivot, each a warp-wide step
// closed by __syncwarp(); the forward and back substitutions run one pivot
// per step across the lanes.  Several warps (independent matrices) share a
// block.  It serves every mode at n > 80, beyond the register design of
// cholesky_regs.cu (n <= 32) and the wide design of cholesky_wide.cu
// (n <= 80); no model of the repository reaches it.  At any n it stays the
// yardstick a run times the other designs against, in turns
// (linalg_cuda._launch(..., design='shared')).
//
// Numerics match the Pallas kernels: pivot clamp rsqrt(max(a_kk, 1e-12)),
// the same column scaling and rank-1 update order, and the same packed
// factor layout (strict lower = L, diagonal = 1 / L_kk, upper = whatever
// the input held there).
//
// Bound: at the planner's shapes (B = 1024, n = 30, float32) each call
// moves a few MB, about 1-2 us at the card's memory rate, and the n^3/3
// FMAs per matrix are far below its FP32 rate.  The kernel is instead
// bound by latency along the n-step serial chain (n pivots, each a
// shared-memory round trip plus a warp barrier); one warp per matrix keeps
// every pivot's work in one warp so no block-wide barrier is needed.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int MODE_SOLVE = 0;
constexpr int MODE_SOLVE_FACTOR = 1;
constexpr int MODE_RESOLVE = 2;
constexpr int MODE_FACTOR = 3;  // packed factor only, no substitutions

__device__ __forceinline__ float clamp_rsqrt(float x) {
  return rsqrtf(fmaxf(x, 1e-12f));
}
__device__ __forceinline__ double clamp_rsqrt(double x) {
  return rsqrt(fmax(x, 1e-12));
}

// Cycle stamps of each matrix at entry, with the matrix loaded, after the
// pivots (K2: after the forward substitution) and at its end: (batch, 4,
// 4) int64 (warp slot 0), in a build with DEX_PHASE_CLOCKS defined only
// (chip_smoke.py --phase-split).
#ifdef DEX_PHASE_CLOCKS
__device__ long long* g_phase_clocks;
#define DEX_STAMP(mat, lane, i)                                            \
  do {                                                                     \
    if ((lane) == 0) g_phase_clocks[(mat) * 16 + (i)] = clock64();         \
  } while (0)
#else
#define DEX_STAMP(mat, lane, i) \
  do {                          \
  } while (0)
#endif

// Shared-memory row stride: n rounded up to an odd count.
__host__ __device__ inline int row_stride(int n) { return n | 1; }

__host__ __device__ inline size_t warp_smem_elems(int n) {
  return (size_t)n * row_stride(n) + (size_t)n;  // matrix + rhs
}

template <typename T, int MODE>
__global__ void cholesky_kernel(const T* __restrict__ a_in,
                                const T* __restrict__ g_in,
                                T* __restrict__ x_out,
                                T* __restrict__ fac_out,
                                int64_t batch, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
  const int64_t mat = (int64_t)blockIdx.x * (blockDim.x / kWarp) + warp;
  if (mat >= batch) return;  // whole warp exits together
  DEX_STAMP(mat, lane, 0);

  const int ld = row_stride(n);
  T* a = smem + (size_t)warp * warp_smem_elems(n);
  T* y = a + (size_t)n * ld;
  const T* src = a_in + mat * (int64_t)n * n;

  for (int idx = lane; idx < n * n; idx += kWarp) {
    a[(idx / n) * ld + idx % n] = src[idx];
  }
  if (MODE != MODE_FACTOR) {
    for (int i = lane; i < n; i += kWarp) y[i] = g_in[mat * n + i];
  }
  __syncwarp();
  DEX_STAMP(mat, lane, 1);

  if (MODE != MODE_RESOLVE) {
    // Right-looking Cholesky; the diagonal ends up holding 1 / L_kk.
    for (int k = 0; k < n; ++k) {
      const T inv = clamp_rsqrt(a[k * ld + k]);
      for (int i = k + 1 + lane; i < n; i += kWarp) a[i * ld + k] *= inv;
      __syncwarp();
      if (lane == 0) a[k * ld + k] = inv;
      for (int i = k + 1 + lane; i < n; i += kWarp) {
        const T lik = a[i * ld + k];
        T* row = a + i * ld;
        for (int j = k + 1; j <= i; ++j) row[j] -= lik * a[j * ld + k];
      }
      __syncwarp();
    }
  }
  if (MODE != MODE_RESOLVE) DEX_STAMP(mat, lane, 2);

  if (MODE == MODE_SOLVE_FACTOR || MODE == MODE_FACTOR) {
    T* dst = fac_out + mat * (int64_t)n * n;
    for (int idx = lane; idx < n * n; idx += kWarp) {
      dst[idx] = a[(idx / n) * ld + idx % n];
    }
  }
  if (MODE != MODE_FACTOR) {
    // Forward substitution L y = g (column-oriented).
    for (int k = 0; k < n; ++k) {
      const T yk = y[k] * a[k * ld + k];
      __syncwarp();
      for (int i = k + 1 + lane; i < n; i += kWarp) y[i] -= a[i * ld + k] * yk;
      if (lane == 0) y[k] = yk;
      __syncwarp();
    }
    if (MODE == MODE_RESOLVE) DEX_STAMP(mat, lane, 2);
    // Back substitution L^T x = y; L^T[j, k] = a[k, j].
    T* x = x_out + mat * n;
    for (int k = n - 1; k >= 0; --k) {
      const T xk = y[k] * a[k * ld + k];
      __syncwarp();
      for (int j = lane; j < k; j += kWarp) y[j] -= a[k * ld + j] * xk;
      if (lane == 0) x[k] = xk;
      __syncwarp();
    }
  }
  DEX_STAMP(mat, lane, 3);
}

template <typename T, int MODE>
int launch(const void* a, const void* g, void* x, void* fac, int64_t batch,
           int n, int warps_per_block, void* stream) {
  if (batch <= 0) return (int)cudaSuccess;
  const size_t smem =
      (size_t)warps_per_block * warp_smem_elems(n) * sizeof(T);
  auto kernel = cholesky_kernel<T, MODE>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int64_t blocks = (batch + warps_per_block - 1) / warps_per_block;
  kernel<<<(unsigned)blocks, warps_per_block * kWarp, smem,
           (cudaStream_t)stream>>>(
      (const T*)a, (const T*)g, (T*)x, (T*)fac, batch, n);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int mode, const void* a, const void* g, void* x, void* fac,
             int64_t batch, int n, int warps_per_block, void* stream) {
  switch (mode) {
    case MODE_SOLVE:
      return launch<T, MODE_SOLVE>(a, g, x, fac, batch, n, warps_per_block,
                                   stream);
    case MODE_SOLVE_FACTOR:
      return launch<T, MODE_SOLVE_FACTOR>(a, g, x, fac, batch, n,
                                          warps_per_block, stream);
    case MODE_RESOLVE:
      return launch<T, MODE_RESOLVE>(a, g, x, fac, batch, n, warps_per_block,
                                     stream);
    case MODE_FACTOR:
      return launch<T, MODE_FACTOR>(a, g, x, fac, batch, n, warps_per_block,
                                    stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// mode: 0 solve, 1 solve + packed factor, 2 resolve against a packed factor,
// 3 packed factor only.  elem_bytes: 4 (float) or 8 (double).  a: (batch,
// n, n) matrices or packed factors; g: (batch, n) (unused by mode 3); x:
// (batch, n) out (unused by mode 3); fac: (batch, n, n) out (modes 1, 3).
// Returns the cudaError_t of the launch (0 on success).
int dex_cholesky(int mode, int elem_bytes, const void* a, const void* g,
                 void* x, void* fac, int64_t batch, int n,
                 int warps_per_block, void* stream) {
  if (elem_bytes == 4)
    return dispatch<float>(mode, a, g, x, fac, batch, n, warps_per_block,
                           stream);
  if (elem_bytes == 8)
    return dispatch<double>(mode, a, g, x, fac, batch, n, warps_per_block,
                            stream);
  return (int)cudaErrorInvalidValue;
}

#ifdef DEX_PHASE_CLOCKS
// Points the kernels' cycle stamps at `clocks`, (batch, 4, 4) int64.
int dex_phase_clocks(void* clocks) {
  return (int)cudaMemcpyToSymbol(g_phase_clocks, &clocks, sizeof(clocks));
}
#endif

}  // extern "C"

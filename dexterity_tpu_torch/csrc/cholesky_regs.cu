// Batched small dense Cholesky kernels for Hopper (sm_90a), register
// design: K1 and K2 of the planner's Newton solve, K3 of the environment
// step's, K4 of the cholesky_factor entry point.
//
// Port of dexterity_tpu/physics/linalg_pallas.py:
//   MODE_SOLVE        <- _kernel               (cholesky_solve, K3)
//   MODE_SOLVE_FACTOR <- _solve_factor_kernel  (cholesky_solve_factor, K1)
//   MODE_RESOLVE      <- _resolve_kernel       (cholesky_resolve_const,
//                                               cholesky_resolve, K2)
//   MODE_FACTOR       <- _factor_kernel        (cholesky_factor, K4)
// K1, K3 and K4 are one kernel with two template flags: kEmitFactor keeps
// the packed factor's writes to the stage and its bulk store (K1, K4),
// kSolve the rhs, the forward substitution in the pivot loop and the back
// substitution (K1, K3).  cholesky.cu holds the shared-memory design, which
// serves these four modes at n > 32.
//
// Numerics match the Pallas kernels: right-looking order, pivot clamp
// rsqrt(max(a_kk, 1e-12)), the same column scaling and rank-1 update order,
// and the same packed factor layout (strict lower = L, diagonal = 1 / L_kk,
// upper unspecified: here the input's).
//
// One warp per matrix, n <= 32, lane i holding row i.  (This code with two
// rows per lane, for n <= 64, spills K1 in both types under ptxas 12.8, so
// those sizes stay on cholesky.cu.)  What
// bounds it on this card: at the planner's shapes (B = 1024, n = 30,
// float32) K1 moves 2 B n^2 4 bytes (7.4 MB, 2.2 us at 3.35 TB/s), K2 and
// K3 half that; the n^3 / 3 FMAs per matrix are far below the FP32 rate.  So
// the floor is bytes, and what stands above it is the latency of the
// n-step dependent chain (pivot k + 1 needs pivot k's update).  K4 moves
// K1's bytes less the two vectors and runs the same chain.  What the
// design does about each:
//   - bytes: each matrix is read once, by one 1-D TMA bulk copy
//     (cp.async.bulk with an mbarrier) into a dense shared-memory stage
//     where its bytes and address are 16-byte multiples, else by a
//     coalesced element copy; K1's packed factor leaves the same way, by one
//     bulk store.  No per-element division by n.
//   - the chain: lane i holds row i in registers and the pivot loop is
//     unrolled at compile time, with no branch: it runs over all 32 pivots,
//     and a padded pivot (rows n .. 31 are the identity's) changes nothing.
//     At pivot k the diagonal and y_k reach every lane by __shfl_sync and
//     each lane scales its own a[i][k]; lane k + 1 takes its next diagonal
//     from its own l_{k+1,k}, so the next rsqrt waits on no broadcast.  The
//     rest of the column l_jk reaches every lane through shared memory:
//     each lane stores its l_ik, and after one __syncwarp() every lane reads
//     the column with 16-byte broadcast loads, four floats (two doubles) an
//     instruction, where a shuffle gives one.  K1's forward substitution
//     runs in the same loop.
//   - the back substitution needs columns of L, which a lane cannot take
//     from other lanes' registers: the columns broadcast during the factor
//     stay in shared memory, one per pivot, so lane j reads its column j
//     with 16-byte loads off the chain; x_k is broadcast by shuffle.  K2
//     reads L from its stage: row i for the forward pass, column i for the
//     backward pass.
// Every address in the unrolled loops is a base register plus a constant,
// and every per-lane choice is a select, not a branch (a divergent branch
// would turn each shuffle after it into a collective sequence).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int MODE_SOLVE = 0;
constexpr int MODE_SOLVE_FACTOR = 1;
constexpr int MODE_RESOLVE = 2;
constexpr int MODE_FACTOR = 3;
constexpr int kRegsMaxWarps = 4;

__device__ __forceinline__ float clamp_rsqrt(float x) {
  return rsqrtf(fmaxf(x, 1e-12f));
}
__device__ __forceinline__ double clamp_rsqrt(double x) {
  return rsqrt(fmax(x, 1e-12));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

template <typename T>
__device__ __forceinline__ T bcast(T v, int src_lane) {
  return __shfl_sync(0xffffffffu, v, src_lane);
}

// Shared memory per warp: a 16-byte slot for the mbarrier; K1's 32 columns
// of L at a stride of 32 elements plus 16 bytes (each column 16-byte
// aligned, and lane j's reads of column j spread over the banks); then the
// dense (n, n) stage with 32 elements of slack, so a padded row's loads stay
// inside it.
__host__ __device__ inline int col_stride(int elem) { return 32 + 16 / elem; }
__host__ __device__ inline size_t regs_warp_smem_bytes(int n, int elem) {
  return 16 + (size_t)32 * col_stride(elem) * elem +
         ((((size_t)n * n + 32) * elem + 15) & ~(size_t)15);
}

// A 16-byte vector of T (four floats or two doubles) and its elements.
template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  using type = float4;
  static constexpr int kN = 4;
};
template <>
struct Vec16<double> {
  using type = double2;
  static constexpr int kN = 2;
};
__device__ __forceinline__ float elem(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}
__device__ __forceinline__ double elem(const double2& v, int e) {
  return e == 0 ? v.x : v.y;
}

// A bulk (TMA) copy needs 16-byte multiples of bytes and of address.
__device__ __forceinline__ bool bulk_ok(const void* p, uint32_t bytes) {
  return (bytes & 15u) == 0 && ((uintptr_t)p & 15u) == 0;
}

// Copies `count` elements of `src` into the dense stage `dst` (16-byte
// aligned) for the whole warp and returns once every lane may read them:
// one TMA bulk copy where allowed, else a coalesced element copy.
template <typename T>
__device__ __forceinline__ void stage_in(T* dst, const T* src, int count,
                                         uint64_t* bar, int lane) {
  const uint32_t bytes = (uint32_t)count * sizeof(T);
  if (bulk_ok(src, bytes)) {
    const uint32_t b = smem_u32(bar);
    if (lane == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(b)
                   : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncwarp();
    if (lane == 0) {
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                   ::"r"(b), "r"(bytes)
                   : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
          "l"((uint64_t)(uintptr_t)src), "r"(bytes), "r"(b)
          : "memory");
    }
    uint32_t done = 0;
    do {
      asm volatile(
          "{\n.reg .pred p;\n"
          "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
          "selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(b)
          : "memory");
    } while (!done);
  } else {
    for (int i = lane; i < count; i += kWarp) dst[i] = src[i];
  }
  // The lanes may leave the wait at different times: reconverge, so ptxas
  // knows the shuffles that follow run on a converged warp (else each one
  // carries a divergence check and a fallback path that hold registers).
  __syncwarp();
}

// Copies the dense stage `src`, just written by this warp, to `dst`: one
// TMA bulk store where allowed (stage_out_wait before the warp exits), else
// a coalesced element copy.  Returns with every lane's earlier shared-memory
// writes visible to the warp.
template <typename T>
__device__ __forceinline__ void stage_out(T* dst, const T* src, int count,
                                          int lane) {
  const uint32_t bytes = (uint32_t)count * sizeof(T);
  if (bulk_ok(dst, bytes)) {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncwarp();
    if (lane == 0) {
      asm volatile(
          "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
          ::"l"((uint64_t)(uintptr_t)dst), "r"(smem_u32(src)), "r"(bytes)
          : "memory");
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
  } else {
    __syncwarp();
    for (int i = lane; i < count; i += kWarp) dst[i] = src[i];
  }
}

// Holds the warp until its bulk store, if any, has read the stage.
__device__ __forceinline__ void stage_out_wait(int lane) {
  if (lane == 0)
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Row `lane` of the dense stage into registers; rows and columns n .. 31
// of the identity.  kStrictLower keeps only the strict lower triangle (a
// packed factor's L) and zeroes the rest.
template <typename T, bool kStrictLower>
__device__ __forceinline__ void load_row(T (&a)[32], const T* s, int n,
                                         int lane) {
  const T* src = s + (lane < n ? lane : n - 1) * n;  // the stage's slack
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const T v = src[j];
    const bool keep = lane < n && j < n && (!kStrictLower || j < lane);
    a[j] = keep ? v : (lane == j && !kStrictLower ? T(1) : T(0));
  }
}

// Back substitution L^T x = y over all 32 rows, with c[k] = L[k][lane] for
// k > lane (else 0): x_k = y_k / L_kk on lane k, broadcast, and y_i -=
// L[k][i] x_k.  Padded rows (y = 0, inverse diagonal 1, column 0) change
// nothing.
template <typename T>
__device__ __forceinline__ T back_substitute(T y, const T (&c)[32],
                                             T inv_diag, int lane) {
#pragma unroll
  for (int k = 31; k >= 0; --k) {
    const T xk = bcast(y * inv_diag, k);
    y = lane == k ? xk : fma(-c[k], xk, y);
  }
  return y;
}

// K1 (kEmitFactor, kSolve): solve + packed factor; K3 (kSolve): the solve
// alone; K4 (kEmitFactor): the packed factor alone, no rhs read and no x
// written.  One resident block per SM is asked for, so ptxas may take up
// to 255 registers.
template <typename T, bool kEmitFactor, bool kSolve>
__global__ void __launch_bounds__(kRegsMaxWarps * kWarp, 1)
    cholesky_regs_solve_factor(const T* __restrict__ a_in,
                               const T* __restrict__ g_in,
                               T* __restrict__ x_out, T* __restrict__ fac_out,
                               int64_t batch, int n) {
  using V = typename Vec16<T>::type;
  constexpr int kV = Vec16<T>::kN;
  constexpr int S = 32 + kV;  // col_stride(sizeof(T))
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
  const int64_t mat = (int64_t)blockIdx.x * (blockDim.x / kWarp) + warp;
  if (mat >= batch) return;  // whole warp exits together

  unsigned char* base = smem_raw + (size_t)warp *
                                       regs_warp_smem_bytes(n, sizeof(T));
  T* cols = reinterpret_cast<T*>(base + 16);  // column k at cols + k S
  T* s = cols + 32 * S;
  const int64_t nn = (int64_t)n * n;
  // Loaded first: its latency overlaps the matrix's copy.
  T y = kSolve && lane < n ? g_in[mat * n + lane] : T(0);
  stage_in(s, a_in + mat * nn, n * n, reinterpret_cast<uint64_t*>(base),
           lane);
  T a[32];
  load_row<T, false>(a, s, n, lane);
  __syncwarp();  // every row is in registers: the stage may be written

  // Right-looking factor with the forward substitution L y = g fused in.
  // Column k of the packed factor is final at pivot k and goes into the
  // stage at once (K1), so a[k] is dead from then on.
  T* srow = s + (lane < n ? lane : 0) * n;
  T inv_diag = T(1);
  T inv = clamp_rsqrt(bcast(a[0], 0));
  // Left alone, ptxas runs the pivots' dependent chain ever further ahead of
  // their column updates and holds the deferred operands in registers until
  // it spills.  A branch that is never taken (n < 0), every kFence pivots,
  // ends a block it cannot schedule across.
  constexpr int kFence = 8;
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    T* col = cols + k * S;
    const bool below = lane > k, at = lane == k;
    const T lik = a[k] * inv;
    const T lm = below ? lik : T(0);  // l_ik below the pivot, 0 elsewhere
    col[lane] = lm;
    if (kEmitFactor && k < n && lane < n && lane >= k)
      srow[k] = at ? inv : lik;
    if constexpr (kSolve) {
      const T yk = bcast(y, k) * inv;
      y = at ? yk : fma(-lm, yk, y);
      inv_diag = at ? inv : inv_diag;
    }
    if (k + 1 < 32) {
      // Lane k + 1 updates its own diagonal with its own l_{k+1,k} (the
      // FFMA the column update below repeats, to the bit).
      const T inv_next = clamp_rsqrt(bcast(fma(-lm, lm, a[k + 1]), k + 1));
      __syncwarp();
#pragma unroll
      for (int q = (k + 1) / kV; q < 32 / kV; ++q) {
        const V v = reinterpret_cast<const V*>(col)[q];
#pragma unroll
        for (int e = 0; e < kV; ++e) {
          // a[i][j] -= l_ik l_jk; rows at or above the pivot keep theirs.
          const int j = q * kV + e;
          if (j > k) a[j] = fma(-lm, elem(v, e), a[j]);
        }
      }
      inv = inv_next;
    }
    if ((k + 1) % kFence == 0 && n < 0) __trap();
  }

  // The stage now holds the packed factor: out with one bulk store.  K3
  // only makes the last column's writes visible to the warp.
  if (kEmitFactor)
    stage_out(fac_out + mat * nn, s, n * n, lane);
  else
    __syncwarp();

  if constexpr (kSolve) {
    // Column `lane` of L, from the columns of the factor loop.
    T c[32];
    const V* mine = reinterpret_cast<const V*>(cols + lane * S);
#pragma unroll
    for (int q = 0; q < 32 / kV; ++q) {
      const V v = mine[q];
#pragma unroll
      for (int e = 0; e < kV; ++e) {
        const int k = q * kV + e;
        c[k] = k > lane ? elem(v, e) : T(0);
      }
    }
    y = back_substitute<T>(y, c, inv_diag, lane);
    if (lane < n) x_out[mat * n + lane] = y;
  }
  if (kEmitFactor) stage_out_wait(lane);
}

// K2: resolve against a packed factor staged in shared memory: row i of L
// in registers for the forward pass, column i for the backward pass.  Only
// the strict lower triangle and the diagonal are read into registers.
template <typename T>
__global__ void __launch_bounds__(kRegsMaxWarps * kWarp)
    cholesky_regs_resolve(const T* __restrict__ fac_in,
                          const T* __restrict__ g_in, T* __restrict__ x_out,
                          int64_t batch, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
  const int64_t mat = (int64_t)blockIdx.x * (blockDim.x / kWarp) + warp;
  if (mat >= batch) return;

  unsigned char* base = smem_raw + (size_t)warp *
                                       regs_warp_smem_bytes(n, sizeof(T));
  T* s = reinterpret_cast<T*>(base + 16) + 32 * col_stride(sizeof(T));
  // Loaded first: its latency overlaps the factor's copy.
  T y = lane < n ? g_in[mat * n + lane] : T(0);
  stage_in(s, fac_in + mat * (int64_t)n * n, n * n,
           reinterpret_cast<uint64_t*>(base), lane);
  T a[32];
  load_row<T, true>(a, s, n, lane);
  const T inv_diag = lane < n ? s[lane * n + lane] : T(1);

  // Forward substitution L y = g over all 32 rows.
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    const T yk = bcast(y * inv_diag, k);
    y = lane == k ? yk : fma(-a[k], yk, y);
  }
  // Column `lane` of L: c[k] = L[k][lane] for k > lane, read down the stage.
  T c[32];
  const int rc = lane < n ? lane : 0;
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    const T v = s[(k < n ? k : 0) * n + rc];
    c[k] = (k < n && k > lane) ? v : T(0);
  }
  y = back_substitute<T>(y, c, inv_diag, lane);
  if (lane < n) x_out[mat * n + lane] = y;
}

// Lifts the kernel's dynamic shared-memory limit where 48 KB is too few.
template <typename KernelT>
cudaError_t allow_smem(KernelT kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T>
int dispatch_regs(int mode, const void* a, const void* g, void* x, void* fac,
                  int64_t batch, int n, int warps_per_block, void* stream) {
  if (mode < MODE_SOLVE || mode > MODE_FACTOR || n < 1 ||
      n > 32 || warps_per_block < 1 || warps_per_block > kRegsMaxWarps)
    return (int)cudaErrorInvalidValue;
  if (batch <= 0) return (int)cudaSuccess;
  const size_t smem =
      (size_t)warps_per_block * regs_warp_smem_bytes(n, sizeof(T));
  const int64_t blocks = (batch + warps_per_block - 1) / warps_per_block;
  const dim3 grid((unsigned)blocks), block(warps_per_block * kWarp);
  cudaStream_t st = (cudaStream_t)stream;
  if (mode != MODE_RESOLVE) {
    auto kernel = mode == MODE_SOLVE_FACTOR
                      ? cholesky_regs_solve_factor<T, true, true>
                  : mode == MODE_FACTOR
                      ? cholesky_regs_solve_factor<T, true, false>
                      : cholesky_regs_solve_factor<T, false, true>;
    const cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, block, smem, st>>>((const T*)a, (const T*)g, (T*)x,
                                      (T*)fac, batch, n);
  } else {
    auto kernel = cholesky_regs_resolve<T>;
    const cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, block, smem, st>>>((const T*)a, (const T*)g, (T*)x,
                                      batch, n);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// mode: 0 solve (K3), 1 solve + packed factor (K1), 2 resolve against a
// packed factor (K2), 3 packed factor (K4); 1 <= n <= 32, at most 4 warps
// per block.  elem_bytes: 4 (float) or 8 (double).  a: (batch, n, n)
// matrices or packed factors; g: (batch, n) (unused in mode 3); x:
// (batch, n) out (unused in mode 3); fac: (batch, n, n) out (modes 1 and 3,
// else unused).  Returns the cudaError_t of the launch (0 on success).
int dex_cholesky_regs(int mode, int elem_bytes, const void* a, const void* g,
                      void* x, void* fac, int64_t batch, int n,
                      int warps_per_block, void* stream) {
  if (elem_bytes == 4)
    return dispatch_regs<float>(mode, a, g, x, fac, batch, n,
                                warps_per_block, stream);
  if (elem_bytes == 8)
    return dispatch_regs<double>(mode, a, g, x, fac, batch, n,
                                 warps_per_block, stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"

// Batched small dense Cholesky kernels for Hopper (sm_90a), wide register
// design: all four modes at 32 < n <= 64, the sizes of the juggle task's
// two-hand model (n = nv = 62).
//
// Port of dexterity_tpu/physics/linalg_pallas.py:
//   MODE_SOLVE        <- _kernel               (:74,  cholesky_solve, K3)
//   MODE_SOLVE_FACTOR <- _solve_factor_kernel  (:135, cholesky_solve_factor,
//                                               K1)
//   MODE_RESOLVE      <- _resolve_kernel       (:291, cholesky_resolve_const,
//                                               cholesky_resolve, K2)
//   MODE_FACTOR       <- _factor_kernel        (:262, cholesky_factor, K4)
// K1, K3 and K4 are one kernel with two template flags, as in
// cholesky_regs.cu: kEmitFactor keeps the packed factor's writes to the
// stage and its bulk store (K1, K4), kSolve the rhs, the forward
// substitution in the pivot loop and the back substitution (K1, K3).  K2
// is a kernel of its own.  cholesky_regs.cu serves n <= 32, cholesky.cu
// every mode at n > 64.
//
// Numerics match the Pallas kernels: right-looking order (each a_ij takes
// its rank-1 terms for k = 0, 1, ... in order), pivot clamp
// rsqrt(max(a_kk, 1e-12)), the same column scaling, and the same packed
// factor layout (strict lower = L, diagonal = 1 / L_kk, upper unspecified:
// here the input's), which K2 reads unchanged.  K2 gives each y_i its
// terms in k order and each x_i its terms for k = n - 1, n - 2, ..., as
// _resolve_kernel does.
//
// One matrix per group of two warps (64 threads), thread i holding row i
// in registers; rows and columns n .. 63 are the identity's, so the pivot
// loop is unrolled over all 64 pivots and a padded pivot changes nothing.
// (cholesky_regs.cu with two rows per lane spills K1 in both types under
// ptxas 12.8: one row per thread halves the row state.)
//
// What bounds each on this card:
//   - K3: at the suite's (4096, 62, 62) float32 the ~n^3 / 3 FMAs per
//     matrix (10.2 us at the FP32 rate) and the bytes (10.1 us at 3.35
//     TB/s for one triangle of each matrix; the whole squares this kernel
//     reads take 19 us) stand level.  At the juggle environment's
//     (32, 62, 62) the card is nearly empty and the floor is the 62-step
//     dependent chain: pivot k + 1 needs pivot k's column.
//   - K1 at (1024, 62, 62): bytes, 4.93 us; K4 the same less the two
//     vectors: bytes, 4.78 us.  Both run K3's pivot chain.
//   - K2 at (1024, 62, 62): bytes, 2.54 us (a triangle and two vectors a
//     matrix; its n^2 FMAs are nothing).  At (32, 62, 62): the chain of 2n
//     substitution steps, each a shuffle and an FMA.
// What the design does about each:
//   - bytes: each matrix is read once, by one 1-D TMA bulk copy
//     (cp.async.bulk with an mbarrier) into a dense shared-memory stage
//     where its bytes and address are 16-byte multiples, else by an element
//     copy; the packed factor (K1, K4) leaves the same way, by one bulk
//     store.  No per-element division by n.  K3's stage lies inside its
//     column slots, which it no longer needs once the rows are in
//     registers.
//   - operations: each thread updates its own row, reading the pivot
//     column from shared memory with 16-byte broadcast loads (four floats
//     or two doubles an instruction).  Warp 0's rows 0 .. 31 end left of
//     column 32: it updates columns below 32 only and is done after pivot
//     31: a matrix takes 32 x (2,016 + 496) = 80,384 FMAs, about the
//     n^3 / 3 that bound counts at n = 62.
//   - the factor's chain: one 64-thread named barrier (bar.sync id, 64; one
//     id per matrix group) per pivot while both warps work, __syncwarp()
//     once warp 1 is alone, and nothing block-wide.  Every pivot's
//     column has its own slot (64 slots, kept for the back substitution),
//     so a slot is never rewritten and one barrier orders both the writes
//     of pivot k and the reads of pivot k - 1.  The pivot's inverse
//     diagonal rides in the slot of the pivot before it: thread k + 1
//     updates its own diagonal with its own l_{k+1,k} (the FFMA the column
//     update repeats, to the bit) and stores rsqrt of it beside column k,
//     so the barrier that publishes column k publishes inv_{k+1} too; y_k
//     of the fused forward substitution rides there as well.
//   - K2's chain, blocked by warp: two barriers a solve instead of one a
//     step.  Forward: warp 0 solves y_0 .. y_31 by shuffles (lane k
//     broadcasts y_k / L_kk, a multiply by the stored inverse) and
//     publishes them; after one barrier warp 1 subtracts L[i][0:32] y[0:32]
//     from its rows with 16-byte broadcast loads and solves its block by
//     shuffles.  Back substitution as K1's below, with column i of L read
//     down the stage (the lanes of a warp at consecutive addresses): no
//     transpose and no column slots.
//   - occupancy: the barrier's id is not a constant, so ptxas reserves all
//     16 named barriers for a block, and a Hopper SM then holds at most 4
//     such blocks; a block takes two matrices (kWideGroups; four were
//     slower), 8 a SM, 1,056 a wave.
//   - the back substitution needs columns of L, which a thread cannot take
//     from other threads' registers: thread j reads its column j from the
//     slots (K1, K3) or the stage (K2) off the chain.  Rows 32 .. 63 solve
//     their block within warp 1 by shuffles and publish x; after one
//     barrier, warp 0 subtracts them and solves its block by shuffles.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRows = 64;   // rows of a group: one per thread
constexpr int kGroup = 64;  // threads per matrix
constexpr int kWideGroups = 2;  // matrices per block (linalg_cuda mirrors)
constexpr int MODE_SOLVE = 0;
constexpr int MODE_SOLVE_FACTOR = 1;
constexpr int MODE_RESOLVE = 2;
constexpr int MODE_FACTOR = 3;

__device__ __forceinline__ float clamp_rsqrt(float x) {
  return rsqrtf(fmaxf(x, 1e-12f));
}
__device__ __forceinline__ double clamp_rsqrt(double x) {
  return rsqrt(fmax(x, 1e-12));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// The two warps of one matrix group meet at their own named barrier.
__device__ __forceinline__ void group_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(kGroup) : "memory");
}

// Shared memory per group: a 16-byte slot for the mbarrier; except for K2,
// 64 column slots of 64 elements plus 16 bytes (slot k holds column k of
// L, then inv_{k+1} and y_k; each slot 16-byte aligned, and thread j's
// reads of slot j spread over the banks); 32 elements for y or x of one
// warp's rows; then, except for K3, the dense (n, n) stage with 64
// elements of slack, so a padded row's loads stay inside it.  K3's stage
// lies in the column slots.
__host__ __device__ inline int wide_col_stride(int elem) {
  return kRows + 16 / elem;
}
__host__ __device__ inline size_t wide_group_smem_bytes(int n, int elem,
                                                        int mode) {
  const size_t cols =
      mode == MODE_RESOLVE ? 0 : (size_t)kRows * wide_col_stride(elem) * elem;
  const size_t stage =
      mode == MODE_SOLVE ? 0
                         : ((((size_t)n * n + kRows) * elem + 15) &
                            ~(size_t)15);
  return 16 + cols + (size_t)32 * elem + stage;
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
// aligned) for the group and returns once every thread may read them: one
// TMA bulk copy where allowed, else an element copy.
template <typename T>
__device__ __forceinline__ void stage_in(T* dst, const T* src, int count,
                                         uint64_t* bar, int t, int bar_id) {
  const uint32_t bytes = (uint32_t)count * sizeof(T);
  if (bulk_ok(src, bytes)) {
    const uint32_t b = smem_u32(bar);
    if (t == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(b)
                   : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                   ::"r"(b), "r"(bytes)
                   : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
          "l"((uint64_t)(uintptr_t)src), "r"(bytes), "r"(b)
          : "memory");
    }
    group_sync(bar_id);  // the mbarrier is initialised before anyone waits
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
    for (int i = t; i < count; i += kGroup) dst[i] = src[i];
  }
  // Reconverges the warps after the wait, and orders the element copy.
  group_sync(bar_id);
}

// Copies the dense stage `src`, just written by this group, to `dst`: one
// TMA bulk store where allowed (stage_out_wait before the group exits),
// else an element copy.
template <typename T>
__device__ __forceinline__ void stage_out(T* dst, const T* src, int count,
                                          int t, int bar_id) {
  const uint32_t bytes = (uint32_t)count * sizeof(T);
  if (bulk_ok(dst, bytes)) {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    group_sync(bar_id);
    if (t == 0) {
      asm volatile(
          "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
          ::"l"((uint64_t)(uintptr_t)dst), "r"(smem_u32(src)), "r"(bytes)
          : "memory");
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
  } else {
    group_sync(bar_id);
    for (int i = t; i < count; i += kGroup) dst[i] = src[i];
  }
}

// Holds the group until its bulk store, if any, has read the stage.
__device__ __forceinline__ void stage_out_wait(int t) {
  if (t == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Row `t` of the dense stage into registers; rows and columns n .. 63 of
// the identity.  kStrictLower keeps only the strict lower triangle (a
// packed factor's L) and zeroes the rest.
template <typename T, bool kStrictLower>
__device__ __forceinline__ void load_row(T (&a)[kRows], const T* s, int n,
                                         int t) {
  const T* src = s + (t < n ? t : n - 1) * n;  // the stage's slack
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const T v = src[j];
    const bool keep = t < n && j < n && (!kStrictLower || j < t);
    a[j] = keep ? v : (t == j && !kStrictLower ? T(1) : T(0));
  }
}

// Forward substitution L y = g over the 32 rows of one warp, columns
// kBase .. kBase + 31 of its row `a`: y_k = y_k / L_kk on lane k,
// broadcast, and y_i -= L[i][k] y_k.  Padded rows (y = 0, inverse diagonal
// 1, row 0) change nothing.
template <typename T, int kBase>
__device__ __forceinline__ T forward_substitute(T y, const T (&a)[kRows],
                                                T inv_diag, int lane) {
#pragma unroll
  for (int m = 0; m < 32; ++m) {
    const T ym = __shfl_sync(0xffffffffu, y * inv_diag, m);
    y = lane == m ? ym : fma(-a[kBase + m], ym, y);
  }
  return y;
}

// Back substitution L^T x = y over the 32 rows of one warp, with c[m] =
// L[m'][i] for the warp's row m' = base + m below row i (else 0): x on
// lane m, broadcast, and y_i -= L[m'][i] x.  Padded rows (y = 0, inverse
// diagonal 1, column 0) change nothing.
template <typename T>
__device__ __forceinline__ T back_substitute(T y, const T (&c)[32],
                                             T inv_diag, int lane) {
#pragma unroll
  for (int m = 31; m >= 0; --m) {
    const T xm = __shfl_sync(0xffffffffu, y * inv_diag, m);
    y = lane == m ? xm : fma(-c[m], xm, y);
  }
  return y;
}

// y_i -= c[k] x_{32 + k} for k = 31 .. 0 (rows 63 .. 32, in the plain
// version's order), x read from shared memory with 16-byte broadcast loads.
template <typename T>
__device__ __forceinline__ T subtract_upper(T y, const T (&c)[32],
                                            const T* xs) {
  using V = typename Vec16<T>::type;
  constexpr int kV = Vec16<T>::kN;
#pragma unroll
  for (int q = 32 / kV - 1; q >= 0; --q) {
    const V v = reinterpret_cast<const V*>(xs)[q];
#pragma unroll
    for (int e = kV - 1; e >= 0; --e) y = fma(-c[q * kV + e], elem(v, e), y);
  }
  return y;
}

// c[m] = L[base + m][t] for base + m > t, else 0: column t of L from its
// slot, rows base .. base + 31.
template <typename T>
__device__ __forceinline__ void load_column(T (&c)[32], const T* slot,
                                            int base, int t) {
  using V = typename Vec16<T>::type;
  constexpr int kV = Vec16<T>::kN;
  const V* src = reinterpret_cast<const V*>(slot + base);
#pragma unroll
  for (int q = 0; q < 32 / kV; ++q) {
    const V v = src[q];
#pragma unroll
    for (int e = 0; e < kV; ++e) {
      const int m = q * kV + e;
      c[m] = base + m > t ? elem(v, e) : T(0);
    }
  }
}

// The same from the dense (n, n) stage of a packed factor, read down
// column t (the lanes of a warp at consecutive addresses).
template <typename T>
__device__ __forceinline__ void stage_column(T (&c)[32], const T* s,
                                             int base, int n, int t) {
  const T* src = s + (t < n ? t : 0);
#pragma unroll
  for (int m = 0; m < 32; ++m) {
    const int k = base + m;
    const T v = src[(k < n ? k : 0) * n];
    c[m] = k < n && k > t ? v : T(0);
  }
}

// One pivot's rank-1 update of row i over the 16-byte vector q of column
// k: a[i][j] -= l_ik l_jk for its columns j > k.
template <typename T>
__device__ __forceinline__ void rank1(T (&a)[kRows],
                                      const typename Vec16<T>::type& v, T lm,
                                      int k, int q) {
  constexpr int kV = Vec16<T>::kN;
#pragma unroll
  for (int e = 0; e < kV; ++e) {
    const int j = q * kV + e;
    if (j > k) a[j] = fma(-lm, elem(v, e), a[j]);
  }
}

// Pivots kFirst .. kLast - 1 of the right-looking factor, with the forward
// substitution L y = g fused in (kSolve), for a row whose columns end
// before kCols.  Both warps run pivots 0 .. 31 and meet at the group's
// barrier after each (kGroupSync); warp 0's rows end left of column 32, so
// it updates columns below 32 only and is done after pivot 31, and warp 1
// runs pivots 32 .. 63 alone, meeting at __syncwarp().  Column k of the
// packed factor is final at pivot k and goes into the stage at once (K1,
// K4), so a[k] is dead from then on.
template <typename T, bool kEmitFactor, bool kSolve, int kFirst, int kLast,
          int kCols, bool kGroupSync>
__device__ __forceinline__ void pivots(T (&a)[kRows], T& y, T& inv,
                                       T& inv_diag, T* cols, T* srow, int t,
                                       int n, int bar_id) {
  using V = typename Vec16<T>::type;
  constexpr int kV = Vec16<T>::kN;
  constexpr int S = kRows + kV;
#pragma unroll
  for (int k = kFirst; k < kLast; ++k) {
    T* col = cols + k * S;
    const bool below = t > k, at = t == k;
    const T lik = a[k] * inv;
    const T lm = below ? lik : T(0);  // l_ik below the pivot, 0 elsewhere
    col[t] = lm;
    if (kEmitFactor && k < n && t < n && t >= k) srow[k] = at ? inv : lik;
    if (kSolve && at) col[kRows + 1] = y * inv;  // y_k
    inv_diag = at ? inv : inv_diag;
    // Thread k + 1 updates its own diagonal with its own l_{k+1,k} and
    // publishes the next pivot's inverse beside column k.
    if (k + 1 < kRows && t == k + 1)
      col[kRows] = clamp_rsqrt(fma(-lm, lm, a[k + 1]));
    if (kGroupSync)
      group_sync(bar_id);
    else
      __syncwarp();
    const V ex = reinterpret_cast<const V*>(col + kRows)[0];
    if (kSolve) {
      const T yk = elem(ex, 1);
      y = at ? yk : fma(-lm, yk, y);
    }
    if (k + 1 < kRows) {
      inv = elem(ex, 0);
      const V* cv = reinterpret_cast<const V*>(col);
#pragma unroll
      for (int q = (k + 1) / kV; q < kCols / kV; ++q)
        rank1<T>(a, cv[q], lm, k, q);
    }
  }
}

// K1 (kEmitFactor, kSolve): solve + packed factor; K3 (kSolve): the solve
// alone; K4 (kEmitFactor): the packed factor alone, no rhs read and no x
// written.
template <typename T, bool kEmitFactor, bool kSolve>
__global__ void __launch_bounds__(kWideGroups * kGroup)
    cholesky_wide_solve_factor(const T* __restrict__ a_in,
                               const T* __restrict__ g_in,
                               T* __restrict__ x_out, T* __restrict__ fac_out,
                               int64_t batch, int n) {
  constexpr int S = kRows + Vec16<T>::kN;  // wide_col_stride(sizeof(T))
  constexpr int kMode = !kSolve ? MODE_FACTOR
                        : kEmitFactor ? MODE_SOLVE_FACTOR
                                      : MODE_SOLVE;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int t = threadIdx.x & (kGroup - 1);
  const int lane = threadIdx.x & (kWarp - 1);
  const bool upper_warp = t >= kWarp;  // rows 32 .. 63
  const int group = threadIdx.x / kGroup;
  const int bar_id = 1 + group;  // barrier 0 is __syncthreads'
  const int64_t mat = (int64_t)blockIdx.x * (blockDim.x / kGroup) + group;
  if (mat >= batch) return;  // the whole group exits together

  unsigned char* base =
      smem_raw + (size_t)group * wide_group_smem_bytes(n, sizeof(T), kMode);
  T* cols = reinterpret_cast<T*>(base + 16);  // slot k at cols + k S
  T* xs = cols + kRows * S;
  T* s = kEmitFactor ? xs + 32 : cols;
  const int64_t nn = (int64_t)n * n;
  // Loaded first: its latency overlaps the matrix's copy.
  T y = kSolve && t < n ? g_in[mat * n + t] : T(0);
  stage_in(s, a_in + mat * nn, n * n, reinterpret_cast<uint64_t*>(base), t,
           bar_id);
  T a[kRows];
  load_row<T, false>(a, s, n, t);
  T inv = clamp_rsqrt(s[0]);
  group_sync(bar_id);  // every row is in registers: the slots may be written

  T* srow = s + (t < n ? t : 0) * n;
  T inv_diag = T(1);
  if (upper_warp) {
    pivots<T, kEmitFactor, kSolve, 0, kWarp, kRows, true>(
        a, y, inv, inv_diag, cols, srow, t, n, bar_id);
    pivots<T, kEmitFactor, kSolve, kWarp, kRows, kRows, false>(
        a, y, inv, inv_diag, cols, srow, t, n, bar_id);
  } else {
    pivots<T, kEmitFactor, kSolve, 0, kWarp, kWarp, true>(
        a, y, inv, inv_diag, cols, srow, t, n, bar_id);
  }

  // The stage now holds the packed factor: out with one bulk store.
  if (kEmitFactor) stage_out(fac_out + mat * nn, s, n * n, t, bar_id);

  if constexpr (kSolve) {
    // Back substitution L^T x = y.  Rows 32 .. 63 first, within warp 1;
    // their x reaches warp 0 through shared memory.
    const T* mine = cols + t * S;  // column t of L
    T c[32];
    load_column<T>(c, mine, 32, t);
    if (upper_warp) {
      y = back_substitute<T>(y, c, inv_diag, lane);
      xs[lane] = y;
    }
    group_sync(bar_id);
    if (!upper_warp) {
      y = subtract_upper<T>(y, c, xs);
      load_column<T>(c, mine, 0, t);
      y = back_substitute<T>(y, c, inv_diag, lane);
    }
    if (t < n) x_out[mat * n + t] = y;
  }
  if (kEmitFactor) stage_out_wait(t);
}

// K2: resolve against a packed factor staged in shared memory: row i of L
// in registers for the forward pass, column i read down the stage for the
// backward pass.  Only the strict lower triangle and the diagonal are
// read.  `xs` carries y of rows 0 .. 31 to warp 1, then x of rows
// 32 .. 63 to warp 0.
template <typename T>
__global__ void __launch_bounds__(kWideGroups * kGroup)
    cholesky_wide_resolve(const T* __restrict__ fac_in,
                          const T* __restrict__ g_in, T* __restrict__ x_out,
                          int64_t batch, int n) {
  using V = typename Vec16<T>::type;
  constexpr int kV = Vec16<T>::kN;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int t = threadIdx.x & (kGroup - 1);
  const int lane = threadIdx.x & (kWarp - 1);
  const bool upper_warp = t >= kWarp;  // rows 32 .. 63
  const int group = threadIdx.x / kGroup;
  const int bar_id = 1 + group;
  const int64_t mat = (int64_t)blockIdx.x * (blockDim.x / kGroup) + group;
  if (mat >= batch) return;

  unsigned char* base =
      smem_raw +
      (size_t)group * wide_group_smem_bytes(n, sizeof(T), MODE_RESOLVE);
  T* xs = reinterpret_cast<T*>(base + 16);
  T* s = xs + 32;
  // Loaded first: its latency overlaps the factor's copy.
  T y = t < n ? g_in[mat * n + t] : T(0);
  stage_in(s, fac_in + mat * (int64_t)n * n, n * n,
           reinterpret_cast<uint64_t*>(base), t, bar_id);
  T a[kRows];
  load_row<T, true>(a, s, n, t);
  const T inv_diag = t < n ? s[t * n + t] : T(1);

  // Forward substitution L y = g: rows 0 .. 31 within warp 0, published;
  // warp 1 subtracts them (k = 0 .. 31, in the plain version's order) and
  // solves its own block.
  if (!upper_warp) {
    y = forward_substitute<T, 0>(y, a, inv_diag, lane);
    xs[lane] = y;
  }
  group_sync(bar_id);
  if (upper_warp) {
#pragma unroll
    for (int q = 0; q < 32 / kV; ++q) {
      const V v = reinterpret_cast<const V*>(xs)[q];
#pragma unroll
      for (int e = 0; e < kV; ++e) y = fma(-a[q * kV + e], elem(v, e), y);
    }
    y = forward_substitute<T, kWarp>(y, a, inv_diag, lane);
  }

  // Back substitution L^T x = y, blocked as K1's.  Warp 1's reads of xs
  // above feed the shuffles its write below waits on.
  T c[32];
  stage_column<T>(c, s, 32, n, t);
  if (upper_warp) {
    y = back_substitute<T>(y, c, inv_diag, lane);
    xs[lane] = y;
  }
  group_sync(bar_id);
  if (!upper_warp) {
    y = subtract_upper<T>(y, c, xs);
    stage_column<T>(c, s, 0, n, t);
    y = back_substitute<T>(y, c, inv_diag, lane);
  }
  if (t < n) x_out[mat * n + t] = y;
}

// Lifts the kernel's dynamic shared-memory limit where 48 KB is too few.
template <typename KernelT>
cudaError_t allow_smem(KernelT kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T>
int dispatch_wide(int mode, const void* a, const void* g, void* x, void* fac,
                  int64_t batch, int n, int groups, void* stream) {
  if (mode < MODE_SOLVE || mode > MODE_FACTOR || n < 1 || n > kRows ||
      groups != kWideGroups)
    return (int)cudaErrorInvalidValue;
  if (batch <= 0) return (int)cudaSuccess;
  const size_t smem =
      (size_t)groups * wide_group_smem_bytes(n, sizeof(T), mode);
  const int64_t blocks = (batch + groups - 1) / groups;
  const dim3 grid((unsigned)blocks), block(groups * kGroup);
  cudaStream_t st = (cudaStream_t)stream;
  if (mode != MODE_RESOLVE) {
    auto kernel = mode == MODE_SOLVE_FACTOR
                      ? cholesky_wide_solve_factor<T, true, true>
                  : mode == MODE_FACTOR
                      ? cholesky_wide_solve_factor<T, true, false>
                      : cholesky_wide_solve_factor<T, false, true>;
    const cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, block, smem, st>>>((const T*)a, (const T*)g, (T*)x,
                                      (T*)fac, batch, n);
  } else {
    auto kernel = cholesky_wide_resolve<T>;
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
// packed factor (K2), 3 packed factor (K4); 1 <= n <= 64; groups: matrices
// (two warps each) per block, kWideGroups (2).  elem_bytes: 4 (float) or 8
// (double).  a: (batch, n, n) matrices or packed factors; g: (batch, n)
// (unused in mode 3); x: (batch, n) out (unused in mode 3); fac:
// (batch, n, n) out (modes 1 and 3, else unused).  Returns the cudaError_t
// of the launch (0 on success).
int dex_cholesky_wide(int mode, int elem_bytes, const void* a, const void* g,
                      void* x, void* fac, int64_t batch, int n, int groups,
                      void* stream) {
  if (elem_bytes == 4)
    return dispatch_wide<float>(mode, a, g, x, fac, batch, n, groups, stream);
  if (elem_bytes == 8)
    return dispatch_wide<double>(mode, a, g, x, fac, batch, n, groups,
                                 stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"

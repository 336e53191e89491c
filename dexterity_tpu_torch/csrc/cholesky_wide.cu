// Batched small dense Cholesky kernels for Hopper (sm_90a), wide register
// design: all four modes at 32 < n <= 80, the sizes of the juggle task's
// two-hand model (n = nv = 62) up to the top of the JAX package's Pallas
// range (80).
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
// every mode at n > 80.
//
// Numerics match the Pallas kernels: right-looking order (each a_ij takes
// its rank-1 terms for k = 0, 1, ... in order), pivot clamp
// rsqrt(max(a_kk, 1e-12)), the same column scaling, and the same packed
// factor layout (strict lower = L, diagonal = 1 / L_kk, upper unspecified:
// here the input's), which K2 reads unchanged.  K2 gives each y_i its
// terms in k order and each x_i its terms for k = n - 1, n - 2, ..., as
// _resolve_kernel does.
//
// One matrix per group of kWarps warps, thread i holding row i in
// registers; rows and columns n .. kRows - 1 are the identity's, so the
// pivot loop is unrolled over all kRows pivots and a padded pivot changes
// nothing.  Two layouts (the kernel is templated on rows and warps):
// kRows = 64 over two warps (32 < n <= 64) and kRows = 80 over three
// warps (64 < n <= 80; threads 80 .. 95 hold no row and take part in the
// barriers and shuffles only), every mode in each.
// (cholesky_regs.cu with two rows per lane spills K1 in both types under
// ptxas 12.8: one row per thread halves the row state.)
//
// What bounds each on this card:
//   - K3: at the suite's (4096, 62, 62) float32 the ~n^3 / 3 FMAs per
//     matrix (10.2 us at the FP32 rate) and the bytes (10.1 us at 3.35
//     TB/s for one triangle of each matrix; the whole squares this kernel
//     reads take 19 us) stand level.  At the juggle environment's
//     (32, 62, 62) the card is nearly empty and the floor is the 62-step
//     dependent chain: pivot k + 1 needs pivot k's column.  At (1024, 80,
//     80): operations, 5.41 us.
//   - K1 at (1024, 62, 62): bytes, 4.93 us; K4 the same less the two
//     vectors: bytes, 4.78 us.  Both run K3's pivot chain.  At
//     (1024, 80, 80): bytes, 8.12 and 7.92 us.
//   - K2 at (1024, 62, 62): bytes, 2.54 us (a triangle and two vectors a
//     matrix; its n^2 FMAs are nothing); at (1024, 80, 80) 4.16 us.  At
//     (32, 62, 62): the chain of 2n substitution steps, each a shuffle and
//     an FMA.
// What the design does about each:
//   - bytes: each matrix is read once, by one 1-D TMA bulk copy
//     (cp.async.bulk with an mbarrier) into a dense shared-memory stage
//     where its bytes and address are 16-byte multiples, else by an element
//     copy; the packed factor (K1, K4) leaves the same way, by one bulk
//     store.  No per-element division by n.  K2 and K3 at 80 rows read only
//     the lower triangle: they copy just that, an element a lane by
//     cp.async, into a stage of odd row stride (stage_lower,
//     wide_stage_ld), where a dense stride of 80 would put a warp's row
//     loads in 2 banks.  K3's stage lies inside its column slots, which it
//     no longer needs once the rows are in registers.
//   - operations: each thread updates its own row, reading the pivot
//     column from shared memory with 16-byte broadcast loads (four floats
//     or two doubles an instruction).  Warp w's rows end left of column
//     32 (w + 1): it updates the columns below that only and is done after
//     pivot 32 (w + 1) - 1.  At n = 62 a matrix takes 32 x (2,016 + 496) =
//     80,384 FMAs, about the n^3 / 3 that bound counts.
//   - the factor's chain: one named barrier per pivot (bar.sync id, count)
//     of the warps still working, __syncwarp() once one warp is left, and
//     nothing block-wide.  Pivots 0 .. 31 meet at the group's barrier (id
//     1 + group, every warp); with three warps, pivots 32 .. 63 meet at a
//     64-thread barrier of warps 1 and 2 (id 1 + kWideGroups + group);
//     the last warp runs the rest alone.  Every pivot's column has its
//     own slot (kRows slots, kept for the back substitution), so a slot
//     is never rewritten and one barrier orders both the writes of pivot k
//     and the reads of pivot k - 1.  The pivot's inverse diagonal rides in
//     the slot of the pivot before it: thread k + 1 updates its own
//     diagonal with its own l_{k+1,k} (the FFMA the column update repeats,
//     to the bit) and stores rsqrt of it beside column k, so the barrier
//     that publishes column k publishes inv_{k+1} too; y_k of the fused
//     forward substitution rides there as well.
//   - K2's chain, blocked by warp: a barrier a block of 32 rows each way
//     instead of one a step.  Forward (forward_blocks): warp 0 solves y_0
//     .. y_31 by shuffles (lane k broadcasts y_k / L_kk, a multiply by the
//     stored inverse) and publishes them; after the group's barrier the
//     warps below subtract L[i][0:32] y[0:32] from their rows with 16-byte
//     broadcast loads, and warp 1 solves its block; with three warps it
//     publishes y_32 .. y_63, and after a 64-thread barrier warp 2
//     subtracts them and solves its 16 rows.  Over three warps a thread
//     holds one block of its row at a time.
//     Back substitution as K1's below, with column i of L read down the
//     stage (the lanes of a warp at consecutive addresses): no transpose
//     and no column slots.
//   - registers at kRows = 80: left alone, ptxas issues a pivot's whole
//     column (up to 40 16-byte loads) before its first FMA: float32 K1
//     then needs more registers than two blocks an SM allow, and float64
//     K1 spills.  So a never-taken branch every kChunk columns of the
//     update bounds the loads in flight (float32 K1 152 registers, K4
//     148: two blocks an SM), and in float64 the last warp keeps its own
//     16 columns out of its registers until pivot 64: warps 1 and 2 then
//     both update 64 columns through pivots 0 .. 63, and warp 2 gives its
//     last 16 their 64 deferred terms in one pass with no barrier
//     (deferred_block), in the same order, to the bit (190 registers, no
//     spill; float32 fits without that pass, which only adds latency).
//     The block waits in 2 KB of its own (save_deferred: K3's stage lies
//     in the slots, which pivot 0 starts to overwrite), and l_tk comes
//     from slot k, which holds the same l_tk the packed factor does.
//   - occupancy: the barriers' ids are not constants, so ptxas reserves
//     all 16 named barriers for a block, and a Hopper SM then holds at
//     most 4 such blocks whatever the ids used; a block takes two matrices
//     (kWideGroups; four were slower at n = 62), and at kRows = 80 the
//     registers decide how many blocks an SM holds.
//   - the back substitution needs columns of L, which a thread cannot take
//     from other threads' registers: thread j reads its column j from the
//     slots (K1, K3) or the stage (K2) off the chain.  It is blocked by
//     warp from the last: the last warp solves its rows by shuffles and
//     publishes x; after one barrier each warp above subtracts them, and
//     the next warp up solves its block, until warp 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWideGroups = 2;  // matrices per block (linalg_cuda mirrors)
constexpr int MODE_SOLVE = 0;
constexpr int MODE_SOLVE_FACTOR = 1;
constexpr int MODE_RESOLVE = 2;
constexpr int MODE_FACTOR = 3;

// A matrix of at most kRows_ rows, a row per thread over kWarps_ warps.
// kChunk: columns of a pivot's update between never-taken branches (0:
// none), which end a block ptxas cannot schedule across (see pivots).
// kDefer: the last warp's own block of columns, from kLastBase on, stays
// out of its registers until its own phase (deferred_block; float64 at
// kRows = 80).
template <int kRows_, int kWarps_, bool kDefer_ = false>
struct Layout {
  static constexpr int kRows = kRows_;
  static constexpr int kWarps = kWarps_;
  static constexpr int kGroup = kWarps * kWarp;  // threads per matrix
  static constexpr int kChunk = kRows > 64 ? 32 : 0;
  static constexpr bool kDefer = kDefer_;
  static constexpr int kLastBase = kWarp * (kWarps - 1);
  // Columns load_row puts in registers.
  static constexpr int kLoadCols = kDefer ? kLastBase : kRows;
};

__host__ __device__ constexpr int cmin(int a, int b) { return a < b ? a : b; }

__device__ __forceinline__ float clamp_rsqrt(float x) {
  return rsqrtf(fmaxf(x, 1e-12f));
}
__device__ __forceinline__ double clamp_rsqrt(double x) {
  return rsqrt(fmax(x, 1e-12));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// The kThreads threads of some warps of one matrix group meet at their own
// named barrier.
template <int kThreads>
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(kThreads) : "memory");
}

// Cycle stamps of each warp of each matrix at entry, with its rows loaded,
// after its pivots and at its end: (batch, 4, 4) int64, in a build with
// DEX_PHASE_CLOCKS defined only (chip_smoke.py --phase-split).
#ifdef DEX_PHASE_CLOCKS
__device__ long long* g_phase_clocks;
#define DEX_STAMP(mat, warp, lane, i)                                    \
  do {                                                                   \
    if ((lane) == 0) g_phase_clocks[((mat) * 4 + (warp)) * 4 + (i)] =    \
        clock64();                                                       \
  } while (0)
#else
#define DEX_STAMP(mat, warp, lane, i) \
  do {                                \
  } while (0)
#endif

// Shared memory per group: a 16-byte slot for the mbarrier; except for K2,
// kRows column slots of kRows elements plus 16 bytes (slot k holds column
// k of L, then inv_{k+1} and y_k; each slot 16-byte aligned, and thread
// j's reads of slot j spread over the banks); 32 elements for y or x of
// each warp but the first; where the last warp defers its own block
// (float64 at kRows = 80, K1, K3 and K4), that block of the matrix as it
// came in; then, except for K3, the (n, n) stage at row stride
// wide_stage_ld with kRows elements of slack, so a padded row's loads stay
// inside it.  K3's stage lies in the column slots.
__host__ __device__ inline int wide_col_stride(int rows, int elem) {
  return rows + 16 / elem;
}
// Row stride of the stage: odd (n | 1) where the stage holds a lower
// triangle (stage_lower: K2; K3, in its slots; at 80 rows), so that a
// warp's loads of its rows (thread t in row t) fall in 32 banks, where a
// stride of 80 puts them in 2 (float32; float64 in 1 pair); dense (n)
// elsewhere: K1's and K4's stage becomes the packed factor, which leaves
// by one bulk store, and at 64 rows the stage comes in by one bulk copy.
__host__ __device__ inline int wide_stage_ld(int rows, int n, int mode) {
  return rows > 64 && (mode == MODE_SOLVE || mode == MODE_RESOLVE) ? (n | 1)
                                                                  : n;
}
__host__ __device__ inline size_t wide_group_smem_bytes(int rows, int warps,
                                                        int n, int elem,
                                                        int mode) {
  const size_t cols =
      mode == MODE_RESOLVE
          ? 0
          : (size_t)rows * wide_col_stride(rows, elem) * elem;
  const size_t last = rows - 32 * (warps - 1);  // the last warp's rows
  const size_t deferred =
      mode != MODE_RESOLVE && rows > 64 && elem == 8 ? last * last * elem : 0;
  const size_t stage =
      mode == MODE_SOLVE
          ? 0
          : ((((size_t)n * wide_stage_ld(rows, n, mode) + rows) * elem + 15) &
             ~(size_t)15);
  return 16 + cols + (size_t)32 * (warps - 1) * elem + deferred + stage;
}

// A branch that is never taken (n < 0): it ends a block that ptxas does
// not schedule across.  The empty asm hides n's value, so that the
// compiler does not fold one such test into the one before it.
__device__ __forceinline__ void block_fence(int n) {
  asm volatile("" : "+r"(n));
  if (n < 0) __trap();
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
// aligned) for the group of kGroup threads and returns once every thread
// may read them: one TMA bulk copy where allowed, else an element copy.
template <typename T, int kGroup>
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
    // The mbarrier is initialised before anyone waits.
    bar_sync<kGroup>(bar_id);
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
  bar_sync<kGroup>(bar_id);
}

// Copies the lower triangle, diagonal included, of the (n, n) matrix
// `src` into the stage `dst` at row stride `ld` (wide_stage_ld) for the
// group of kGroup threads and returns once every thread may read it: an
// asynchronous copy of an element a lane (cp.async; a warp a row, the
// lanes along it), which reads half the square's bytes (K2 and K3 at 80
// rows read no more of it) and, unlike a bulk copy, spreads the rows.
template <typename T, int kGroup>
__device__ __forceinline__ void stage_lower(T* dst, const T* src, int n,
                                            int ld, int t, int bar_id) {
  for (int r = t / kWarp; r < n; r += kGroup / kWarp)
    for (int c = t % kWarp; c <= r; c += kWarp)
      asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                       smem_u32(dst + r * ld + c)),
                   "l"(src + (int64_t)r * n + c), "n"((int)sizeof(T))
                   : "memory");
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  bar_sync<kGroup>(bar_id);
}

// Copies the dense stage `src`, just written by this group, to `dst`: one
// TMA bulk store where allowed (stage_out_wait before the group exits),
// else an element copy.
template <typename T, int kGroup>
__device__ __forceinline__ void stage_out(T* dst, const T* src, int count,
                                          int t, int bar_id) {
  const uint32_t bytes = (uint32_t)count * sizeof(T);
  if (bulk_ok(dst, bytes)) {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    bar_sync<kGroup>(bar_id);
    if (t == 0) {
      asm volatile(
          "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
          ::"l"((uint64_t)(uintptr_t)dst), "r"(smem_u32(src)), "r"(bytes)
          : "memory");
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
  } else {
    bar_sync<kGroup>(bar_id);
    for (int i = t; i < count; i += kGroup) dst[i] = src[i];
  }
}

// Holds the group until its bulk store, if any, has read the stage.
__device__ __forceinline__ void stage_out_wait(int t) {
  if (t == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// The part of a row the kernels keep: all of it (K1, K4; K3 at 64 rows),
// the lower triangle with the diagonal (K3 at 80 rows, whose stage holds
// no more: stage_lower) or the strict lower triangle (K2: a packed
// factor's L).  The rest reads as zero.
constexpr int kFull = 0, kLower = 1, kStrictLower = 2;

// Element j of row `t` of the (n, n) stage as the kernels take it: rows
// and columns n .. kRows - 1 of the identity (a thread past kRows holds
// zeros), only part kPart of each row.  `src` is row t, or row n - 1 on a
// padded row (the stage's slack).
template <typename T, int kPart>
__device__ __forceinline__ T row_elem(const T* src, int j, int n, int t) {
  const T v = src[j];
  const bool keep = t < n && j < n &&
                    (kPart == kFull || j < t || (kPart == kLower && j == t));
  return keep ? v : (t == j && kPart != kStrictLower ? T(1) : T(0));
}

// Columns kFrom .. kTo - 1 of row `t` of the stage (row stride ld) into
// registers (row_elem).
template <typename T, int kRows, int kPart, int kFrom = 0, int kTo = kRows>
__device__ __forceinline__ void load_row(T (&a)[kRows], const T* s, int ld,
                                         int n, int t) {
  const T* src = s + (t < n ? t : n - 1) * ld;
#pragma unroll
  for (int j = kFrom; j < kTo; ++j)
    a[j] = row_elem<T, kPart>(src, j, n, t);
}

// Forward substitution L y = g over the kM rows of a block of one warp,
// columns kBase .. kBase + kM - 1 of its row `a`: y_k = y_k / L_kk on lane
// k, broadcast, and y_i -= L[i][k] y_k.  Padded rows (y = 0, inverse
// diagonal 1, row 0) change nothing.
template <typename T, int kRows, int kBase, int kM = 32>
__device__ __forceinline__ T forward_substitute(T y, const T (&a)[kRows],
                                                T inv_diag, int lane) {
#pragma unroll
  for (int m = 0; m < kM; ++m) {
    const T ym = __shfl_sync(0xffffffffu, y * inv_diag, m);
    y = lane == m ? ym : fma(-a[kBase + m], ym, y);
  }
  return y;
}

// y_i -= L[i][kBase + k] y_{kBase + k} for k = 0 .. 31 (the plain
// version's order), y read from shared memory with 16-byte broadcast
// loads.
template <typename T, int kRows, int kBase>
__device__ __forceinline__ T subtract_lower(T y, const T (&a)[kRows],
                                            const T* ys) {
  using V = typename Vec16<T>::type;
  constexpr int kV = Vec16<T>::kN;
#pragma unroll
  for (int q = 0; q < kWarp / kV; ++q) {
    const V v = reinterpret_cast<const V*>(ys)[q];
#pragma unroll
    for (int e = 0; e < kV; ++e) y = fma(-a[kBase + q * kV + e], elem(v, e), y);
  }
  return y;
}

// Back substitution L^T x = y over the kM rows of a block of one warp,
// with c[m] = L[m'][i] for the block's row m' = base + m below row i (else
// 0): x on lane m, broadcast, and y_i -= L[m'][i] x.  Padded rows (y = 0,
// inverse diagonal 1, column 0) change nothing.
template <typename T, int kM>
__device__ __forceinline__ T back_substitute(T y, const T (&c)[32],
                                             T inv_diag, int lane) {
#pragma unroll
  for (int m = kM - 1; m >= 0; --m) {
    const T xm = __shfl_sync(0xffffffffu, y * inv_diag, m);
    y = lane == m ? xm : fma(-c[m], xm, y);
  }
  return y;
}

// y_i -= c[k] x_{base + k} for k = kM - 1 .. 0 (the block's rows from the
// last, in the plain version's order), x read from shared memory with
// 16-byte broadcast loads.
template <typename T, int kM>
__device__ __forceinline__ T subtract_upper(T y, const T (&c)[32],
                                            const T* xs) {
  using V = typename Vec16<T>::type;
  constexpr int kV = Vec16<T>::kN;
#pragma unroll
  for (int q = kM / kV - 1; q >= 0; --q) {
    const V v = reinterpret_cast<const V*>(xs)[q];
#pragma unroll
    for (int e = kV - 1; e >= 0; --e) y = fma(-c[q * kV + e], elem(v, e), y);
  }
  return y;
}

// c[m] = L[base + m][t] for base + m > t, else 0, m < kM: column t of L
// from its slot, rows base .. base + kM - 1.
template <typename T, int kM>
__device__ __forceinline__ void load_column(T (&c)[32], const T* slot,
                                            int base, int t) {
  using V = typename Vec16<T>::type;
  constexpr int kV = Vec16<T>::kN;
  const V* src = reinterpret_cast<const V*>(slot + base);
#pragma unroll
  for (int q = 0; q < kM / kV; ++q) {
    const V v = src[q];
#pragma unroll
    for (int e = 0; e < kV; ++e) {
      const int m = q * kV + e;
      c[m] = base + m > t ? elem(v, e) : T(0);
    }
  }
}

// The same from the (n, n) stage (row stride ld) of a packed factor, read
// down column t (the lanes of a warp at consecutive addresses).
template <typename T, int kM>
__device__ __forceinline__ void stage_column(T (&c)[32], const T* s,
                                             int base, int ld, int n, int t) {
  const T* src = s + (t < n ? t : 0);
#pragma unroll
  for (int m = 0; m < kM; ++m) {
    const int k = base + m;
    const T v = src[(k < n ? k : 0) * ld];
    c[m] = k < n && k > t ? v : T(0);
  }
}

// Column t of L, rows base .. base + kM - 1 below row t, into c: from the
// slot `src` (kFromStage false: K1, K3) or down the stage `src` (K2).
template <typename T, int kM, bool kFromStage>
__device__ __forceinline__ void column_of_l(T (&c)[32], const T* src,
                                            int base, int ld, int n, int t) {
  if constexpr (kFromStage)
    stage_column<T, kM>(c, src, base, ld, n, t);
  else
    load_column<T, kM>(c, src, base, t);
}

// One pivot's rank-1 update of row i over the 16-byte vector q of column
// k: a[i][j] -= l_ik l_jk for its columns j > k.
template <typename T, int kRows>
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
// before kCols, the kSync threads of the warps still working meeting at
// barrier `bar_id` after each (__syncwarp() for one warp).  Column k of the
// packed factor is final at pivot k and goes into the stage at once (K1,
// K4), so a[k] is dead from then on.
template <typename T, class L, bool kEmitFactor, bool kSolve, int kFirst,
          int kLast, int kCols, int kSync>
__device__ __forceinline__ void pivots(T (&a)[L::kRows], T& y, T& inv,
                                       T& inv_diag, T* cols, T* srow, int t,
                                       int n, int bar_id) {
  using V = typename Vec16<T>::type;
  constexpr int kRows = L::kRows;
  constexpr int kV = Vec16<T>::kN;
  constexpr int S = kRows + kV;
#pragma unroll
  for (int k = kFirst; k < kLast; ++k) {
    T* col = cols + k * S;
    const bool below = t > k, at = t == k;
    const T lik = a[k] * inv;
    const T lm = below ? lik : T(0);  // l_ik below the pivot, 0 elsewhere
    if (L::kGroup == kRows || t < kRows) col[t] = lm;
    if (kEmitFactor && k < n && t < n && t >= k) srow[k] = at ? inv : lik;
    if (kSolve && at) col[kRows + 1] = y * inv;  // y_k
    inv_diag = at ? inv : inv_diag;
    // Thread k + 1 updates its own diagonal with its own l_{k+1,k} and
    // publishes the next pivot's inverse beside column k (not where that
    // diagonal is a deferred column: deferred_block's shuffle does).
    if (k + 1 < kRows && t == k + 1 && (!L::kDefer || k + 1 < kCols))
      col[kRows] = clamp_rsqrt(fma(-lm, lm, a[k + 1]));
    if (kSync > kWarp)
      bar_sync<kSync>(bar_id);
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
      for (int q = (k + 1) / kV; q < kCols / kV; ++q) {
        rank1<T, kRows>(a, cv[q], lm, k, q);
        if constexpr (L::kChunk > 0) {
          if ((q + 1) * kV % L::kChunk == 0) block_fence(n);
        }
      }
    }
  }
}

// The last warp's own block, rows and columns kLastBase .. kRows - 1 (as
// row_elem gives them), into `blk` (kLast x kLast, column-major: a warp's
// reads at consecutive addresses) before the slots may be written: K3's
// stage lies in them.
template <typename T, class L, int kPart>
__device__ __forceinline__ void save_deferred(T* blk, const T* s, int ld,
                                              int n, int t) {
  constexpr int kBase = L::kLastBase, kLast = L::kRows - kBase;
  if (t < kBase || t >= L::kRows) return;
  const T* src = s + (t < n ? t : n - 1) * ld;
#pragma unroll
  for (int j = kBase; j < L::kRows; ++j)
    blk[(j - kBase) * kLast + t - kBase] = row_elem<T, kPart>(src, j, n, t);
}

// The last warp's own block of columns (kLastBase .. kRows - 1), kept
// out of its registers through the phases before its own (kDefer): loaded
// from `blk` (save_deferred), then given the terms of pivots 0 ..
// kLastBase - 1 in that order, l_tk and l_jk both read from slot k: the
// FMAs of the rank-1 updates the warp skipped, to the bit.  The next
// pivot's inverse then comes from its diagonal's owner, lane 0, by
// shuffle.
template <typename T, class L>
__device__ __forceinline__ void deferred_block(T (&a)[L::kRows], T& inv,
                                               const T* cols, const T* blk,
                                               int t, int n) {
  using V = typename Vec16<T>::type;
  constexpr int kRows = L::kRows, kBase = L::kLastBase;
  constexpr int kLast = kRows - kBase;
  constexpr int kV = Vec16<T>::kN;
  constexpr int S = kRows + kV;
  const bool mine = t < kRows;  // threads past kRows hold zeros
  const T* src = blk + (mine ? t - kBase : 0);
#pragma unroll
  for (int j = kBase; j < kRows; ++j)
    a[j] = mine ? src[(j - kBase) * kLast] : T(0);
#pragma unroll
  for (int k = 0; k < kBase; ++k) {
    const T lm = t < n ? cols[k * S + t] : T(0);  // l_tk; 0 on a padded row
    const V* cv = reinterpret_cast<const V*>(cols + k * S);
#pragma unroll
    for (int q = kBase / kV; q < kRows / kV; ++q)
      rank1<T, kRows>(a, cv[q], lm, k, q);
    block_fence(n);
  }
  inv = __shfl_sync(0xffffffffu, clamp_rsqrt(a[kBase]), 0);
}

// Warp kW's pivots: phases kP .. kW, phase p being pivots 32 p .. 32 p +
// 31 (up to kRows), which warps p .. kWarps - 1 run together, meeting at
// barrier bar_id + p kWideGroups (of their 32 (kWarps - p) threads) after
// each.  Warp kW's rows end before column 32 (kW + 1): it updates those
// columns only, and is done after its own phase.  With kDefer the last
// warp updates its columns before kLastBase only until its own phase.
template <typename T, class L, bool kEmitFactor, bool kSolve, int kW,
          int kP = 0>
__device__ __forceinline__ void warp_pivots(T (&a)[L::kRows], T& y, T& inv,
                                            T& inv_diag, T* cols, T* srow,
                                            const T* blk, int t, int n,
                                            int bar_id) {
  constexpr bool kDeferring = L::kDefer && kW == L::kWarps - 1 && kP < kW;
  if constexpr (L::kDefer && kW == L::kWarps - 1 && kP == kW && kP > 0)
    deferred_block<T, L>(a, inv, cols, blk, t, n);
  pivots<T, L, kEmitFactor, kSolve, kWarp * kP,
         cmin(kWarp * (kP + 1), L::kRows),
         kDeferring ? L::kLastBase : cmin(kWarp * (kW + 1), L::kRows),
         kWarp * (L::kWarps - kP)>(a, y, inv, inv_diag, cols, srow, t, n,
                                   bar_id + kP * kWideGroups);
  if constexpr (kP < kW)
    warp_pivots<T, L, kEmitFactor, kSolve, kW, kP + 1>(
        a, y, inv, inv_diag, cols, srow, blk, t, n, bar_id);
}

// Each warp to its own pivots, from the last warp (kW) down.
template <typename T, class L, bool kEmitFactor, bool kSolve, int kW>
__device__ __forceinline__ void all_pivots(T (&a)[L::kRows], T& y, T& inv,
                                           T& inv_diag, T* cols, T* srow,
                                           const T* blk, int t, int n,
                                           int bar_id) {
  if constexpr (kW == 0) {
    warp_pivots<T, L, kEmitFactor, kSolve, 0>(a, y, inv, inv_diag, cols,
                                              srow, blk, t, n, bar_id);
  } else {
    if (t >= kWarp * kW) {
      warp_pivots<T, L, kEmitFactor, kSolve, kW>(a, y, inv, inv_diag, cols,
                                                 srow, blk, t, n, bar_id);
    } else {
      all_pivots<T, L, kEmitFactor, kSolve, kW - 1>(
          a, y, inv, inv_diag, cols, srow, blk, t, n, bar_id);
    }
  }
}

// Back substitution L^T x = y, blocks kS .. 0 (block s: rows 32 s ..
// 32 s + 31, warp s's).  Warp kS solves its block by shuffles once the x
// of every block below it is subtracted, and publishes x in xs; after the
// group's barrier the warps above it subtract that x, each with column t
// of L read before the barrier from its slot (`src`, K1 and K3) or down
// the stage (`src`, kFromStage: K2).
template <typename T, class L, bool kFromStage, int kS>
__device__ __forceinline__ void back_blocks(T& y, T (&c)[32], const T* src,
                                            int ld, T* xs, T inv_diag,
                                            int lane, int t, int n,
                                            int bar_id) {
  constexpr int kM = cmin(kWarp, L::kRows - kWarp * kS);  // the block's rows
  if constexpr (kS == 0) {
    if (t < kWarp) {
      column_of_l<T, kM, kFromStage>(c, src, 0, ld, n, t);
      y = back_substitute<T, kM>(y, c, inv_diag, lane);
    }
  } else {
    const bool top = kS == L::kWarps - 1;  // no warp below this block's
    if (top || t < kWarp * (kS + 1))
      column_of_l<T, kM, kFromStage>(c, src, kWarp * kS, ld, n, t);
    if (t >= kWarp * kS && (top || t < kWarp * (kS + 1))) {
      y = back_substitute<T, kM>(y, c, inv_diag, lane);
      xs[kWarp * (kS - 1) + lane] = y;
    }
    bar_sync<L::kGroup>(bar_id);
    if (t < kWarp * kS) y = subtract_upper<T, kM>(y, c, xs + kWarp * (kS - 1));
    back_blocks<T, L, kFromStage, kS - 1>(y, c, src, ld, xs, inv_diag, lane,
                                          t, n, bar_id);
  }
}

// Forward substitution L y = g, blocked by warp from the first (K2): warp
// kP solves its block by shuffles and publishes y in xs; after the barrier
// of warps kP .. kWarps - 1 (bar_id + kP kWideGroups, as the pivots') the
// warps below it subtract L[i][32 kP : 32 kP + 32] y[32 kP : 32 kP + 32]
// (k in order).  With two warps warp 1 holds its whole row from the start
// (80 / 154 registers in float32 / float64).  With three, a thread holds
// one block of its row at a time, loading the next after it subtracts one;
// the never-taken branch between them keeps ptxas from issuing the loads
// early (63 / 106 registers: in float32 four blocks of two matrices an SM,
// one wave of 1,056).  ptxas spilled 4 bytes each way round: at 80 rows
// with two blocks held (80 registers), at 64 with one (56).
template <typename T, class L, int kP>
__device__ __forceinline__ void forward_blocks(T& y, T (&a)[L::kRows],
                                               T* xs, const T* s, int ld,
                                               T inv_diag, int w, int lane,
                                               int t, int n, int bar_id) {
  constexpr int kRows = L::kRows, kB = kWarp * kP;
  if (w == kP) {
    y = forward_substitute<T, kRows, kB, cmin(kWarp, kRows - kB)>(
        y, a, inv_diag, lane);
    if constexpr (kP + 1 < L::kWarps) xs[kB + lane] = y;
  }
  if constexpr (kP + 1 < L::kWarps) {
    bar_sync<kWarp * (L::kWarps - kP)>(bar_id + kP * kWideGroups);
    if (w > kP) {
      y = subtract_lower<T, kRows, kB>(y, a, xs + kB);
      if constexpr (L::kWarps > 2) {
        block_fence(n);
        load_row<T, kRows, kStrictLower, kB + kWarp,
                 cmin(kB + 2 * kWarp, kRows)>(a, s, ld, n, t);
      }
      forward_blocks<T, L, kP + 1>(y, a, xs, s, ld, inv_diag, w, lane, t, n,
                                   bar_id);
    }
  }
}

// K1 (kEmitFactor, kSolve): solve + packed factor; K3 (kSolve): the solve
// alone; K4 (kEmitFactor): the packed factor alone, no rhs read and no x
// written.  A matrix of at most kRows rows over kWarps warps.
template <typename T, int kRows, int kWarps, bool kEmitFactor, bool kSolve>
__global__ void __launch_bounds__(kWideGroups * kWarps * kWarp)
    cholesky_wide_solve_factor(const T* __restrict__ a_in,
                               const T* __restrict__ g_in,
                               T* __restrict__ x_out, T* __restrict__ fac_out,
                               int64_t batch, int n) {
  using L = Layout<kRows, kWarps, (kRows > 64 && sizeof(T) == 8)>;
  constexpr int kGroup = L::kGroup;
  constexpr int S = kRows + Vec16<T>::kN;  // wide_col_stride(kRows, sizeof(T))
  constexpr int kMode = !kSolve ? MODE_FACTOR
                        : kEmitFactor ? MODE_SOLVE_FACTOR
                                      : MODE_SOLVE;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int t = threadIdx.x % kGroup;
  const int lane = threadIdx.x & (kWarp - 1);
  const int group = threadIdx.x / kGroup;
  const int bar_id = 1 + group;  // barrier 0 is __syncthreads'
  const int64_t mat = (int64_t)blockIdx.x * (blockDim.x / kGroup) + group;
  if (mat >= batch) return;  // the whole group exits together
  DEX_STAMP(mat, t / kWarp, lane, 0);

  unsigned char* base =
      smem_raw + (size_t)group * wide_group_smem_bytes(kRows, kWarps, n,
                                                       sizeof(T), kMode);
  T* cols = reinterpret_cast<T*>(base + 16);  // slot k at cols + k S
  T* xs = cols + kRows * S;
  T* blk = xs + kWarp * (kWarps - 1);  // the deferred block (kDefer)
  constexpr int kLast = kRows - L::kLastBase;
  T* s = kEmitFactor ? blk + (L::kDefer ? kLast * kLast : 0) : cols;
  const int64_t nn = (int64_t)n * n;
  const int ld = wide_stage_ld(kRows, n, kMode);
  // K3 at 80 rows stages the lower triangle only.
  constexpr bool kTriangle = kRows > 64 && !kEmitFactor;
  constexpr int kPart = kTriangle ? kLower : kFull;
  // Loaded first: its latency overlaps the matrix's copy.
  T y = kSolve && t < n ? g_in[mat * n + t] : T(0);
  if constexpr (kTriangle)
    stage_lower<T, kGroup>(s, a_in + mat * nn, n, ld, t, bar_id);
  else
    stage_in<T, kGroup>(s, a_in + mat * nn, n * n,
                        reinterpret_cast<uint64_t*>(base), t, bar_id);
  T a[kRows];
  load_row<T, kRows, kPart, 0, L::kLoadCols>(a, s, ld, n, t);
  if constexpr (L::kDefer) save_deferred<T, L, kPart>(blk, s, ld, n, t);
  T inv = clamp_rsqrt(s[0]);
  // Every row is in registers or saved: the slots may be written.
  bar_sync<kGroup>(bar_id);
  DEX_STAMP(mat, t / kWarp, lane, 1);

  T* srow = s + (t < n ? t : 0) * n;
  T inv_diag = T(1);
  all_pivots<T, L, kEmitFactor, kSolve, kWarps - 1>(a, y, inv, inv_diag, cols,
                                                    srow, blk, t, n, bar_id);
  DEX_STAMP(mat, t / kWarp, lane, 2);

  // The stage now holds the packed factor: out with one bulk store.
  if (kEmitFactor)
    stage_out<T, kGroup>(fac_out + mat * nn, s, n * n, t, bar_id);

  if constexpr (kSolve) {
    // Back substitution L^T x = y, blocked by warp from the last; x of a
    // block reaches the warps above it through shared memory.
    const T* mine = cols + (kGroup == kRows || t < kRows ? t : 0) * S;
    T c[32];
    back_blocks<T, L, false, kWarps - 1>(y, c, mine, ld, xs, inv_diag, lane,
                                         t, n, bar_id);
    if (t < n) x_out[mat * n + t] = y;
  }
  if (kEmitFactor) stage_out_wait(t);
  DEX_STAMP(mat, t / kWarp, lane, 3);
}

// K2: resolve against a packed factor staged in shared memory: row i of L
// in registers for the forward pass, a block of 32 columns at a time
// (forward_blocks), column i read down the stage for the backward pass
// (back_blocks).  Only the strict lower triangle and the diagonal are
// read.  `xs` carries y of each warp's rows but the last's to the warps
// below it, then x of each warp's rows but the first's to the warps above.
template <typename T, int kRows, int kWarps>
__global__ void __launch_bounds__(kWideGroups * kWarps * kWarp)
    cholesky_wide_resolve(const T* __restrict__ fac_in,
                          const T* __restrict__ g_in, T* __restrict__ x_out,
                          int64_t batch, int n) {
  using L = Layout<kRows, kWarps>;
  constexpr int kGroup = L::kGroup;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int t = threadIdx.x % kGroup;
  const int lane = threadIdx.x & (kWarp - 1);
  const int w = t / kWarp;
  const int group = threadIdx.x / kGroup;
  const int bar_id = 1 + group;
  const int64_t mat = (int64_t)blockIdx.x * (blockDim.x / kGroup) + group;
  if (mat >= batch) return;
  DEX_STAMP(mat, w, lane, 0);

  unsigned char* base =
      smem_raw + (size_t)group * wide_group_smem_bytes(kRows, kWarps, n,
                                                       sizeof(T),
                                                       MODE_RESOLVE);
  T* xs = reinterpret_cast<T*>(base + 16);
  T* s = xs + kWarp * (kWarps - 1);
  const int ld = wide_stage_ld(kRows, n, MODE_RESOLVE);
  // Loaded first: its latency overlaps the factor's copy.
  T y = t < n ? g_in[mat * n + t] : T(0);
  const T* src = fac_in + mat * (int64_t)n * n;
  if constexpr (kRows > 64)
    stage_lower<T, kGroup>(s, src, n, ld, t, bar_id);
  else
    stage_in<T, kGroup>(s, src, n * n, reinterpret_cast<uint64_t*>(base), t,
                        bar_id);
  const T inv_diag = t < n ? s[t * ld + t] : T(1);
  T a[kRows];
  load_row<T, kRows, kStrictLower, 0, kWarp>(a, s, ld, n, t);
  if (kWarps == 2 && w > 0)  // forward_blocks: warp 1's whole row
    load_row<T, kRows, kStrictLower, kWarp, 2 * kWarp>(a, s, ld, n, t);
  DEX_STAMP(mat, w, lane, 1);

  forward_blocks<T, L, 0>(y, a, xs, s, ld, inv_diag, w, lane, t, n, bar_id);
  DEX_STAMP(mat, w, lane, 2);

  // Back substitution L^T x = y, blocked as K1's.  A warp's reads of xs in
  // the forward pass feed the shuffles its writes there wait on.
  T c[32];
  back_blocks<T, L, true, kWarps - 1>(y, c, s, ld, xs, inv_diag, lane, t, n,
                                      bar_id);
  if (t < n) x_out[mat * n + t] = y;
  DEX_STAMP(mat, w, lane, 3);
}

// Lifts the kernel's dynamic shared-memory limit where 48 KB is too few.
template <typename KernelT>
cudaError_t allow_smem(KernelT kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// Launches mode `mode` in the layout of kRows rows over kWarps warps.
template <typename T, int kRows, int kWarps>
int launch_wide(int mode, const void* a, const void* g, void* x, void* fac,
                int64_t batch, int n, int groups, cudaStream_t st) {
  const size_t smem =
      (size_t)groups *
      wide_group_smem_bytes(kRows, kWarps, n, sizeof(T), mode);
  const int64_t blocks = (batch + groups - 1) / groups;
  const dim3 grid((unsigned)blocks), block(groups * kWarps * kWarp);
  if (mode == MODE_RESOLVE) {
    auto kernel = cholesky_wide_resolve<T, kRows, kWarps>;
    const cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, block, smem, st>>>((const T*)a, (const T*)g, (T*)x, batch,
                                      n);
    return (int)cudaGetLastError();
  }
  auto kernel = cholesky_wide_solve_factor<T, kRows, kWarps, true, true>;
  if (mode == MODE_FACTOR)
    kernel = cholesky_wide_solve_factor<T, kRows, kWarps, true, false>;
  else if (mode == MODE_SOLVE)
    kernel = cholesky_wide_solve_factor<T, kRows, kWarps, false, true>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, block, smem, st>>>((const T*)a, (const T*)g, (T*)x, (T*)fac,
                                    batch, n);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_wide(int mode, const void* a, const void* g, void* x, void* fac,
                  int64_t batch, int n, int groups, void* stream) {
  if (mode < MODE_SOLVE || mode > MODE_FACTOR || n < 1 || n > 80 ||
      groups != kWideGroups)
    return (int)cudaErrorInvalidValue;
  if (batch <= 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  if (n <= 64)
    return launch_wide<T, 64, 2>(mode, a, g, x, fac, batch, n, groups, st);
  return launch_wide<T, 80, 3>(mode, a, g, x, fac, batch, n, groups, st);
}

}  // namespace

extern "C" {

// mode: 0 solve (K3), 1 solve + packed factor (K1), 2 resolve against a
// packed factor (K2), 3 packed factor (K4); 1 <= n <= 80; groups:
// matrices per block, kWideGroups (2), of two warps each at n <= 64 and
// three above.  elem_bytes: 4 (float) or 8 (double).
// a: (batch, n, n) matrices or packed factors; g: (batch, n) (unused in
// mode 3); x: (batch, n) out (unused in mode 3); fac: (batch, n, n) out
// (modes 1 and 3, else unused).  Returns the cudaError_t of the launch (0
// on success).
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

#ifdef DEX_PHASE_CLOCKS
// Points the kernels' cycle stamps at `clocks`, (batch, 4, 4) int64.
int dex_phase_clocks(void* clocks) {
  return (int)cudaMemcpyToSymbol(g_phase_clocks, &clocks, sizeof(clocks));
}
#endif

}  // extern "C"

// Fused kinematic-tree sweep for Hopper (sm_90a): two kernels.
//
// Port of dexterity_tpu/physics/tree_pallas.py:
//   tree_fk_kernel  <- _kernel_body (K5): FK, cdof, geom and inertial
//                      frames, body10 (spatial inertias about the origin),
//                      tendon length and velocity
//   tree_dyn_kernel <- _kernel_dyn  (K6): CRB joint-space inertia qm and
//                      RNE bias qfrc_bias from cdof, body10 and qvel
//
// Every array is batch-minor: row k of an (rows, B) array holds rollout r at
// k * B + r, so consecutive threads on consecutive rollouts store
// contiguously.  The model's static tables come in two packed buffers built
// once by tree_cuda.py: an int32 buffer whose header holds every segment's
// offset (int segments, then float segments) and a float buffer in the
// kernel's type.  The segment order is the enums below; tree_cuda.py mirrors
// them and checks their counts through dex_tree_layout.
//
// Design.  The Pallas kernels turned the tree walk into one-hot matmuls and
// pointer jumping, a device for the TPU's MXU.  Here K5 gives one CTA a tile
// of rollouts: every body's pose in its parent's frame is computed at once,
// a thread per (body, rollout), and the world poses are composed level by
// level over a static table of the bodies by tree depth; then the CTA's
// threads spread over (body | dof | geom | tendon, 16-byte chunk of
// rollouts) to write the outputs (see K5 below).  K6 keeps _kernel_dyn's
// formulation, each recursion a gather over static tables: a CTA per 8
// rollouts (128 CTAs at B = 1024) whose 512 threads share every phase (see
// K6 below).
//
// Bound: at the reorient planning model and B = 1024 (float32), K5 moves
// ~15.4 MB (4.6 us at 3.35 TB/s) and K6 ~6.0 MB (1.8 us); their arithmetic is
// far below the FP32 rate, so both are memory-bound on paper.  What stands
// above the bound is latency: for K5 the loads, then one barrier per tree
// level (10 for the hand), then the output phase; for K6 six dependent
// phases.  Both issue their loads all at once by cp.async.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// K5 stages the int buffer from its header through I_DOF_BODY; K6's int
// segments (I_DOF_BODY .. I_QM_KIND) come last, one block.
enum IntSeg {
  I_BODY_PARENT, I_BODY_JTYPE, I_BODY_QADR, I_BODY_MOCAP, I_DOF_JTYPE,
  I_DOF_JOFS, I_GEOM_BODY, I_LEVEL_PTR, I_LEVEL_BODY, I_DOF_BODY,
  I_BODY_SUB_PTR, I_BODY_SUB, I_BODY_ANCDOF_PTR, I_BODY_ANCDOF, I_QM_KIND,
  N_INT_SEGS
};
enum FloatSeg {
  F_BODY_POS, F_BODY_QUAT, F_BODY_JAXIS, F_BODY_JPOS, F_BODY_IPOS,
  F_BODY_IQUAT, F_BODY_MASS, F_BODY_INERTIA, F_DOF_JAXIS, F_DOF_JPOS,
  F_DOF_ARMATURE, F_DOF_KEEP, F_GEOM_POS, F_GEOM_QUAT, F_GRAVITY,
  F_TEN_QSEL, F_TEN_MOMENT, N_FLOAT_SEGS
};

// JointType values of the model compiler.
constexpr int kFree = 0;
constexpr int kSlide = 2;
constexpr int kHinge = 3;

struct Dims {
  int nbody, nv, nq, ngeom, ntendon, nmocap;
};

template <typename T>
struct Tables {
  const int* ti;
  const T* tf;
  __device__ __forceinline__ const int* iseg(int s) const {
    return ti + ti[s];
  }
  __device__ __forceinline__ const T* fseg(int s) const {
    return tf + ti[N_INT_SEGS + s];
  }
};

template <typename T>
struct Quat {
  T w, x, y, z;
};
template <typename T>
struct Vec {
  T x, y, z;
};

template <typename T>
__device__ __forceinline__ Quat<T> qmul(Quat<T> q, Quat<T> r) {
  return {q.w * r.w - q.x * r.x - q.y * r.y - q.z * r.z,
          q.w * r.x + q.x * r.w + q.y * r.z - q.z * r.y,
          q.w * r.y - q.x * r.z + q.y * r.w + q.z * r.x,
          q.w * r.z + q.x * r.y - q.y * r.x + q.z * r.w};
}

// R(q) v as v + w t + q_vec x t with t = 2 q_vec x v.
template <typename T>
__device__ __forceinline__ Vec<T> rotate(Quat<T> q, Vec<T> v) {
  const T tx = T(2) * (q.y * v.z - q.z * v.y);
  const T ty = T(2) * (q.z * v.x - q.x * v.z);
  const T tz = T(2) * (q.x * v.y - q.y * v.x);
  return {v.x + q.w * tx + (q.y * tz - q.z * ty),
          v.y + q.w * ty + (q.z * tx - q.x * tz),
          v.z + q.w * tz + (q.x * ty - q.y * tx)};
}

// Row-major rotation matrix of a unit quaternion.
template <typename T>
__device__ __forceinline__ void quat_to_mat(Quat<T> q, T m[9]) {
  const T xx = q.x * q.x, yy = q.y * q.y, zz = q.z * q.z;
  const T xy = q.x * q.y, xz = q.x * q.z, yz = q.y * q.z;
  const T wx = q.w * q.x, wy = q.w * q.y, wz = q.w * q.z;
  m[0] = 1 - 2 * (yy + zz); m[1] = 2 * (xy - wz); m[2] = 2 * (xz + wy);
  m[3] = 2 * (xy + wz); m[4] = 1 - 2 * (xx + zz); m[5] = 2 * (yz - wx);
  m[6] = 2 * (xz - wy); m[7] = 2 * (yz + wx); m[8] = 1 - 2 * (xx + yy);
}

template <typename T>
__device__ __forceinline__ Vec<T> cross(Vec<T> u, Vec<T> v) {
  return {u.y * v.z - u.z * v.y, u.z * v.x - u.x * v.z,
          u.x * v.y - u.y * v.x};
}

__device__ __forceinline__ void sin_cos(float a, float* s, float* c) {
  sincosf(a, s, c);
}
__device__ __forceinline__ void sin_cos(double a, double* s, double* c) {
  sincos(a, s, c);
}

template <typename T>
__device__ __forceinline__ Vec<T> vec3(const T* p) {
  return {p[0], p[1], p[2]};
}
template <typename T>
__device__ __forceinline__ Quat<T> quat4(const T* p) {
  return {p[0], p[1], p[2], p[3]};
}

// Origin-frame spatial inertia p10 = [m, h(3), I(xx, xy, xz, yy, yz, zz)]
// applied to a motion [w, v]: force [torque about the origin, force].
template <typename T>
__device__ __forceinline__ void inertia_apply(const T p[10], const T m6[6],
                                              T out[6]) {
  const T mm = p[0], hx = p[1], hy = p[2], hz = p[3];
  const T ixx = p[4], ixy = p[5], ixz = p[6], iyy = p[7], iyz = p[8],
          izz = p[9];
  const T wx = m6[0], wy = m6[1], wz = m6[2], vx = m6[3], vy = m6[4],
          vz = m6[5];
  out[0] = ixx * wx + ixy * wy + ixz * wz + (hy * vz - hz * vy);
  out[1] = ixy * wx + iyy * wy + iyz * wz + (hz * vx - hx * vz);
  out[2] = ixz * wx + iyz * wy + izz * wz + (hx * vy - hy * vx);
  out[3] = mm * vx + (wy * hz - wz * hy);
  out[4] = mm * vy + (wz * hx - wx * hz);
  out[5] = mm * vz + (wx * hy - wy * hx);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Copies of 4, 8 or 16 bytes from global to shared memory with no register
// round trip (cp.async); cp_async_wait() before the barrier that publishes
// the stage.
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(__cvta_generic_to_global(src)), "n"(kBytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return ((uintptr_t)p & 15u) == 0;
}

template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  using type = float4;
};
template <>
struct Vec16<double> {
  using type = double2;
};

// A row of kN rollouts' values in registers (kN a multiple of 16 bytes),
// moved between shared memory and registers as 16-byte vectors (float4 or
// double2): K6's tile rows, K5's 16-byte chunks.
template <typename T, int kN>
struct TileRow {
  static constexpr int kPer16 = 16 / sizeof(T);
  using V = typename Vec16<T>::type;
  T v[kN];

  __device__ __forceinline__ void load(const T* s) {  // shared, aligned
#pragma unroll
    for (int i = 0; i < kN / kPer16; ++i) {
      const V x = reinterpret_cast<const V*>(s)[i];
      if constexpr (kPer16 == 4) {
        v[4 * i] = x.x, v[4 * i + 1] = x.y, v[4 * i + 2] = x.z,
                  v[4 * i + 3] = x.w;
      } else {
        v[2 * i] = x.x, v[2 * i + 1] = x.y;
      }
    }
  }
  __device__ __forceinline__ void store(T* s) const {  // 16-byte aligned
#pragma unroll
    for (int i = 0; i < kN / kPer16; ++i) {
      V x;
      if constexpr (kPer16 == 4) {
        x.x = v[4 * i], x.y = v[4 * i + 1], x.z = v[4 * i + 2],
        x.w = v[4 * i + 3];
      } else {
        x.x = v[2 * i], x.y = v[2 * i + 1];
      }
      reinterpret_cast<V*>(s)[i] = x;
    }
  }
  // The row's first `live` rollouts to a global output row (dst is the
  // first one's place): vector stores where the row is whole and aligned.
  // (Every index into v is a constant, or v would leave the registers for
  // local memory.)
  __device__ __forceinline__ void put(T* dst, int live) const {
    if (live == kN && aligned16(dst)) {
      store(dst);
    } else {
#pragma unroll
      for (int t = 0; t < kN; ++t)
        if (t < live) dst[t] = v[t];
    }
  }
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int t = 0; t < kN; ++t) v[t] = T(0);
  }
  __device__ __forceinline__ void fma(const TileRow& x, const TileRow& y) {
#pragma unroll
    for (int t = 0; t < kN; ++t) v[t] += x.v[t] * y.v[t];
  }
  __device__ __forceinline__ void add(const TileRow& x) {
#pragma unroll
    for (int t = 0; t < kN; ++t) v[t] += x.v[t];
  }
};

// Copies `count` elements from global src to shared dst (16-byte aligned)
// by cp.async over the CTA's threads: 16 bytes a copy where src is aligned
// too, the tail element by element.
template <typename E>
__device__ __forceinline__ void stage_block(E* dst, const E* src, int count) {
  constexpr int kPer = 16 / sizeof(E);
  const int n16 = aligned16(src) ? count / kPer : 0;
  for (int i = threadIdx.x; i < n16; i += blockDim.x)
    cp_async<16>(dst + i * kPer, src + i * kPer);
  for (int i = n16 * kPer + threadIdx.x; i < count; i += blockDim.x)
    cp_async<sizeof(E)>(dst + i, src + i);
}

// ---------------------------------------------------------------------------
// K5: FK, frames, body10, tendons.  A CTA per (tile of kFkTile<T> rollouts,
// slice of the output items): blockIdx.x picks the tile, blockIdx.y one of
// kFkSlices slices; kFkThreads threads.  Four phases, a __syncthreads() after each step:
//   1. stage: the tile's input rows and the tables, by cp.async into shared
//      memory, every copy issued at once (the sizes follow from Dims, so
//      none waits on the table header);
//   2. local poses: a thread per (body, rollout) computes the body's pose in
//      its parent's frame from its joint or mocap rows (the world: the
//      identity); no body waits on another;
//   3. world poses, level by level over the table of the bodies by tree
//      depth: a thread per (body, rollout) of the level composes x = parent
//      o local in place, one barrier per level (for the hand 9 dependent
//      steps, where a walk takes 32);
//   4. outputs: a thread per (item, 16-byte chunk of the tile's rollouts)
//      of the CTA's slice, the items being body poses, body inertias
//      (body10), dofs, geoms and tendons; it computes the item's rows for
//      the chunk's rollouts and stores each row as one 16-byte vector where
//      the chunk is whole and aligned, else element by element.
//      Consecutive threads take consecutive chunks of a row.  (Writing
//      finished levels' items during the later compositions was slower on
//      the card: the levels' barriers then waited on the outputs.)
// What sets the tile: the output rows are B apart, so a CTA writes a
// tile's values of each of ~3,700 rows, and on the H100 that store stream
// runs far faster when each piece is a whole 128-byte line than when it is
// smaller.  So a tile is a line (32 floats, 16 doubles), and the items are
// split over kFkSlices CTAs per tile to keep the SMs busy.  Every CTA of a
// tile repeats phases 1-3, in parallel.
// The per-body arithmetic and its order are those of the walk it replaced.
// Shared memory, each region 16-byte aligned, rows of a tile's values:
//   pose: 7 nbody rows, c * nbody + b with c over xpos 0..2, xquat 3..6
//     (the local pose, then in place the world pose);
//   in: qpos (nq rows), qvel (nv), mocap pos (3 nmocap) and quat
//     (4 nmocap), component-major: the tile's inputs, zeros past B;
//   the float tables whole, then the int buffer from its header through
//   dof_body, so a table offset reads the same in shared memory.
// ---------------------------------------------------------------------------

// K5's CTA shape: a tile of one 128-byte line of rollouts (its bytes are
// mirrored by tree_cuda.py, checked through dex_tree_layout), kFkSlices
// CTAs per tile, kFkThreads threads each.
constexpr int kFkLine = 128;
template <typename T>
constexpr int kFkTile = kFkLine / (int)sizeof(T);
constexpr int kFkSlices = 4;
constexpr int kFkThreads = 256;

__host__ __device__ inline size_t round16(size_t x) {
  return (x + 15) & ~(size_t)15;
}
__host__ __device__ inline int fk_in_rows(Dims d) {
  return d.nq + d.nv + 7 * d.nmocap;
}
// Entries of the float buffer: the FloatSeg segments' sizes.
__host__ __device__ inline int fk_floats(Dims d) {
  return 24 * d.nbody + 8 * d.nv + 7 * d.ngeom + 3 +
         d.ntendon * (d.nq + d.nv);
}
// Entries of the int buffer from its header through dof_body, at most: the
// level pointers number at most nbody + 1 (a chain).  A copy of this bound
// stays inside the buffer, since K6's segments (nbody + 1 subtree pointers
// first) follow dof_body.
__host__ __device__ inline int fk_ints(Dims d) {
  return N_INT_SEGS + N_FLOAT_SEGS + 6 * d.nbody + 3 * d.nv + d.ngeom + 1;
}
// K5's shared memory in bytes (tree_cuda._fk_smem mirrors it).
__host__ __device__ inline size_t fk_smem_bytes(Dims d, int elem) {
  return (size_t)(7 * d.nbody + fk_in_rows(d)) * kFkLine +
         round16((size_t)fk_floats(d) * elem) +
         round16((size_t)fk_ints(d) * 4);
}

template <typename T>
__global__ void __launch_bounds__(kFkThreads)
    tree_fk_kernel(Tables<T> tab, Dims d, const T* __restrict__ qpos,
                   const T* __restrict__ qvel, const T* __restrict__ mpos,
                   const T* __restrict__ mquat, T* __restrict__ out,
                   int64_t B) {
  using C = TileRow<T, 16 / sizeof(T)>;  // a 16-byte chunk of rollouts
  constexpr int kTile = kFkTile<T>, kV = C::kPer16, kChunks = kTile / kV;
  static_assert(kTile % kV == 0, "a tile is whole 16-byte chunks");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nb = d.nbody, nv = d.nv, nq = d.nq, ng = d.ngeom,
            nt = d.ntendon, nm = d.nmocap;
  const int tid = threadIdx.x;
  const int64_t r0 = (int64_t)blockIdx.x * kTile;
  const int live = B - r0 < kTile ? (int)(B - r0) : kTile;
  T* pose = reinterpret_cast<T*>(smem_raw);
  T* s_in = pose + 7 * nb * kTile;
  T* s_tf = s_in + fk_in_rows(d) * kTile;
  int* s_ti = reinterpret_cast<int*>(
      reinterpret_cast<unsigned char*>(s_tf) +
      round16((size_t)fk_floats(d) * sizeof(T)));
  auto P = [&](int c, int b) -> T* { return pose + (c * nb + b) * kTile; };
  auto in = [&](int row) -> const T* { return s_in + row * kTile; };

  // 1. Stage the inputs, a 16-byte chunk a copy where it is whole and
  //    aligned, and the tables.
  const int n_in = fk_in_rows(d);
  for (int u = tid; u < n_in * kChunks; u += kFkThreads) {
    const int row = u / kChunks, t0 = (u - row * kChunks) * kV;
    const T* src =
        (row < nq            ? qpos + (int64_t)row * B
         : row < nq + nv     ? qvel + (int64_t)(row - nq) * B
         : row < nq + nv + 3 * nm ? mpos + (int64_t)(row - nq - nv) * B
                              : mquat + (int64_t)(row - nq - nv - 3 * nm) * B) +
        r0 + t0;
    T* dst = s_in + row * kTile + t0;
    if (t0 + kV <= live && aligned16(src)) {
      cp_async<16>(dst, src);
      continue;
    }
    for (int e = 0; e < kV; ++e) {
      if (t0 + e < live)
        cp_async<sizeof(T)>(dst + e, src + e);
      else
        dst[e] = T(0);
    }
  }
  stage_block(s_tf, tab.tf, fk_floats(d));
  stage_block(s_ti, tab.ti, fk_ints(d));
  cp_async_wait();
  __syncthreads();
  const Tables<T> st{s_ti, s_tf};

  // 2. Every body's pose in its parent's frame.
  {
    const int* jtype = st.iseg(I_BODY_JTYPE);
    const int* qadr = st.iseg(I_BODY_QADR);
    const int* mocap = st.iseg(I_BODY_MOCAP);
    const T* bpos = st.fseg(F_BODY_POS);
    const T* bquat = st.fseg(F_BODY_QUAT);
    const T* jaxis = st.fseg(F_BODY_JAXIS);
    const T* jpos = st.fseg(F_BODY_JPOS);
    for (int u = tid; u < nb * kTile; u += kFkThreads) {
      const int b = u / kTile, t = u % kTile;
      Vec<T> lp = {T(0), T(0), T(0)};
      Quat<T> lq = {T(1), T(0), T(0), T(0)};
      const int m = mocap[b];
      const int jt = jtype[b];
      if (b == 0) {
        // The world body is the identity, whatever its stored pose.
      } else if (m >= 0) {
        const int p0 = nq + nv + m, q0 = p0 + 3 * nm;
        lp = {in(p0)[t], in(p0 + nm)[t], in(p0 + 2 * nm)[t]};
        lq = {in(q0)[t], in(q0 + nm)[t], in(q0 + 2 * nm)[t],
              in(q0 + 3 * nm)[t]};
      } else if (jt == kFree) {
        const int a = qadr[b];
        lp = {in(a)[t], in(a + 1)[t], in(a + 2)[t]};
        const Quat<T> raw = {in(a + 3)[t], in(a + 4)[t], in(a + 5)[t],
                             in(a + 6)[t]};
        const T nsq =
            raw.w * raw.w + raw.x * raw.x + raw.y * raw.y + raw.z * raw.z;
        const T norm = sqrt(nsq > T(1e-24) ? nsq : T(1e-24));
        lq = {raw.w / norm, raw.x / norm, raw.y / norm, raw.z / norm};
      } else {
        // Local increment (dq, dpos) of the body's joint, then
        // lpos = body_pos + R(body_quat) dpos, lquat = body_quat dq.
        Quat<T> dq = {T(1), T(0), T(0), T(0)};
        Vec<T> dp = {T(0), T(0), T(0)};
        if (jt == kHinge) {
          const T q = in(qadr[b])[t];
          T s, c;
          sin_cos(T(0.5) * q, &s, &c);
          const Vec<T> ax = vec3(jaxis + 3 * b);
          const Vec<T> jp = vec3(jpos + 3 * b);
          dq = {c, ax.x * s, ax.y * s, ax.z * s};
          // The hinge turns about its anchor jpos, not the body origin.
          const Vec<T> rj = rotate(dq, jp);
          dp = {jp.x - rj.x, jp.y - rj.y, jp.z - rj.z};
        } else if (jt == kSlide) {
          const T q = in(qadr[b])[t];
          const Vec<T> ax = vec3(jaxis + 3 * b);
          dp = {ax.x * q, ax.y * q, ax.z * q};
        }
        const Quat<T> bq = quat4(bquat + 4 * b);
        const Vec<T> rp = rotate(bq, dp);
        lp = {bpos[3 * b] + rp.x, bpos[3 * b + 1] + rp.y,
              bpos[3 * b + 2] + rp.z};
        lq = qmul(bq, dq);
      }
      P(0, b)[t] = lp.x, P(1, b)[t] = lp.y, P(2, b)[t] = lp.z;
      P(3, b)[t] = lq.w, P(4, b)[t] = lq.x, P(5, b)[t] = lq.y,
      P(6, b)[t] = lq.z;
    }
  }
  __syncthreads();

  // 3. World poses, level by level: x_b = x_parent o local_b.
  {
    const int* parent = st.iseg(I_BODY_PARENT);
    const int* lptr = st.iseg(I_LEVEL_PTR);
    const int* lbody = st.iseg(I_LEVEL_BODY);
    const int nlev = s_ti[I_LEVEL_BODY] - s_ti[I_LEVEL_PTR] - 1;
    for (int l = 1; l < nlev; ++l) {
      const int first = lptr[l], n = (lptr[l + 1] - first) * kTile;
      for (int u = tid; u < n; u += kFkThreads) {
        const int b = lbody[first + u / kTile], t = u % kTile;
        const int p = parent[b];
        const Vec<T> pp = {P(0, p)[t], P(1, p)[t], P(2, p)[t]};
        const Quat<T> pq = {P(3, p)[t], P(4, p)[t], P(5, p)[t], P(6, p)[t]};
        const Vec<T> lp = {P(0, b)[t], P(1, b)[t], P(2, b)[t]};
        const Quat<T> lq = {P(3, b)[t], P(4, b)[t], P(5, b)[t], P(6, b)[t]};
        const Vec<T> rp = rotate(pq, lp);
        const Quat<T> xq = qmul(pq, lq);
        P(0, b)[t] = pp.x + rp.x, P(1, b)[t] = pp.y + rp.y,
        P(2, b)[t] = pp.z + rp.z;
        P(3, b)[t] = xq.w, P(4, b)[t] = xq.x, P(5, b)[t] = xq.y,
        P(6, b)[t] = xq.z;
      }
      __syncthreads();
    }
  }

  // 4. Outputs: rows of the one (rows, B) buffer, in tree_cuda's order;
  //    this CTA's slice is a contiguous run of the (item, chunk) units.
  T* o_xpos = out;
  T* o_xquat = o_xpos + (int64_t)3 * nb * B;
  T* o_cdof = o_xquat + (int64_t)4 * nb * B;
  T* o_gpos = o_cdof + (int64_t)6 * nv * B;
  T* o_gmat = o_gpos + (int64_t)3 * ng * B;
  T* o_xipos = o_gmat + (int64_t)9 * ng * B;
  T* o_b10 = o_xipos + (int64_t)3 * nb * B;
  T* o_tlen = o_b10 + (int64_t)10 * nb * B;
  T* o_tvel = o_tlen + (int64_t)nt * B;
  const int units = (2 * nb + nv + ng + nt) * kChunks;
  const int u_end = (int)((int64_t)(blockIdx.y + 1) * units / kFkSlices);
  for (int u = (int)((int64_t)blockIdx.y * units / kFkSlices) + tid;
       u < u_end; u += kFkThreads) {
    const int item = u / kChunks, t0 = (u - item * kChunks) * kV;
    const int n = live - t0 < kV ? live - t0 : kV;
    if (n <= 0) continue;
    auto row = [&](T* base, int k) { return base + (int64_t)k * B + r0 + t0; };
    auto pose_of = [&](int b, C (&x)[7]) {
#pragma unroll
      for (int c = 0; c < 7; ++c) x[c].load(P(c, b) + t0);
    };
    auto xp_of = [&](const C (&x)[7], int e) -> Vec<T> {
      return {x[0].v[e], x[1].v[e], x[2].v[e]};
    };
    auto xq_of = [&](const C (&x)[7], int e) -> Quat<T> {
      return {x[3].v[e], x[4].v[e], x[5].v[e], x[6].v[e]};
    };
    if (item < nb) {
      // Body pose and inertial frame position.
      const int b = item;
      C x[7], xi[3];
      pose_of(b, x);
      const Vec<T> ip = vec3(st.fseg(F_BODY_IPOS) + 3 * b);
#pragma unroll
      for (int e = 0; e < kV; ++e) {
        const Vec<T> xp = xp_of(x, e);
        const Vec<T> rp = rotate(xq_of(x, e), ip);
        xi[0].v[e] = xp.x + rp.x;
        xi[1].v[e] = xp.y + rp.y;
        xi[2].v[e] = xp.z + rp.z;
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        x[c].put(row(o_xpos, c * nb + b), n);
        xi[c].put(row(o_xipos, c * nb + b), n);
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) x[3 + c].put(row(o_xquat, c * nb + b), n);
    } else if (item < 2 * nb) {
      // body10: the spatial inertia about the world origin.
      const int b = item - nb;
      C x[7], p[10];
      pose_of(b, x);
      const Vec<T> ip = vec3(st.fseg(F_BODY_IPOS) + 3 * b);
      const Quat<T> iq = quat4(st.fseg(F_BODY_IQUAT) + 4 * b);
      const T* in3 = st.fseg(F_BODY_INERTIA) + 3 * b;
      const T m = st.fseg(F_BODY_MASS)[b];
#pragma unroll
      for (int e = 0; e < kV; ++e) {
        const Vec<T> xp = xp_of(x, e);
        const Quat<T> xq = xq_of(x, e);
        const Vec<T> rp = rotate(xq, ip);
        const T cx = xp.x + rp.x, cy = xp.y + rp.y, cz = xp.z + rp.z;
        T im[9];
        quat_to_mat(qmul(xq, iq), im);
        auto iw = [&](int a, int c) {
          return in3[0] * im[3 * a] * im[3 * c] +
                 in3[1] * im[3 * a + 1] * im[3 * c + 1] +
                 in3[2] * im[3 * a + 2] * im[3 * c + 2];
        };
        const T cc = cx * cx + cy * cy + cz * cz;
        p[0].v[e] = m;
        p[1].v[e] = m * cx;
        p[2].v[e] = m * cy;
        p[3].v[e] = m * cz;
        p[4].v[e] = iw(0, 0) + m * (cc - cx * cx);
        p[5].v[e] = iw(0, 1) - m * cx * cy;
        p[6].v[e] = iw(0, 2) - m * cx * cz;
        p[7].v[e] = iw(1, 1) + m * (cc - cy * cy);
        p[8].v[e] = iw(1, 2) - m * cy * cz;
        p[9].v[e] = iw(2, 2) + m * (cc - cz * cz);
      }
#pragma unroll
      for (int k = 0; k < 10; ++k) p[k].put(row(o_b10, k * nb + b), n);
    } else if (item < 2 * nb + nv) {
      // Dof: motion axis about the world origin, rows [ang(3), lin(3)].
      const int v = item - 2 * nb;
      const int b = st.iseg(I_DOF_BODY)[v];
      const int jt = st.iseg(I_DOF_JTYPE)[v];
      const int a = st.iseg(I_DOF_JOFS)[v];
      const Vec<T> jax = vec3(st.fseg(F_DOF_JAXIS) + 3 * v);
      const Vec<T> jps = vec3(st.fseg(F_DOF_JPOS) + 3 * v);
      C x[7], o[6];
      pose_of(b, x);
#pragma unroll
      for (int e = 0; e < kV; ++e) {
        const Vec<T> xp = xp_of(x, e);
        const Quat<T> xq = xq_of(x, e);
        Vec<T> ang = {T(0), T(0), T(0)}, lin = {T(0), T(0), T(0)};
        if (jt == kHinge) {
          ang = rotate(xq, jax);
          const Vec<T> rj = rotate(xq, jps);
          lin = cross(ang, Vec<T>{-(xp.x + rj.x), -(xp.y + rj.y),
                                  -(xp.z + rj.z)});
        } else if (jt == kSlide) {
          lin = rotate(xq, jax);
        } else if (jt == kFree) {
          if (a < 3) {
            // Translational dofs: world axes.
            lin = {T(a == 0), T(a == 1), T(a == 2)};
          } else {
            // Rotational dofs: the body frame's columns, about the origin.
            T mat[9];
            quat_to_mat(xq, mat);
            ang = {mat[a - 3], mat[3 + a - 3], mat[6 + a - 3]};
            lin = cross(ang, Vec<T>{-xp.x, -xp.y, -xp.z});
          }
        }
        o[0].v[e] = ang.x, o[1].v[e] = ang.y, o[2].v[e] = ang.z;
        o[3].v[e] = lin.x, o[4].v[e] = lin.y, o[5].v[e] = lin.z;
      }
#pragma unroll
      for (int c = 0; c < 6; ++c) o[c].put(row(o_cdof, c * nv + v), n);
    } else if (item < 2 * nb + nv + ng) {
      // Geom frame.
      const int g = item - 2 * nb - nv;
      const int b = st.iseg(I_GEOM_BODY)[g];
      const Vec<T> gp = vec3(st.fseg(F_GEOM_POS) + 3 * g);
      const Quat<T> gq = quat4(st.fseg(F_GEOM_QUAT) + 4 * g);
      C x[7], o[12];
      pose_of(b, x);
#pragma unroll
      for (int e = 0; e < kV; ++e) {
        const Vec<T> xp = xp_of(x, e);
        const Quat<T> xq = xq_of(x, e);
        const Vec<T> rp = rotate(xq, gp);
        o[0].v[e] = xp.x + rp.x;
        o[1].v[e] = xp.y + rp.y;
        o[2].v[e] = xp.z + rp.z;
        T mat[9];
        quat_to_mat(qmul(xq, gq), mat);
#pragma unroll
        for (int k = 0; k < 9; ++k) o[3 + k].v[e] = mat[k];
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) o[c].put(row(o_gpos, c * ng + g), n);
#pragma unroll
      for (int k = 0; k < 9; ++k) o[3 + k].put(row(o_gmat, k * ng + g), n);
    } else {
      // Tendon: length through each dof's qpos address, velocity.
      const int k = item - 2 * nb - nv - ng;
      const T* qsel = st.fseg(F_TEN_QSEL) + (size_t)k * nq;
      const T* mom = st.fseg(F_TEN_MOMENT) + (size_t)k * nv;
      C len, vel, x;
#pragma unroll
      for (int e = 0; e < kV; ++e) len.v[e] = vel.v[e] = T(0);
      for (int j = 0; j < nq; ++j) {
        x.load(in(j) + t0);
#pragma unroll
        for (int e = 0; e < kV; ++e) len.v[e] += qsel[j] * x.v[e];
      }
      for (int j = 0; j < nv; ++j) {
        x.load(in(nq + j) + t0);
#pragma unroll
        for (int e = 0; e < kV; ++e) vel.v[e] += mom[j] * x.v[e];
      }
      len.put(row(o_tlen, k), n);
      vel.put(row(o_tvel, k), n);
    }
  }
}

// ---------------------------------------------------------------------------
// K6: CRB + RNE in _kernel_dyn's formulation: every recursion over the tree
// is a gather over static tables (each body's subtree, each body's
// ancestor-or-self dofs, the kind of each qm entry), so every output element
// is an independent short sum and no two threads write one place.  A CTA
// takes kDynTile rollouts and runs six phases, one __syncthreads() between
// them.  The sums over a subtree or the ancestor dofs (composite inertias,
// velocities, force totals) and qfrc_bias give each thread one row for the
// whole tile, moved as 16-byte vectors (TileRow): the row's list is read
// once, not once per rollout, and the tile's rollouts are independent work
// within the thread.  qm and the 6-vector arithmetic (f and tau per dof,
// the body forces) give each thread one (row, rollout); on the card, a row
// per thread made the qm phase slower.  The tables are staged in shared
// memory with the inputs: read from global memory, each dependent index
// load waited on an L2 round trip.
// Shared memory holds rows of kDynTile values, [row * kDynTile + t]:
//   cdof (6 nv rows, c * nv + v), body10 (10 nbody, k * nbody + b), qvel
//     (nv): the tile's inputs, staged by cp.async;
//   comp (10 nbody): composite inertias, body10 summed over the subtree;
//     later btot (6 nbody), the body forces summed over the subtree;
//   cvel (6 nbody): body velocities, cdof qvel over the ancestor dofs;
//   f (6 nv): Ic_body(w) cdof_w;
//   tau (6 nv): ((keep_v cvel_body(v)) x cdof_v) qvel_v, the bias terms;
//   fb (6 nbody): body forces;
// then armature, keep (nv each) and gravity (3), and K6's int tables.
// The world body's sums are never read (no dof lies on it) and are skipped.
// ---------------------------------------------------------------------------

constexpr int kDynTile = 8;

// Threads per CTA at most (the launch bound ptxas allots registers for).
constexpr int kDynMaxThreads = 512;

// Kinds of the qm entries (table I_QM_KIND): off the CRB pattern, strict
// upper pattern, its mirror below the diagonal, diagonal.
constexpr int kQmZero = 0;
constexpr int kQmDiag = 3;

__host__ __device__ inline int dyn_rows(int nbody, int nv) {
  return 19 * nv + 32 * nbody;
}

// K6's shared memory in bytes: the rows, the float tables, and room for the
// int tables, whose entries are at most those of a chain of nbody bodies
// with all nv dofs on each (subtree lists nbody^2, ancestor-dof lists
// nbody nv).
__host__ __device__ inline size_t dyn_smem_bytes(int nbody, int nv,
                                                 int elem) {
  const size_t ints = (size_t)nv + 2 * (nbody + 1) + (size_t)nbody * nbody +
                      (size_t)nbody * nv + (size_t)nv * nv;
  return ((size_t)dyn_rows(nbody, nv) * kDynTile + 2 * nv + 3) * elem +
         4 * ints;
}

// Runs body(k, b, t) over the rows k * n + b < rows of one phase, kLanes
// threads per row: thread tid takes lane t = tid % kLanes of every
// (blockDim.x / kLanes)-th row from tid / kLanes, with (k, b) stepped, not
// divided, per row.
template <int kLanes, typename F>
__device__ __forceinline__ void for_rows(int rows, int n, F&& body) {
  const int per = blockDim.x / kLanes;
  const int t = threadIdx.x % kLanes;
  int r = threadIdx.x / kLanes;
  int k = r / n, b = r - k * n;
  const int dk = per / n, db = per - dk * n;
  for (; r < rows; r += per) {
    body(k, b, t);
    k += dk;
    b += db;
    if (b >= n) {
      b -= n;
      ++k;
    }
  }
}

// Spatial motion cross product v x m and force cross product v x* f, on
// [ang, lin] vectors.
template <typename T>
__device__ __forceinline__ void motion_cross(const T v[6], const T m[6],
                                             T out[6]) {
  const T ax = v[0], ay = v[1], az = v[2], cx = v[3], cy = v[4], cz = v[5];
  const T bx = m[0], by = m[1], bz = m[2], dx = m[3], dy = m[4], dz = m[5];
  out[0] = ay * bz - az * by;
  out[1] = az * bx - ax * bz;
  out[2] = ax * by - ay * bx;
  out[3] = (ay * dz - az * dy) + (cy * bz - cz * by);
  out[4] = (az * dx - ax * dz) + (cz * bx - cx * bz);
  out[5] = (ax * dy - ay * dx) + (cx * by - cy * bx);
}
template <typename T>
__device__ __forceinline__ void force_cross(const T v[6], const T f[6],
                                            T out[6]) {
  const T ax = v[0], ay = v[1], az = v[2], cx = v[3], cy = v[4], cz = v[5];
  const T tx = f[0], ty = f[1], tz = f[2], fx = f[3], fy = f[4], fz = f[5];
  out[0] = (ay * tz - az * ty) + (cy * fz - cz * fy);
  out[1] = (az * tx - ax * tz) + (cz * fx - cx * fz);
  out[2] = (ax * ty - ay * tx) + (cx * fy - cy * fx);
  out[3] = ay * fz - az * fy;
  out[4] = az * fx - ax * fz;
  out[5] = ax * fy - ay * fx;
}

template <typename T>
__global__ void __launch_bounds__(kDynMaxThreads)
    tree_dyn_kernel(Tables<T> tab, Dims d, const T* __restrict__ cdof,
                    const T* __restrict__ body10,
                    const T* __restrict__ qvel, T* __restrict__ qm,
                    T* __restrict__ qfrc_bias, int64_t B) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int TT = kDynTile;
  using Row = TileRow<T, kDynTile>;
  constexpr int kPer16 = Row::kPer16, kChunks = TT / kPer16;
  const int nb = d.nbody, nv = d.nv;
  T* s_cdof = reinterpret_cast<T*>(smem_raw);
  T* s_b10 = s_cdof + 6 * nv * TT;
  T* s_qvel = s_b10 + 10 * nb * TT;
  T* s_comp = s_qvel + nv * TT;
  T* s_cvel = s_comp + 10 * nb * TT;
  T* s_f = s_cvel + 6 * nb * TT;
  T* s_tau = s_f + 6 * nv * TT;
  T* s_fb = s_tau + 6 * nv * TT;
  T* armature = s_fb + 6 * nb * TT;
  T* keep = armature + nv;
  T* grav = keep + nv;
  int* s_int = reinterpret_cast<int*>(grav + 3);
  const int64_t r0 = (int64_t)blockIdx.x * TT;
  const int live = B - r0 < TT ? (int)(B - r0) : TT;  // rollouts in the tile
  // The int tables' place in shared memory: the block from I_DOF_BODY to
  // the end of I_QM_KIND, copied whole.
  const int i0 = tab.ti[I_DOF_BODY];
  const int n_int = tab.ti[I_QM_KIND] + nv * nv - i0;
  auto staged = [&](int seg) -> const int* {
    return s_int + (tab.ti[seg] - i0);
  };
  const int* dof_body = staged(I_DOF_BODY);
  const int* sub_ptr = staged(I_BODY_SUB_PTR);
  const int* sub = staged(I_BODY_SUB);
  const int* anc_ptr = staged(I_BODY_ANCDOF_PTR);
  const int* anc = staged(I_BODY_ANCDOF);
  const int* qm_kind = staged(I_QM_KIND);
  auto at = [&](const T* base, int row, int t) -> T {
    return base[row * TT + t];
  };

  // 1. Stage the tile's cdof, body10 and qvel rows, which lie one after
  //    another in shared memory, a 16-byte chunk a copy where the chunk is
  //    whole and aligned (a rollout past B reads zeros); then the tables,
  //    whose addresses wait on the header's loads.
  const int n6 = 6 * nv, n16 = 6 * nv + 10 * nb, n_in = n16 + nv;
  for_rows<kChunks>(n_in, n_in, [&](int, int row, int part) {
    const T* src = (row < n6    ? cdof + (int64_t)row * B
                    : row < n16 ? body10 + (int64_t)(row - n6) * B
                                : qvel + (int64_t)(row - n16) * B) +
                   r0 + part * kPer16;
    T* dst = s_cdof + row * TT + part * kPer16;
    if (live == TT && aligned16(src)) {
      cp_async<16>(dst, src);
      return;
    }
    for (int e = 0; e < kPer16; ++e) {
      if (part * kPer16 + e < live)
        cp_async<sizeof(T)>(dst + e, src + e);
      else
        dst[e] = T(0);
    }
  });
  for (int i = threadIdx.x; i < n_int; i += blockDim.x)
    cp_async<4>(s_int + i, tab.ti + i0 + i);
  for (int i = threadIdx.x; i < 2 * nv + 3; i += blockDim.x)
    cp_async<sizeof(T)>(armature + i,
                        i < 2 * nv ? tab.fseg(F_DOF_ARMATURE) + i
                                   : tab.fseg(F_GRAVITY) + i - 2 * nv);
  cp_async_wait();
  __syncthreads();

  auto row_of = [&](T* base, int row) { return base + row * TT; };
  // Row k of `src` summed over the subtree of body b, into `dst`.
  auto subtree_sum = [&](T* dst, T* src, int k, int b) {
    Row acc, x;
    acc.zero();
#pragma unroll 2
    for (int j = sub_ptr[b]; j < sub_ptr[b + 1]; ++j) {
      x.load(row_of(src, k * nb + sub[j]));
      acc.add(x);
    }
    acc.store(row_of(dst, k * nb + b));
  };

  // 2. Composite inertias (subtree sums of body10, rows k < 10) and body
  //    velocities (cdof qvel over the ancestor-or-self dofs, rows 10 + c).
  for_rows<1>(16 * nb, nb, [&](int k, int b, int) {
    if (b == 0) return;
    if (k < 10) {
      subtree_sum(s_comp, s_b10, k, b);
      return;
    }
    const int c = k - 10;
    Row acc, x, q;
    acc.zero();
#pragma unroll 2
    for (int j = anc_ptr[b]; j < anc_ptr[b + 1]; ++j) {
      const int v = anc[j];
      x.load(row_of(s_cdof, c * nv + v));
      q.load(row_of(s_qvel, v));
      acc.fma(x, q);
    }
    acc.store(row_of(s_cvel, c * nb + b));
  });
  __syncthreads();

  // 3. Per dof: f_w = Ic_body(w) cdof_w, and the bias term tau_v (the
  //    keep mask zeroes cvel for a free joint's translational dofs).
  for_rows<TT>(nv, nv, [&](int, int v, int t) {
    const int bv = dof_body[v];
    T cd[6], p10[10], cv[6], f[6], tau[6];
    for (int c = 0; c < 6; ++c) cd[c] = at(s_cdof, c * nv + v, t);
    for (int k = 0; k < 10; ++k) p10[k] = at(s_comp, k * nb + bv, t);
    inertia_apply(p10, cd, f);
    const T kp = keep[v], qv = at(s_qvel, v, t);
    for (int c = 0; c < 6; ++c) cv[c] = at(s_cvel, c * nb + bv, t) * kp;
    motion_cross(cv, cd, tau);
    for (int c = 0; c < 6; ++c) {
      s_f[(c * nv + v) * TT + t] = f[c];
      s_tau[(c * nv + v) * TT + t] = tau[c] * qv;
    }
  });
  __syncthreads();

  // 4. Body forces fb_b = I_b cacc_b + cvel_b x* (I_b cvel_b), with cacc_b
  //    = -g on the linear rows plus tau over the ancestor-or-self dofs; and
  //    every qm entry in one pass: cdof_i . f_j on the pattern with (i, j)
  //    = (min, max) of its row and column, armature on the diagonal, zero
  //    off the pattern.
  for_rows<TT>(nb, nb, [&](int, int b, int t) {
    if (b == 0) return;
    T ca[6], p10[10], cv[6], iv[6], ia[6], fx[6];
    for (int c = 0; c < 6; ++c) ca[c] = c >= 3 ? -grav[c - 3] : T(0);
#pragma unroll 2
    for (int j = anc_ptr[b]; j < anc_ptr[b + 1]; ++j)
      for (int c = 0; c < 6; ++c) ca[c] += at(s_tau, c * nv + anc[j], t);
    for (int k = 0; k < 10; ++k) p10[k] = at(s_b10, k * nb + b, t);
    for (int c = 0; c < 6; ++c) cv[c] = at(s_cvel, c * nb + b, t);
    inertia_apply(p10, cv, iv);
    inertia_apply(p10, ca, ia);
    force_cross(cv, iv, fx);
    for (int c = 0; c < 6; ++c) s_fb[(c * nb + b) * TT + t] = ia[c] + fx[c];
  });
  for_rows<TT>(nv * nv, nv, [&](int v, int w, int t) {
    if (t >= live) return;
    const int kind = qm_kind[v * nv + w];
    T val = T(0);
    if (kind != kQmZero) {
      const int lo = v < w ? v : w, hi = v < w ? w : v;
      for (int c = 0; c < 6; ++c)
        val += at(s_cdof, c * nv + lo, t) * at(s_f, c * nv + hi, t);
      if (kind == kQmDiag) val += armature[v];
    }
    qm[(int64_t)(v * nv + w) * B + r0 + t] = val;
  });
  __syncthreads();

  // 5. The body forces summed over each subtree, into comp's rows.
  T* s_btot = s_comp;
  for_rows<1>(6 * nb, nb, [&](int c, int b, int) {
    if (b > 0) subtree_sum(s_btot, s_fb, c, b);
  });
  __syncthreads();

  // 6. qfrc_bias_v = cdof_v . btot_body(v).
  for_rows<1>(nv, nv, [&](int, int v, int) {
    const int bv = dof_body[v];
    Row acc, x, y;
    acc.zero();
    for (int c = 0; c < 6; ++c) {
      x.load(row_of(s_cdof, c * nv + v));
      y.load(row_of(s_btot, c * nb + bv));
      acc.fma(x, y);
    }
    acc.put(qfrc_bias + (int64_t)v * B + r0, live);
  });
}

template <typename K>
int set_smem(K kernel, size_t smem) {
  if (smem > 48 * 1024) {
    return (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  }
  return (int)cudaSuccess;
}

template <typename T>
int launch_fk(const void* ti, const void* tf, Dims d, const void* qpos,
              const void* qvel, const void* mpos, const void* mquat,
              void* out, int64_t B, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  const size_t smem = fk_smem_bytes(d, sizeof(T));
  auto kernel = tree_fk_kernel<T>;
  int err = set_smem(kernel, smem);
  if (err != (int)cudaSuccess) return err;
  constexpr int kTile = kFkTile<T>;
  const dim3 grid((unsigned)((B + kTile - 1) / kTile), (unsigned)kFkSlices);
  kernel<<<grid, kFkThreads, smem, (cudaStream_t)stream>>>(
      Tables<T>{(const int*)ti, (const T*)tf}, d, (const T*)qpos,
      (const T*)qvel, (const T*)mpos, (const T*)mquat, (T*)out, B);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dyn(const void* ti, const void* tf, Dims d, const void* cdof,
               const void* body10, const void* qvel, void* qm,
               void* qfrc_bias, int64_t B, int threads, void* stream) {
  if (threads < kDynTile || threads > kDynMaxThreads ||
      threads % kDynTile != 0)
    return (int)cudaErrorInvalidValue;
  if (B <= 0) return (int)cudaSuccess;
  const size_t smem = dyn_smem_bytes(d.nbody, d.nv, sizeof(T));
  auto kernel = tree_dyn_kernel<T>;
  int err = set_smem(kernel, smem);
  if (err != (int)cudaSuccess) return err;
  const int64_t blocks = (B + kDynTile - 1) / kDynTile;
  kernel<<<(unsigned)blocks, threads, smem, (cudaStream_t)stream>>>(
      Tables<T>{(const int*)ti, (const T*)tf}, d, (const T*)cdof,
      (const T*)body10, (const T*)qvel, (T*)qm, (T*)qfrc_bias, B);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Number of int (which == 0) or float (which == 1) table segments; K6's
// rollouts per CTA (which == 2); the bytes of K5's tile of rollouts (3).
int dex_tree_layout(int which) {
  return which == 0   ? (int)N_INT_SEGS
         : which == 1 ? (int)N_FLOAT_SEGS
         : which == 2 ? kDynTile
                      : kFkLine;
}

// K5.  elem_bytes: 4 or 8.  ti/tf: the packed tables.  Inputs qpos (nq, B),
// qvel (nv, B), mpos (3 nmocap, B), mquat (4 nmocap, B); output one
// (20 nbody + 6 nv + 12 ngeom + 2 ntendon, B) buffer holding, row after
// row, xpos (3 nbody), xquat (4 nbody), cdof (6 nv), gpos (3 ngeom), gmat
// (9 ngeom), xipos (3 nbody), body10 (10 nbody), ten_length and
// ten_velocity (ntendon each).  K5's CTA shape is fixed (kFkTile,
// kFkSlices, kFkThreads); shared memory fk_smem_bytes.  Returns the
// cudaError_t of the launch.
int dex_tree_fk(int elem_bytes, const void* ti, const void* tf, int nbody,
                int nv, int nq, int ngeom, int ntendon, int nmocap,
                const void* qpos, const void* qvel, const void* mpos,
                const void* mquat, void* out, int64_t B, void* stream) {
  const Dims d{nbody, nv, nq, ngeom, ntendon, nmocap};
  if (elem_bytes == 4)
    return launch_fk<float>(ti, tf, d, qpos, qvel, mpos, mquat, out, B,
                            stream);
  if (elem_bytes == 8)
    return launch_fk<double>(ti, tf, d, qpos, qvel, mpos, mquat, out, B,
                             stream);
  return (int)cudaErrorInvalidValue;
}

// K6.  Inputs cdof (6 nv, B), body10 (10 nbody, B), qvel (nv, B); outputs
// qm (nv * nv, B) and qfrc_bias (nv, B).  kDynTile rollouts per CTA of
// `threads` threads (a multiple of kDynTile, at most kDynMaxThreads); shared
// memory dyn_smem_bytes(nbody, nv, elem_bytes).
int dex_tree_dyn(int elem_bytes, const void* ti, const void* tf, int nbody,
                 int nv, int nq, int ngeom, int ntendon, int nmocap,
                 const void* cdof, const void* body10, const void* qvel,
                 void* qm, void* qfrc_bias, int64_t B, int threads,
                 void* stream) {
  const Dims d{nbody, nv, nq, ngeom, ntendon, nmocap};
  if (elem_bytes == 4)
    return launch_dyn<float>(ti, tf, d, cdof, body10, qvel, qm, qfrc_bias, B,
                             threads, stream);
  if (elem_bytes == 8)
    return launch_dyn<double>(ti, tf, d, cdof, body10, qvel, qm, qfrc_bias,
                              B, threads, stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"

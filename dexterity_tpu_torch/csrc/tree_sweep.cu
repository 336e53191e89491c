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
// of rollouts: one thread per rollout walks the bodies in index order,
// parents first, composing world poses into shared memory; after a barrier
// the CTA's threads spread over (body | dof | geom | tendon, rollout) items
// to write the outputs.  K6 keeps _kernel_dyn's formulation, each recursion
// a gather over static tables: a CTA per 8 rollouts (128 CTAs at B = 1024)
// whose 512 threads share every phase (see K6 below).
//
// Bound: at the reorient planning model and B = 1024 (float32), K5 moves
// ~15.4 MB (4.6 us at 3.35 TB/s) and K6 ~6.0 MB (1.8 us); their arithmetic is
// far below the FP32 rate, so both are memory-bound on paper.  K5 is
// latency-bound along its serial per-rollout body walk.  K6's phases are
// short independent sums; what stands above its bound is the latency of
// six dependent phases and of its loads, which cp.async issues all at once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// K6's int segments (I_DOF_BODY .. I_QM_KIND) come last, one block.
enum IntSeg {
  I_BODY_PARENT, I_BODY_JTYPE, I_BODY_QADR, I_BODY_MOCAP, I_DOF_JTYPE,
  I_DOF_JOFS, I_GEOM_BODY, I_DOF_BODY, I_BODY_SUB_PTR, I_BODY_SUB,
  I_BODY_ANCDOF_PTR, I_BODY_ANCDOF, I_QM_KIND, N_INT_SEGS
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

// ---------------------------------------------------------------------------
// K5: FK, frames, body10, tendons.  One CTA per tile of `tile` rollouts;
// shared memory holds the tile's world poses, [(c * nbody + b) * tile + t]
// for c in (xpos 0..2, xquat 3..6).
// ---------------------------------------------------------------------------

template <typename T>
__global__ void tree_fk_kernel(Tables<T> tab, Dims d,
                               const T* __restrict__ qpos,
                               const T* __restrict__ mpos,
                               const T* __restrict__ mquat,
                               const T* __restrict__ qvel,
                               T* __restrict__ xpos, T* __restrict__ xquat,
                               T* __restrict__ cdof, T* __restrict__ gpos,
                               T* __restrict__ gmat, T* __restrict__ xipos,
                               T* __restrict__ body10,
                               T* __restrict__ ten_length,
                               T* __restrict__ ten_velocity, int64_t B,
                               int tile) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* pose = reinterpret_cast<T*>(smem_raw);
  const int nb = d.nbody;
  const int64_t r0 = (int64_t)blockIdx.x * tile;
  const int tid = threadIdx.x;
  auto P = [&](int c, int b, int t) -> T& {
    return pose[((size_t)c * nb + b) * tile + t];
  };

  // Phase 1: one thread per rollout walks the bodies, parents first.
  if (tid < tile && r0 + tid < B) {
    const int64_t r = r0 + tid;
    const int* parent = tab.iseg(I_BODY_PARENT);
    const int* jtype = tab.iseg(I_BODY_JTYPE);
    const int* qadr = tab.iseg(I_BODY_QADR);
    const int* mocap = tab.iseg(I_BODY_MOCAP);
    const T* bpos = tab.fseg(F_BODY_POS);
    const T* bquat = tab.fseg(F_BODY_QUAT);
    const T* jaxis = tab.fseg(F_BODY_JAXIS);
    const T* jpos = tab.fseg(F_BODY_JPOS);
    // The world body is the identity, whatever its stored pose.
    for (int c = 0; c < 7; ++c) P(c, 0, tid) = c == 3 ? T(1) : T(0);
    for (int b = 1; b < nb; ++b) {
      Vec<T> lp;
      Quat<T> lq;
      const int m = mocap[b];
      const int jt = jtype[b];
      if (m >= 0) {
        // Mocap rows are component-major: row c * nmocap + m.
        lp = {mpos[(0 * d.nmocap + m) * B + r],
              mpos[(1 * d.nmocap + m) * B + r],
              mpos[(2 * d.nmocap + m) * B + r]};
        lq = {mquat[(0 * d.nmocap + m) * B + r],
              mquat[(1 * d.nmocap + m) * B + r],
              mquat[(2 * d.nmocap + m) * B + r],
              mquat[(3 * d.nmocap + m) * B + r]};
      } else if (jt == kFree) {
        const int64_t a = qadr[b];
        lp = {qpos[a * B + r], qpos[(a + 1) * B + r], qpos[(a + 2) * B + r]};
        const Quat<T> raw = {qpos[(a + 3) * B + r], qpos[(a + 4) * B + r],
                             qpos[(a + 5) * B + r], qpos[(a + 6) * B + r]};
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
          const T q = qpos[(int64_t)qadr[b] * B + r];
          T s, c;
          sin_cos(T(0.5) * q, &s, &c);
          const Vec<T> ax = vec3(jaxis + 3 * b);
          const Vec<T> jp = vec3(jpos + 3 * b);
          dq = {c, ax.x * s, ax.y * s, ax.z * s};
          // The hinge turns about its anchor jpos, not the body origin.
          const Vec<T> rj = rotate(dq, jp);
          dp = {jp.x - rj.x, jp.y - rj.y, jp.z - rj.z};
        } else if (jt == kSlide) {
          const T q = qpos[(int64_t)qadr[b] * B + r];
          const Vec<T> ax = vec3(jaxis + 3 * b);
          dp = {ax.x * q, ax.y * q, ax.z * q};
        }
        const Quat<T> bq = quat4(bquat + 4 * b);
        const Vec<T> rp = rotate(bq, dp);
        lp = {bpos[3 * b] + rp.x, bpos[3 * b + 1] + rp.y,
              bpos[3 * b + 2] + rp.z};
        lq = qmul(bq, dq);
      }
      const int p = parent[b];
      const Vec<T> pp = {P(0, p, tid), P(1, p, tid), P(2, p, tid)};
      const Quat<T> pq = {P(3, p, tid), P(4, p, tid), P(5, p, tid),
                          P(6, p, tid)};
      const Vec<T> rp = rotate(pq, lp);
      const Quat<T> xq = qmul(pq, lq);
      P(0, b, tid) = pp.x + rp.x;
      P(1, b, tid) = pp.y + rp.y;
      P(2, b, tid) = pp.z + rp.z;
      P(3, b, tid) = xq.w;
      P(4, b, tid) = xq.x;
      P(5, b, tid) = xq.y;
      P(6, b, tid) = xq.z;
    }
  }
  __syncthreads();

  // Phase 2: (item, rollout) pairs over the CTA's threads.
  const int nv = d.nv, ng = d.ngeom;
  const int items = nb + nv + ng + d.ntendon;
  for (int i = tid; i < items * tile; i += blockDim.x) {
    const int item = i / tile;
    const int t = i - item * tile;
    const int64_t r = r0 + t;
    if (r >= B) continue;
    if (item < nb) {
      // Body: pose, inertial frame, body10 about the origin.
      const int b = item;
      const Vec<T> xp = {P(0, b, t), P(1, b, t), P(2, b, t)};
      const Quat<T> xq = {P(3, b, t), P(4, b, t), P(5, b, t), P(6, b, t)};
      xpos[(0 * nb + b) * B + r] = xp.x;
      xpos[(1 * nb + b) * B + r] = xp.y;
      xpos[(2 * nb + b) * B + r] = xp.z;
      xquat[(0 * nb + b) * B + r] = xq.w;
      xquat[(1 * nb + b) * B + r] = xq.x;
      xquat[(2 * nb + b) * B + r] = xq.y;
      xquat[(3 * nb + b) * B + r] = xq.z;
      const Vec<T> rp = rotate(xq, vec3(tab.fseg(F_BODY_IPOS) + 3 * b));
      const T cx = xp.x + rp.x, cy = xp.y + rp.y, cz = xp.z + rp.z;
      xipos[(0 * nb + b) * B + r] = cx;
      xipos[(1 * nb + b) * B + r] = cy;
      xipos[(2 * nb + b) * B + r] = cz;
      T im[9];
      quat_to_mat(qmul(xq, quat4(tab.fseg(F_BODY_IQUAT) + 4 * b)), im);
      const T* in = tab.fseg(F_BODY_INERTIA) + 3 * b;
      const T m = tab.fseg(F_BODY_MASS)[b];
      auto iw = [&](int a, int c) {
        return in[0] * im[3 * a] * im[3 * c] +
               in[1] * im[3 * a + 1] * im[3 * c + 1] +
               in[2] * im[3 * a + 2] * im[3 * c + 2];
      };
      const T cc = cx * cx + cy * cy + cz * cz;
      const T p10[10] = {m, m * cx, m * cy, m * cz,
                         iw(0, 0) + m * (cc - cx * cx), iw(0, 1) - m * cx * cy,
                         iw(0, 2) - m * cx * cz, iw(1, 1) + m * (cc - cy * cy),
                         iw(1, 2) - m * cy * cz, iw(2, 2) + m * (cc - cz * cz)};
      for (int k = 0; k < 10; ++k) body10[((int64_t)k * nb + b) * B + r] = p10[k];
    } else if (item < nb + nv) {
      // Dof: motion axis about the world origin, rows [ang(3), lin(3)].
      const int v = item - nb;
      const int b = tab.iseg(I_DOF_BODY)[v];
      const int jt = tab.iseg(I_DOF_JTYPE)[v];
      const Vec<T> xp = {P(0, b, t), P(1, b, t), P(2, b, t)};
      const Quat<T> xq = {P(3, b, t), P(4, b, t), P(5, b, t), P(6, b, t)};
      Vec<T> ang = {T(0), T(0), T(0)}, lin = {T(0), T(0), T(0)};
      if (jt == kHinge) {
        ang = rotate(xq, vec3(tab.fseg(F_DOF_JAXIS) + 3 * v));
        const Vec<T> rj = rotate(xq, vec3(tab.fseg(F_DOF_JPOS) + 3 * v));
        lin = cross(ang, Vec<T>{-(xp.x + rj.x), -(xp.y + rj.y),
                                -(xp.z + rj.z)});
      } else if (jt == kSlide) {
        lin = rotate(xq, vec3(tab.fseg(F_DOF_JAXIS) + 3 * v));
      } else if (jt == kFree) {
        const int a = tab.iseg(I_DOF_JOFS)[v];
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
      cdof[((int64_t)0 * nv + v) * B + r] = ang.x;
      cdof[((int64_t)1 * nv + v) * B + r] = ang.y;
      cdof[((int64_t)2 * nv + v) * B + r] = ang.z;
      cdof[((int64_t)3 * nv + v) * B + r] = lin.x;
      cdof[((int64_t)4 * nv + v) * B + r] = lin.y;
      cdof[((int64_t)5 * nv + v) * B + r] = lin.z;
    } else if (item < nb + nv + ng) {
      // Geom frame.
      const int g = item - nb - nv;
      const int b = tab.iseg(I_GEOM_BODY)[g];
      const Vec<T> xp = {P(0, b, t), P(1, b, t), P(2, b, t)};
      const Quat<T> xq = {P(3, b, t), P(4, b, t), P(5, b, t), P(6, b, t)};
      const Vec<T> rp = rotate(xq, vec3(tab.fseg(F_GEOM_POS) + 3 * g));
      gpos[((int64_t)0 * ng + g) * B + r] = xp.x + rp.x;
      gpos[((int64_t)1 * ng + g) * B + r] = xp.y + rp.y;
      gpos[((int64_t)2 * ng + g) * B + r] = xp.z + rp.z;
      T mat[9];
      quat_to_mat(qmul(xq, quat4(tab.fseg(F_GEOM_QUAT) + 4 * g)), mat);
      for (int k = 0; k < 9; ++k) gmat[((int64_t)k * ng + g) * B + r] = mat[k];
    } else {
      // Tendon: length through each dof's qpos address, velocity.
      const int k = item - nb - nv - ng;
      const T* qsel = tab.fseg(F_TEN_QSEL) + (size_t)k * d.nq;
      const T* mom = tab.fseg(F_TEN_MOMENT) + (size_t)k * nv;
      T len = T(0), vel = T(0);
      for (int j = 0; j < d.nq; ++j) len += qsel[j] * qpos[(int64_t)j * B + r];
      for (int j = 0; j < nv; ++j) vel += mom[j] * qvel[(int64_t)j * B + r];
      ten_length[(int64_t)k * B + r] = len;
      ten_velocity[(int64_t)k * B + r] = vel;
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

// A tile row in registers: the kDynTile rollouts' values of one row,
// moved between shared memory and registers as 16-byte vectors (float4 or
// double2).
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

template <typename T>
struct TileRow {
  static constexpr int kPer16 = 16 / sizeof(T);
  using V = typename Vec16<T>::type;
  T v[kDynTile];

  __device__ __forceinline__ void load(const T* s) {  // shared, aligned
#pragma unroll
    for (int i = 0; i < kDynTile / kPer16; ++i) {
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
    for (int i = 0; i < kDynTile / kPer16; ++i) {
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
  // The tile's live rollouts to a global output row (dst is rollout r0's
  // place): vector stores where the row is whole and aligned.  (Every index
  // into v is a constant, or v would leave the registers for local memory.)
  __device__ __forceinline__ void put(T* dst, int live) const {
    if (live == kDynTile && aligned16(dst)) {
      store(dst);
    } else {
#pragma unroll
      for (int t = 0; t < kDynTile; ++t)
        if (t < live) dst[t] = v[t];
    }
  }
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int t = 0; t < kDynTile; ++t) v[t] = T(0);
  }
  __device__ __forceinline__ void fma(const TileRow& x, const TileRow& y) {
#pragma unroll
    for (int t = 0; t < kDynTile; ++t) v[t] += x.v[t] * y.v[t];
  }
  __device__ __forceinline__ void add(const TileRow& x) {
#pragma unroll
    for (int t = 0; t < kDynTile; ++t) v[t] += x.v[t];
  }
};

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
  using Row = TileRow<T>;
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
              void* xpos, void* xquat, void* cdof, void* gpos, void* gmat,
              void* xipos, void* body10, void* ten_length,
              void* ten_velocity, int64_t B, int tile, int threads,
              void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  const size_t smem = (size_t)7 * d.nbody * tile * sizeof(T);
  auto kernel = tree_fk_kernel<T>;
  int err = set_smem(kernel, smem);
  if (err != (int)cudaSuccess) return err;
  const int64_t blocks = (B + tile - 1) / tile;
  kernel<<<(unsigned)blocks, threads, smem, (cudaStream_t)stream>>>(
      Tables<T>{(const int*)ti, (const T*)tf}, d, (const T*)qpos,
      (const T*)mpos, (const T*)mquat, (const T*)qvel, (T*)xpos, (T*)xquat,
      (T*)cdof, (T*)gpos, (T*)gmat, (T*)xipos, (T*)body10, (T*)ten_length,
      (T*)ten_velocity, B, tile);
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
// rollouts per CTA (which == 2).
int dex_tree_layout(int which) {
  return which == 0 ? (int)N_INT_SEGS
         : which == 1 ? (int)N_FLOAT_SEGS
                      : kDynTile;
}

// K5.  elem_bytes: 4 or 8.  ti/tf: the packed tables.  Inputs qpos (nq, B),
// qvel (nv, B), mpos (3 nmocap, B), mquat (4 nmocap, B); outputs xpos
// (3 nbody, B), xquat (4 nbody, B), cdof (6 nv, B), gpos (3 ngeom, B), gmat
// (9 ngeom, B), xipos (3 nbody, B), body10 (10 nbody, B), ten_length and
// ten_velocity (ntendon, B).  tile rollouts per CTA of `threads` threads
// (threads >= tile).  Returns the cudaError_t of the launch.
int dex_tree_fk(int elem_bytes, const void* ti, const void* tf, int nbody,
                int nv, int nq, int ngeom, int ntendon, int nmocap,
                const void* qpos, const void* qvel, const void* mpos,
                const void* mquat, void* xpos, void* xquat, void* cdof,
                void* gpos, void* gmat, void* xipos, void* body10,
                void* ten_length, void* ten_velocity, int64_t B, int tile,
                int threads, void* stream) {
  const Dims d{nbody, nv, nq, ngeom, ntendon, nmocap};
  if (threads < tile) return (int)cudaErrorInvalidValue;
  if (elem_bytes == 4)
    return launch_fk<float>(ti, tf, d, qpos, qvel, mpos, mquat, xpos, xquat,
                            cdof, gpos, gmat, xipos, body10, ten_length,
                            ten_velocity, B, tile, threads, stream);
  if (elem_bytes == 8)
    return launch_fk<double>(ti, tf, d, qpos, qvel, mpos, mquat, xpos, xquat,
                             cdof, gpos, gmat, xipos, body10, ten_length,
                             ten_velocity, B, tile, threads, stream);
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

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
// to write the outputs.  K6 runs one thread per rollout: composite inertias
// accumulate children-into-parents in shared memory, each dof walks its
// ancestor dofs to fill qm, then the RNE forward (cvel, cacc) and backward
// (forces) sweeps give qfrc_bias.
//
// Bound: at the reorient planning model and B = 1024 (float32), K5 moves
// ~15.4 MB (4.6 us at 3.35 TB/s) and K6 ~6.0 MB (1.8 us); their arithmetic is
// far below the FP32 rate, so both are memory-bound on paper.  In practice
// they are latency-bound along the serial per-rollout chains (the body walk
// in K5, the CRB and RNE sweeps in K6), and B = 1024 gives K6 only 32 warps
// on 132 SMs.  Faster designs split a rollout's work over a warp.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum IntSeg {
  I_BODY_PARENT, I_BODY_JTYPE, I_BODY_QADR, I_BODY_DADR, I_BODY_DOFNUM,
  I_BODY_MOCAP, I_DOF_BODY, I_DOF_JTYPE, I_DOF_JOFS, I_DOF_PARENT,
  I_GEOM_BODY, N_INT_SEGS
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
// K6: CRB + RNE.  One thread per rollout; shared memory holds 12 rows per
// body for the thread, [(k * nbody + b) * tile + t]: the composite inertias
// (k < 10) during CRB, then cvel (k < 6) and the ancestor sum of
// cdof_dot * qvel, later the body forces (6 <= k < 12), during RNE.
// ---------------------------------------------------------------------------

template <typename T>
__global__ void tree_dyn_kernel(Tables<T> tab, Dims d,
                                const T* __restrict__ cdof,
                                const T* __restrict__ body10,
                                const T* __restrict__ qvel,
                                T* __restrict__ qm,
                                T* __restrict__ qfrc_bias, int64_t B) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s = reinterpret_cast<T*>(smem_raw);
  const int tile = blockDim.x;
  const int t = threadIdx.x;
  const int64_t r = (int64_t)blockIdx.x * tile + t;
  if (r >= B) return;
  const int nb = d.nbody, nv = d.nv;
  auto S = [&](int k, int b) -> T& {
    return s[((size_t)k * nb + b) * tile + t];
  };
  auto load6 = [&](const T* a, int n, int i, T out[6]) {
    for (int c = 0; c < 6; ++c) out[c] = a[((int64_t)c * n + i) * B + r];
  };
  const int* parent = tab.iseg(I_BODY_PARENT);
  const int* dadr = tab.iseg(I_BODY_DADR);
  const int* dofnum = tab.iseg(I_BODY_DOFNUM);
  const int* dof_body = tab.iseg(I_DOF_BODY);
  const int* dof_parent = tab.iseg(I_DOF_PARENT);
  const T* armature = tab.fseg(F_DOF_ARMATURE);
  const T* keep = tab.fseg(F_DOF_KEEP);
  const T* grav = tab.fseg(F_GRAVITY);

  // CRB: composite inertias, children into parents (parent < child).
  for (int k = 0; k < 10; ++k)
    for (int b = 0; b < nb; ++b) S(k, b) = body10[((int64_t)k * nb + b) * B + r];
  for (int b = nb - 1; b > 0; --b) {
    const int p = parent[b];
    for (int k = 0; k < 10; ++k) S(k, p) += S(k, b);
  }
  // qm[v, w] = cdof_v . (Ic_body(w) cdof_w) on the upper pattern (v an
  // ancestor dof of w, v <= w), mirrored below the diagonal; armature on
  // the diagonal; zero elsewhere.
  for (int i = 0; i < nv * nv; ++i) qm[(int64_t)i * B + r] = T(0);
  for (int w = 0; w < nv; ++w) {
    const int bw = dof_body[w];
    T cw[6], p10[10], f[6];
    load6(cdof, nv, w, cw);
    for (int k = 0; k < 10; ++k) p10[k] = S(k, bw);
    inertia_apply(p10, cw, f);
    for (int v = w; v >= 0; v = dof_parent[v]) {
      T cv[6];
      load6(cdof, nv, v, cv);
      T val = T(0);
      for (int c = 0; c < 6; ++c) val += cv[c] * f[c];
      if (v == w) {
        qm[((int64_t)w * nv + w) * B + r] = val + armature[w];
      } else {
        qm[((int64_t)v * nv + w) * B + r] = val;
        qm[((int64_t)w * nv + v) * B + r] = val;
      }
    }
  }

  // RNE forward sweep: cvel (k < 6) and the ancestor sum of
  // cdof_dot * qvel (6 <= k < 12), with cdof_dot = cvel_body x cdof; the
  // translational dofs of a free joint take no cvel term.
  for (int k = 0; k < 12; ++k) S(k, 0) = T(0);
  for (int b = 1; b < nb; ++b) {
    const int p = parent[b];
    T cv[6], mt[6];
    for (int c = 0; c < 6; ++c) {
      cv[c] = S(c, p);
      mt[c] = S(6 + c, p);
    }
    const int v0 = dadr[b], v1 = dadr[b] + dofnum[b];
    for (int v = v0; v < v1; ++v) {
      T cd[6];
      load6(cdof, nv, v, cd);
      const T qv = qvel[(int64_t)v * B + r];
      for (int c = 0; c < 6; ++c) cv[c] += cd[c] * qv;
    }
    for (int v = v0; v < v1; ++v) {
      T cd[6];
      load6(cdof, nv, v, cd);
      const T qv = qvel[(int64_t)v * B + r];
      const T kp = keep[v];
      const T ax = cv[0] * kp, ay = cv[1] * kp, az = cv[2] * kp;
      const T lx = cv[3] * kp, ly = cv[4] * kp, lz = cv[5] * kp;
      const T bx = cd[0], by = cd[1], bz = cd[2];
      const T dx = cd[3], dy = cd[4], dz = cd[5];
      mt[0] += (ay * bz - az * by) * qv;
      mt[1] += (az * bx - ax * bz) * qv;
      mt[2] += (ax * by - ay * bx) * qv;
      mt[3] += ((ay * dz - az * dy) + (ly * bz - lz * by)) * qv;
      mt[4] += ((az * dx - ax * dz) + (lz * bx - lx * bz)) * qv;
      mt[5] += ((ax * dy - ay * dx) + (lx * by - ly * bx)) * qv;
    }
    for (int c = 0; c < 6; ++c) {
      S(c, b) = cv[c];
      S(6 + c, b) = mt[c];
    }
  }
  // Body forces f_b = I_b cacc_b + cvel_b x* (I_b cvel_b); gravity enters
  // cacc as -g on the linear rows.
  for (int b = 1; b < nb; ++b) {
    T p10[10], cv[6], ca[6], iv[6], ia[6];
    for (int k = 0; k < 10; ++k) p10[k] = body10[((int64_t)k * nb + b) * B + r];
    for (int c = 0; c < 6; ++c) {
      cv[c] = S(c, b);
      ca[c] = S(6 + c, b) - (c >= 3 ? grav[c - 3] : T(0));
    }
    inertia_apply(p10, cv, iv);
    inertia_apply(p10, ca, ia);
    const T ax = cv[0], ay = cv[1], az = cv[2];
    const T lx = cv[3], ly = cv[4], lz = cv[5];
    const T tx = iv[0], ty = iv[1], tz = iv[2];
    const T fx = iv[3], fy = iv[4], fz = iv[5];
    S(6, b) = ia[0] + ((ay * tz - az * ty) + (ly * fz - lz * fy));
    S(7, b) = ia[1] + ((az * tx - ax * tz) + (lz * fx - lx * fz));
    S(8, b) = ia[2] + ((ax * ty - ay * tx) + (lx * fy - ly * fx));
    S(9, b) = ia[3] + (ay * fz - az * fy);
    S(10, b) = ia[4] + (az * fx - ax * fz);
    S(11, b) = ia[5] + (ax * fy - ay * fx);
  }
  // Backward sweep: subtree sums of the body forces.
  for (int b = nb - 1; b > 0; --b) {
    const int p = parent[b];
    if (p == 0) continue;
    for (int c = 0; c < 6; ++c) S(6 + c, p) += S(6 + c, b);
  }
  for (int v = 0; v < nv; ++v) {
    T cd[6];
    load6(cdof, nv, v, cd);
    const int b = dof_body[v];
    T acc = T(0);
    for (int c = 0; c < 6; ++c) acc += cd[c] * S(6 + c, b);
    qfrc_bias[(int64_t)v * B + r] = acc;
  }
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
               void* qfrc_bias, int64_t B, int tile, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  const size_t smem = (size_t)12 * d.nbody * tile * sizeof(T);
  auto kernel = tree_dyn_kernel<T>;
  int err = set_smem(kernel, smem);
  if (err != (int)cudaSuccess) return err;
  const int64_t blocks = (B + tile - 1) / tile;
  kernel<<<(unsigned)blocks, tile, smem, (cudaStream_t)stream>>>(
      Tables<T>{(const int*)ti, (const T*)tf}, d, (const T*)cdof,
      (const T*)body10, (const T*)qvel, (T*)qm, (T*)qfrc_bias, B);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Number of int (which == 0) or float (which == 1) table segments.
int dex_tree_layout(int which) {
  return which == 0 ? (int)N_INT_SEGS : (int)N_FLOAT_SEGS;
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
// qm (nv * nv, B) and qfrc_bias (nv, B).  tile rollouts (= threads) per CTA.
int dex_tree_dyn(int elem_bytes, const void* ti, const void* tf, int nbody,
                 int nv, int nq, int ngeom, int ntendon, int nmocap,
                 const void* cdof, const void* body10, const void* qvel,
                 void* qm, void* qfrc_bias, int64_t B, int tile,
                 void* stream) {
  const Dims d{nbody, nv, nq, ngeom, ntendon, nmocap};
  if (elem_bytes == 4)
    return launch_dyn<float>(ti, tf, d, cdof, body10, qvel, qm, qfrc_bias, B,
                             tile, stream);
  if (elem_bytes == 8)
    return launch_dyn<double>(ti, tf, d, cdof, body10, qvel, qm, qfrc_bias,
                              B, tile, stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"

// Fused physics step of the Open Duck Mini v2: n substeps of the MuJoCo
// Euler pipeline (Newton solver, iterations=1) for a batch of envs, in one
// kernel launch.
//
// Replaces the TPU kernel open_duck_playground_tpu/ops/pallas_step.py::
// _build_kernel (its pl.pallas_call), whose body is
// ops/lane_physics.py::LanePhysics.substep, in all its variants: the step
// variant (n_substeps = 10) and the init variant (n_substeps = 1, integration
// thrown away by the wrapper), with has_hf False (plane-hull and hull-hull
// contacts, the flat scenes) and True (heightfield-hull contacts, the rough
// scenes). The plain PyTorch version of the same program is
// ops/lane_physics.py of this package; the wrapper is ops/cuda_step.py.
//
// Design:
// - One thread per env, 1-D grid, ragged edge masked: no (8, 128) lanes and
//   no BLOCK padding. The wrapper picks the block size (32 to 128 threads)
//   so that the blocks reach every SM. Each thread runs the whole straight-line program of
//   every substep; a runtime loop runs the first n-1 substeps, the last one
//   also writes the derived outputs from its pre-integration state.
// - The model is data, not code: the wrapper packs the structural arrays
//   (tree, addresses, types, constants, hulls, constraint-row tables, LDL
//   sparsity masks, the heightfield table) once into device tensors and
//   passes them in DuckModel. One build serves every scene that fits the
//   compile-time maxima below. Every pair type is handled by name; the
//   wrapper admits no other.
// - Domain randomization comes as optional per-env pointers (DuckDR); a null
//   pointer means the model constant is used (the with_dr=False variant).
// - Per-env work arrays (mass matrix, Newton Hessian, constraint Jacobian)
//   are dense and sized by the maxima, in the thread's local memory (~45 KB
//   a thread), which the hardware interleaves across the threads of a warp,
//   so a warp's access to one field is one contiguous line. Sparse loops
//   follow bit masks of the tree / LDL pattern, in the twin's order.
// - The heightfield (256 x 256 floats, 256 KB, on the rough scene) is larger
//   than a block's shared memory, so it stays in device memory: each foot
//   vertex reads the 4 corners of its cell with __ldg, about 1,300 loads per
//   env per control step, served from L2 after the first touch (the TPU
//   kernel gathered them with a one-hot matmul, as Mosaic has no vector
//   gather). Its per-vertex state (local coordinates, normals) adds ~0.4 KB
//   to each thread's local memory.
//
// What bounds it on an H100: not device-memory traffic (a few hundred bytes
// of state in and out per env per control step, the table once) but each
// thread's latency chain: ~1e5 dependent flops per substep per env, most of
// them on the Jacobian (MAX_EFC x MAX_NV floats) and the two dense nv x nv
// matrices in local memory, served by L1/L2. 4096 envs are one warp per SM,
// so nothing hides that latency. The design takes that cost for now so the
// arithmetic stays the twin's, operation for operation (built with
// -fmad=false, no fast math; the heightfield constants are divided by, as
// the twin divides, since a last-bit change in a cell coordinate can move a
// vertex to another cell); making it fast (warp-cooperative rows and solves,
// more warps per env group, shared-memory model constants and judge table)
// is later work.
//
// NaN is never clamped away: min/max/clip propagate NaN like jax.numpy and
// torch do, so a NaN action still terminates the env.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define MAX_NQ 40
#define MAX_NV 32
#define MAX_NU 32
#define MAX_BODY 40
#define MAX_JNT 40
#define MAX_SITE 8
#define MAX_PAIR 4
#define MAX_HV 32
#define MAX_HF 64
#define MAX_EFC 128
#define MAX_HFIELD_N 4096  // heightfield rows, and columns

#define MINVAL 1e-10f
#define TINY 1e-12f
#define BIGD 1e10f

// field counts of the packed per-row parameter blocks (see cuda_step.py)
#define IMP_N 10   // k, b, dmin, dmax, width, mid, power, c_low, c_high, dd
#define LIM_N 14   // IMP_N + lo, hi, margin, invweight
#define PAIR_NI 13 // type, g1, g2, b1, b2, root1, root2, hull1, hull2, mu_g1, mu_g2, dofs1, dofs2
#define PAIR_NF 39 // IMP_N + diag_const, mu_const, n[3], ppn, frame[9], invweight, impratio,
                   // then PAIR_HF: the heightfield's pose hp[3], R[9] (row major)
#define PAIR_HF (IMP_N + 17)
// hfield_prm: rx, ry, 2 rx, 2 ry, ncol - 1, nrow - 1, ncol - 1.001, nrow - 1.001,
// ztop, dx = 2 rx / (ncol - 1), dy = 2 ry / (nrow - 1); each rounded to float
// once, as the twin's python floats are when they meet a float32 tile
#define HFP_N 11
#define ACT_NF 9   // ctrl_lo, ctrl_hi, gear, gain0, bias0, bias1, bias2, force_lo, force_hi

extern "C" {

struct DuckModel {
  int nq, nv, nu, nbody, njnt, ngeom, nsite, nsensor, npair, nfri, nlim, hv, hf;
  int iterations, ls_iterations;
  int hfield_nrow, hfield_ncol;  // 0 without a heightfield
  float dt, gx, gy, gz;
  const int *body_parentid, *body_rootid, *body_jntadr, *body_jntnum,
      *body_dofadr, *body_dofnum;
  const float *body_pos, *body_quat, *body_ipos, *body_iquat, *body_mass,
      *body_inertia;
  const int *jnt_type, *jnt_qposadr, *jnt_dofadr;
  const float *jnt_pos, *jnt_axis;
  const int *dof_bodyid;
  const float *dof_armature, *dof_damping, *dof_frictionloss;
  const uint32_t *tree_mask;  // bit j of row i: j ancestor-or-self of i
  const uint32_t *ldl_mask;   // bit k < i: (i, k) in the LDL pattern of M
  const uint32_t *ldlh_mask;  // same for the Newton Hessian's pattern
  const int *fri_dof;
  const float *fri_D, *fri_b;
  const int *lim_jnt;
  const float *lim_prm;
  const int *geom_bodyid;
  const float *geom_pos, *geom_quat, *geom_friction;
  const int *site_bodyid;
  const float *site_pos, *site_quat;
  const int *sensor_type, *sensor_objid, *sensor_adr;
  const int *act_adr;  // per actuator: qposadr, dofadr
  const float *act_prm;
  const float *gainprm, *biasprm;  // (nu, 3) model constants
  const float *qpos0;
  const int *pair_i;
  const float *pair_f;
  const float *hull_vert, *hull_face_n;  // (nhull, hv, 3), (nhull, hf, 3): hf counts hull faces
  const float *hfield_data;  // (hfield_nrow, hfield_ncol) row major, or null
  const float *hfield_prm;   // HFP_N constants, or null
};

struct DuckDR {  // per-env rows, or null for the model constant
  const float *geom_friction, *body_ipos, *dof_frictionloss, *dof_armature,
      *body_mass, *qpos0, *gainprm, *biasprm;
};

}  // extern "C"

enum { J_FREE = 0 };        // else HINGE: the wrapper lets in no other joint type
enum { P_PLANE_HULL = 0, P_HFIELD_HULL = 1, P_HULL_HULL = 2 };  // ops/types.py PairType
enum {
  S_GYRO = 0, S_VELOCIMETER, S_ACCELEROMETER, S_FRAMEXAXIS, S_FRAMEZAXIS,
  S_FRAMELINVEL, S_FRAMEANGVEL, S_FRAMEPOS, S_FRAMEQUAT
};

// ---------------------------------------------------------------------------
// scalar helpers with jax.numpy / torch NaN semantics
// ---------------------------------------------------------------------------

__device__ __forceinline__ float vmax(float a, float b) {
  if (a != a || b != b) return a + b;
  return a > b ? a : b;
}
__device__ __forceinline__ float vmin(float a, float b) {
  if (a != a || b != b) return a + b;
  return a < b ? a : b;
}
__device__ __forceinline__ float vclip(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}
__device__ __forceinline__ float vsign(float x) {
  return x > 0.f ? 1.f : (x < 0.f ? -1.f : x);
}

// ---------------------------------------------------------------------------
// vec3 / quat / mat3 / spatial algebra (ops/lane.py)
// ---------------------------------------------------------------------------

struct V3 { float x, y, z; };
struct Q4 { float w, x, y, z; };
struct M3 { float m[9]; };

__device__ __forceinline__ V3 v3(float x, float y, float z) { V3 r = {x, y, z}; return r; }
__device__ __forceinline__ V3 vld(const float* p) { return v3(p[0], p[1], p[2]); }
__device__ __forceinline__ Q4 qld(const float* p) { Q4 q = {p[0], p[1], p[2], p[3]}; return q; }
__device__ __forceinline__ V3 add(V3 a, V3 b) { return v3(a.x + b.x, a.y + b.y, a.z + b.z); }
__device__ __forceinline__ V3 sub(V3 a, V3 b) { return v3(a.x - b.x, a.y - b.y, a.z - b.z); }
__device__ __forceinline__ V3 scl(V3 a, float s) { return v3(a.x * s, a.y * s, a.z * s); }
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return v3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x);
}

__device__ __forceinline__ Q4 qmul(Q4 a, Q4 b) {
  Q4 r;
  r.w = a.w * b.w - a.x * b.x - a.y * b.y - a.z * b.z;
  r.x = a.w * b.x + a.x * b.w + a.y * b.z - a.z * b.y;
  r.y = a.w * b.y - a.x * b.z + a.y * b.w + a.z * b.x;
  r.z = a.w * b.z + a.x * b.y - a.y * b.x + a.z * b.w;
  return r;
}
__device__ __forceinline__ V3 qrot(Q4 q, V3 v) {
  V3 qv = v3(q.x, q.y, q.z);
  V3 uv = cross(qv, v);
  V3 t = add(scl(uv, q.w), cross(qv, uv));
  return add(v, scl(t, 2.0f));
}
__device__ __forceinline__ Q4 qnormalize(Q4 q) {
  float n2 = q.w * q.w + q.x * q.x + q.y * q.y + q.z * q.z;
  float inv = 1.0f / sqrtf(n2);
  Q4 r = {q.w * inv, q.x * inv, q.y * inv, q.z * inv};
  return r;
}
__device__ __forceinline__ M3 qmat(Q4 q) {
  float xx = q.x * q.x, yy = q.y * q.y, zz = q.z * q.z;
  float wx = q.w * q.x, wy = q.w * q.y, wz = q.w * q.z;
  float xy = q.x * q.y, xz = q.x * q.z, yz = q.y * q.z;
  M3 r;
  r.m[0] = 1.0f - 2.0f * (yy + zz); r.m[1] = 2.0f * (xy - wz); r.m[2] = 2.0f * (xz + wy);
  r.m[3] = 2.0f * (xy + wz); r.m[4] = 1.0f - 2.0f * (xx + zz); r.m[5] = 2.0f * (yz - wx);
  r.m[6] = 2.0f * (xz - wy); r.m[7] = 2.0f * (yz + wx); r.m[8] = 1.0f - 2.0f * (xx + yy);
  return r;
}
__device__ __forceinline__ V3 mvec(const M3& m, V3 v) {
  return v3(m.m[0] * v.x + m.m[1] * v.y + m.m[2] * v.z,
            m.m[3] * v.x + m.m[4] * v.y + m.m[5] * v.z,
            m.m[6] * v.x + m.m[7] * v.y + m.m[8] * v.z);
}
__device__ __forceinline__ V3 mtvec(const M3& m, V3 v) {
  return v3(m.m[0] * v.x + m.m[3] * v.y + m.m[6] * v.z,
            m.m[1] * v.x + m.m[4] * v.y + m.m[7] * v.z,
            m.m[2] * v.x + m.m[5] * v.y + m.m[8] * v.z);
}
__device__ __forceinline__ V3 mcol(const M3& m, int j) { return v3(m.m[j], m.m[3 + j], m.m[6 + j]); }

// spatial 6-vectors [ang(3), lin(3)]
__device__ __forceinline__ void v6_axpy(float* a, const float* x, float s) {
  for (int i = 0; i < 6; ++i) a[i] = a[i] + x[i] * s;
}
__device__ __forceinline__ float v6_dot(const float* a, const float* b) {
  float s = a[0] * b[0];
  for (int i = 1; i < 6; ++i) s = s + a[i] * b[i];
  return s;
}
__device__ __forceinline__ void motion_cross(const float* vel, const float* m, float* out) {
  V3 w1 = vld(vel), v1 = vld(vel + 3), w2 = vld(m), v2 = vld(m + 3);
  V3 a = cross(w1, w2), b = add(cross(w1, v2), cross(v1, w2));
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = b.x; out[4] = b.y; out[5] = b.z;
}
__device__ __forceinline__ void force_cross(const float* vel, const float* f, float* out) {
  V3 w = vld(vel), v = vld(vel + 3), n = vld(f), fo = vld(f + 3);
  V3 a = add(cross(w, n), cross(v, fo)), b = cross(w, fo);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = b.x; out[4] = b.y; out[5] = b.z;
}

// sym6: 21 lower-triangle entries, row major
__device__ __forceinline__ int s6(int i, int j) {
  return i >= j ? i * (i + 1) / 2 + j : j * (j + 1) / 2 + i;
}
__device__ __forceinline__ void sym6_vec(const float* s, const float* v, float* out) {
  for (int i = 0; i < 6; ++i) {
    float acc = s[s6(i, 0)] * v[0];
    for (int j = 1; j < 6; ++j) acc = acc + s[s6(i, j)] * v[j];
    out[i] = acc;
  }
}
__device__ void spatial_inertia_sym(float mass, const M3& I, V3 c, float* out) {
  float xx = mass * (c.y * c.y + c.z * c.z);
  float yy = mass * (c.x * c.x + c.z * c.z);
  float zz = mass * (c.x * c.x + c.y * c.y);
  float xy = -mass * (c.x * c.y);
  float xz = -mass * (c.x * c.z);
  float yz = -mass * (c.y * c.z);
  out[s6(0, 0)] = I.m[0] + xx;
  out[s6(1, 0)] = I.m[3] + xy;
  out[s6(1, 1)] = I.m[4] + yy;
  out[s6(2, 0)] = I.m[6] + xz;
  out[s6(2, 1)] = I.m[7] + yz;
  out[s6(2, 2)] = I.m[8] + zz;
  float zero = mass * 0.0f;
  float mcx = mass * c.x, mcy = mass * c.y, mcz = mass * c.z;
  out[s6(3, 0)] = zero; out[s6(3, 1)] = mcz; out[s6(3, 2)] = -mcy;
  out[s6(4, 0)] = -mcz; out[s6(4, 1)] = zero; out[s6(4, 2)] = mcx;
  out[s6(5, 0)] = mcy; out[s6(5, 1)] = -mcx; out[s6(5, 2)] = zero;
  out[s6(3, 3)] = mass * 1.0f; out[s6(4, 3)] = zero; out[s6(4, 4)] = mass * 1.0f;
  out[s6(5, 3)] = zero; out[s6(5, 4)] = zero; out[s6(5, 5)] = mass * 1.0f;
}
__device__ M3 rotate_inertia(V3 d, const M3& R) {
  M3 out;
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c)
      out.m[3 * r + c] = R.m[3 * r + 0] * d.x * R.m[3 * c + 0] +
                         R.m[3 * r + 1] * d.y * R.m[3 * c + 1] +
                         R.m[3 * r + 2] * d.z * R.m[3 * c + 2];
  return out;
}

// ---------------------------------------------------------------------------
// impedance (lane_physics._impedance) from a packed IMP_N block
// ---------------------------------------------------------------------------

__device__ float impedance(float pos, const float* p) {
  const float dmin = p[2], dmax = p[3], width = p[4], mid = p[5], power = p[6];
  float x = fabsf(pos) / width;
  float y_low, y_high;
  if (power == 2.0f) {
    y_low = x * x * p[7];
    float xm = 1.0f - x;
    y_high = 1.0f - xm * xm * p[8];
  } else if (power == 1.0f) {
    y_low = x;
    y_high = x;
  } else {
    y_low = powf(x, power) * p[7];
    y_high = 1.0f - powf(1.0f - x, power) * p[8];
  }
  float y = x < mid ? y_low : y_high;
  float imp = dmin + y * p[9];
  imp = x >= 1.0f ? dmax : imp;
  return vclip(imp, dmin, dmax);
}

// ---------------------------------------------------------------------------
// per-thread work state
// ---------------------------------------------------------------------------

struct Cand { float dist; V3 pos; };

struct Work {
  // kinematics
  V3 xpos[MAX_BODY];
  Q4 xquat[MAX_BODY];
  V3 xanchor[MAX_JNT];
  V3 xaxis[MAX_JNT];
  // com / inertia
  V3 subtree_com[MAX_BODY];
  float cinert[MAX_BODY][21];
  float cdof[MAX_NV][6];
  float cdofdot[MAX_NV][6];
  float cvel[MAX_BODY][6];
  float M[MAX_NV][MAX_NV];
  float H[MAX_NV][MAX_NV];
  float dinv[MAX_NV];
  float qacc_smooth[MAX_NV];
  float actuator_force[MAX_NU];
  // contacts: per pair 4 candidates + frame (rows n, t1, t2)
  Cand cand[MAX_PAIR][4];
  float frame[MAX_PAIR][9];
  // constraint rows
  int nefc;
  float J[MAX_EFC][MAX_NV];
  uint32_t sup[MAX_EFC];
  float D[MAX_EFC], aref[MAX_EFC], pos[MAX_EFC], floss[MAX_EFC];
  float Jaref[MAX_EFC], Jd[MAX_EFC];
  uint8_t is_fri[MAX_EFC];
  // solver
  float qacc[MAX_NV];
  float dir[MAX_NV];
  float tmp[MAX_NV];
  float tmp2[MAX_NV];
  // hull vertices in world frame
  V3 w1[MAX_HV];
  V3 w2[MAX_HV];
  float sup_v[MAX_HV];
  uint8_t mask_v[MAX_HV];
};

// DR-or-constant accessors
#define DRF(field, off) (dr.field ? dr.field[env * (size_t)(stride_##field) + (off)] : m.field[(off)])

// ---------------------------------------------------------------------------
// stages
// ---------------------------------------------------------------------------

__device__ void kinematics(const DuckModel& m, const DuckDR& dr, int env,
                           const float* qpos, Work& w) {
  const int stride_qpos0 = m.nq;
  w.xpos[0] = v3(0.f, 0.f, 0.f);
  Q4 one = {1.f, 0.f, 0.f, 0.f};
  w.xquat[0] = one;
  for (int b = 1; b < m.nbody; ++b) {
    int p = m.body_parentid[b];
    V3 pos = add(w.xpos[p], qrot(w.xquat[p], vld(m.body_pos + 3 * b)));
    Q4 quat = qmul(w.xquat[p], qld(m.body_quat + 4 * b));
    int jadr = m.body_jntadr[b], jnum = m.body_jntnum[b];
    for (int j = jadr; j < jadr + jnum; ++j) {
      int qadr = m.jnt_qposadr[j];
      if (m.jnt_type[j] == J_FREE) {
        pos = v3(qpos[qadr], qpos[qadr + 1], qpos[qadr + 2]);
        Q4 q = {qpos[qadr + 3], qpos[qadr + 4], qpos[qadr + 5], qpos[qadr + 6]};
        quat = qnormalize(q);
        w.xanchor[j] = pos;
        w.xaxis[j] = qrot(quat, vld(m.jnt_axis + 3 * j));
      } else {
        float q0 = DRF(qpos0, qadr);
        float angle = qpos[qadr] - q0;
        V3 jp = vld(m.jnt_pos + 3 * j), ax = vld(m.jnt_axis + 3 * j);
        V3 anchor = add(pos, qrot(quat, jp));
        float s = sinf(angle * 0.5f), c = cosf(angle * 0.5f);
        Q4 qloc = {c, ax.x * s, ax.y * s, ax.z * s};
        quat = qnormalize(qmul(quat, qloc));
        pos = sub(anchor, qrot(quat, jp));
        w.xanchor[j] = anchor;
        w.xaxis[j] = qrot(quat, ax);
      }
    }
    w.xpos[b] = pos;
    w.xquat[b] = quat;
  }
}

__device__ void com_pos(const DuckModel& m, const DuckDR& dr, int env, Work& w) {
  const int stride_body_ipos = 3 * m.nbody, stride_body_mass = m.nbody;
  V3 xipos[MAX_BODY], seg[MAX_BODY];
  float segm[MAX_BODY];
  for (int b = 0; b < m.nbody; ++b) {
    V3 ip = v3(DRF(body_ipos, 3 * b), DRF(body_ipos, 3 * b + 1), DRF(body_ipos, 3 * b + 2));
    xipos[b] = b ? add(w.xpos[b], qrot(w.xquat[b], ip)) : w.xpos[b];
    float mass = DRF(body_mass, b);
    seg[b] = scl(xipos[b], mass);
    segm[b] = mass;
  }
  for (int b = m.nbody - 1; b > 0; --b) {
    int p = m.body_parentid[b];
    seg[p] = add(seg[p], seg[b]);
    segm[p] = segm[p] + segm[b];
  }
  for (int b = 0; b < m.nbody; ++b)
    w.subtree_com[b] = scl(seg[b], 1.0f / vmax(segm[b], 1e-12f));
  for (int b = 0; b < m.nbody; ++b) {
    V3 root_com = w.subtree_com[m.body_rootid[b]];
    M3 ximat = qmat(qmul(w.xquat[b], qld(m.body_iquat + 4 * b)));
    M3 I = rotate_inertia(vld(m.body_inertia + 3 * b), ximat);
    spatial_inertia_sym(DRF(body_mass, b), I, sub(xipos[b], root_com), w.cinert[b]);
  }
  for (int b = 1; b < m.nbody; ++b) {
    int jadr = m.body_jntadr[b], jnum = m.body_jntnum[b];
    V3 root_com = w.subtree_com[m.body_rootid[b]];
    for (int j = jadr; j < jadr + jnum; ++j) {
      int vadr = m.jnt_dofadr[j];
      V3 neg = scl(sub(w.xanchor[j], root_com), -1.0f);
      if (m.jnt_type[j] == J_FREE) {
        for (int i = 0; i < 3; ++i)
          for (int k = 0; k < 6; ++k) w.cdof[vadr + i][k] = (k == 3 + i) ? 1.0f : 0.0f;
        M3 xmat = qmat(w.xquat[b]);
        for (int i = 0; i < 3; ++i) {
          V3 axis = mcol(xmat, i), cr = cross(axis, neg);
          float* cd = w.cdof[vadr + 3 + i];
          cd[0] = axis.x; cd[1] = axis.y; cd[2] = axis.z; cd[3] = cr.x; cd[4] = cr.y; cd[5] = cr.z;
        }
      } else {
        V3 axis = w.xaxis[j], cr = cross(axis, neg);
        float* cd = w.cdof[vadr];
        cd[0] = axis.x; cd[1] = axis.y; cd[2] = axis.z; cd[3] = cr.x; cd[4] = cr.y; cd[5] = cr.z;
      }
    }
  }
}

__device__ void crb(const DuckModel& m, const DuckDR& dr, int env, Work& w) {
  const int stride_dof_armature = m.nv;
  float crb_in[MAX_BODY][21];
  for (int b = 0; b < m.nbody; ++b)
    for (int k = 0; k < 21; ++k) crb_in[b][k] = w.cinert[b][k];
  for (int b = m.nbody - 1; b > 0; --b) {
    int p = m.body_parentid[b];
    if (p > 0)
      for (int k = 0; k < 21; ++k) crb_in[p][k] = crb_in[p][k] + crb_in[b][k];
  }
  for (int i = 0; i < m.nv; ++i)
    for (int j = 0; j < m.nv; ++j) w.M[i][j] = 0.0f;
  for (int i = 0; i < m.nv; ++i) {
    float F[6];
    sym6_vec(crb_in[m.dof_bodyid[i]], w.cdof[i], F);
    uint32_t mask = m.tree_mask[i];
    for (int j = 0; j <= i; ++j)
      if (mask >> j & 1u) {
        float v = v6_dot(F, w.cdof[j]);
        w.M[i][j] = v;
        w.M[j][i] = v;
      }
  }
  for (int i = 0; i < m.nv; ++i) {
    float v = w.M[i][i] + DRF(dof_armature, i);
    w.M[i][i] = v;
  }
}

__device__ void com_vel(const DuckModel& m, const float* qvel, Work& w) {
  for (int k = 0; k < 6; ++k) w.cvel[0][k] = 0.0f;
  for (int b = 1; b < m.nbody; ++b) {
    int p = m.body_parentid[b];
    float v[6];
    for (int k = 0; k < 6; ++k) v[k] = w.cvel[p][k];
    int jadr = m.body_jntadr[b], jnum = m.body_jntnum[b];
    for (int j = jadr; j < jadr + jnum; ++j) {
      int vadr = m.jnt_dofadr[j];
      if (m.jnt_type[j] == J_FREE) {
        for (int i = vadr; i < vadr + 3; ++i) {
          for (int k = 0; k < 6; ++k) w.cdofdot[i][k] = 0.0f;
          v6_axpy(v, w.cdof[i], qvel[i]);
        }
        float v_pre[6];
        for (int k = 0; k < 6; ++k) v_pre[k] = v[k];
        for (int i = vadr + 3; i < vadr + 6; ++i) {
          motion_cross(v_pre, w.cdof[i], w.cdofdot[i]);
          v6_axpy(v, w.cdof[i], qvel[i]);
        }
      } else {
        motion_cross(v, w.cdof[vadr], w.cdofdot[vadr]);
        v6_axpy(v, w.cdof[vadr], qvel[vadr]);
      }
    }
    for (int k = 0; k < 6; ++k) w.cvel[b][k] = v[k];
  }
}

// bias forces (rne); returns qfrc_bias in out
__device__ void rne(const DuckModel& m, const float* qvel, Work& w, float* out) {
  float cacc[MAX_BODY][6], cfrc[MAX_BODY][6];
  cacc[0][0] = cacc[0][1] = cacc[0][2] = 0.0f;
  cacc[0][3] = 0.0f - m.gx; cacc[0][4] = 0.0f - m.gy; cacc[0][5] = 0.0f - m.gz;
  for (int k = 0; k < 6; ++k) cfrc[0][k] = 0.0f;
  for (int b = 1; b < m.nbody; ++b) {
    int p = m.body_parentid[b];
    float a[6];
    for (int k = 0; k < 6; ++k) a[k] = cacc[p][k];
    int dofadr = m.body_dofadr[b], dofnum = m.body_dofnum[b];
    for (int i = dofadr; i < dofadr + dofnum; ++i) v6_axpy(a, w.cdofdot[i], qvel[i]);
    for (int k = 0; k < 6; ++k) cacc[b][k] = a[k];
    float Iv[6], Ia[6], fc[6];
    sym6_vec(w.cinert[b], w.cvel[b], Iv);
    sym6_vec(w.cinert[b], a, Ia);
    force_cross(w.cvel[b], Iv, fc);
    for (int k = 0; k < 6; ++k) cfrc[b][k] = Ia[k] + fc[k];
  }
  for (int b = m.nbody - 1; b > 0; --b) {
    int p = m.body_parentid[b];
    if (p > 0)
      for (int k = 0; k < 6; ++k) cfrc[p][k] = cfrc[p][k] + cfrc[b][k];
  }
  for (int i = 0; i < m.nv; ++i) out[i] = v6_dot(w.cdof[i], cfrc[m.dof_bodyid[i]]);
}

// position servos; fills w.actuator_force and adds into qfrc_act
__device__ void actuation(const DuckModel& m, const DuckDR& dr, int env,
                          const float* qpos, const float* qvel, const float* ctrl,
                          Work& w, float* qfrc_act) {
  const int stride_gainprm = 3 * m.nu, stride_biasprm = 3 * m.nu;
  for (int i = 0; i < m.nv; ++i) qfrc_act[i] = 0.0f;
  for (int u = 0; u < m.nu; ++u) {
    int qadr = m.act_adr[2 * u], vadr = m.act_adr[2 * u + 1];
    const float* p = m.act_prm + ACT_NF * u;
    float gear = p[2];
    float ctrl_c = vclip(ctrl[u], p[0], p[1]);
    float length = qpos[qadr] * gear;
    float velocity = qvel[vadr] * gear;
    float gain0 = DRF(gainprm, 3 * u);
    float bias1 = DRF(biasprm, 3 * u + 1);
    float force = gain0 * ctrl_c + p[4] + bias1 * length + p[6] * velocity;
    force = vclip(force, p[7], p[8]);
    w.actuator_force[u] = force;
    qfrc_act[vadr] = qfrc_act[vadr] + force * gear;
  }
}

// sparse LDL^T of A (dense storage) on the pattern given by masks; factor is
// written into L (strict lower) and dinv; A is read only
__device__ void ldl_factor(int nv, const uint32_t* mask, float (*A)[MAX_NV],
                           float (*L)[MAX_NV], float* d, float* dinv) {
  for (int j = 0; j < nv; ++j) {
    float s = A[j][j];
    uint32_t rj = mask[j];
    for (int k = 0; k < j; ++k)
      if (rj >> k & 1u) s = s - L[j][k] * L[j][k] * d[k];
    d[j] = s;
    dinv[j] = 1.0f / s;
    for (int i = j + 1; i < nv; ++i) {
      if (!(mask[i] >> j & 1u)) continue;
      float t = A[i][j];
      uint32_t both = mask[i] & rj;
      for (int k = 0; k < j; ++k)
        if (both >> k & 1u) t = t - L[i][k] * L[j][k] * d[k];
      L[i][j] = t * dinv[j];
    }
  }
}

__device__ void ldl_solve(int nv, const uint32_t* mask, float (*L)[MAX_NV],
                          const float* dinv, float* z) {
  for (int i = 0; i < nv; ++i)
    for (int k = 0; k < i; ++k)
      if (mask[i] >> k & 1u) z[i] = z[i] - L[i][k] * z[k];
  for (int i = 0; i < nv; ++i) z[i] = z[i] * dinv[i];
  for (int i = nv - 1; i >= 0; --i)
    for (int k = 0; k < i; ++k)
      if (mask[i] >> k & 1u) z[k] = z[k] - L[i][k] * z[i];
}

// symmetric tree-pattern matvec, in lane_physics._mat_vec_tree's order
__device__ void mat_vec_tree(const DuckModel& m, float (*M)[MAX_NV], const float* v, float* out) {
  for (int i = 0; i < m.nv; ++i) out[i] = 0.0f;
  for (int i = 0; i < m.nv; ++i) {
    uint32_t mask = m.tree_mask[i];
    for (int j = 0; j <= i; ++j) {
      if (!(mask >> j & 1u)) continue;
      out[i] = out[i] + M[i][j] * v[j];
      if (i != j) out[j] = out[j] + M[i][j] * v[i];
    }
  }
}

// ---------------------------------------------------------------------------
// collision
// ---------------------------------------------------------------------------

__device__ void geom_pose(const DuckModel& m, int g, const Work& w, V3& pos, M3& mat) {
  int b = m.geom_bodyid[g];
  pos = add(w.xpos[b], qrot(w.xquat[b], vld(m.geom_pos + 3 * g)));
  mat = qmat(qmul(w.xquat[b], qld(m.geom_quat + 4 * g)));
}

// first-max running argmax (ties keep the first index)
__device__ __forceinline__ int argmax_first(const float* s, int n) {
  int bi = 0;
  float bs = s[0];
  for (int v = 1; v < n; ++v)
    if (s[v] > bs) { bs = s[v]; bi = v; }
  return bi;
}

// the four candidate vertices of lane_physics._manifold (dyn=false: spread
// about the constant normal n, candidate a the deepest vertex) and
// _manifold_dyn (dyn=true: candidate a the first masked vertex), with their
// validity after dedup; candidate 0 is always valid
__device__ void manifold_pick(const V3* wv, const float* support, const uint8_t* mask, int V,
                              V3 n, bool dyn, int* idx, bool* valid) {
  float dm[MAX_HV], sc[MAX_HV];
  for (int v = 0; v < V; ++v) dm[v] = mask[v] ? 0.0f : -1e6f;
  int ia = argmax_first(dyn ? dm : support, V);
  V3 a = wv[ia];
  for (int v = 0; v < V; ++v) { V3 d = sub(a, wv[v]); sc[v] = dot(d, d) + dm[v]; }
  int ib = argmax_first(sc, V);
  V3 b = wv[ib];
  V3 ab = cross(n, sub(a, b));
  for (int v = 0; v < V; ++v) sc[v] = fabsf(dot(sub(a, wv[v]), ab)) + dm[v];
  int ic = argmax_first(sc, V);
  V3 c = wv[ic];
  V3 ac = cross(n, sub(a, c)), bc = cross(n, sub(b, c));
  for (int v = 0; v < V; ++v)
    sc[v] = fabsf(dot(sub(b, wv[v]), bc)) + fabsf(dot(sub(a, wv[v]), ac)) + dm[v];
  int id = argmax_first(sc, V);
  idx[0] = ia; idx[1] = ib; idx[2] = ic; idx[3] = id;
  for (int k = 0; k < 4; ++k) {
    bool seen = false;
    for (int j = 0; j < k; ++j) seen = seen || (idx[j] == idx[k]);
    valid[k] = (k == 0) ? true : (mask[idx[k]] && !seen);
  }
}

// _manifold (plane: dist from the support, offset along n) and _manifold_dyn
// (hull-hull: dist from `depth`, offset along the SAT axis)
__device__ void manifold(const V3* wv, const float* support, const uint8_t* mask, int V,
                         V3 n, bool dyn, float depth, Cand* out) {
  int idx[4];
  bool valid[4];
  manifold_pick(wv, support, mask, V, n, dyn, idx, valid);
  for (int k = 0; k < 4; ++k) {
    V3 pk = wv[idx[k]];
    if (!dyn) {
      float dist = -support[idx[k]];
      float h = 0.5f * dist;
      out[k].pos = v3(pk.x - h * n.x, pk.y - h * n.y, pk.z - h * n.z);
      out[k].dist = valid[k] ? dist : BIGD;
    } else {
      float h = 0.5f * depth;
      out[k].pos = v3(pk.x + h * n.x, pk.y + h * n.y, pk.z + h * n.z);
      out[k].dist = (valid[k] && depth > 0.0f) ? -depth : BIGD;
    }
  }
}

// per-env contact frame rows [n, t1, t2] (lane_physics._dyn_frame)
__device__ void dyn_frame(V3 n, float* fr) {
  bool refy = fabsf(n.y) < 0.9f;
  V3 ref = v3(0.0f, refy ? 1.0f : 0.0f, refy ? 0.0f : 1.0f);
  V3 t1 = cross(ref, n);
  float inv = 1.0f / vmax(sqrtf(dot(t1, t1)), 1e-12f);
  t1 = scl(t1, inv);
  V3 t2 = cross(n, t1);
  fr[0] = n.x; fr[1] = n.y; fr[2] = n.z;
  fr[3] = t1.x; fr[4] = t1.y; fr[5] = t1.z;
  fr[6] = t2.x; fr[7] = t2.y; fr[8] = t2.z;
}

// heightfield vs hull (lane_physics._hfield_hull): each hull vertex against
// the triangulated surface of its cell, the candidates spread about the
// heightfield's up axis, and one frame from the deepest vertex's normal
__device__ void hfield_hull(const DuckModel& m, const int* pi, const float* pf, Work& w,
                            Cand* out, float* fr) {
  const int HV = m.hv, nrow = m.hfield_nrow, ncol = m.hfield_ncol;
  const float* hp = pf + PAIR_HF;  // the heightfield frame: world <- local
  M3 R;
  for (int k = 0; k < 9; ++k) R.m[k] = hp[3 + k];
  const float* c = m.hfield_prm;
  const float rx = c[0], ry = c[1], two_rx = c[2], two_ry = c[3], cols1 = c[4], rows1 = c[5],
              gx_max = c[6], gy_max = c[7], ztop = c[8], dx = c[9], dy = c[10];
  const float* verts = m.hull_vert + (size_t)pi[8] * HV * 3;
  V3 gpos; M3 gmat;
  geom_pose(m, pi[2], w, gpos, gmat);
  V3 n_loc[MAX_HV];
  float smax = 0.f;
  for (int v = 0; v < HV; ++v) {
    V3 wv = add(gpos, mvec(gmat, vld(verts + 3 * v)));
    w.w2[v] = wv;
    V3 loc = mtvec(R, v3(wv.x - hp[0], wv.y - hp[1], wv.z - hp[2]));  // R^T (w - hp)
    // cell and fractions (_hf_indices): divide, as the twin does
    float gx = vclip((loc.x + rx) / two_rx * cols1, 0.0f, gx_max);
    float gy = vclip((loc.y + ry) / two_ry * rows1, 0.0f, gy_max);
    float flx = floorf(gx), fly = floorf(gy);
    float fx = gx - flx, fy = gy - fly;
    // a NaN coordinate reads cell 0 (its fraction stays NaN); finite ones
    // are within [0, n - 2] already
    int ix = flx > 0.0f ? min((int)flx, ncol - 2) : 0;
    int iy = fly > 0.0f ? min((int)fly, nrow - 2) : 0;
    const float* cell = m.hfield_data + (size_t)iy * ncol + ix;
    float z00 = __ldg(cell) * ztop, z10 = __ldg(cell + 1) * ztop;
    float z01 = __ldg(cell + ncol) * ztop, z11 = __ldg(cell + ncol + 1) * ztop;
    // triangulated height and normal (_hf_interp)
    bool lower = fx + fy < 1.0f;
    float z = lower ? z00 + fx * (z10 - z00) + fy * (z01 - z00)
                    : z11 + (1.0f - fx) * (z01 - z11) + (1.0f - fy) * (z10 - z11);
    float gxs = lower ? (z10 - z00) / dx : (z11 - z01) / dx;
    float gys = lower ? (z01 - z00) / dy : (z11 - z10) / dy;
    float inv = 1.0f / sqrtf(gxs * gxs + gys * gys + 1.0f);
    n_loc[v] = v3(-gxs * inv, -gys * inv, inv);
    w.sup_v[v] = -((loc.z - z) * n_loc[v].z);
    smax = v ? vmax(smax, w.sup_v[v]) : w.sup_v[v];
  }
  // candidate band within 1 mm of the deepest vertex, as the plane path
  float band = vmax(smax - 1e-3f, 0.0f);
  for (int v = 0; v < HV; ++v) w.mask_v[v] = w.sup_v[v] > band;
  int idx[4];
  bool valid[4];
  manifold_pick(w.w2, w.sup_v, w.mask_v, HV, mcol(R, 2), false, idx, valid);
  // world normal of the deepest vertex: the contact normal of all four
  V3 n0 = mvec(R, n_loc[idx[0]]);
  n0 = scl(n0, 1.0f / vmax(sqrtf(dot(n0, n0)), 1e-12f));
  for (int k = 0; k < 4; ++k) {
    V3 pk = w.w2[idx[k]];
    float dist = -w.sup_v[idx[k]];
    float h = 0.5f * dist;
    out[k].pos = v3(pk.x - h * n0.x, pk.y - h * n0.y, pk.z - h * n0.z);
    out[k].dist = valid[k] ? dist : BIGD;
  }
  dyn_frame(n0, fr);
}

__device__ void collide(const DuckModel& m, Work& w) {
  const int HV = m.hv, HF = m.hf;
  for (int p = 0; p < m.npair; ++p) {
    const int* pi = m.pair_i + PAIR_NI * p;
    const float* pf = m.pair_f + PAIR_NF * p;
    int type = pi[0], g1 = pi[1], g2 = pi[2];
    if (type == P_PLANE_HULL) {
      V3 n = v3(pf[IMP_N + 2], pf[IMP_N + 3], pf[IMP_N + 4]);
      float ppn = pf[IMP_N + 5];
      const float* verts = m.hull_vert + (size_t)pi[8] * HV * 3;
      V3 gpos; M3 gmat;
      geom_pose(m, g2, w, gpos, gmat);
      float smax = 0.f;
      for (int v = 0; v < HV; ++v) {
        w.w2[v] = add(gpos, mvec(gmat, vld(verts + 3 * v)));
        w.sup_v[v] = ppn - dot(w.w2[v], n);
        smax = v ? vmax(smax, w.sup_v[v]) : w.sup_v[v];
      }
      float band = vmax(smax - 1e-3f, 0.0f);
      for (int v = 0; v < HV; ++v) w.mask_v[v] = w.sup_v[v] > band;
      manifold(w.w2, w.sup_v, w.mask_v, HV, n, false, 0.f, w.cand[p]);
      for (int k = 0; k < 9; ++k) w.frame[p][k] = pf[IMP_N + 6 + k];
    } else if (type == P_HFIELD_HULL) {
      hfield_hull(m, pi, pf, w, w.cand[p], w.frame[p]);
    } else if (type == P_HULL_HULL) {
      const float* v1 = m.hull_vert + (size_t)pi[7] * HV * 3;
      const float* v2 = m.hull_vert + (size_t)pi[8] * HV * 3;
      const float* f1 = m.hull_face_n + (size_t)pi[7] * HF * 3;
      const float* f2 = m.hull_face_n + (size_t)pi[8] * HF * 3;
      V3 pos1, pos2; M3 mat1, mat2;
      geom_pose(m, g1, w, pos1, mat1);
      geom_pose(m, g2, w, pos2, mat2);
      for (int v = 0; v < HV; ++v) {
        w.w1[v] = add(pos1, mvec(mat1, vld(v1 + 3 * v)));
        w.w2[v] = add(pos2, mvec(mat2, vld(v2 + 3 * v)));
      }
      float best_d = 0.f;
      V3 best_ax = v3(0.f, 0.f, 0.f);
      for (int ai = 0; ai < 2 * HF; ++ai) {
        V3 a = ai < HF ? mvec(mat1, vld(f1 + 3 * ai)) : mvec(mat2, vld(f2 + 3 * (ai - HF)));
        float mx1 = 0.f, mn1 = 0.f, mx2 = 0.f, mn2 = 0.f;
        for (int v = 0; v < HV; ++v) {
          float t1 = dot(w.w1[v], a), t2 = dot(w.w2[v], a);
          if (v == 0) { mx1 = mn1 = t1; mx2 = mn2 = t2; }
          else { mx1 = vmax(mx1, t1); mn1 = vmin(mn1, t1); mx2 = vmax(mx2, t2); mn2 = vmin(mn2, t2); }
        }
        float depth_f = mx1 - mn2, depth_b = mx2 - mn1;
        float depth = vmin(depth_f, depth_b);
        bool flip = depth_f > depth_b;
        V3 ax = flip ? v3(-a.x, -a.y, -a.z) : a;
        if (ai == 0 || depth < best_d) { best_d = depth; best_ax = ax; }
      }
      float smax = 0.f;
      for (int v = 0; v < HV; ++v) {
        w.sup_v[v] = -dot(w.w2[v], best_ax);
        smax = v ? vmax(smax, w.sup_v[v]) : w.sup_v[v];
      }
      float thresh = smax - 1e-4f;
      for (int v = 0; v < HV; ++v) w.mask_v[v] = (w.sup_v[v] >= thresh) && (best_d > 0.0f);
      manifold(w.w2, w.sup_v, w.mask_v, HV, best_ax, true, best_d, w.cand[p]);
      dyn_frame(best_ax, w.frame[p]);
    } else {
      // unreachable: pack_model admits no other pair type. No contact.
      for (int k = 0; k < 4; ++k) { w.cand[p][k].dist = BIGD; w.cand[p][k].pos = v3(0.f, 0.f, 0.f); }
      for (int k = 0; k < 9; ++k) w.frame[p][k] = (k % 4 == 0) ? 1.0f : 0.0f;
    }
  }
}

// ---------------------------------------------------------------------------
// constraint rows (lane_physics.make_efc)
// ---------------------------------------------------------------------------

__device__ void make_efc(const DuckModel& m, const DuckDR& dr, int env,
                         const float* qpos, const float* qvel, Work& w) {
  const int stride_dof_frictionloss = m.nv, stride_geom_friction = 3 * m.ngeom;
  int r = 0;
  for (int f = 0; f < m.nfri; ++f, ++r) {
    int i = m.fri_dof[f];
    for (int d = 0; d < m.nv; ++d) w.J[r][d] = 0.0f;
    w.J[r][i] = 1.0f;
    w.sup[r] = 1u << i;
    w.D[r] = m.fri_D[f];
    w.aref[r] = -m.fri_b[f] * qvel[i];
    w.pos[r] = 0.0f;
    w.floss[r] = DRF(dof_frictionloss, i);
    w.is_fri[r] = 1;
  }
  for (int l = 0; l < m.nlim; ++l, ++r) {
    const float* p = m.lim_prm + LIM_N * l;
    int j = m.lim_jnt[l];
    int qadr = m.jnt_qposadr[j], dofadr = m.jnt_dofadr[j];
    float q = qpos[qadr];
    float dist_lo = q - p[IMP_N], dist_hi = p[IMP_N + 1] - q;
    float dist = vmin(dist_lo, dist_hi);
    float side = dist_lo < dist_hi ? 1.0f : -1.0f;
    float pos = dist - p[IMP_N + 2];
    float imp = impedance(pos, p);
    float R = (1.0f - imp) / imp * p[IMP_N + 3];
    R = vmax(R, MINVAL);
    for (int d = 0; d < m.nv; ++d) w.J[r][d] = 0.0f;
    w.J[r][dofadr] = side;
    w.sup[r] = 1u << dofadr;
    w.D[r] = 1.0f / R;
    w.aref[r] = -p[1] * (side * qvel[dofadr]) - p[0] * imp * pos;
    w.pos[r] = pos;
    w.floss[r] = 0.0f;
    w.is_fri[r] = 0;
  }
  for (int pp = 0; pp < m.npair; ++pp) {
    const int* pi = m.pair_i + PAIR_NI * pp;
    const float* pf = m.pair_f + PAIR_NF * pp;
    float mu, diag;
    if (dr.geom_friction) {
      // priorities equal: max of both geoms' friction; else mu_g1 == mu_g2
      float mu1 = DRF(geom_friction, 3 * pi[9]), mu2 = DRF(geom_friction, 3 * pi[10]);
      mu = vmax(mu1, mu2);
      float iw = pf[IMP_N + 15];
      diag = (iw + mu * mu * iw) * 2.0f * mu * mu / pf[IMP_N + 16];
      diag = vmax(diag, MINVAL);
    } else {
      mu = pf[IMP_N + 1];
      diag = pf[IMP_N];
    }
    int root1 = pi[5], root2 = pi[6];
    uint32_t dofs1 = (uint32_t)pi[11], dofs2 = (uint32_t)pi[12];
    uint32_t dofs = dofs1 | dofs2;
    V3 fn = v3(w.frame[pp][0], w.frame[pp][1], w.frame[pp][2]);
    V3 ft1 = v3(w.frame[pp][3], w.frame[pp][4], w.frame[pp][5]);
    V3 ft2 = v3(w.frame[pp][6], w.frame[pp][7], w.frame[pp][8]);
    for (int k = 0; k < 4; ++k) {
      float dist = w.cand[pp][k].dist;
      V3 pos_c = w.cand[pp][k].pos;
      float pos_neg = vmin(dist, 0.0f);
      float imp = impedance(pos_neg, pf);
      float R = vmax((1.0f - imp) / imp * diag, MINVAL);
      float D = 1.0f / R;
      float Jn[MAX_NV], Jt1[MAX_NV], Jt2[MAX_NV];
      for (int d = 0; d < m.nv; ++d) {
        if (!(dofs >> d & 1u)) continue;
        const float* cd = w.cdof[d];
        V3 ang = vld(cd), lin = vld(cd + 3);
        V3 contrib = v3(0.f, 0.f, 0.f);
        bool in2 = dofs2 >> d & 1u, in1 = dofs1 >> d & 1u;
        if (in2) contrib = add(lin, cross(ang, sub(pos_c, w.subtree_com[root2])));
        if (in1) {
          V3 jp1 = add(lin, cross(ang, sub(pos_c, w.subtree_com[root1])));
          contrib = in2 ? sub(contrib, jp1) : v3(-jp1.x, -jp1.y, -jp1.z);
        }
        Jn[d] = dot(contrib, fn);
        Jt1[d] = dot(contrib, ft1);
        Jt2[d] = dot(contrib, ft2);
      }
      for (int dir = 0; dir < 4; ++dir, ++r) {
        const float* Jt = dir < 2 ? Jt1 : Jt2;
        float smu = (dir & 1) ? -mu : mu;
        float Jq = 0.f;
        bool first = true;
        for (int d = 0; d < m.nv; ++d) {
          if (!(dofs >> d & 1u)) { w.J[r][d] = 0.0f; continue; }
          float cf = Jn[d] + smu * Jt[d];
          w.J[r][d] = cf;
          float t = cf * qvel[d];
          Jq = first ? t : Jq + t;
          first = false;
        }
        w.sup[r] = dofs;
        w.D[r] = D;
        w.aref[r] = -pf[1] * Jq - pf[0] * imp * pos_neg;
        w.pos[r] = dist;
        w.floss[r] = 0.0f;
        w.is_fri[r] = 0;
      }
    }
  }
  w.nefc = r;
}

// sum over a row's support, first term without a leading zero
__device__ __forceinline__ float jv(const Work& w, int r, const float* v, int nv) {
  float out = 0.f;
  bool first = true;
  uint32_t s = w.sup[r];
  for (int d = 0; d < nv; ++d) {
    if (!(s >> d & 1u)) continue;
    float t = w.J[r][d] * v[d];
    out = first ? t : out + t;
    first = false;
  }
  return out;
}

__device__ float primal_cost(const DuckModel& m, Work& w, const float* q) {
  int nv = m.nv;
  for (int i = 0; i < nv; ++i) w.tmp[i] = q[i] - w.qacc_smooth[i];
  mat_vec_tree(m, w.M, w.tmp, w.tmp2);
  float cost = w.tmp[0] * 0.0f;
  for (int i = 0; i < nv; ++i) cost = cost + 0.5f * w.tmp[i] * w.tmp2[i];
  for (int r = 0; r < w.nefc; ++r) {
    float x = jv(w, r, q, nv) - w.aref[r];
    float D = w.D[r];
    float Dx = D * x;
    float c;
    if (w.is_fri[r]) {
      float fl = w.floss[r];
      bool inside = fabsf(Dx) <= fl;
      c = inside ? 0.5f * D * x * x : fl * fabsf(x) - 0.5f * fl * fl / D;
    } else {
      bool act = (w.pos[r] < 0.0f) && (x < 0.0f);
      c = act ? 0.5f * D * x * x : 0.0f;
    }
    cost = cost + c;
  }
  return cost;
}

__device__ void dphi(const Work& w, float alpha, float smooth_a, float smooth_b,
                     float& d1, float& d2) {
  d1 = smooth_b + smooth_a * alpha;
  d2 = smooth_a;
  for (int r = 0; r < w.nefc; ++r) {
    float ja = w.Jaref[r], jd = w.Jd[r], D = w.D[r];
    float x = ja + alpha * jd;
    float Dx = D * x;
    if (w.is_fri[r]) {
      float fl = w.floss[r];
      bool inside = fabsf(Dx) <= fl;
      d1 = d1 + (inside ? Dx * jd : fl * vsign(x) * jd);
      d2 = d2 + (inside ? D * jd * jd : 0.0f);
    } else {
      bool act = (w.pos[r] < 0.0f) && (x < 0.0f);
      d1 = d1 + (act ? Dx * jd : 0.0f);
      d2 = d2 + (act ? D * jd * jd : 0.0f);
    }
  }
}

// Newton solve with warm start by primal cost; result in w.qacc
__device__ void solve_constraints(const DuckModel& m, Work& w, const float* warm) {
  const int nv = m.nv;
  float cost_ws = primal_cost(m, w, warm);
  float cost_sm = primal_cost(m, w, w.qacc_smooth);
  bool use_ws = cost_ws < cost_sm;
  for (int i = 0; i < nv; ++i) w.qacc[i] = use_ws ? warm[i] : w.qacc_smooth[i];
  for (int r = 0; r < w.nefc; ++r) w.Jaref[r] = jv(w, r, w.qacc, nv) - w.aref[r];

  const int iters = m.iterations > 1 ? m.iterations : 1;
  for (int it = 0; it < iters; ++it) {
    float grad[MAX_NV], Ma_err[MAX_NV];
    for (int i = 0; i < nv; ++i) w.tmp[i] = w.qacc[i] - w.qacc_smooth[i];
    mat_vec_tree(m, w.M, w.tmp, Ma_err);
    for (int i = 0; i < nv; ++i) grad[i] = Ma_err[i];
    for (int i = 0; i < nv; ++i)
      for (int j = 0; j < nv; ++j) w.H[i][j] = w.M[i][j];
    for (int r = 0; r < w.nefc; ++r) {
      float ja = w.Jaref[r], D = w.D[r];
      float Dx = D * ja;
      float f;
      bool hm;
      if (w.is_fri[r]) {
        f = -vclip(Dx, -w.floss[r], w.floss[r]);
        hm = fabsf(Dx) <= w.floss[r];
      } else {
        hm = (w.pos[r] < 0.0f) && (ja < 0.0f);
        f = hm ? -Dx : 0.0f;
      }
      uint32_t s = w.sup[r];
      for (int d = 0; d < nv; ++d)
        if (s >> d & 1u) grad[d] = grad[d] - w.J[r][d] * f;
      float wgt = D * (hm ? 1.0f : 0.0f);
      for (int a = 0; a < nv; ++a) {
        if (!(s >> a & 1u)) continue;
        float ca = w.J[r][a];
        for (int b = 0; b <= a; ++b) {
          if (!(s >> b & 1u)) continue;
          w.H[a][b] = w.H[a][b] + wgt * ca * w.J[r][b];
        }
      }
    }
    // factor the lower triangle in place: H's strict lower part becomes L
    ldl_factor(nv, m.ldlh_mask, w.H, w.H, w.tmp2, w.dinv);
    for (int i = 0; i < nv; ++i) w.dir[i] = -grad[i];
    ldl_solve(nv, m.ldlh_mask, w.H, w.dinv, w.dir);

    for (int r = 0; r < w.nefc; ++r) w.Jd[r] = jv(w, r, w.dir, nv);
    mat_vec_tree(m, w.M, w.dir, w.tmp);
    float smooth_b = 0.0f, smooth_a = 0.0f;
    for (int i = 0; i < nv; ++i) smooth_b = smooth_b + w.dir[i] * Ma_err[i];
    for (int i = 0; i < nv; ++i) smooth_a = smooth_a + w.dir[i] * w.tmp[i];

    float d1_0, d2_0;
    dphi(w, 0.0f, smooth_a, smooth_b, d1_0, d2_0);
    bool descent = d1_0 < 0.0f;
    float hi0 = d2_0 > TINY ? -d1_0 / vmax(d2_0, TINY) : 1.0f;
    hi0 = vmax(hi0, 1e-8f);
    float still_neg = 1.0f, count = 0.0f;
    for (int kk = 0; kk < 8; ++kk) {
      float d1_k, d2_k;
      dphi(w, hi0 * (float)(1 << kk), smooth_a, smooth_b, d1_k, d2_k);
      float neg = d1_k < 0.0f ? 1.0f : 0.0f;
      still_neg = kk == 0 ? neg : still_neg * neg;
      count = count + still_neg;
    }
    float hi = ldexpf(hi0, (int)count);
    float lo = 0.0f;
    float alpha = 0.5f * (lo + hi);
    const int ls = m.ls_iterations > 1 ? m.ls_iterations : 1;
    for (int l = 0; l < ls; ++l) {
      float d1_a, d2_a;
      dphi(w, alpha, smooth_a, smooth_b, d1_a, d2_a);
      lo = d1_a < 0.0f ? alpha : lo;
      hi = d1_a >= 0.0f ? alpha : hi;
      float newton = alpha - d1_a / vmax(d2_a, TINY);
      float mid = 0.5f * (lo + hi);
      alpha = (newton > lo && newton < hi && d2_a > TINY) ? newton : mid;
    }
    alpha = descent ? alpha : 0.0f;
    for (int i = 0; i < nv; ++i) w.qacc[i] = w.qacc[i] + alpha * w.dir[i];
    for (int r = 0; r < w.nefc; ++r) w.Jaref[r] = w.Jaref[r] + alpha * w.Jd[r];
  }
}

// ---------------------------------------------------------------------------
// sensors / derived outputs of the last substep
// ---------------------------------------------------------------------------

__device__ void write_derived(const DuckModel& m, int env, int nsensordata, const float* qvel,
                              Work& w, float* sensordata, float* actuator_force,
                              float* contact_dist, float* site_xpos, float* site_xmat) {
  // site kinematics
  V3 spos[MAX_SITE];
  M3 smat[MAX_SITE];
  for (int s = 0; s < m.nsite; ++s) {
    int b = m.site_bodyid[s];
    spos[s] = add(w.xpos[b], qrot(w.xquat[b], vld(m.site_pos + 3 * s)));
    smat[s] = qmat(qmul(w.xquat[b], qld(m.site_quat + 4 * s)));
    float* xp = site_xpos + (size_t)env * m.nsite * 3 + 3 * s;
    xp[0] = spos[s].x; xp[1] = spos[s].y; xp[2] = spos[s].z;
    float* xm = site_xmat + (size_t)env * m.nsite * 9 + 9 * s;
    for (int k = 0; k < 9; ++k) xm[k] = smat[s].m[k];
  }
  // body accelerations with the constraint solution (rne_post_cacc)
  float cacc[MAX_BODY][6];
  cacc[0][0] = cacc[0][1] = cacc[0][2] = 0.0f;
  cacc[0][3] = 0.0f - m.gx; cacc[0][4] = 0.0f - m.gy; cacc[0][5] = 0.0f - m.gz;
  for (int b = 1; b < m.nbody; ++b) {
    int p = m.body_parentid[b];
    float a[6];
    for (int k = 0; k < 6; ++k) a[k] = cacc[p][k];
    int dofadr = m.body_dofadr[b], dofnum = m.body_dofnum[b];
    for (int i = dofadr; i < dofadr + dofnum; ++i)
      for (int k = 0; k < 6; ++k)
        a[k] = a[k] + (w.cdofdot[i][k] * qvel[i] + w.cdof[i][k] * w.qacc[i]);
    for (int k = 0; k < 6; ++k) cacc[b][k] = a[k];
  }
  float* out = sensordata + (size_t)env * nsensordata;
  for (int s = 0; s < m.nsensor; ++s) {
    int sid = m.sensor_objid[s];
    int body = m.site_bodyid[sid];
    V3 origin = w.subtree_com[m.body_rootid[body]];
    V3 p = spos[sid];
    const M3& R = smat[sid];
    V3 w_world = vld(w.cvel[body]);
    V3 pv = add(vld(w.cvel[body] + 3), cross(w_world, sub(p, origin)));
    float* o = out + m.sensor_adr[s];
    V3 r3;
    switch (m.sensor_type[s]) {
      case S_GYRO: r3 = mtvec(R, w_world); break;
      case S_VELOCIMETER: r3 = mtvec(R, pv); break;
      case S_ACCELEROMETER: {
        V3 a_ang = vld(cacc[body]);
        V3 a_lin = add(vld(cacc[body] + 3), cross(a_ang, sub(p, origin)));
        r3 = mtvec(R, add(a_lin, cross(w_world, pv)));
        break;
      }
      case S_FRAMEXAXIS: r3 = mcol(R, 0); break;
      case S_FRAMEZAXIS: r3 = mcol(R, 2); break;
      case S_FRAMELINVEL: r3 = pv; break;
      case S_FRAMEANGVEL: r3 = w_world; break;
      case S_FRAMEPOS: r3 = p; break;
      default: {  // S_FRAMEQUAT
        Q4 q = qmul(w.xquat[body], qld(m.site_quat + 4 * sid));
        o[0] = q.w; o[1] = q.x; o[2] = q.y; o[3] = q.z;
        continue;
      }
    }
    o[0] = r3.x; o[1] = r3.y; o[2] = r3.z;
  }
  for (int u = 0; u < m.nu; ++u) actuator_force[(size_t)env * m.nu + u] = w.actuator_force[u];
  for (int pp = 0; pp < m.npair; ++pp)
    for (int k = 0; k < 4; ++k)
      contact_dist[(size_t)env * m.npair * 4 + 4 * pp + k] = w.cand[pp][k].dist;
}

// ---------------------------------------------------------------------------
// one substep (lane_physics.LanePhysics.substep)
// ---------------------------------------------------------------------------

__device__ void substep(const DuckModel& m, const DuckDR& dr, int env, float* qpos,
                        float* qvel, const float* ctrl, float* warm, Work& w) {
  const int nv = m.nv;
  kinematics(m, dr, env, qpos, w);
  com_pos(m, dr, env, w);
  crb(m, dr, env, w);
  collide(m, w);
  com_vel(m, qvel, w);
  float bias[MAX_NV], qfrc_act[MAX_NV];
  rne(m, qvel, w, bias);
  actuation(m, dr, env, qpos, qvel, ctrl, w, qfrc_act);
  for (int i = 0; i < nv; ++i)
    w.qacc_smooth[i] = qfrc_act[i] - bias[i] - m.dof_damping[i] * qvel[i];
  ldl_factor(nv, m.ldl_mask, w.M, w.H, w.tmp2, w.dinv);
  ldl_solve(nv, m.ldl_mask, w.H, w.dinv, w.qacc_smooth);
  make_efc(m, dr, env, qpos, qvel, w);
  solve_constraints(m, w, warm);
}

__device__ void integrate(const DuckModel& m, float* qpos, float* qvel, const Work& w) {
  const float dt = m.dt;
  for (int i = 0; i < m.nv; ++i) qvel[i] = qvel[i] + dt * w.qacc[i];
  for (int j = 0; j < m.njnt; ++j) {
    int qadr = m.jnt_qposadr[j], vadr = m.jnt_dofadr[j];
    if (m.jnt_type[j] == J_FREE) {
      for (int i = 0; i < 3; ++i) qpos[qadr + i] = qpos[qadr + i] + dt * qvel[vadr + i];
      V3 wl = v3(qvel[vadr + 3], qvel[vadr + 4], qvel[vadr + 5]);
      float angle = sqrtf(dot(wl, wl));
      float safe = angle > 1e-12f ? angle : 1.0f;
      float half = angle * (dt * 0.5f);
      float s = sinf(half) / safe;
      Q4 dq = {cosf(half), wl.x * s, wl.y * s, wl.z * s};
      Q4 q = {qpos[qadr + 3], qpos[qadr + 4], qpos[qadr + 5], qpos[qadr + 6]};
      Q4 qn = qnormalize(qmul(q, dq));
      qpos[qadr + 3] = qn.w; qpos[qadr + 4] = qn.x; qpos[qadr + 5] = qn.y; qpos[qadr + 6] = qn.z;
    } else {
      qpos[qadr] = qpos[qadr] + dt * qvel[vadr];
    }
  }
}

__global__ void physics_step_kernel(DuckModel m, DuckDR dr, int B, int n_substeps, int nsensordata,
                                    const float* __restrict__ qpos_in,
                                    const float* __restrict__ qvel_in,
                                    const float* __restrict__ warm_in,
                                    const float* __restrict__ ctrl_in, float* qpos_out,
                                    float* qvel_out, float* warm_out, float* sensordata,
                                    float* actuator_force, float* contact_dist, float* site_xpos,
                                    float* site_xmat) {
  int env = blockIdx.x * blockDim.x + threadIdx.x;
  if (env >= B) return;
  Work w;
  float qpos[MAX_NQ], qvel[MAX_NV], warm[MAX_NV], ctrl[MAX_NU];
  for (int i = 0; i < m.nq; ++i) qpos[i] = qpos_in[(size_t)env * m.nq + i];
  for (int i = 0; i < m.nv; ++i) qvel[i] = qvel_in[(size_t)env * m.nv + i];
  for (int i = 0; i < m.nv; ++i) warm[i] = warm_in[(size_t)env * m.nv + i];
  for (int i = 0; i < m.nu; ++i) ctrl[i] = ctrl_in[(size_t)env * m.nu + i];
  for (int k = 0; k < n_substeps; ++k) {
    substep(m, dr, env, qpos, qvel, ctrl, warm, w);
    if (k == n_substeps - 1)
      write_derived(m, env, nsensordata, qvel, w, sensordata, actuator_force, contact_dist,
                    site_xpos, site_xmat);
    integrate(m, qpos, qvel, w);
    for (int i = 0; i < m.nv; ++i) warm[i] = w.qacc[i];
  }
  for (int i = 0; i < m.nq; ++i) qpos_out[(size_t)env * m.nq + i] = qpos[i];
  for (int i = 0; i < m.nv; ++i) qvel_out[(size_t)env * m.nv + i] = qvel[i];
  for (int i = 0; i < m.nv; ++i) warm_out[(size_t)env * m.nv + i] = warm[i];
}

extern "C" {

int duck_limits(int* out) {
  out[0] = MAX_NQ; out[1] = MAX_NV; out[2] = MAX_NU; out[3] = MAX_BODY; out[4] = MAX_JNT;
  out[5] = MAX_SITE; out[6] = MAX_PAIR; out[7] = MAX_HV; out[8] = MAX_HF; out[9] = MAX_EFC;
  out[10] = MAX_HFIELD_N; out[11] = MAX_HFIELD_N;
  return 12;
}

int duck_physics_step(const DuckModel* m, const DuckDR* dr, int B, int n_substeps,
                      int nsensordata, const float* qpos, const float* qvel, const float* warm,
                      const float* ctrl, float* qpos_out, float* qvel_out, float* warm_out,
                      float* sensordata, float* actuator_force, float* contact_dist,
                      float* site_xpos, float* site_xmat, int threads, void* stream) {
  const int blocks = (B + threads - 1) / threads;
  physics_step_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      *m, *dr, B, n_substeps, nsensordata, qpos, qvel, warm, ctrl, qpos_out, qvel_out, warm_out,
      sensordata, actuator_force, contact_dist, site_xpos, site_xmat);
  return (int)cudaGetLastError();
}

}  // extern "C"

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
// Design: one warp per env, the env's working set in shared memory.
// - A block holds k warps, one env each; the grid has ceil(B / k) blocks, and
//   a warp whose env is >= B returns at once (the block never synchronises).
//   The wrapper picks k from the shared memory one env needs and the
//   occupancy the runtime reports (duck_occupancy).
// - Every per-env array lives in the block's dynamic shared memory, in the
//   env's own slice, at offsets the wrapper computes from the model's sizes
//   (DuckModel.lay, cuda_step.shared_layout): state, kinematics, inertias,
//   M and the Newton Hessian as packed lower triangles, the constraint
//   Jacobian stored over each row's support only (efc_off / efc_col, the
//   twin's column order), and per-stage scratch that later stages reuse.
//   Nothing is sized by compile-time maxima but the LDL's rows: each lane
//   keeps one row of the factor in registers, unrolled to a ceiling (24 or
//   32, one kernel instantiation each, duck_step_kernel; the wrapper takes
//   the least that holds nv). ptxas: 80 and 96 registers, 32 bytes of
//   stack, 0 spills. The stand-in duck needs 12,224 bytes per env flat and
//   16,032 backlash or rough: 18 and 14 envs resident per SM, bound by
//   shared memory, not registers (up to 112 and 144 would keep them).
// - Lanes split independent outputs, never the terms of one sum: one
//   constraint row, dof, M or H entry, hull vertex, separating axis, body or
//   spatial component per lane. Every float sum keeps the twin's order term
//   for term, on one lane where the twin adds in row order (the costs, the
//   line search's derivatives), and the warp reductions over vertices and
//   axes return exactly what the twin's serial scans return, ties and NaN
//   included. Built with -fmad=false and no fast math (the heightfield
//   constants are divided by, as the twin divides), the kernel is bit-for-bit
//   equal to the twin with DR on.
// - The model is data, not code: the wrapper packs the structural arrays
//   (tree, addresses, types, constants, hulls, constraint-row tables, LDL
//   sparsity masks, the heightfield table) once into device tensors, read
//   through the read-only path (__ldg). Every pair type is handled by name;
//   the wrapper admits no other.
// - Domain randomization comes as optional per-env pointers (DuckDR); a null
//   pointer means the model constant is used (the with_dr=False variant).
// - The heightfield (256 x 256 floats, 256 KB, on the rough scene) is larger
//   than a block's shared memory, so it stays in device memory: each foot
//   vertex reads the 4 corners of its cell with __ldg, served from L2 after
//   the first touch.
//
// What bounds it on an H100: the instructions each warp issues along its
// env's dependent chain, not memory (a few hundred bytes of state per env
// and control step) and not the arithmetic (~45x the float32 bound). With
// 14-18 warps per SM the schedulers are mostly busy, so a stage costs what
// it issues. The two LDL factorizations took ~30% of the cycles at nv = 30
// with three shared loads per term and two warp barriers per column; with
// the rows in registers and the column by shuffle (one shuffle, two
// products and a subtraction per term, no barrier per column) the kernel
// runs 13% faster at 8192 backlash envs (8.30 -> 7.23 ms a launch), the two
// LDL stages 22% of the cycles. A test per term or per step costs more than
// it saves: a version that left the triangle at nv by two branches per term
// was slower than the shared-memory one. By share now: the Newton Hessian
// and gradient and the primal costs (14% each), H's factor and solve (12%),
// the line search, M's factor and make_efc (9-10% each), the collision
// (7%); the row-ordered sums on one lane (costs, line search) could be cut
// only with the twin changed alike (a tree instead of order). Built with
// -DDUCK_PROFILE the kernel reports each stage's clock cycles.
//
// NaN is never clamped away: min/max/clip propagate NaN like jax.numpy and
// torch do, so a NaN action still terminates the env.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define MAX_NV 32  // dof bit masks are 32 bits wide
#define MAX_HV 32  // one lane per hull vertex
#define FULL 0xffffffffu

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

// The env's shared-memory slice: offsets (in floats) of each array, in the
// order of cuda_step.LAYOUT_NAMES. The first group lives through a whole
// substep, the second from kinematics to the bias forces; each later group
// is one stage's scratch, overlaid as cuda_step.shared_layout places it.
enum {
  L_QPOS, L_QVEL, L_WARM, L_CTRL,
  L_XPOS, L_XQUAT, L_SUBTREE_COM, L_CDOF, L_CDOFDOT, L_CVEL,
  L_M, L_QACC_SMOOTH, L_QACC, L_ACT_FORCE,
  L_CAND, L_FRAME,
  L_EFC_J, L_EFC_D, L_EFC_AREF, L_EFC_POS, L_EFC_FLOSS, L_EFC_JAREF, L_EFC_JD,
  L_SCAL,
  // kinematics to the bias forces
  L_XANCHOR, L_XAXIS, L_CINERT,
  // com_pos
  L_XIPOS, L_SEG,
  // crb
  L_CRB, L_FVEC,
  // collide
  L_W1, L_W2,
  // com_vel, rne, actuation
  L_VPRE, L_CACC, L_CFRC, L_BIAS, L_QFRC_ACT,
  // smooth acceleration (overlays the kinematics-to-bias arrays)
  L_LDLM,
  // make_efc
  L_CMETA, L_JNT,
  // solver
  L_H, L_GRAD, L_MAERR, L_DIR, L_TMP, L_TMP2, L_EFC_F, L_EFC_W, L_TERMS,
  // derived outputs
  L_SPOS, L_SMAT, L_PCACC,
  L_COUNT
};

extern "C" {

struct DuckModel {
  int nq, nv, nu, nbody, njnt, ngeom, nsite, nsensor, npair, nfri, nlim, hv, hf;
  int iterations, ls_iterations;
  int hfield_nrow, hfield_ncol;  // 0 without a heightfield
  int nefc, max_depth, env_floats;  // constraint rows; tree depth; floats of one env's slice
  float dt, gx, gy, gz;
  int lay[L_COUNT];
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
  const int *efc_off;        // (nefc + 1,) row r's support is efc_col[efc_off[r]:efc_off[r+1]]
  const int *efc_col;        // the dofs of each row's support, ascending (the twin's order)
  const int *efc_dof_rows;   // (nv, 2) each dof's friction row and limit row, or -1
  const int *body_depth;     // depth of each body in the tree (world 0)
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

// model reads go through the read-only data path
#define G(x) __ldg(&(x))
// this env's array `name` in shared memory (`sm` and `m` in scope)
#define SA(name) (sm + m.lay[L_##name])
// packed lower triangle, i >= j
#define TRI(i, j) ((i) * ((i) + 1) / 2 + (j))

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
__device__ __forceinline__ V3 vldg(const float* p) { return v3(__ldg(p), __ldg(p + 1), __ldg(p + 2)); }
__device__ __forceinline__ Q4 qldg(const float* p) {
  Q4 q = {__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3)};
  return q;
}
__device__ __forceinline__ void vst(float* p, V3 v) { p[0] = v.x; p[1] = v.y; p[2] = v.z; }
__device__ __forceinline__ void qst(float* p, Q4 q) { p[0] = q.w; p[1] = q.x; p[2] = q.y; p[3] = q.z; }
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
__device__ __forceinline__ void spatial_inertia_sym(float mass, const M3& I, V3 c, float* out) {
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
__device__ __forceinline__ M3 rotate_inertia(V3 d, const M3& R) {
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

__device__ __forceinline__ float impedance(float pos, const float* p) {
  const float dmin = G(p[2]), dmax = G(p[3]), width = G(p[4]), mid = G(p[5]), power = G(p[6]);
  float x = fabsf(pos) / width;
  float y_low, y_high;
  if (power == 2.0f) {
    y_low = x * x * G(p[7]);
    float xm = 1.0f - x;
    y_high = 1.0f - xm * xm * G(p[8]);
  } else if (power == 1.0f) {
    y_low = x;
    y_high = x;
  } else {
    y_low = powf(x, power) * G(p[7]);
    y_high = 1.0f - powf(1.0f - x, power) * G(p[8]);
  }
  float y = x < mid ? y_low : y_high;
  float imp = dmin + y * G(p[9]);
  imp = x >= 1.0f ? dmax : imp;
  return vclip(imp, dmin, dmax);
}

// Built with -DDUCK_PROFILE, lane 0 of every warp adds the clock cycles of
// each stage of each substep into duck_prof (read by duck_profile): the
// share of the warp's time each stage takes. Without it PROF is the
// __syncwarp() that ends the stage.
enum {
  PROF_KINEMATICS, PROF_COM_POS, PROF_CRB, PROF_COLLIDE, PROF_DYNAMICS, PROF_SMOOTH_SOLVE,
  PROF_MAKE_EFC, PROF_COSTS, PROF_GRAD_H, PROF_FACTOR_H, PROF_LINE_SEARCH, PROF_OUTPUT,
  PROF_COUNT
};
#ifdef DUCK_PROFILE
__device__ unsigned long long duck_prof[PROF_COUNT];
#define PROF_START() long long prof_t = clock64()
#define PROF(stage)                                                                \
  do {                                                                             \
    __syncwarp();                                                                  \
    if (lane == 0) {                                                               \
      long long prof_now = clock64();                                              \
      atomicAdd(&duck_prof[stage], (unsigned long long)(prof_now - prof_t));       \
      prof_t = prof_now;                                                           \
    }                                                                              \
  } while (0)
#else
#define PROF_START() do {} while (0)
#define PROF(stage) __syncwarp()
#endif

// DR-or-constant accessors
#define DRF(field, off) \
  (dr.field ? __ldg(dr.field + env * (size_t)(stride_##field) + (off)) : __ldg(m.field + (off)))

// lane-strided loop over [0, n)
#define LANES(i, n) for (int i = lane; i < (n); i += 32)

// ---------------------------------------------------------------------------
// warp reductions that return, on every lane, exactly what the twin's serial
// scan returns. Lane order is sequence order: at butterfly step o a lane's
// segment and its partner's are neighbours, the lower lane's first, and
// each combine takes (earlier, later) in that order.
// ---------------------------------------------------------------------------

// first best: the serial `best = s[0]; for v: if (s[v] > best) take v` (or <).
// A leaf can win if `valid`: index 0 always, another only if its score is
// not NaN (a NaN never compares true); lanes past the end pass valid=false.
// A NaN at index 0 therefore keeps index 0, as the scan does.
__device__ __forceinline__ void warp_first_best(float& s, int& idx, bool& valid, bool greater) {
  const int lane = threadIdx.x & 31;
  int iv = valid ? idx : -1;  // the index, or -1 for a leaf that cannot win
  for (int o = 1; o < 32; o <<= 1) {
    float s2 = __shfl_xor_sync(FULL, s, o);
    int i2 = __shfl_xor_sync(FULL, iv, o);
    bool first = (lane & o) == 0;
    float ls = first ? s : s2, hs = first ? s2 : s;
    int li = first ? iv : i2, hi = first ? i2 : iv;
    bool take = hi >= 0 && (li < 0 || (greater ? hs > ls : hs < ls));
    s = take ? hs : ls;
    iv = take ? hi : li;
  }
  valid = iv >= 0;
  idx = valid ? iv : 0;
}

// the serial `acc = x[0]; for v: acc = vmax(acc, x[v])`: vmax(earlier, later)
// at every combine keeps the scan's tie rule (the later of equal values) and
// its NaN propagation
__device__ __forceinline__ float warp_fold_vmax(float x, bool valid) {
  const int lane = threadIdx.x & 31;
  for (int o = 1; o < 32; o <<= 1) {
    float x2 = __shfl_xor_sync(FULL, x, o);
    bool v2 = __shfl_xor_sync(FULL, (int)valid, o) != 0;
    bool first = (lane & o) == 0;
    float lx = first ? x : x2, hx = first ? x2 : x;
    bool lv = first ? valid : v2, hv = first ? v2 : valid;
    x = !lv ? hx : (!hv ? lx : vmax(lx, hx));
    valid = lv || hv;
  }
  return x;
}

// (i, j), i >= j, of packed lower-triangle entry e
__device__ __forceinline__ void tri_ij(int e, int& i, int& j) {
  int r = (int)((sqrtf(8.0f * (float)e + 1.0f) - 1.0f) * 0.5f);
  while (r * (r + 1) / 2 > e) --r;
  while ((r + 1) * (r + 2) / 2 <= e) ++r;
  i = r;
  j = e - r * (r + 1) / 2;
}

// ---------------------------------------------------------------------------
// stages: every lane of the env's warp calls each one; lanes split
// independent outputs, and every sum keeps the twin's order term for term.
// Each stage ends with __syncwarp(), so the next one reads its results.
// ---------------------------------------------------------------------------

// bodies of one tree depth at a time, one body per lane
__device__ __forceinline__ void kinematics(const DuckModel& m, const DuckDR& dr, int env, float* sm,
                                           int lane) {
  const int stride_qpos0 = m.nq;
  const float* qpos = SA(QPOS);
  float *xpos = SA(XPOS), *xquat = SA(XQUAT), *xanchor = SA(XANCHOR), *xaxis = SA(XAXIS);
  if (lane == 0) {
    vst(xpos, v3(0.f, 0.f, 0.f));
    Q4 one = {1.f, 0.f, 0.f, 0.f};
    qst(xquat, one);
  }
  __syncwarp();
  for (int level = 1; level <= m.max_depth; ++level) {
    LANES(b, m.nbody) {
      if (b == 0 || G(m.body_depth[b]) != level) continue;
      int p = G(m.body_parentid[b]);
      V3 pos = add(vld(xpos + 3 * p), qrot(qld(xquat + 4 * p), vldg(m.body_pos + 3 * b)));
      Q4 quat = qmul(qld(xquat + 4 * p), qldg(m.body_quat + 4 * b));
      int jadr = G(m.body_jntadr[b]), jnum = G(m.body_jntnum[b]);
      for (int j = jadr; j < jadr + jnum; ++j) {
        int qadr = G(m.jnt_qposadr[j]);
        if (G(m.jnt_type[j]) == J_FREE) {
          pos = v3(qpos[qadr], qpos[qadr + 1], qpos[qadr + 2]);
          Q4 q = {qpos[qadr + 3], qpos[qadr + 4], qpos[qadr + 5], qpos[qadr + 6]};
          quat = qnormalize(q);
          vst(xanchor + 3 * j, pos);
          vst(xaxis + 3 * j, qrot(quat, vldg(m.jnt_axis + 3 * j)));
        } else {
          float q0 = DRF(qpos0, qadr);
          float angle = qpos[qadr] - q0;
          V3 jp = vldg(m.jnt_pos + 3 * j), ax = vldg(m.jnt_axis + 3 * j);
          V3 anchor = add(pos, qrot(quat, jp));
          float s = sinf(angle * 0.5f), c = cosf(angle * 0.5f);
          Q4 qloc = {c, ax.x * s, ax.y * s, ax.z * s};
          quat = qnormalize(qmul(quat, qloc));
          pos = sub(anchor, qrot(quat, jp));
          vst(xanchor + 3 * j, anchor);
          vst(xaxis + 3 * j, qrot(quat, ax));
        }
      }
      vst(xpos + 3 * b, pos);
      qst(xquat + 4 * b, quat);
    }
    __syncwarp();
  }
}

__device__ __forceinline__ void com_pos(const DuckModel& m, const DuckDR& dr, int env, float* sm,
                                        int lane) {
  const int stride_body_ipos = 3 * m.nbody, stride_body_mass = m.nbody;
  const float *xpos = SA(XPOS), *xquat = SA(XQUAT), *xanchor = SA(XANCHOR), *xaxis = SA(XAXIS);
  float *xipos = SA(XIPOS), *seg = SA(SEG), *com = SA(SUBTREE_COM);
  float *cinert = SA(CINERT), *cdof = SA(CDOF);
  LANES(b, m.nbody) {
    V3 ip = v3(DRF(body_ipos, 3 * b), DRF(body_ipos, 3 * b + 1), DRF(body_ipos, 3 * b + 2));
    V3 xi = b ? add(vld(xpos + 3 * b), qrot(qld(xquat + 4 * b), ip)) : vld(xpos + 3 * b);
    vst(xipos + 3 * b, xi);
    float mass = DRF(body_mass, b);
    vst(seg + 4 * b, scl(xi, mass));
    seg[4 * b + 3] = mass;
  }
  __syncwarp();
  if (lane < 4)  // one component (x, y, z, mass) per lane, leaves to root
    for (int b = m.nbody - 1; b > 0; --b) {
      int p = G(m.body_parentid[b]);
      seg[4 * p + lane] = seg[4 * p + lane] + seg[4 * b + lane];
    }
  __syncwarp();
  LANES(b, m.nbody)
    vst(com + 3 * b, scl(vld(seg + 4 * b), 1.0f / vmax(seg[4 * b + 3], 1e-12f)));
  __syncwarp();
  LANES(b, m.nbody) {
    V3 root_com = vld(com + 3 * G(m.body_rootid[b]));
    M3 ximat = qmat(qmul(qld(xquat + 4 * b), qldg(m.body_iquat + 4 * b)));
    M3 I = rotate_inertia(vldg(m.body_inertia + 3 * b), ximat);
    spatial_inertia_sym(DRF(body_mass, b), I, sub(vld(xipos + 3 * b), root_com), cinert + 21 * b);
    if (b == 0) continue;
    int jadr = G(m.body_jntadr[b]), jnum = G(m.body_jntnum[b]);
    for (int j = jadr; j < jadr + jnum; ++j) {
      int vadr = G(m.jnt_dofadr[j]);
      V3 neg = scl(sub(vld(xanchor + 3 * j), root_com), -1.0f);
      if (G(m.jnt_type[j]) == J_FREE) {
        for (int i = 0; i < 3; ++i)
          for (int k = 0; k < 6; ++k) cdof[6 * (vadr + i) + k] = (k == 3 + i) ? 1.0f : 0.0f;
        M3 xmat = qmat(qld(xquat + 4 * b));
        for (int i = 0; i < 3; ++i) {
          V3 axis = mcol(xmat, i), cr = cross(axis, neg);
          float* cd = cdof + 6 * (vadr + 3 + i);
          vst(cd, axis); vst(cd + 3, cr);
        }
      } else {
        V3 axis = vld(xaxis + 3 * j), cr = cross(axis, neg);
        float* cd = cdof + 6 * vadr;
        vst(cd, axis); vst(cd + 3, cr);
      }
    }
  }
  __syncwarp();
}

// composite inertias (one sym6 entry per lane), then one M entry per lane
__device__ __forceinline__ void crb(const DuckModel& m, const DuckDR& dr, int env, float* sm,
                                    int lane) {
  const int stride_dof_armature = m.nv;
  const float *cinert = SA(CINERT), *cdof = SA(CDOF);
  float *crb_in = SA(CRB), *F = SA(FVEC), *M = SA(M);
  LANES(e, 21 * m.nbody) crb_in[e] = cinert[e];
  __syncwarp();
  if (lane < 21)
    for (int b = m.nbody - 1; b > 0; --b) {
      int p = G(m.body_parentid[b]);
      if (p > 0) crb_in[21 * p + lane] = crb_in[21 * p + lane] + crb_in[21 * b + lane];
    }
  __syncwarp();
  LANES(i, m.nv) sym6_vec(crb_in + 21 * G(m.dof_bodyid[i]), cdof + 6 * i, F + 6 * i);
  __syncwarp();
  LANES(e, m.nv * (m.nv + 1) / 2) {
    int i, j;
    tri_ij(e, i, j);
    float v = (G(m.tree_mask[i]) >> j & 1u) ? v6_dot(F + 6 * i, cdof + 6 * j) : 0.0f;
    if (i == j) v = v + DRF(dof_armature, i);
    M[e] = v;
  }
  __syncwarp();
}

// body velocities: one spatial component per lane down the tree, keeping
// each dof's incoming velocity; then cdofdot one body per lane
__device__ __forceinline__ void com_vel(const DuckModel& m, float* sm, int lane) {
  const float *qvel = SA(QVEL), *cdof = SA(CDOF);
  float *cvel = SA(CVEL), *cdofdot = SA(CDOFDOT), *vpre = SA(VPRE);
  if (lane < 6) {
    const int k = lane;
    cvel[k] = 0.0f;
    for (int b = 1; b < m.nbody; ++b) {
      float v = cvel[6 * G(m.body_parentid[b]) + k];
      int jadr = G(m.body_jntadr[b]), jnum = G(m.body_jntnum[b]);
      for (int j = jadr; j < jadr + jnum; ++j) {
        int vadr = G(m.jnt_dofadr[j]);
        if (G(m.jnt_type[j]) == J_FREE) {
          for (int i = vadr; i < vadr + 3; ++i) v = v + cdof[6 * i + k] * qvel[i];
          for (int i = vadr + 3; i < vadr + 6; ++i) vpre[6 * i + k] = v;
          for (int i = vadr + 3; i < vadr + 6; ++i) v = v + cdof[6 * i + k] * qvel[i];
        } else {
          vpre[6 * vadr + k] = v;
          v = v + cdof[6 * vadr + k] * qvel[vadr];
        }
      }
      cvel[6 * b + k] = v;
    }
  }
  __syncwarp();
  LANES(b, m.nbody) {
    if (b == 0) continue;
    int jadr = G(m.body_jntadr[b]), jnum = G(m.body_jntnum[b]);
    for (int j = jadr; j < jadr + jnum; ++j) {
      int vadr = G(m.jnt_dofadr[j]);
      if (G(m.jnt_type[j]) == J_FREE) {
        for (int i = vadr; i < vadr + 3; ++i)
          for (int k = 0; k < 6; ++k) cdofdot[6 * i + k] = 0.0f;
        for (int i = vadr + 3; i < vadr + 6; ++i)
          motion_cross(vpre + 6 * i, cdof + 6 * i, cdofdot + 6 * i);
      } else {
        motion_cross(vpre + 6 * vadr, cdof + 6 * vadr, cdofdot + 6 * vadr);
      }
    }
  }
  __syncwarp();
}

// bias forces (rne) into BIAS
__device__ __forceinline__ void rne(const DuckModel& m, float* sm, int lane) {
  const float *qvel = SA(QVEL), *cdof = SA(CDOF), *cdofdot = SA(CDOFDOT), *cinert = SA(CINERT),
              *cvel = SA(CVEL);
  float *cacc = SA(CACC), *cfrc = SA(CFRC), *out = SA(BIAS);
  if (lane < 6) {
    const int k = lane;
    cacc[k] = k < 3 ? 0.0f : 0.0f - (k == 3 ? m.gx : (k == 4 ? m.gy : m.gz));
    for (int b = 1; b < m.nbody; ++b) {
      float a = cacc[6 * G(m.body_parentid[b]) + k];
      int dofadr = G(m.body_dofadr[b]), dofnum = G(m.body_dofnum[b]);
      for (int i = dofadr; i < dofadr + dofnum; ++i) a = a + cdofdot[6 * i + k] * qvel[i];
      cacc[6 * b + k] = a;
    }
  }
  __syncwarp();
  LANES(b, m.nbody) {
    float* f = cfrc + 6 * b;
    if (b == 0) {
      for (int k = 0; k < 6; ++k) f[k] = 0.0f;
      continue;
    }
    float Iv[6], Ia[6], fc[6];
    sym6_vec(cinert + 21 * b, cvel + 6 * b, Iv);
    sym6_vec(cinert + 21 * b, cacc + 6 * b, Ia);
    force_cross(cvel + 6 * b, Iv, fc);
    for (int k = 0; k < 6; ++k) f[k] = Ia[k] + fc[k];
  }
  __syncwarp();
  if (lane < 6)
    for (int b = m.nbody - 1; b > 0; --b) {
      int p = G(m.body_parentid[b]);
      if (p > 0) cfrc[6 * p + lane] = cfrc[6 * p + lane] + cfrc[6 * b + lane];
    }
  __syncwarp();
  LANES(i, m.nv) out[i] = v6_dot(cdof + 6 * i, cfrc + 6 * G(m.dof_bodyid[i]));
  __syncwarp();
}

// position servos: ACT_FORCE one actuator per lane, then their sum per dof
// (in actuator order) into QFRC_ACT
__device__ __forceinline__ void actuation(const DuckModel& m, const DuckDR& dr, int env, float* sm,
                                          int lane) {
  const int stride_gainprm = 3 * m.nu, stride_biasprm = 3 * m.nu;
  const float *qpos = SA(QPOS), *qvel = SA(QVEL), *ctrl = SA(CTRL);
  float *act_force = SA(ACT_FORCE), *qfrc_act = SA(QFRC_ACT);
  LANES(u, m.nu) {
    int qadr = G(m.act_adr[2 * u]), vadr = G(m.act_adr[2 * u + 1]);
    const float* p = m.act_prm + ACT_NF * u;
    float gear = G(p[2]);
    float ctrl_c = vclip(ctrl[u], G(p[0]), G(p[1]));
    float length = qpos[qadr] * gear;
    float velocity = qvel[vadr] * gear;
    float gain0 = DRF(gainprm, 3 * u);
    float bias1 = DRF(biasprm, 3 * u + 1);
    float force = gain0 * ctrl_c + G(p[4]) + bias1 * length + G(p[6]) * velocity;
    act_force[u] = vclip(force, G(p[7]), G(p[8]));
  }
  __syncwarp();
  LANES(i, m.nv) {
    float acc = 0.0f;
    for (int u = 0; u < m.nu; ++u)
      if (G(m.act_adr[2 * u + 1]) == i) acc = acc + act_force[u] * G(m.act_prm[ACT_NF * u + 2]);
    qfrc_act[i] = acc;
  }
  __syncwarp();
}

// Sparse LDL^T of A (packed lower triangle) on the pattern given by masks
// (bit k < i of mask[i]: (i, k) in the pattern), and the solve of L D L^T x
// = b. Lane i keeps row i of A, then of L, in registers (`LdlRow::r`,
// indexed by compile-time constants: the triangle is unrolled to the
// ceiling NVC >= nv). The factor is right-looking: step j takes d[j] from
// lane j's diagonal by shuffle, every lane forms 1 / d[j] itself (the same
// bits on every lane), scales its entry j into L[i][j], and subtracts
// (L[i][j] L[k][j]) d[j] from its entry k for each k > j, with L[k][j] from
// lane k by shuffle. Entry (i, k) so takes its terms in ascending j with the
// twin's rounding (LDLTree.factor), its diagonal as well, and no step
// touches shared memory. The lanes past nv hold identity rows and every step
// runs to the ceiling, with no test per step or term: a row's entries are
// changed only by the steps before them, so the rows past nv leave the
// model's rows alone, and the entries above a row's diagonal take
// whatever comes and are never read.
template <int NVC>
struct LdlRow {
  float r[NVC];  // row `lane` of A, then L's strict lower part (entries past it unused)
  float dinv;    // 1 / d[lane]
  uint32_t ri;   // mask[lane], 0 past nv
};

// every step's updates, each entry over its pattern: DENSE (every mask
// holds every k < i) without a test per term
template <int NVC, bool DENSE>
__device__ __forceinline__ void ldl_steps(int nv, const uint32_t* mask, LdlRow<NVC>& row,
                                          int lane) {
#pragma unroll
  for (int j = 0; j < NVC; ++j) {
    const float dj = __shfl_sync(FULL, row.r[j], j);  // d[j]: lane j's diagonal, all its terms in
    const float inv = 1.0f / dj;
    if (lane == j) row.dinv = inv;
    row.r[j] = row.r[j] * inv;  // L[lane][j] on lanes > j; the others' entry j is not read again
#pragma unroll
    for (int k = j + 1; k < NVC; ++k) {
      const float p = row.r[j] * __shfl_sync(FULL, row.r[j], k) * dj;
      if (DENSE)
        row.r[k] = row.r[k] - p;
      else
        row.r[k] = ((row.ri & (k < nv ? G(mask[k]) : 0u)) >> j & 1u) ? row.r[k] - p : row.r[k];
    }
  }
}

// factor A into `row` (registers) and L's strict lower part into shared L,
// written once, for ldl_solve's backward pass; A may be L (in place): a lane
// reads and writes only its own row
template <int NVC>
__device__ __forceinline__ void ldl_factor(int nv, const uint32_t* mask, const float* A, float* L,
                                           LdlRow<NVC>& row, int lane) {
  row.ri = lane < nv ? G(mask[lane]) : 0u;
  row.dinv = 0.0f;
#pragma unroll
  for (int k = 0; k < NVC; ++k)
    row.r[k] = lane >= nv ? (k == lane ? 1.0f : 0.0f) : (k <= lane ? A[TRI(lane, k)] : 0.0f);
  if (__all_sync(FULL, lane >= nv || row.ri == (1u << lane) - 1u))
    ldl_steps<NVC, true>(nv, mask, row, lane);
  else
    ldl_steps<NVC, false>(nv, mask, row, lane);
#pragma unroll
  for (int k = 0; k < NVC; ++k)
    if (k < lane && lane < nv) L[TRI(lane, k)] = row.r[k];
  __syncwarp();
}

// L D L^T x = b with lane i holding b[i] (returns x[i]): the forward solve
// runs k outer with rows in parallel (L's rows from the registers), the
// backward one i outer with columns in parallel (L's columns from shared
// memory); each entry sees its updates in the twin's order
template <int NVC>
__device__ __forceinline__ float ldl_solve(int nv, const uint32_t* mask, const float* L,
                                           const LdlRow<NVC>& row, float z, int lane) {
#pragma unroll
  for (int k = 0; k < NVC; ++k) {  // row.ri holds no bit past nv
    const float zk = __shfl_sync(FULL, z, k);
    if (row.ri >> k & 1u) z = z - row.r[k] * zk;
  }
  if (lane < nv) z = z * row.dinv;
  for (int i = nv - 1; i >= 0; --i) {
    const float zi = __shfl_sync(FULL, z, i);
    if (lane < i && (G(mask[i]) >> lane & 1u)) z = z - L[TRI(i, lane)] * zi;
  }
  return z;
}

// entry o of the symmetric tree-pattern matvec: the serial loop of
// lane_physics._mat_vec_tree adds M[o][j] v[j] for j <= o (row o), then
// M[i][o] v[i] for i > o (the later rows), and so does this
__device__ __forceinline__ float mat_vec_row(const DuckModel& m, const float* M, const float* v,
                                             int o) {
  float acc = 0.0f;
  const uint32_t mo = G(m.tree_mask[o]);
#pragma unroll 4
  for (int j = 0; j <= o; ++j) {
    float p = M[TRI(o, j)] * v[j];
    acc = (mo >> j & 1u) ? acc + p : acc;
  }
#pragma unroll 4
  for (int i = o + 1; i < m.nv; ++i) {
    float p = M[TRI(i, o)] * v[i];
    acc = (G(m.tree_mask[i]) >> o & 1u) ? acc + p : acc;
  }
  return acc;
}

// ---------------------------------------------------------------------------
// collision: one hull vertex per lane (hv <= 32), the vertex in registers and
// the reductions over vertices by the ordered warp scans above
// ---------------------------------------------------------------------------

__device__ __forceinline__ V3 shfl3(V3 v, int src) {
  return v3(__shfl_sync(FULL, v.x, src), __shfl_sync(FULL, v.y, src), __shfl_sync(FULL, v.z, src));
}

__device__ __forceinline__ void geom_pose(const DuckModel& m, int g, const float* sm, V3& pos,
                                          M3& mat) {
  int b = G(m.geom_bodyid[g]);
  Q4 xq = qld(SA(XQUAT) + 4 * b);
  pos = add(vld(SA(XPOS) + 3 * b), qrot(xq, vldg(m.geom_pos + 3 * g)));
  mat = qmat(qmul(xq, qldg(m.geom_quat + 4 * g)));
}

// first-best index among the lanes' scores (the serial argmax_first)
__device__ __forceinline__ int warp_argmax_first(float s, bool in, int lane) {
  int idx = lane;
  bool valid = in && (lane == 0 || s == s);
  warp_first_best(s, idx, valid, true);
  return idx;
}

// the four candidate vertices of lane_physics._manifold (dyn=false: spread
// about the constant normal n, candidate a the deepest vertex) and
// _manifold_dyn (dyn=true: candidate a the first masked vertex), with their
// validity after dedup; candidate 0 is always valid. Lane v < V holds
// vertex wv, its support and its mask; every lane gets idx and valid.
__device__ __forceinline__ void manifold_pick(V3 wv, float support, bool msk, int V, V3 n,
                                              bool dyn, int lane, int* idx, bool* valid) {
  const bool in = lane < V;
  const float dm = msk ? 0.0f : -1e6f;
  idx[0] = warp_argmax_first(dyn ? dm : support, in, lane);
  V3 a = shfl3(wv, idx[0]);
  V3 d = sub(a, wv);
  idx[1] = warp_argmax_first(dot(d, d) + dm, in, lane);
  V3 b = shfl3(wv, idx[1]);
  V3 ab = cross(n, sub(a, b));
  idx[2] = warp_argmax_first(fabsf(dot(sub(a, wv), ab)) + dm, in, lane);
  V3 c = shfl3(wv, idx[2]);
  V3 ac = cross(n, sub(a, c)), bc = cross(n, sub(b, c));
  idx[3] = warp_argmax_first(fabsf(dot(sub(b, wv), bc)) + fabsf(dot(sub(a, wv), ac)) + dm, in,
                             lane);
  for (int k = 0; k < 4; ++k) {
    bool seen = false;
    for (int j = 0; j < k; ++j) seen = seen || (idx[j] == idx[k]);
    bool mk = __shfl_sync(FULL, (int)msk, idx[k]) != 0;
    valid[k] = (k == 0) ? true : (mk && !seen);
  }
}

// per-env contact frame rows [n, t1, t2] (lane_physics._dyn_frame)
__device__ __forceinline__ void dyn_frame(V3 n, float* fr) {
  bool refy = fabsf(n.y) < 0.9f;
  V3 ref = v3(0.0f, refy ? 1.0f : 0.0f, refy ? 0.0f : 1.0f);
  V3 t1 = cross(ref, n);
  float inv = 1.0f / vmax(sqrtf(dot(t1, t1)), 1e-12f);
  t1 = scl(t1, inv);
  V3 t2 = cross(n, t1);
  vst(fr, n); vst(fr + 3, t1); vst(fr + 6, t2);
}

// plane vs hull (lane_physics.collide's PLANE_HULL): support along the
// plane's constant normal, candidates within 1 mm of the deepest vertex
__device__ __forceinline__ void plane_hull(const DuckModel& m, const int* pi, const float* pf,
                                           const float* sm, float* out, float* fr, int lane) {
  const int HV = m.hv;
  const bool in = lane < HV;
  V3 n = v3(G(pf[IMP_N + 2]), G(pf[IMP_N + 3]), G(pf[IMP_N + 4]));
  float ppn = G(pf[IMP_N + 5]);
  const float* verts = m.hull_vert + (size_t)G(pi[8]) * HV * 3;
  V3 gpos; M3 gmat;
  geom_pose(m, G(pi[2]), sm, gpos, gmat);
  V3 wv = v3(0.f, 0.f, 0.f);
  float sup = 0.f;
  if (in) {
    wv = add(gpos, mvec(gmat, vldg(verts + 3 * lane)));
    sup = ppn - dot(wv, n);
  }
  float smax = warp_fold_vmax(sup, in);
  float band = vmax(smax - 1e-3f, 0.0f);
  bool msk = in && sup > band;
  int idx[4];
  bool valid[4];
  manifold_pick(wv, sup, msk, HV, n, false, lane, idx, valid);
  for (int k = 0; k < 4; ++k) {
    V3 pk = shfl3(wv, idx[k]);
    float dist = -__shfl_sync(FULL, sup, idx[k]);
    if (lane == k) {
      float h = 0.5f * dist;
      vst(out + 4 * k + 1, v3(pk.x - h * n.x, pk.y - h * n.y, pk.z - h * n.z));
      out[4 * k] = valid[k] ? dist : BIGD;
    }
  }
  if (lane < 9) fr[lane] = G(pf[IMP_N + 6 + lane]);
}

// heightfield vs hull (lane_physics._hfield_hull): each hull vertex against
// the triangulated surface of its cell, the candidates spread about the
// heightfield's up axis, and one frame from the deepest vertex's normal
__device__ __forceinline__ void hfield_hull(const DuckModel& m, const int* pi, const float* pf,
                                            const float* sm, float* out, float* fr, int lane) {
  const int HV = m.hv, nrow = m.hfield_nrow, ncol = m.hfield_ncol;
  const bool in = lane < HV;
  const float* hp = pf + PAIR_HF;  // the heightfield frame: world <- local
  M3 R;
  for (int k = 0; k < 9; ++k) R.m[k] = G(hp[3 + k]);
  const float* c = m.hfield_prm;
  const float rx = G(c[0]), ry = G(c[1]), two_rx = G(c[2]), two_ry = G(c[3]), cols1 = G(c[4]),
              rows1 = G(c[5]), gx_max = G(c[6]), gy_max = G(c[7]), ztop = G(c[8]),
              dx = G(c[9]), dy = G(c[10]);
  const float* verts = m.hull_vert + (size_t)G(pi[8]) * HV * 3;
  V3 gpos; M3 gmat;
  geom_pose(m, G(pi[2]), sm, gpos, gmat);
  V3 wv = v3(0.f, 0.f, 0.f), nl = v3(0.f, 0.f, 1.f);
  float sup = 0.f;
  if (in) {
    wv = add(gpos, mvec(gmat, vldg(verts + 3 * lane)));
    V3 loc = mtvec(R, v3(wv.x - G(hp[0]), wv.y - G(hp[1]), wv.z - G(hp[2])));  // R^T (w - hp)
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
    nl = v3(-gxs * inv, -gys * inv, inv);
    sup = -((loc.z - z) * nl.z);
  }
  // candidate band within 1 mm of the deepest vertex, as the plane path
  float smax = warp_fold_vmax(sup, in);
  float band = vmax(smax - 1e-3f, 0.0f);
  bool msk = in && sup > band;
  int idx[4];
  bool valid[4];
  manifold_pick(wv, sup, msk, HV, mcol(R, 2), false, lane, idx, valid);
  // world normal of the deepest vertex: the contact normal of all four
  V3 n0 = mvec(R, shfl3(nl, idx[0]));
  n0 = scl(n0, 1.0f / vmax(sqrtf(dot(n0, n0)), 1e-12f));
  for (int k = 0; k < 4; ++k) {
    V3 pk = shfl3(wv, idx[k]);
    float dist = -__shfl_sync(FULL, sup, idx[k]);
    if (lane == k) {
      float h = 0.5f * dist;
      vst(out + 4 * k + 1, v3(pk.x - h * n0.x, pk.y - h * n0.y, pk.z - h * n0.z));
      out[4 * k] = valid[k] ? dist : BIGD;
    }
  }
  if (lane == 0) dyn_frame(n0, fr);
}

// hull vs hull (lane_physics._hull_hull): separating-axis test over both
// hulls' face normals, each lane a contiguous run of axes, then the first
// axis of least depth by the ordered warp scan
__device__ __forceinline__ void hull_hull(const DuckModel& m, const int* pi, float* sm, float* out,
                                          float* fr, int lane) {
  const int HV = m.hv, HF = m.hf;
  const bool in = lane < HV;
  const float* v1 = m.hull_vert + (size_t)G(pi[7]) * HV * 3;
  const float* v2 = m.hull_vert + (size_t)G(pi[8]) * HV * 3;
  const float* f1 = m.hull_face_n + (size_t)G(pi[7]) * HF * 3;
  const float* f2 = m.hull_face_n + (size_t)G(pi[8]) * HF * 3;
  float *w1 = SA(W1), *w2 = SA(W2);
  V3 pos1, pos2; M3 mat1, mat2;
  geom_pose(m, G(pi[1]), sm, pos1, mat1);
  geom_pose(m, G(pi[2]), sm, pos2, mat2);
  V3 wv = v3(0.f, 0.f, 0.f);
  if (in) {
    vst(w1 + 3 * lane, add(pos1, mvec(mat1, vldg(v1 + 3 * lane))));
    wv = add(pos2, mvec(mat2, vldg(v2 + 3 * lane)));
    vst(w2 + 3 * lane, wv);
  }
  __syncwarp();
  const int nax = 2 * HF, run = (nax + 31) / 32;
  float best_d = 0.f;
  V3 best_ax = v3(0.f, 0.f, 0.f);
  int best_i = 0;
  bool have = false;
  for (int ai = lane * run; ai < min(nax, (lane + 1) * run); ++ai) {
    V3 a = ai < HF ? mvec(mat1, vldg(f1 + 3 * ai)) : mvec(mat2, vldg(f2 + 3 * (ai - HF)));
    float mx1 = 0.f, mn1 = 0.f, mx2 = 0.f, mn2 = 0.f;
    for (int v = 0; v < HV; ++v) {
      float t1 = dot(vld(w1 + 3 * v), a), t2 = dot(vld(w2 + 3 * v), a);
      if (v == 0) { mx1 = mn1 = t1; mx2 = mn2 = t2; }
      else { mx1 = vmax(mx1, t1); mn1 = vmin(mn1, t1); mx2 = vmax(mx2, t2); mn2 = vmin(mn2, t2); }
    }
    float depth_f = mx1 - mn2, depth_b = mx2 - mn1;
    float depth = vmin(depth_f, depth_b);
    bool flip = depth_f > depth_b;
    V3 ax = flip ? v3(-a.x, -a.y, -a.z) : a;
    // the serial `ai == 0 || depth < best_d` within the run
    bool can = ai == 0 || depth == depth;
    if (can && (!have || depth < best_d)) { best_d = depth; best_ax = ax; best_i = ai; have = true; }
  }
  warp_first_best(best_d, best_i, have, false);
  best_ax = shfl3(best_ax, best_i / run);
  float sup = in ? -dot(wv, best_ax) : 0.f;
  float smax = warp_fold_vmax(sup, in);
  float thresh = smax - 1e-4f;
  bool msk = in && (sup >= thresh) && (best_d > 0.0f);
  int idx[4];
  bool valid[4];
  manifold_pick(wv, sup, msk, HV, best_ax, true, lane, idx, valid);
  for (int k = 0; k < 4; ++k) {
    V3 pk = shfl3(wv, idx[k]);
    if (lane == k) {
      float h = 0.5f * best_d;
      vst(out + 4 * k + 1, v3(pk.x + h * best_ax.x, pk.y + h * best_ax.y, pk.z + h * best_ax.z));
      out[4 * k] = (valid[k] && best_d > 0.0f) ? -best_d : BIGD;
    }
  }
  if (lane == 0) dyn_frame(best_ax, fr);
}

__device__ __forceinline__ void collide(const DuckModel& m, float* sm, int lane) {
  for (int p = 0; p < m.npair; ++p) {
    const int* pi = m.pair_i + PAIR_NI * p;
    const float* pf = m.pair_f + PAIR_NF * p;
    float* cand = SA(CAND) + 16 * p;
    float* frame = SA(FRAME) + 9 * p;
    int type = G(pi[0]);
    if (type == P_PLANE_HULL) {
      plane_hull(m, pi, pf, sm, cand, frame, lane);
    } else if (type == P_HFIELD_HULL) {
      hfield_hull(m, pi, pf, sm, cand, frame, lane);
    } else if (type == P_HULL_HULL) {
      hull_hull(m, pi, sm, cand, frame, lane);
    } else if (lane == 0) {
      // unreachable: pack_model admits no other pair type. No contact.
      for (int k = 0; k < 4; ++k) {
        cand[4 * k] = BIGD; cand[4 * k + 1] = cand[4 * k + 2] = cand[4 * k + 3] = 0.f;
      }
      for (int k = 0; k < 9; ++k) frame[k] = (k % 4 == 0) ? 1.0f : 0.0f;
    }
    __syncwarp();
  }
}

// ---------------------------------------------------------------------------
// constraint rows (lane_physics.make_efc): one row, candidate or Jacobian
// entry per lane
// ---------------------------------------------------------------------------

__device__ __forceinline__ void make_efc(const DuckModel& m, const DuckDR& dr, int env, float* sm,
                                         int lane) {
  const int stride_dof_frictionloss = m.nv, stride_geom_friction = 3 * m.ngeom;
  const int nfl = m.nfri + m.nlim;
  const float *qpos = SA(QPOS), *qvel = SA(QVEL), *cdof = SA(CDOF), *com = SA(SUBTREE_COM);
  float *J = SA(EFC_J), *eD = SA(EFC_D), *eaa = SA(EFC_AREF), *epos = SA(EFC_POS),
        *efl = SA(EFC_FLOSS), *cmeta = SA(CMETA), *jnt = SA(JNT);
  LANES(r, m.nfri) {
    int i = G(m.fri_dof[r]);
    J[G(m.efc_off[r])] = 1.0f;
    eD[r] = G(m.fri_D[r]);
    eaa[r] = -G(m.fri_b[r]) * qvel[i];
    epos[r] = 0.0f;
    efl[r] = DRF(dof_frictionloss, i);
  }
  LANES(l, m.nlim) {
    const int r = m.nfri + l;
    const float* p = m.lim_prm + LIM_N * l;
    int j = G(m.lim_jnt[l]);
    int qadr = G(m.jnt_qposadr[j]), dofadr = G(m.jnt_dofadr[j]);
    float q = qpos[qadr];
    float dist_lo = q - G(p[IMP_N]), dist_hi = G(p[IMP_N + 1]) - q;
    float dist = vmin(dist_lo, dist_hi);
    float side = dist_lo < dist_hi ? 1.0f : -1.0f;
    float pos = dist - G(p[IMP_N + 2]);
    float imp = impedance(pos, p);
    float R = (1.0f - imp) / imp * G(p[IMP_N + 3]);
    R = vmax(R, MINVAL);
    J[G(m.efc_off[r])] = side;
    eD[r] = 1.0f / R;
    eaa[r] = -G(p[1]) * (side * qvel[dofadr]) - G(p[0]) * imp * pos;
    epos[r] = pos;
    efl[r] = 0.0f;
  }
  // per candidate: friction, impedance and D
  LANES(c, 4 * m.npair) {
    const int* pi = m.pair_i + PAIR_NI * (c >> 2);
    const float* pf = m.pair_f + PAIR_NF * (c >> 2);
    float mu, diag;
    if (dr.geom_friction) {
      // priorities equal: max of both geoms' friction; else mu_g1 == mu_g2
      float mu1 = DRF(geom_friction, 3 * G(pi[9])), mu2 = DRF(geom_friction, 3 * G(pi[10]));
      mu = vmax(mu1, mu2);
      float iw = G(pf[IMP_N + 15]);
      diag = (iw + mu * mu * iw) * 2.0f * mu * mu / G(pf[IMP_N + 16]);
      diag = vmax(diag, MINVAL);
    } else {
      mu = G(pf[IMP_N + 1]);
      diag = G(pf[IMP_N]);
    }
    float pos_neg = vmin(SA(CAND)[4 * c], 0.0f);
    float imp = impedance(pos_neg, pf);
    float R = vmax((1.0f - imp) / imp * diag, MINVAL);
    float* cm = cmeta + 4 * c;
    cm[0] = imp; cm[1] = 1.0f / R; cm[2] = pos_neg; cm[3] = mu;
  }
  // per candidate and support dof: the contact point's Jacobian along the
  // frame's rows (Jn, Jt1, Jt2); pair p's block starts at 12 x the support
  // widths of the pairs before it
  for (int pp = 0; pp < m.npair; ++pp) {
    const int* pi = m.pair_i + PAIR_NI * pp;
    const int r0 = nfl + 16 * pp, off0 = G(m.efc_off[r0]), w = G(m.efc_off[r0 + 1]) - off0;
    float* blk = jnt + 12 * ((off0 - nfl) / 16);
    const int root1 = G(pi[5]), root2 = G(pi[6]);
    const uint32_t dofs1 = (uint32_t)G(pi[11]), dofs2 = (uint32_t)G(pi[12]);
    const float* frame = SA(FRAME) + 9 * pp;
    LANES(it, 4 * w) {
      const int k = it / w, t = it - k * w;
      const float* cand = SA(CAND) + 16 * pp + 4 * k;
      V3 pos_c = vld(cand + 1);
      int d = G(m.efc_col[off0 + t]);
      const float* cd = cdof + 6 * d;
      V3 ang = vld(cd), lin = vld(cd + 3);
      V3 contrib = v3(0.f, 0.f, 0.f);
      bool in2 = dofs2 >> d & 1u, in1 = dofs1 >> d & 1u;
      if (in2) contrib = add(lin, cross(ang, sub(pos_c, vld(com + 3 * root2))));
      if (in1) {
        V3 jp1 = add(lin, cross(ang, sub(pos_c, vld(com + 3 * root1))));
        contrib = in2 ? sub(contrib, jp1) : v3(-jp1.x, -jp1.y, -jp1.z);
      }
      blk[it] = dot(contrib, vld(frame));
      blk[4 * w + it] = dot(contrib, vld(frame + 3));
      blk[8 * w + it] = dot(contrib, vld(frame + 6));
    }
  }
  __syncwarp();
  // the pyramid rows' coefficients: Jn +- mu Jt1, Jn +- mu Jt2
  for (int pp = 0; pp < m.npair; ++pp) {
    const int r0 = nfl + 16 * pp, off0 = G(m.efc_off[r0]), w = G(m.efc_off[r0 + 1]) - off0;
    const float* blk = jnt + 12 * ((off0 - nfl) / 16);
    LANES(it, 16 * w) {
      const int rr = it / w, t = it - rr * w, k = rr >> 2, dir = rr & 3;
      const float mu = cmeta[4 * (4 * pp + k) + 3];
      const float* Jt = blk + (dir < 2 ? 4 : 8) * w;
      float smu = (dir & 1) ? -mu : mu;
      J[off0 + it] = blk[k * w + t] + smu * Jt[k * w + t];
    }
  }
  __syncwarp();
  LANES(q, 16 * m.npair) {
    const int r = nfl + q, pp = q >> 4, c = q >> 2;
    const float* pf = m.pair_f + PAIR_NF * pp;
    const int o0 = G(m.efc_off[r]), o1 = G(m.efc_off[r + 1]);
    float Jq = J[o0] * qvel[G(m.efc_col[o0])];
    for (int o = o0 + 1; o < o1; ++o) Jq = Jq + J[o] * qvel[G(m.efc_col[o])];
    const float* cm = cmeta + 4 * c;
    eD[r] = cm[1];
    eaa[r] = -G(pf[1]) * Jq - G(pf[0]) * cm[0] * cm[2];
    epos[r] = SA(CAND)[4 * c];
    efl[r] = 0.0f;
  }
  __syncwarp();
}

// row r of J times v, over the row's support, first term without a leading zero
__device__ __forceinline__ float jv(const DuckModel& m, const float* J, int r, const float* v) {
  const int o0 = G(m.efc_off[r]), o1 = G(m.efc_off[r + 1]);
  float out = J[o0] * v[G(m.efc_col[o0])];
#pragma unroll 4
  for (int o = o0 + 1; o < o1; ++o) out = out + J[o] * v[G(m.efc_col[o])];
  return out;
}

// the constraint cost of row r at q (lane_physics._primal_cost's term)
__device__ __forceinline__ float cost_row(const DuckModel& m, const float* sm, int r,
                                          const float* q) {
  const float D = SA(EFC_D)[r];
  float x = jv(m, SA(EFC_J), r, q) - SA(EFC_AREF)[r];
  float Dx = D * x;
  if (r < m.nfri) {
    float fl = SA(EFC_FLOSS)[r];
    bool inside = fabsf(Dx) <= fl;
    return inside ? 0.5f * D * x * x : fl * fabsf(x) - 0.5f * fl * fl / D;
  }
  bool act = (SA(EFC_POS)[r] < 0.0f) && (x < 0.0f);
  return act ? 0.5f * D * x * x : 0.0f;
}

// row r's terms of the line search's first and second derivative at alpha
__device__ __forceinline__ void dphi_row(const DuckModel& m, const float* sm, int r, float alpha,
                                         float& t1, float& t2) {
  float ja = SA(EFC_JAREF)[r], jd = SA(EFC_JD)[r], D = SA(EFC_D)[r];
  float x = ja + alpha * jd;
  float Dx = D * x;
  if (r < m.nfri) {
    float fl = SA(EFC_FLOSS)[r];
    bool inside = fabsf(Dx) <= fl;
    t1 = inside ? Dx * jd : fl * vsign(x) * jd;
    t2 = inside ? D * jd * jd : 0.0f;
  } else {
    bool act = (SA(EFC_POS)[r] < 0.0f) && (x < 0.0f);
    t1 = act ? Dx * jd : 0.0f;
    t2 = act ? D * jd * jd : 0.0f;
  }
}

// d1, d2 of the line search at alpha: the row terms one row per lane, then
// lane 0 sums d1 and lane 1 sums d2, each in row order
__device__ __forceinline__ void dphi(const DuckModel& m, float* sm, float alpha, float smooth_a,
                                     float smooth_b, float& d1, float& d2, int lane) {
  const int nefc = m.nefc;
  float *T = SA(TERMS), *scal = SA(SCAL);
  LANES(r, nefc) dphi_row(m, sm, r, alpha, T[r], T[nefc + r]);
  __syncwarp();
  if (lane < 2) {
    float acc = lane ? smooth_a : smooth_b + smooth_a * alpha;
    const float* t = T + lane * nefc;
#pragma unroll 8
    for (int r = 0; r < nefc; ++r) acc = acc + t[r];
    scal[4 + lane] = acc;
  }
  __syncwarp();
  d1 = scal[4];
  d2 = scal[5];
}

// Newton solve with warm start by primal cost; result in QACC
template <int NVC>
__device__ __forceinline__ void solve_constraints(const DuckModel& m, float* sm, int lane) {
  const int nv = m.nv, nefc = m.nefc, ntri = nv * (nv + 1) / 2, nfl = m.nfri + m.nlim;
  const float *warm = SA(WARM), *qs = SA(QACC_SMOOTH), *M = SA(M), *J = SA(EFC_J),
              *eD = SA(EFC_D), *eaa = SA(EFC_AREF), *epos = SA(EFC_POS), *efl = SA(EFC_FLOSS);
  float *qacc = SA(QACC), *H = SA(H), *Jaref = SA(EFC_JAREF), *Jd = SA(EFC_JD);
  float *grad = SA(GRAD), *Ma_err = SA(MAERR), *dir = SA(DIR), *tmp = SA(TMP), *tmp2 = SA(TMP2);
  float *F = SA(EFC_F), *W = SA(EFC_W), *T = SA(TERMS), *scal = SA(SCAL);
  PROF_START();

  // primal costs at the warm start (lane 0) and at qacc_smooth (lane 1)
  LANES(i, nv) {
    grad[i] = warm[i] - qs[i];
    Ma_err[i] = qs[i] - qs[i];
  }
  __syncwarp();
  LANES(i, nv) {
    tmp[i] = mat_vec_row(m, M, grad, i);
    tmp2[i] = mat_vec_row(m, M, Ma_err, i);
  }
  LANES(r, nefc) {
    T[r] = cost_row(m, sm, r, warm);
    T[nefc + r] = cost_row(m, sm, r, qs);
  }
  __syncwarp();
  if (lane < 2) {
    const float *diff = lane ? Ma_err : grad, *Md = lane ? tmp2 : tmp, *t = T + lane * nefc;
    float cost = diff[0] * 0.0f;
#pragma unroll 8
    for (int i = 0; i < nv; ++i) cost = cost + 0.5f * diff[i] * Md[i];
#pragma unroll 8
    for (int r = 0; r < nefc; ++r) cost = cost + t[r];
    scal[lane] = cost;
  }
  __syncwarp();
  const bool use_ws = scal[0] < scal[1];
  LANES(i, nv) qacc[i] = use_ws ? warm[i] : qs[i];
  __syncwarp();
  LANES(r, nefc) Jaref[r] = jv(m, J, r, qacc) - eaa[r];
  __syncwarp();

  const int iters = m.iterations > 1 ? m.iterations : 1;
  for (int it = 0; it < iters; ++it) {
    LANES(i, nv) tmp[i] = qacc[i] - qs[i];
    __syncwarp();
    LANES(i, nv) Ma_err[i] = mat_vec_row(m, M, tmp, i);
    PROF(PROF_COSTS);
    LANES(r, nefc) {
      float ja = Jaref[r], D = eD[r];
      float Dx = D * ja;
      float f;
      bool hm;
      if (r < m.nfri) {
        f = -vclip(Dx, -efl[r], efl[r]);
        hm = fabsf(Dx) <= efl[r];
      } else {
        hm = (epos[r] < 0.0f) && (ja < 0.0f);
        f = hm ? -Dx : 0.0f;
      }
      F[r] = f;
      W[r] = D * (hm ? 1.0f : 0.0f);
    }
    __syncwarp();
    // grad (one dof per lane) and H = M + J^T diag(W) J (one entry per lane),
    // each over the rows that touch it, in row order: the dof's friction
    // and limit rows, then the 16 rows of every pair whose support holds it
    LANES(d, nv) {
      float g = Ma_err[d];
      for (int kind = 0; kind < 2; ++kind) {
        int r = G(m.efc_dof_rows[2 * d + kind]);
        if (r >= 0) g = g - J[G(m.efc_off[r])] * F[r];
      }
      for (int pp = 0; pp < m.npair; ++pp) {
        const int* pi = m.pair_i + PAIR_NI * pp;
        uint32_t dofs = (uint32_t)G(pi[11]) | (uint32_t)G(pi[12]);
        if (!(dofs >> d & 1u)) continue;
        const int r0 = nfl + 16 * pp, o0 = G(m.efc_off[r0]), w = G(m.efc_off[r0 + 1]) - o0;
        const int pd = __popc(dofs & ((1u << d) - 1u));
        for (int q = 0; q < 16; ++q) g = g - J[o0 + q * w + pd] * F[r0 + q];
      }
      grad[d] = g;
    }
    LANES(e, ntri) {
      int a, b;
      tri_ij(e, a, b);
      float h = M[e];
      if (a == b)
        for (int kind = 0; kind < 2; ++kind) {
          int r = G(m.efc_dof_rows[2 * a + kind]);
          if (r >= 0) {
            float c = J[G(m.efc_off[r])];
            h = h + W[r] * c * c;
          }
        }
      for (int pp = 0; pp < m.npair; ++pp) {
        const int* pi = m.pair_i + PAIR_NI * pp;
        uint32_t dofs = (uint32_t)G(pi[11]) | (uint32_t)G(pi[12]);
        if (!((dofs >> a & 1u) && (dofs >> b & 1u))) continue;
        const int r0 = nfl + 16 * pp, o0 = G(m.efc_off[r0]), w = G(m.efc_off[r0 + 1]) - o0;
        const int pa = __popc(dofs & ((1u << a) - 1u)), pb = __popc(dofs & ((1u << b) - 1u));
        for (int q = 0; q < 16; ++q) {
          const float* Jr = J + o0 + q * w;
          h = h + W[r0 + q] * Jr[pa] * Jr[pb];
        }
      }
      H[e] = h;
    }
    PROF(PROF_GRAD_H);
    // factor the lower triangle in place: H's strict lower part becomes L
    LdlRow<NVC> row;
    ldl_factor(nv, m.ldlh_mask, H, H, row, lane);
    float z = ldl_solve(nv, m.ldlh_mask, H, row, lane < nv ? -grad[lane] : 0.0f, lane);
    if (lane < nv) dir[lane] = z;
    __syncwarp();

    LANES(r, nefc) Jd[r] = jv(m, J, r, dir);
    LANES(i, nv) tmp[i] = mat_vec_row(m, M, dir, i);
    __syncwarp();
    if (lane < 2) {  // smooth_b on lane 0, smooth_a on lane 1
      const float* u = lane ? tmp : Ma_err;
      float acc = 0.0f;
#pragma unroll 8
      for (int i = 0; i < nv; ++i) acc = acc + dir[i] * u[i];
      scal[2 + lane] = acc;
    }
    __syncwarp();
    const float smooth_b = scal[2], smooth_a = scal[3];
    PROF(PROF_FACTOR_H);

    float d1_0, d2_0;
    dphi(m, sm, 0.0f, smooth_a, smooth_b, d1_0, d2_0, lane);
    bool descent = d1_0 < 0.0f;
    float hi0 = d2_0 > TINY ? -d1_0 / vmax(d2_0, TINY) : 1.0f;
    hi0 = vmax(hi0, 1e-8f);
    // the 8 bracket points are independent: lane kk forms point kk's d1,
    // its row terms summed in row order as they are made
    if (lane < 8) {
      const float alpha = hi0 * (float)(1 << lane);
      float acc = smooth_b + smooth_a * alpha;
#pragma unroll 2
      for (int r = 0; r < nefc; ++r) {
        float t1, t2;
        dphi_row(m, sm, r, alpha, t1, t2);
        acc = acc + t1;
      }
      scal[8 + lane] = acc;
    }
    __syncwarp();
    float still_neg = 1.0f, count = 0.0f;
    for (int kk = 0; kk < 8; ++kk) {
      float neg = scal[8 + kk] < 0.0f ? 1.0f : 0.0f;
      still_neg = kk == 0 ? neg : still_neg * neg;
      count = count + still_neg;
    }
    float hi = ldexpf(hi0, (int)count);
    float lo = 0.0f;
    float alpha = 0.5f * (lo + hi);
    const int ls = m.ls_iterations > 1 ? m.ls_iterations : 1;
    for (int l = 0; l < ls; ++l) {
      float d1_a, d2_a;
      dphi(m, sm, alpha, smooth_a, smooth_b, d1_a, d2_a, lane);
      lo = d1_a < 0.0f ? alpha : lo;
      hi = d1_a >= 0.0f ? alpha : hi;
      float newton = alpha - d1_a / vmax(d2_a, TINY);
      float mid = 0.5f * (lo + hi);
      alpha = (newton > lo && newton < hi && d2_a > TINY) ? newton : mid;
    }
    alpha = descent ? alpha : 0.0f;
    LANES(i, nv) qacc[i] = qacc[i] + alpha * dir[i];
    LANES(r, nefc) Jaref[r] = Jaref[r] + alpha * Jd[r];
    PROF(PROF_LINE_SEARCH);
  }
}

// ---------------------------------------------------------------------------
// sensors / derived outputs of the last substep
// ---------------------------------------------------------------------------

__device__ __forceinline__ void write_derived(const DuckModel& m, int env, int nsensordata,
                                              float* sm, float* sensordata, float* actuator_force,
                                              float* contact_dist, float* site_xpos,
                                              float* site_xmat, int lane) {
  const float *xpos = SA(XPOS), *xquat = SA(XQUAT), *qvel = SA(QVEL), *qacc = SA(QACC),
              *cdof = SA(CDOF), *cdofdot = SA(CDOFDOT), *cvel = SA(CVEL), *com = SA(SUBTREE_COM);
  float *spos = SA(SPOS), *smat = SA(SMAT), *cacc = SA(PCACC);
  // site kinematics, one site per lane
  LANES(s, m.nsite) {
    int b = G(m.site_bodyid[s]);
    Q4 xq = qld(xquat + 4 * b);
    V3 p = add(vld(xpos + 3 * b), qrot(xq, vldg(m.site_pos + 3 * s)));
    M3 R = qmat(qmul(xq, qldg(m.site_quat + 4 * s)));
    vst(spos + 3 * s, p);
    for (int k = 0; k < 9; ++k) smat[9 * s + k] = R.m[k];
    float* xp = site_xpos + (size_t)env * m.nsite * 3 + 3 * s;
    xp[0] = p.x; xp[1] = p.y; xp[2] = p.z;
    float* xm = site_xmat + (size_t)env * m.nsite * 9 + 9 * s;
    for (int k = 0; k < 9; ++k) xm[k] = R.m[k];
  }
  // body accelerations with the constraint solution (rne_post_cacc), one
  // spatial component per lane down the tree
  if (lane < 6) {
    const int k = lane;
    cacc[k] = k < 3 ? 0.0f : 0.0f - (k == 3 ? m.gx : (k == 4 ? m.gy : m.gz));
    for (int b = 1; b < m.nbody; ++b) {
      float a = cacc[6 * G(m.body_parentid[b]) + k];
      int dofadr = G(m.body_dofadr[b]), dofnum = G(m.body_dofnum[b]);
      for (int i = dofadr; i < dofadr + dofnum; ++i)
        a = a + (cdofdot[6 * i + k] * qvel[i] + cdof[6 * i + k] * qacc[i]);
      cacc[6 * b + k] = a;
    }
  }
  __syncwarp();
  float* out = sensordata + (size_t)env * nsensordata;
  LANES(s, m.nsensor) {
    int sid = G(m.sensor_objid[s]);
    int body = G(m.site_bodyid[sid]);
    V3 origin = vld(com + 3 * G(m.body_rootid[body]));
    V3 p = vld(spos + 3 * sid);
    M3 R;
    for (int k = 0; k < 9; ++k) R.m[k] = smat[9 * sid + k];
    V3 w_world = vld(cvel + 6 * body);
    V3 pv = add(vld(cvel + 6 * body + 3), cross(w_world, sub(p, origin)));
    float* o = out + G(m.sensor_adr[s]);
    V3 r3;
    switch (G(m.sensor_type[s])) {
      case S_GYRO: r3 = mtvec(R, w_world); break;
      case S_VELOCIMETER: r3 = mtvec(R, pv); break;
      case S_ACCELEROMETER: {
        V3 a_ang = vld(cacc + 6 * body);
        V3 a_lin = add(vld(cacc + 6 * body + 3), cross(a_ang, sub(p, origin)));
        r3 = mtvec(R, add(a_lin, cross(w_world, pv)));
        break;
      }
      case S_FRAMEXAXIS: r3 = mcol(R, 0); break;
      case S_FRAMEZAXIS: r3 = mcol(R, 2); break;
      case S_FRAMELINVEL: r3 = pv; break;
      case S_FRAMEANGVEL: r3 = w_world; break;
      case S_FRAMEPOS: r3 = p; break;
      default: {  // S_FRAMEQUAT
        Q4 q = qmul(qld(xquat + 4 * body), qldg(m.site_quat + 4 * sid));
        o[0] = q.w; o[1] = q.x; o[2] = q.y; o[3] = q.z;
        continue;
      }
    }
    o[0] = r3.x; o[1] = r3.y; o[2] = r3.z;
  }
  const float *af = SA(ACT_FORCE), *cand = SA(CAND);
  LANES(u, m.nu) actuator_force[(size_t)env * m.nu + u] = af[u];
  LANES(c, 4 * m.npair) contact_dist[(size_t)env * m.npair * 4 + c] = cand[4 * c];
  __syncwarp();
}

// ---------------------------------------------------------------------------
// one substep (lane_physics.LanePhysics.substep)
// ---------------------------------------------------------------------------

template <int NVC>
__device__ __forceinline__ void substep(const DuckModel& m, const DuckDR& dr, int env, float* sm,
                                       int lane) {
  const int nv = m.nv;
  PROF_START();
  kinematics(m, dr, env, sm, lane);
  PROF(PROF_KINEMATICS);
  com_pos(m, dr, env, sm, lane);
  PROF(PROF_COM_POS);
  crb(m, dr, env, sm, lane);
  PROF(PROF_CRB);
  collide(m, sm, lane);
  PROF(PROF_COLLIDE);
  com_vel(m, sm, lane);
  rne(m, sm, lane);
  actuation(m, dr, env, sm, lane);
  PROF(PROF_DYNAMICS);
  const float *qvel = SA(QVEL), *bias = SA(BIAS), *qfrc_act = SA(QFRC_ACT);
  float* qs = SA(QACC_SMOOTH);
  float z = 0.0f;
  if (lane < nv) z = qfrc_act[lane] - bias[lane] - G(m.dof_damping[lane]) * qvel[lane];
  __syncwarp();  // the factor's arrays may overlay the bias forces
  LdlRow<NVC> row;
  ldl_factor(nv, m.ldl_mask, SA(M), SA(LDLM), row, lane);
  z = ldl_solve(nv, m.ldl_mask, SA(LDLM), row, z, lane);
  if (lane < nv) qs[lane] = z;
  PROF(PROF_SMOOTH_SOLVE);
  make_efc(m, dr, env, sm, lane);
  PROF(PROF_MAKE_EFC);
  solve_constraints<NVC>(m, sm, lane);
}

__device__ __forceinline__ void integrate(const DuckModel& m, float* sm, int lane) {
  const float dt = m.dt;
  float *qpos = SA(QPOS), *qvel = SA(QVEL), *warm = SA(WARM);
  const float* qacc = SA(QACC);
  LANES(i, m.nv) qvel[i] = qvel[i] + dt * qacc[i];
  __syncwarp();
  LANES(j, m.njnt) {
    int qadr = G(m.jnt_qposadr[j]), vadr = G(m.jnt_dofadr[j]);
    if (G(m.jnt_type[j]) == J_FREE) {
      for (int i = 0; i < 3; ++i) qpos[qadr + i] = qpos[qadr + i] + dt * qvel[vadr + i];
      V3 wl = v3(qvel[vadr + 3], qvel[vadr + 4], qvel[vadr + 5]);
      float angle = sqrtf(dot(wl, wl));
      float safe = angle > 1e-12f ? angle : 1.0f;
      float half = angle * (dt * 0.5f);
      float s = sinf(half) / safe;
      Q4 dq = {cosf(half), wl.x * s, wl.y * s, wl.z * s};
      Q4 q = {qpos[qadr + 3], qpos[qadr + 4], qpos[qadr + 5], qpos[qadr + 6]};
      Q4 qn = qnormalize(qmul(q, dq));
      qst(qpos + qadr + 3, qn);
    } else {
      qpos[qadr] = qpos[qadr] + dt * qvel[vadr];
    }
  }
  LANES(i, m.nv) warm[i] = qacc[i];
  __syncwarp();
}

// one warp per env: blockDim.x = 32 k, env = blockIdx.x * k + warp; NVC is
// the LDL's unroll ceiling, nv <= NVC (duck_step_kernel)
template <int NVC>
__global__ void physics_step_kernel(const __grid_constant__ DuckModel m,
                                    const __grid_constant__ DuckDR dr, int B, int n_substeps,
                                    int nsensordata, const float* __restrict__ qpos_in,
                                    const float* __restrict__ qvel_in,
                                    const float* __restrict__ warm_in,
                                    const float* __restrict__ ctrl_in, float* qpos_out,
                                    float* qvel_out, float* warm_out, float* sensordata,
                                    float* actuator_force, float* contact_dist, float* site_xpos,
                                    float* site_xmat) {
  extern __shared__ float4 dyn_smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int env = blockIdx.x * (blockDim.x >> 5) + warp;
  if (env >= B) return;  // the whole warp: no block-wide barrier follows
  float* sm = reinterpret_cast<float*>(dyn_smem) + (size_t)warp * m.env_floats;
  float *qpos = SA(QPOS), *qvel = SA(QVEL), *warm = SA(WARM), *ctrl = SA(CTRL);
  LANES(i, m.nq) qpos[i] = qpos_in[(size_t)env * m.nq + i];
  LANES(i, m.nv) qvel[i] = qvel_in[(size_t)env * m.nv + i];
  LANES(i, m.nv) warm[i] = warm_in[(size_t)env * m.nv + i];
  LANES(i, m.nu) ctrl[i] = ctrl_in[(size_t)env * m.nu + i];
  __syncwarp();
  for (int k = 0; k < n_substeps; ++k) {
    substep<NVC>(m, dr, env, sm, lane);
    PROF_START();
    if (k == n_substeps - 1)
      write_derived(m, env, nsensordata, sm, sensordata, actuator_force, contact_dist, site_xpos,
                    site_xmat, lane);
    integrate(m, sm, lane);
    PROF(PROF_OUTPUT);
  }
  LANES(i, m.nq) qpos_out[(size_t)env * m.nq + i] = qpos[i];
  LANES(i, m.nv) qvel_out[(size_t)env * m.nv + i] = qvel[i];
  LANES(i, m.nv) warm_out[(size_t)env * m.nv + i] = warm[i];
}

// The kernel instantiated for LDL ceiling `ceiling`, or null: the wrapper
// takes the least of these cases that holds the model's nv
// (cuda_step.LDL_CEILINGS). The instantiations differ in that constant alone.
typedef decltype(&physics_step_kernel<MAX_NV>) StepKernel;
inline StepKernel duck_step_kernel(int ceiling) {
  switch (ceiling) {
    case 24: return physics_step_kernel<24>;
    case MAX_NV: return physics_step_kernel<MAX_NV>;
  }
  return nullptr;
}

#ifdef __CUDACC__  // the host entry points (the device code above also builds as C++)
extern "C" {

int duck_limits(int* out) {
  out[0] = MAX_NV;
  out[1] = MAX_HV;
  return 2;
}

// Let the kernel's blocks use up to `smem` bytes of dynamic shared memory,
// and prefer shared memory to L1 in the SM's split.
int duck_configure(int smem, int ceiling) {
  StepKernel kernel = duck_step_kernel(ceiling);
  if (!kernel) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                   (int)cudaSharedmemCarveoutMaxShared);
}

// How many blocks of `threads` threads and `smem` bytes fit one SM (out[0]),
// and the card's SM count (out[1]).
int duck_occupancy(int threads, int smem, int ceiling, int* out) {
  StepKernel kernel = duck_step_kernel(ceiling);
  if (!kernel) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kernel, threads,
                                                                (size_t)smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaDeviceGetAttribute(out + 1, cudaDevAttrMultiProcessorCount, dev);
}

// the stage cycles summed since the last call (PROF_COUNT values); -1
// unless built with -DDUCK_PROFILE
int duck_profile(unsigned long long* out) {
#ifdef DUCK_PROFILE
  cudaError_t e = cudaMemcpyFromSymbol(out, duck_prof, sizeof(duck_prof));
  if (e != cudaSuccess) return (int)e;
  static const unsigned long long zero[PROF_COUNT] = {0};
  return (int)cudaMemcpyToSymbol(duck_prof, zero, sizeof(duck_prof));
#else
  (void)out;
  return -1;
#endif
}

int duck_physics_step(const DuckModel* m, const DuckDR* dr, int B, int n_substeps,
                      int nsensordata, const float* qpos, const float* qvel, const float* warm,
                      const float* ctrl, float* qpos_out, float* qvel_out, float* warm_out,
                      float* sensordata, float* actuator_force, float* contact_dist,
                      float* site_xpos, float* site_xmat, int envs_per_block, int ceiling,
                      void* stream) {
  StepKernel kernel = duck_step_kernel(ceiling);
  if (!kernel) return (int)cudaErrorInvalidValue;
  const int blocks = (B + envs_per_block - 1) / envs_per_block;
  const size_t smem = (size_t)envs_per_block * m->env_floats * sizeof(float);
  kernel<<<blocks, 32 * envs_per_block, smem, (cudaStream_t)stream>>>(
      *m, *dr, B, n_substeps, nsensordata, qpos, qvel, warm, ctrl, qpos_out, qvel_out, warm_out,
      sensordata, actuator_force, contact_dist, site_xpos, site_xmat);
  return (int)cudaGetLastError();
}

}  // extern "C"
#endif

// Order-1 Fermat/MPT solver kernel for NVIDIA Hopper (sm_90a): opt_solver_value.
//
// Replaces the Pallas TPU kernel
// differt2d_tpu/ops/pallas_solver.py::build_opt_order1_kernel (pallas_call
// at :275; B6).  Per receiver-grid pixel and order-1 candidate (one wall or
// RIS), it solves for the bounce point b = a + theta (b - a) on the wall with
// `steps` adam iterations on the scalar theta, from the candidate's uniform
// draw x0[c]:
//
//   Fermat: minimize the path length |b - tx + eps| + |p - b + eps|;
//   MPT:    minimize the interaction residual at b (specular for a wall,
//           constant outgoing angle phi for a RIS).
//
// The objective's derivative in theta is written by hand.  It follows the
// kernel's plain version (the eager solve, differentiated by PyTorch's
// autograd) op for op: the forward of geometry_ops.path_length /
// specular_residual / ris_residual, then the backward formula autograd
// applies to each of those ops, in the same order, so that both round alike
// and take the same adam trajectory.  (The TPU kernel takes the derivative
// in forward mode, jax.jvp, pallas_solver.py:109-138, and its trajectories
// differ from the XLA tracer's near MPT basin boundaries: PARITY.md:111-120.)
// Adam follows optax.adam(0.1): b1 0.9, b2 0.999, eps 1e-8, eps_root 0, the
// moments as (1 - b) g + b m, the bias corrections 1 - b**count from the
// table bc[2 * steps] (the host's float32 powers, equal to XLA's, see
// optimize.py), and x + (-lr) * update.  The reported loss is the objective
// at the second-to-last iterate for MPT and the residual at the solution for
// Fermat (pallas_solver.py:170-190).  Then, as the TPU kernel (:192-238):
// the on-object test, the blocked test of both path segments against every
// wall but the candidate's own and the vertices (patched ends), the loss
// gate, and valid * r_coef / (height**2 + r**2) added to the pixel's sum.
// The on-object test takes the bounce's projected parameter, as the plain
// version does, where the TPU kernel takes theta (equal up to rounding).
//
// Design: one thread per pixel, a loop over the candidates inside the
// thread, and the adam loop inside that; walls, kinds and the RIS phase's
// sin/cos sit in shared memory (computed by the host with torch.sin/cos,
// as the plain version computes them, so the two see the same phase).  One
// launch per transmitter; `accumulate` adds the launch's map to `out`, in
// transmitter order, as the JAX package adds its per-transmitter outputs.
// The validity reuses the deferred-clamp margins of power_map_common.cuh.
//
// Bound on the H100: FP32 operations.  A 1024x1024 RIS map at 1000 steps
// reads 8 B and writes 4 B per pixel against about 57k operations per pixel
// (chip_smoke.solver_ops).  The IEEE divisions and square roots of each step
// are instruction sequences (a reciprocal on the SFU, its refinement, the
// quotient's correction, a range check and a branch to a slow path), so the
// kernel is closer to the card's instruction issue rate than the operation
// count says (PERF.md: the issue-slot bound, from the kernel's own SASS).
//
// The redesign (FAST, exported as opt_solver_value) keeps every operation
// of the objective, its derivative and adam, and their order, and lowers
// them with fewer instructions:
//   - the walls sit in dynamic shared memory sized to W, so registers, not
//     32 KB of mostly unused records, decide how many blocks an SM holds;
//   - each divisor that serves several quotients is inverted once, with an
//     IEEE division, and each quotient formed from that reciprocal exactly
//     (div_by: three instructions, RN(a / b) bit for bit under a range
//     guard, see there): S in unit() and unit_back(), 2 sqrt in unit_back()
//     through 0.5 / S, and adam's bias corrections through a table of
//     reciprocals formed once per launch (bias_recip_kernel; the RIS loop
//     keeps IEEE division for the first moment, which flat residuals drive
//     out of the guard's range);
//   - the RIS and the wall objective get their own adam loops, so the
//     kind test leaves the step.
// The kernel as it was (FAST = false, exported as opt_solver_value_seq) is
// the redesign's bitwise reference, called by checks only.
//
// Numerics: built with -fmad=false and IEEE division and sqrt (no fast
// math), as the other sources (see power_map.cu).  The adam constants are
// optax's Python doubles rounded once to float32 (1 - 0.9 is 0.1f, not
// 1.0f - 0.9f), as PyTorch rounds a Python scalar operand.  The validity and
// power reuse power_map_common.cuh's forms (deferred-clamp margins), which
// agree with the plain version to rounding, not bit for bit.

#include "power_map_common.cuh"

#define OS_MAX_WALLS 512
#define OS_BLOCK 128

namespace {

constexpr int OBJ_FERMAT = 0;
constexpr int OBJ_MPT = 1;

constexpr float kB1 = 0.9f;
constexpr float kB2 = 0.999f;
constexpr float kOneMinusB1 = static_cast<float>(1.0 - 0.9);
constexpr float kOneMinusB2 = static_cast<float>(1.0 - 0.999);
constexpr float kAdamEps = 1e-8f;
constexpr float kAdamEpsRoot = 0.0f;
constexpr float kNegLr = -0.1f;

// -- exact division by a shared reciprocal ---------------------------------------
//
// With y = RN(1/b), q = RN(a y), r = RN(a - b q) (one fma) and q' = fma(r,
// y, q), q' = RN(a / b) in binary32, round to nearest, provided no step
// overflows, underflows or meets a subnormal.  Where q lies within an ulp of
// a / b, r is exact and this is Markstein's theorem (Muller et al., Handbook
// of Floating-Point Arithmetic, FMA-based division).  q = RN(a RN(1/b)) can
// lie up to 1.5 ulps off (only where a's significand is below b's); the
// argument that q' is RN(a / b) there too, with r then rounded, is written
// out in tests/test_torch_exact_division.py, which checks it for every
// divisor significand at its worst numerators.  The
// guards keep every step normal: a divisor in [2^-40, 2^40] (div_ok_b,
// positive) gives y in [2^-40, 2^40]; a nonzero numerator in [2^-79, 2^80]
// (div_ok) gives a y and q' ~ a / b in [2^-119, 2^120], and a nonzero r is
// a multiple of 2^(e_a - 47) >= 2^-126 (the least bit of b q) and at most a
// few ulps of a: normal.  A zero numerator, or any a = b q exactly, leaves
// r == 0, q exact and q' = q (a signed zero too: see div_by).  NaN,
// infinities, subnormals and values outside the ranges fail the guards; a
// step in which any quotient fails them is computed again with IEEE
// division `/` (slow_step), so every quotient is RN(a / b) either way and
// the guards change no bit.
constexpr float kDivLo = 0x1p-79f;
constexpr float kDivHi = 0x1p80f;
constexpr float kDivisorLo = 0x1p-40f;
constexpr float kDivisorHi = 0x1p40f;

// A numerator div_by takes: zero, or a magnitude in [kDivLo, kDivHi].
__device__ __forceinline__ bool div_ok(float a) {
  float m = fabsf(a);
  return m <= kDivHi && (m >= kDivLo || m == 0.0f);
}
// A divisor div_by takes: in [kDivisorLo, kDivisorHi], positive as every
// divisor of the solve is (|v|, 2 |v| and the bias corrections).
__device__ __forceinline__ bool div_ok_b(float b) {
  return b >= kDivisorLo && b <= kDivisorHi;
}
// RN(a / b) from y = RN(1 / b), for a and b that pass the guards.  The
// remainder is formed negated, nr = fma(b, q, -a) = -(a - b q) exactly, so
// that a zero numerator keeps its sign (b > 0): for a = -0, q = -0, nr = +0
// and fma(-nr, y, q) = -0 + -0 = -0, for a = +0, -0 + +0 = +0
// (fma(a - b q, y, q) would turn -0 / b into +0).
__device__ __forceinline__ float div_by(float a, float b, float y) {
  float q = __fmul_rn(a, y);
  float nr = __fmaf_rn(b, q, -a);
  return __fmaf_rn(-nr, y, q);
}

// The unit vector of (vx, vy) as the plain version's geometry_ops.normalize
// forms it (n2 = vx^2 + vy^2, the double-where guard, then v / |v|), with
// what its backward needs.  With R, the quotients by S come from its
// reciprocal y (div_by); ok says whether S, vx and vy passed the guards.
template <bool R>
struct Unit {
  float vx, vy;  // the vector
  float sq;      // sqrt(n2), 1 where n2 == 0
  float S;       // the divisor: |v|, 1 where n2 == 0
  float ux, uy;  // v / S
  bool z;        // n2 == 0
  float y;       // R: RN(1 / S)
  bool ok;       // R: S, vx and vy pass the guards
};

template <bool R>
__device__ __forceinline__ Unit<R> unit(float vx, float vy) {
  Unit<R> u;
  float n2 = vx * vx + vy * vy;
  u.z = n2 == 0.0f;
  u.sq = sqrtf(u.z ? 1.0f : n2);
  float len = u.z ? 0.0f : u.sq;
  u.S = u.z ? 1.0f : len;
  u.vx = vx;
  u.vy = vy;
  if (R) {
    u.y = __frcp_rn(u.S);  // RN(1 / S), as 1.0f / S
    u.ok = div_ok_b(u.S) && div_ok(vx) && div_ok(vy);
    u.ux = div_by(vx, u.S, u.y);
    u.uy = div_by(vy, u.S, u.y);
  } else {
    u.ux = vx / u.S;
    u.uy = vy / u.S;
  }
  return u;
}

// Cotangent (gx, gy) of the unit vector -> cotangent of v, by the rules
// PyTorch's autograd applies to normalize (DivBackward0: g / S and
// -g * ((v / S) / S) summed over the axis; the two wheres; SqrtBackward0:
// g / (2 sqrt); MulBackward0 of v * v: g v for each factor), summed in the
// order autograd accumulates them: the division's term first, then the two
// factors' terms one by one.  With R, the five quotients by S and the one
// by 2 sqrt come from y: 2 sqrt == 2 S wherever n2 != 0 (elsewhere gn is
// 0), and RN(1 / (2 S)) == 0.5 y exactly, 2 S in [2^-39, 2^41] (the guard
// ranges hold with a binade to spare); ok &= whether every numerator passed
// div_ok.
template <bool R>
__device__ __forceinline__ void unit_back(const Unit<R>& u, float gx, float gy, float& ovx,
                                          float& ovy, bool& ok) {
  float gn, bx, by;
  if (R) {
    float gS = (-gx) * div_by(u.ux, u.S, u.y) + (-gy) * div_by(u.uy, u.S, u.y);
    float gsq = u.z ? 0.0f : gS;
    gn = u.z ? 0.0f : div_by(gsq, 2.0f * u.sq, 0.5f * u.y);
    bx = div_by(gx, u.S, u.y);
    by = div_by(gy, u.S, u.y);
    ok = ok && u.ok && div_ok(u.ux) && div_ok(u.uy) && div_ok(gx) && div_ok(gy) &&
         div_ok(gsq);
  } else {
    float gS = (-gx) * (u.ux / u.S) + (-gy) * (u.uy / u.S);
    float gsq = u.z ? 0.0f : gS;
    gn = u.z ? 0.0f : gsq / (2.0f * u.sq);
    bx = gx / u.S;
    by = gy / u.S;
  }
  ovx = (bx + gn * u.vx) + gn * u.vx;
  ovy = (by + gn * u.vy) + gn * u.vy;
}

// The interaction residual at the bounce (bx, by) on wall w, and with G its
// cotangent on the bounce (gbx, gby): RIS residual (constant outgoing
// angle) or specular residual, in the plain version's op order
// (geometry_ops.ris_residual / specular_residual) and its autograd's
// backward.  RIS: 1 the RIS residual, 0 the specular one, -1 either, by
// w.kind.  With R, ok &= whether every quotient passed the guard.
template <bool G, int RIS, bool R>
__device__ __forceinline__ float residual(const WallRec& w, float txx, float txy, float px,
                                          float py, float bx, float by, float& gbx,
                                          float& gby, bool& ok) {
  Unit<R> r = unit<R>(px - bx, py - by);
  float grx, gry;
  float f;
  if (RIS == 1 || (RIS < 0 && w.kind == KIND_RIS)) {
    float sin_a = (-r.ux) * w.ny - (-r.uy) * w.nx;
    float cos_a = (-r.ux) * w.nx + (-r.uy) * w.ny;
    float es = sin_a - w.sinp, ec = cos_a - w.cosp;
    f = es * es + ec * ec;
    if (!G) return f;
    float ges = 2.0f * es, gec = 2.0f * ec;
    grx = (-(ges * w.ny)) + (-(gec * w.nx));
    gry = (ges * w.nx) + (-(gec * w.ny));
    float gwx, gwy;
    unit_back<R>(r, grx, gry, gwx, gwy, ok);
    gbx = -gwx;
    gby = -gwy;
    return f;
  }
  Unit<R> i = unit<R>(bx - txx, by - txy);
  float k = 2.0f * (i.ux * w.nx + i.uy * w.ny);
  float ex = r.ux - (i.ux - k * w.nx);
  float ey = r.uy - (i.uy - k * w.ny);
  f = ex * ex + ey * ey;
  if (!G) return f;
  float gex = ex + ex, gey = ey + ey;
  float gs = (gex * w.nx + gey * w.ny) * 2.0f;
  float gvx, gvy, gwx, gwy;
  unit_back<R>(i, (-gex) + gs * w.nx, (-gey) + gs * w.ny, gvx, gvy, ok);
  unit_back<R>(r, gex, gey, gwx, gwy, ok);
  gbx = gvx + (-gwx);
  gby = gvy + (-gwy);
  return f;
}

// One segment's length |v + eps| as geometry_ops.path_length forms it, and
// the cotangent of v for a unit cotangent of the length.
__device__ __forceinline__ float seg_length(float vx, float vy, float& gx, float& gy) {
  float n2 = vx * vx + vy * vy;
  bool z = n2 == 0.0f;
  float sq = sqrtf(z ? 1.0f : n2);
  float gn = z ? 0.0f : 1.0f / (2.0f * sq);
  gx = gn * vx + gn * vx;
  gy = gn * vy + gn * vy;
  return z ? 0.0f : sq;
}

// The solver's objective at theta, and its derivative in *dtheta: the
// plain version's forward (the bounce b = a + theta (b - a), then
// path_length or the residual) and, op by op, the backward PyTorch's
// autograd forms for it, so that both take the same adam trajectory.
template <int OBJ, int RIS, bool R>
__device__ __forceinline__ float objective(const WallRec& w, float txx, float txy, float px,
                                           float py, float theta, float& dtheta, bool& ok) {
  float bx = w.ax + theta * w.dx, by = w.ay + theta * w.dy;
  float gbx, gby, f;
  if (OBJ == OBJ_FERMAT) {
    float g1x, g1y, g2x, g2y;
    float l1 = seg_length((bx - txx) + kEps, (by - txy) + kEps, g1x, g1y);
    float l2 = seg_length((px - bx) + kEps, (py - by) + kEps, g2x, g2y);
    f = l1 + l2;
    gbx = g1x + (-g2x);
    gby = g1y + (-g2y);
  } else {
    f = residual<true, RIS, R>(w, txx, txy, px, py, bx, by, gbx, gby, ok);
  }
  dtheta = gbx * w.dx + gby * w.dy;
  return f;
}

// One adam step as the sequential kernel takes it: the objective and the
// bias divisions with IEEE division.  out = (objective, m, v, theta).
// Outside the loop's code (noinline): the redesigned loop calls it only for
// a step whose quotients failed div_ok.
template <int OBJ, int RIS>
__device__ __noinline__ float4 slow_step(const WallRec w, float txx, float txy, float px,
                                         float py, float theta, float m, float v, float d1,
                                         float d2) {
  float g;
  bool unused = true;
  float f = objective<OBJ, RIS, false>(w, txx, txy, px, py, theta, g, unused);
  m = kOneMinusB1 * g + kB1 * m;
  v = kOneMinusB2 * (g * g) + kB2 * v;
  float m_hat = m / d1, v_hat = v / d2;
  theta = theta + kNegLr * (m_hat / (sqrtf(v_hat + kAdamEpsRoot) + kAdamEps));
  return make_float4(f, m, v, theta);
}

// `steps` adam iterations from theta; returns the solution and, in *last,
// the objective at the second-to-last iterate.  FAST: the bias divisors
// from rb[t] = (1 - b1**t, its reciprocal, 1 - b2**t, its reciprocal), the
// quotients through div_by (rb_ok: every divisor passed div_ok_b), a step
// whose guards fail redone by slow_step; otherwise bc[2 * steps] and IEEE
// division.
template <int OBJ, int RIS, bool FAST>
__device__ __forceinline__ float adam(const WallRec& w, float txx, float txy, float px,
                                      float py, float theta, const float* __restrict__ bc,
                                      const float4* __restrict__ rb, bool rb_ok, int steps,
                                      float& last) {
  float m = 0.0f, v = 0.0f;
  last = 0.0f;
  for (int t = 0; t < steps; ++t) {
    float g;
    bool ok = true;
    float f = objective<OBJ, RIS, FAST>(w, txx, txy, px, py, theta, g, ok);
    float m1 = kOneMinusB1 * g + kB1 * m;
    float v1 = kOneMinusB2 * (g * g) + kB2 * v;
    float m_hat, v_hat;
    if (FAST) {
      float4 d = __ldg(rb + t);
      // m decays by b1 a step wherever g is exactly 0, which the RIS
      // residual gives at many pixels, and soon leaves div_ok's range: in
      // the RIS loop its quotient stays an IEEE division (a slow step costs
      // more than the division).
      if (RIS == 1) {
        m_hat = m1 / d.x;
      } else {
        m_hat = div_by(m1, d.x, d.y);
        ok = ok && div_ok(m1);
      }
      v_hat = div_by(v1, d.z, d.w);
      ok = ok && rb_ok && div_ok(v1);
      float th = theta + kNegLr * (m_hat / (sqrtf(v_hat + kAdamEpsRoot) + kAdamEps));
      if (!ok) {
        float4 o = slow_step<OBJ, RIS>(w, txx, txy, px, py, theta, m, v, d.x, d.z);
        f = o.x;
        m1 = o.y;
        v1 = o.z;
        th = o.w;
      }
      theta = th;
    } else {
      m_hat = m1 / (1.0f - __ldg(bc + t));
      v_hat = v1 / (1.0f - __ldg(bc + steps + t));
      theta = theta + kNegLr * (m_hat / (sqrtf(v_hat + kAdamEpsRoot) + kAdamEps));
    }
    m = m1;
    v = v1;
    last = f;
  }
  return theta;
}

// valid * power of one order-1 candidate (wall w, index wi) at pixel p.
template <int SOFT, int OBJ, bool FAST>
__device__ __forceinline__ float candidate(const WallRec* __restrict__ sw, int W, int wi,
                                           float theta, const float* __restrict__ bc,
                                           const float4* __restrict__ rb, bool rb_ok,
                                           int steps, float txx, float txy, float px,
                                           float py, const Scalars& s) {
  const WallRec& w = sw[wi];
  float last;
  if (!FAST) {
    theta = adam<OBJ, -1, false>(w, txx, txy, px, py, theta, bc, rb, rb_ok, steps, last);
  } else {
    // The loop reads a copy in registers: the record's address never
    // reaches slow_step, so no call in the loop makes its loads stale.
    const WallRec wr = w;
    if (OBJ == OBJ_MPT && wr.kind == KIND_RIS)
      theta = adam<OBJ, 1, true>(wr, txx, txy, px, py, theta, bc, rb, rb_ok, steps, last);
    else
      theta = adam<OBJ, 0, true>(wr, txx, txy, px, py, theta, bc, rb, rb_ok, steps, last);
  }
  float bx = w.ax + theta * w.dx, by = w.ay + theta * w.dy;
  float unused_x, unused_y;
  bool unused = true;
  float loss = OBJ == OBJ_MPT ? last
                              : residual<false, -1, false>(w, txx, txy, px, py, bx, by,
                                                           unused_x, unused_y, unused);

  // Blocked test: both segments against every wall but this one and the
  // vertices; the running max of the deferred-clamp margins.
  float blk = -INFINITY;
  for (int k = 0; k < W; ++k) {
    const WallRec& o = sw[k];
    if (k == wi || o.kind == KIND_VERTEX) continue;
    blk = pmax(blk, seg_margin<SOFT>(o, txx, txy, bx, by, s.alpha));
  }
  for (int k = 0; k < W; ++k) {
    const WallRec& o = sw[k];
    if (k == wi || o.kind == KIND_VERTEX) continue;
    blk = pmax(blk, seg_margin<SOFT>(o, bx, by, px, py, s.alpha));
  }

  // On-object test on the bounce's projected parameter, as the plain
  // version forms it (geometry_ops.cartesian_to_parametric); the TPU kernel
  // takes theta itself, equal up to rounding.
  float t = ((bx - w.ax) * w.dx + (by - w.ay) * w.dy) / w.sq;
  float valid;
  if (SOFT == SOFT_NONE) {
    bool on = t >= 0.0f && t <= 1.0f;
    valid = (on && !(blk > 0.0f) && loss < s.tol) ? 1.0f : 0.0f;
  } else {
    // on and the loss gate fold into one activation of the smaller margin
    // (monotone activations commute with min); the blocked complement stays
    // 1 - act(m), as in power_map_common.cuh's contrib.
    float z_ol = pmin(pmin(zmargin<SOFT>(t, s.alpha), zmargin<SOFT>(1.0f - t, s.alpha)),
                      zmargin<SOFT>(s.tol - loss, s.alpha));
    float pre;
    if (SOFT == SOFT_SIGMOID) {
      float blk_act = pmin(pmax(sigm(blk), 0.0f), 1.0f);
      pre = pmin(sigm(z_ol), 1.0f - blk_act);
    } else {
      pre = pmin(pmin(pmax(z_ol, 0.0f), 6.0f) / 6.0f, 1.0f - clip01_6(blk));
    }
    valid = nan_to_num(pre);
  }
  float r = norm2(bx - txx + kEps, by - txy + kEps) + norm2(px - bx + kEps, py - by + kEps);
  return valid * (s.r_coef / (s.height * s.height + r * r));
}

// rb[t] = (1 - bc[t], its reciprocal, 1 - bc[steps + t], its reciprocal),
// each divisor as the sequential kernel forms it and each reciprocal an IEEE
// division; rb[steps].x = 1 where every divisor passes div_ok_b, else 0.  One
// block, once per launch.
__global__ void __launch_bounds__(OS_BLOCK)
    bias_recip_kernel(const float* __restrict__ bc, int steps, float4* __restrict__ rb) {
  bool ok = true;
  for (int t = threadIdx.x; t < steps; t += blockDim.x) {
    float d1 = 1.0f - bc[t], d2 = 1.0f - bc[steps + t];
    rb[t] = make_float4(d1, 1.0f / d1, d2, 1.0f / d2);
    ok = ok && div_ok_b(d1) && div_ok_b(d2);
  }
  ok = __syncthreads_and(ok);
  if (threadIdx.x == 0) rb[steps] = make_float4(ok ? 1.0f : 0.0f, 0.0f, 0.0f, 0.0f);
}

// FAST = false keeps the static 512-record wall array of the first kernel;
// FAST = true takes W records of dynamic shared memory, its own RIS and wall
// loops and the shared reciprocals.
template <int SOFT, int OBJ, bool FAST>
__global__ void __launch_bounds__(OS_BLOCK)
    opt_solver_kernel(const float* __restrict__ px, const float* __restrict__ py, int P,
                      const float* __restrict__ tx, const float* __restrict__ walls,
                      const int* __restrict__ kind, const float* __restrict__ sinp,
                      const float* __restrict__ cosp, int W, const int* __restrict__ cand,
                      const float* __restrict__ x0, int C, const float* __restrict__ bc,
                      const float4* __restrict__ rb, int steps, Scalars s, int accumulate,
                      float* __restrict__ out) {
  __shared__ WallRec sw_static[FAST ? 1 : OS_MAX_WALLS];
  extern __shared__ __align__(16) unsigned char os_dyn[];
  WallRec* sw = FAST ? reinterpret_cast<WallRec*>(os_dyn) : sw_static;
  for (int i = threadIdx.x; i < W; i += blockDim.x) {
    WallRec r;
    r.ax = walls[4 * i + 0];
    r.ay = walls[4 * i + 1];
    r.bx = walls[4 * i + 2];
    r.by = walls[4 * i + 3];
    r.dx = r.bx - r.ax;
    r.dy = r.by - r.ay;
    float nx = r.dy, ny = -r.dx;
    float len = sqrtf(nx * nx + ny * ny);
    float safe = len == 0.0f ? 1.0f : len;
    r.nx = nx / safe;
    r.ny = ny / safe;
    float sq = r.dx * r.dx + r.dy * r.dy;
    r.sq = sq == 0.0f ? 1.0f : sq;
    r.pax = r.ax - s.patch * r.dx;
    r.pay = r.ay - s.patch * r.dy;
    r.pbx = r.bx + s.patch * r.dx;
    r.pby = r.by + s.patch * r.dy;
    r.sinp = sinp[i];
    r.cosp = cosp[i];
    r.kind = kind[i];
    sw[i] = r;
  }
  __syncthreads();

  int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  float x = px[p], y = py[p];
  float txx = __ldg(tx), txy = __ldg(tx + 1);
  bool rb_ok = FAST && __ldg(&rb[steps].x) != 0.0f;
  float acc = 0.0f;
  for (int c = 0; c < C; ++c) {
    acc = acc + candidate<SOFT, OBJ, FAST>(sw, W, __ldg(cand + c), __ldg(x0 + c), bc, rb,
                                           rb_ok, steps, txx, txy, x, y, s);
  }
  out[p] = accumulate ? out[p] + acc : acc;
}

using SolverKernel = void (*)(const float*, const float*, int, const float*, const float*,
                             const int*, const float*, const float*, int, const int*,
                             const float*, int, const float*, const float4*, int, Scalars, int,
                             float*);

// The instantiation for (objective, soft_mode), both checked by bad_args.
template <bool FAST>
SolverKernel select_kernel(int objective, int soft_mode) {
  if (objective == OBJ_FERMAT) {
    if (soft_mode == SOFT_NONE) return opt_solver_kernel<SOFT_NONE, OBJ_FERMAT, FAST>;
    if (soft_mode == SOFT_HARD) return opt_solver_kernel<SOFT_HARD, OBJ_FERMAT, FAST>;
    return opt_solver_kernel<SOFT_SIGMOID, OBJ_FERMAT, FAST>;
  }
  if (soft_mode == SOFT_NONE) return opt_solver_kernel<SOFT_NONE, OBJ_MPT, FAST>;
  if (soft_mode == SOFT_HARD) return opt_solver_kernel<SOFT_HARD, OBJ_MPT, FAST>;
  return opt_solver_kernel<SOFT_SIGMOID, OBJ_MPT, FAST>;
}

bool bad_args(int objective, int soft_mode, int P, int W, int C, int steps) {
  return P <= 0 || W < 0 || W > OS_MAX_WALLS || C < 0 || steps < 1 ||
         soft_mode < SOFT_NONE || soft_mode > SOFT_SIGMOID ||
         (objective != OBJ_FERMAT && objective != OBJ_MPT);
}

}  // namespace

extern "C" {

// Order-1 solver map of one transmitter tx[2]: out[P] = (accumulate ?
// out[P] : 0) + the sum over the candidates cand[C] (wall indices, x0[C]
// their initial parameters) of valid * power.  objective: 0 Fermat, 1 MPT;
// bc[2 * steps]: b1**count then b2**count; scratch: float32[4 * (steps +
// 1)] of device memory (the reciprocal table, written by the launch).
// Returns cudaGetLastError() after the launch.
int opt_solver_value(int objective, int soft_mode, const float* px, const float* py, int P,
                     const float* tx, const float* walls, const int* kind, const float* sinp,
                     const float* cosp, int W, const int* cand, const float* x0, int C,
                     const float* bc, int steps, float* scratch, float alpha, float tol,
                     float patch, float r_coef, float height, int accumulate, float* out,
                     void* stream) {
  if (bad_args(objective, soft_mode, P, W, C, steps) || !scratch)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();  // clear any earlier error of this runtime
  Scalars s{alpha, tol, patch, r_coef, height};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float4* rb = reinterpret_cast<float4*>(scratch);
  bias_recip_kernel<<<1, OS_BLOCK, 0, st>>>(bc, steps, rb);
  dim3 grid((P + OS_BLOCK - 1) / OS_BLOCK), block(OS_BLOCK);
  size_t smem = static_cast<size_t>(W) * sizeof(WallRec);
  select_kernel<true>(objective, soft_mode)<<<grid, block, smem, st>>>(
      px, py, P, tx, walls, kind, sinp, cosp, W, cand, x0, C, bc, rb, steps, s, accumulate, out);
  return static_cast<int>(cudaGetLastError());
}

// The same map through the kernel as it was before the redesign (IEEE
// division for every quotient, a static 512-record wall array, 128
// threads): the redesign's bitwise reference, called by checks only.  It
// takes opt_solver_value's arguments and ignores scratch.
int opt_solver_value_seq(int objective, int soft_mode, const float* px, const float* py,
                         int P, const float* tx, const float* walls, const int* kind,
                         const float* sinp, const float* cosp, int W, const int* cand,
                         const float* x0, int C, const float* bc, int steps, float* scratch,
                         float alpha, float tol, float patch, float r_coef, float height,
                         int accumulate, float* out, void* stream) {
  (void)scratch;
  if (bad_args(objective, soft_mode, P, W, C, steps))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();
  Scalars s{alpha, tol, patch, r_coef, height};
  dim3 grid((P + OS_BLOCK - 1) / OS_BLOCK), block(OS_BLOCK);
  select_kernel<false>(objective, soft_mode)<<<grid, block, 0,
                                                      static_cast<cudaStream_t>(stream)>>>(
      px, py, P, tx, walls, kind, sinp, cosp, W, cand, x0, C, bc, nullptr, steps, s,
      accumulate, out);
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks of 128 threads per SM of the kernel for (objective,
// soft_mode), the redesign (fast = 1, W records of shared memory) or the
// sequential twin (fast = 0), into *blocks.
int opt_solver_occupancy(int objective, int soft_mode, int fast, int W, int* blocks) {
  if (bad_args(objective, soft_mode, 1, W, 0, 1)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, fast ? select_kernel<true>(objective, soft_mode)
                   : select_kernel<false>(objective, soft_mode),
      OS_BLOCK, fast ? static_cast<size_t>(W) * sizeof(WallRec) : 0));
}

}  // extern "C"

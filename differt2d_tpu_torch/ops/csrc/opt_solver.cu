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
// A first, simple kernel: the order-1 candidates of a RIS map are few, and
// the adam loop (tens of flops per step, all in registers) is its work;
// making it fast is later work.
//
// Bound on the H100: FP32 operations.  A 1024x1024 RIS map at 1000 steps
// reads 8 B and writes 4 B per pixel against about 57k operations per pixel
// (chip_smoke.solver_ops).  The IEEE divisions and square roots of each step
// (about ten and two) are instruction sequences, and kept as they are for
// the trajectories above; the kernel ran at about 9% of that bound on an
// NVIDIA H100 80GB HBM3 at 700 W (PERF.md).
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

// The unit vector of (vx, vy) as the plain version's geometry_ops.normalize
// forms it (n2 = vx^2 + vy^2, the double-where guard, then v / |v|), with
// what its backward needs.
struct Unit {
  float vx, vy;  // the vector
  float sq;      // sqrt(n2), 1 where n2 == 0
  float S;       // the divisor: |v|, 1 where n2 == 0
  float ux, uy;  // v / S
  bool z;        // n2 == 0
};

__device__ __forceinline__ Unit unit(float vx, float vy) {
  Unit u;
  float n2 = vx * vx + vy * vy;
  u.z = n2 == 0.0f;
  u.sq = sqrtf(u.z ? 1.0f : n2);
  float len = u.z ? 0.0f : u.sq;
  u.S = u.z ? 1.0f : len;
  u.vx = vx;
  u.vy = vy;
  u.ux = vx / u.S;
  u.uy = vy / u.S;
  return u;
}

// Cotangent (gx, gy) of the unit vector -> cotangent of v, by the rules
// PyTorch's autograd applies to normalize (DivBackward0: g / S and
// -g * ((v / S) / S) summed over the axis; the two wheres; SqrtBackward0:
// g / (2 sqrt); MulBackward0 of v * v: g v for each factor), summed in the
// order autograd accumulates them: the division's term first, then the two
// factors' terms one by one.
__device__ __forceinline__ void unit_back(const Unit& u, float gx, float gy, float& ovx,
                                          float& ovy) {
  float gS = (-gx) * (u.ux / u.S) + (-gy) * (u.uy / u.S);
  float gsq = u.z ? 0.0f : gS;
  float gn = u.z ? 0.0f : gsq / (2.0f * u.sq);
  ovx = (gx / u.S + gn * u.vx) + gn * u.vx;
  ovy = (gy / u.S + gn * u.vy) + gn * u.vy;
}

// The interaction residual at the bounce (bx, by) on wall w, and with G its
// cotangent on the bounce (gbx, gby): RIS residual (constant outgoing
// angle) or specular residual, in the plain version's op order
// (geometry_ops.ris_residual / specular_residual) and its autograd's
// backward.
template <bool G>
__device__ __forceinline__ float residual(const WallRec& w, float txx, float txy, float px,
                                          float py, float bx, float by, float& gbx,
                                          float& gby) {
  Unit r = unit(px - bx, py - by);
  float grx, gry;
  float f;
  if (w.kind == KIND_RIS) {
    float sin_a = (-r.ux) * w.ny - (-r.uy) * w.nx;
    float cos_a = (-r.ux) * w.nx + (-r.uy) * w.ny;
    float es = sin_a - w.sinp, ec = cos_a - w.cosp;
    f = es * es + ec * ec;
    if (!G) return f;
    float ges = 2.0f * es, gec = 2.0f * ec;
    grx = (-(ges * w.ny)) + (-(gec * w.nx));
    gry = (ges * w.nx) + (-(gec * w.ny));
    float gwx, gwy;
    unit_back(r, grx, gry, gwx, gwy);
    gbx = -gwx;
    gby = -gwy;
    return f;
  }
  Unit i = unit(bx - txx, by - txy);
  float k = 2.0f * (i.ux * w.nx + i.uy * w.ny);
  float ex = r.ux - (i.ux - k * w.nx);
  float ey = r.uy - (i.uy - k * w.ny);
  f = ex * ex + ey * ey;
  if (!G) return f;
  float gex = ex + ex, gey = ey + ey;
  float gs = (gex * w.nx + gey * w.ny) * 2.0f;
  float gvx, gvy, gwx, gwy;
  unit_back(i, (-gex) + gs * w.nx, (-gey) + gs * w.ny, gvx, gvy);
  unit_back(r, gex, gey, gwx, gwy);
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
template <int OBJ>
__device__ __forceinline__ float objective(const WallRec& w, float txx, float txy, float px,
                                           float py, float theta, float& dtheta) {
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
    f = residual<true>(w, txx, txy, px, py, bx, by, gbx, gby);
  }
  dtheta = gbx * w.dx + gby * w.dy;
  return f;
}

// valid * power of one order-1 candidate (wall w, index wi) at pixel p.
template <int SOFT, int OBJ>
__device__ __forceinline__ float candidate(const WallRec* __restrict__ sw, int W, int wi,
                                           float theta, const float* __restrict__ bc,
                                           int steps, float txx, float txy, float px,
                                           float py, const Scalars& s) {
  const WallRec& w = sw[wi];
  float m = 0.0f, v = 0.0f, last = 0.0f;
  for (int t = 0; t < steps; ++t) {
    float g;
    float f = objective<OBJ>(w, txx, txy, px, py, theta, g);
    m = kOneMinusB1 * g + kB1 * m;
    v = kOneMinusB2 * (g * g) + kB2 * v;
    float m_hat = m / (1.0f - __ldg(bc + t));
    float v_hat = v / (1.0f - __ldg(bc + steps + t));
    theta = theta + kNegLr * (m_hat / (sqrtf(v_hat + kAdamEpsRoot) + kAdamEps));
    last = f;
  }
  float bx = w.ax + theta * w.dx, by = w.ay + theta * w.dy;
  float unused_x, unused_y;
  float loss = OBJ == OBJ_MPT ? last
                              : residual<false>(w, txx, txy, px, py, bx, by, unused_x, unused_y);

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

template <int SOFT, int OBJ>
__global__ void __launch_bounds__(OS_BLOCK)
    opt_solver_kernel(const float* __restrict__ px, const float* __restrict__ py, int P,
                      const float* __restrict__ tx, const float* __restrict__ walls,
                      const int* __restrict__ kind, const float* __restrict__ sinp,
                      const float* __restrict__ cosp, int W, const int* __restrict__ cand,
                      const float* __restrict__ x0, int C, const float* __restrict__ bc,
                      int steps, Scalars s, int accumulate, float* __restrict__ out) {
  __shared__ WallRec sw[OS_MAX_WALLS];
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
  float acc = 0.0f;
  for (int c = 0; c < C; ++c) {
    acc = acc + candidate<SOFT, OBJ>(sw, W, __ldg(cand + c), __ldg(x0 + c), bc, steps, txx,
                                     txy, x, y, s);
  }
  out[p] = accumulate ? out[p] + acc : acc;
}

template <int OBJ>
void launch_obj(int soft_mode, dim3 grid, dim3 block, cudaStream_t stream, const float* px,
                const float* py, int P, const float* tx, const float* walls, const int* kind,
                const float* sinp, const float* cosp, int W, const int* cand, const float* x0,
                int C, const float* bc, int steps, Scalars s, int accumulate, float* out) {
  switch (soft_mode) {
    case SOFT_NONE:
      opt_solver_kernel<SOFT_NONE, OBJ><<<grid, block, 0, stream>>>(
          px, py, P, tx, walls, kind, sinp, cosp, W, cand, x0, C, bc, steps, s, accumulate, out);
      break;
    case SOFT_HARD:
      opt_solver_kernel<SOFT_HARD, OBJ><<<grid, block, 0, stream>>>(
          px, py, P, tx, walls, kind, sinp, cosp, W, cand, x0, C, bc, steps, s, accumulate, out);
      break;
    default:
      opt_solver_kernel<SOFT_SIGMOID, OBJ><<<grid, block, 0, stream>>>(
          px, py, P, tx, walls, kind, sinp, cosp, W, cand, x0, C, bc, steps, s, accumulate, out);
      break;
  }
}

}  // namespace

extern "C" {

// Order-1 solver map of one transmitter tx[2]: out[P] = (accumulate ?
// out[P] : 0) + the sum over the candidates cand[C] (wall indices, x0[C]
// their initial parameters) of valid * power.  objective: 0 Fermat, 1 MPT;
// bc[2 * steps]: b1**count then b2**count.  Returns cudaGetLastError()
// after the launch.
int opt_solver_value(int objective, int soft_mode, const float* px, const float* py, int P,
                     const float* tx, const float* walls, const int* kind, const float* sinp,
                     const float* cosp, int W, const int* cand, const float* x0, int C,
                     const float* bc, int steps, float alpha, float tol, float patch,
                     float r_coef, float height, int accumulate, float* out, void* stream) {
  if (P <= 0 || W < 0 || W > OS_MAX_WALLS || C < 0 || steps < 1 ||
      soft_mode < SOFT_NONE || soft_mode > SOFT_SIGMOID ||
      (objective != OBJ_FERMAT && objective != OBJ_MPT))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();  // clear any earlier error of this runtime
  Scalars s{alpha, tol, patch, r_coef, height};
  dim3 grid((P + OS_BLOCK - 1) / OS_BLOCK), block(OS_BLOCK);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (objective == OBJ_FERMAT)
    launch_obj<OBJ_FERMAT>(soft_mode, grid, block, st, px, py, P, tx, walls, kind, sinp, cosp,
                           W, cand, x0, C, bc, steps, s, accumulate, out);
  else
    launch_obj<OBJ_MPT>(soft_mode, grid, block, st, px, py, P, tx, walls, kind, sinp, cosp, W,
                        cand, x0, C, bc, steps, s, accumulate, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

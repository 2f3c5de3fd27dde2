// Power-map kernels for NVIDIA Hopper (sm_90a): power_map_value and
// power_map_vag.
//
// Replaces the unrolled Pallas TPU kernel
// differt2d_tpu/ops/pallas_kernels.py::build_power_map_kernel
// (pallas_call at :891): power_map_value is its mode="value" (B1),
// power_map_vag its mode="value_and_grad" (B2, make_contrib(want_grad=True),
// :434-838).  Both compute, per receiver-grid pixel and summed over the
// transmitters and the path candidates of the image solver,
//
//     valid * r_coef**order / (height**2 + r**2),
//
// with the image-method bounce chain, the on-object margins, the residual
// loss gate and the blocked test of every path segment against every
// non-adjacent wall; power_map_vag adds the hand-derived pixel gradient
// (rank-1 bounce Jacobians, image-method stationarity shortcuts for
// unbroken chains, full formulas after a vertex, and min/max selects that
// split exact ties 0.5/0.5 as XLA's min/max JVPs do).
//
// Design: one thread per pixel, and a loop inside the thread over
// transmitters, candidates, path segments and walls.  Each block first
// copies the per-wall data it needs (endpoints, unit normal, patched
// endpoints, sin/cos of the RIS phase, kind) into shared memory, computed
// from the wall tensors at launch, so a wall edited between launches is
// never stale.  Candidate rows (order, then wall indices) sit in a small
// device buffer that every thread of a warp reads at the same address.
// Transmitters are summed inside the kernel: one launch per map.  The
// candidate routine is a template on the order, so the per-bounce arrays
// stay in registers.  Caps: W <= PM_MAX_WALLS, order <= PM_MAX_ORDER; the
// wrapper raises above them (power_map_kernel.py's MAX_WALLS and MAX_ORDER
// repeat these defines, and a test holds them equal).
//
// Bound on the H100: FP32 compute.  A 1024x1024 map of the basic scene
// (order <= 1: 8 candidates, 7 walls) reads 8 B and writes 4 B per pixel
// (12 B/px; 20 B/px with the gradient) against a few thousand flops per
// pixel, so bytes never bound it.  This first version does nothing about
// that beyond keeping every intermediate in registers: it is the simple,
// right kernel, and making it fast is later work.
//
// Numerics: built without --use_fast_math; the sigmoid uses expf, not
// __expf (its f32 saturation was measured under flush-to-zero, see
// pallas_kernels.py:68-100).  Built with -fmad=false (ops/_build.py): nvcc
// would contract a*b+c into one FMA, and with contraction one pixel of a
// 256x256 transmitter-grid map left rtol 1e-4 / atol 1e-5 against the plain
// version (measured on the H100); any two maps that must agree bit for bit
// (culled vs unculled, a later slice) still have to come from one build.
// min/max propagate NaN as XLA's do (CUDA's fminf/fmaxf would drop it), and
// the explicit [0, 1] clamps after the /6 are kept
// (pallas_kernels.py:195-206, :238-240).

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

#define PM_MAX_ORDER 4
#define PM_MAX_WALLS 512
#define PM_ROW (PM_MAX_ORDER + 1)
#define PM_BLOCK 128

namespace {

constexpr int KIND_RIS = 1;
constexpr int KIND_VERTEX = 2;

constexpr int SOFT_NONE = 0;     // hard (boolean) logic
constexpr int SOFT_HARD = 1;     // soft logic, hard_sigmoid activation
constexpr int SOFT_SIGMOID = 2;  // soft logic, sigmoid activation

constexpr int ST_Z = 0;  // path point constant in the pixel
constexpr int ST_P = 1;  // path point is the pixel
constexpr int ST_R = 2;  // path point moves along its wall: rank-1 Jacobian

constexpr float kEps = 1.1920929e-07f;  // float32 machine epsilon
constexpr float kTolIntersect = 0.005f;  // blocked-test parameter margin
constexpr float kOnePlusTol = 1.005f;

struct WallRec {
  float ax, ay, bx, by;      // endpoints
  float nx, ny;              // unit normal, (0, 0) for a zero-length wall
  float dx, dy;              // direction b - a
  float sq;                  // |b - a|^2, 1 where it is 0
  float pax, pay, pbx, pby;  // endpoints grown by `patch`
  float sinp, cosp;          // RIS phase
  int kind;
};

struct Scalars {
  float alpha, tol, patch, r_coef, height;
};

// NaN-propagating min/max (XLA semantics); ties return b, the same value.
__device__ __forceinline__ float pmin(float a, float b) {
  return (a != a || a < b) ? a : b;
}
__device__ __forceinline__ float pmax(float a, float b) {
  return (a != a || a > b) ? a : b;
}
__device__ __forceinline__ float clip01_6(float z) {  // clip(clip(z,0,6)/6,0,1)
  return pmin(pmax(pmin(pmax(z, 0.0f), 6.0f) / 6.0f, 0.0f), 1.0f);
}
__device__ __forceinline__ float nan_to_num(float x) {
  if (x != x) return 0.0f;
  if (x == INFINITY) return FLT_MAX;
  if (x == -INFINITY) return -FLT_MAX;
  return x;
}
__device__ __forceinline__ float sigm(float z) { return 1.0f / (1.0f + expf(-z)); }
__device__ __forceinline__ float hsig(float z) {  // relu6(z + 3) / 6
  return pmin(pmax(z + 3.0f, 0.0f), 6.0f) / 6.0f;
}

template <int SOFT>
__device__ __forceinline__ float soft(float x, float alpha) {
  return SOFT == SOFT_SIGMOID ? sigm(alpha * x) : hsig(alpha * x);
}
// d soft(x) / dx: alpha s (1 - s) for the sigmoid; alpha / 6 inside the
// hard_sigmoid band, 0 outside and at its ends.
template <int SOFT>
__device__ __forceinline__ float soft_grad(float x, float alpha) {
  if (SOFT == SOFT_SIGMOID) {
    float s = sigm(alpha * x);
    return alpha * s * (1.0f - s);
  }
  float ax = alpha * x;
  return (ax > -3.0f && ax < 3.0f) ? alpha / 6.0f : 0.0f;
}
// Pre-activation margin: soft(x) == act(zmargin(x)).
template <int SOFT>
__device__ __forceinline__ float zmargin(float x, float alpha) {
  float z = alpha * x;
  return SOFT == SOFT_SIGMOID ? z : z + 3.0f;
}
// Gradients of min(a, b) / max(a, b): the selected argument's, split
// 0.5/0.5 at exact ties.
__device__ __forceinline__ float min_sel(float a, float b, float da, float db) {
  return a < b ? da : (a > b ? db : 0.5f * (da + db));
}
__device__ __forceinline__ float max_sel(float a, float b, float da, float db) {
  return a > b ? da : (a < b ? db : 0.5f * (da + db));
}
__device__ __forceinline__ float norm2(float x, float y) { return sqrtf(x * x + y * y); }
// Unit vector with a zero-vector guard (returns (0, 0) for it).
__device__ __forceinline__ void normalize(float x, float y, float& ox, float& oy) {
  float n2 = x * x + y * y;
  bool zero = n2 == 0.0f;
  float inv = 1.0f / sqrtf(zero ? 1.0f : n2);
  inv = zero ? 1.0f : inv;
  ox = x * inv;
  oy = y * inv;
}

// Blocked test of wall (a, b) against path segment (c, d) in deferred-clamp
// form (pallas_kernels.py::_seg_intersect_m6): soft logic returns the
// pre-activation margin m with hit = act(m), so the running max over walls
// converts once per candidate (the activations are monotone, so the max of
// the activations is the activation of the max, exactly); hard logic
// returns 1 for a hit and -1 otherwise.  Unlike _seg_intersect_m6, each
// margin is formed in the eager tracer's own order (t = num / den, then
// alpha * (t + tol) + 3), and den == 0 is the parallel test, as in the
// tracer: with a true division there is no reciprocal to overflow and no
// num * inv to form 0 * inf.  Soft-logic maps are steep (slope alpha / 6 per
// unit of t), so a reassociated margin moved values near a blocking edge
// beyond rtol 1e-4 / atol 1e-5 against the plain version (measured on the
// H100: one pixel of a 256x256 transmitter-grid map).
template <int SOFT>
__device__ __forceinline__ float seg_margin(const WallRec& w, float cx, float cy,
                                            float dx, float dy, float alpha) {
  float avx = w.pbx - w.pax, avy = w.pby - w.pay;
  float bvx = cx - dx, bvy = cy - dy;
  float cvx = w.pax - cx, cvy = w.pay - cy;
  float num_a = bvy * cvx - bvx * cvy;
  float num_b = avx * cvy - avy * cvx;
  float den = avy * bvx - avx * bvy;
  if (den == 0.0f) return SOFT != SOFT_NONE ? -INFINITY : -1.0f;  // t = +inf
  float t_a = num_a / den, t_b = num_b / den;
  if (SOFT == SOFT_NONE) {
    bool hit = t_a >= -kTolIntersect && t_a <= kOnePlusTol &&
               t_b >= -kTolIntersect && t_b <= kOnePlusTol;
    return hit ? 1.0f : -1.0f;
  }
  return pmin(pmin(zmargin<SOFT>(t_a + kTolIntersect, alpha),
                   zmargin<SOFT>(kOnePlusTol - t_a, alpha)),
              pmin(zmargin<SOFT>(t_b + kTolIntersect, alpha),
                   zmargin<SOFT>(kOnePlusTol - t_b, alpha)));
}

// Soft blocked test with its partials w.r.t. the segment ends c and d
// (pallas_kernels.py::_seg_intersect_vag).
template <int SOFT>
__device__ __forceinline__ float seg_vag(const WallRec& w, float cx, float cy,
                                         float dx, float dy, float alpha,
                                         float& dcx, float& dcy, float& ddx,
                                         float& ddy) {
  float avx = w.pbx - w.pax, avy = w.pby - w.pay;
  float bvx = cx - dx, bvy = cy - dy;
  float cvx = w.pax - cx, cvy = w.pay - cy;
  float num_a = bvy * cvx - bvx * cvy;
  float num_b = avx * cvy - avy * cvx;
  float den = avy * bvx - avx * bvy;
  bool dz = den == 0.0f;
  float safe_den = dz ? 1.0f : den;
  float inv_den = dz ? 0.0f : 1.0f / safe_den;
  float t_a = dz ? INFINITY : num_a / safe_den;
  float t_b = dz ? INFINITY : num_b / safe_den;

  float ge_a = soft<SOFT>(t_a + kTolIntersect, alpha);
  float le_a = soft<SOFT>(kOnePlusTol - t_a, alpha);
  float inr_a = pmin(ge_a, le_a);
  float dinr_a = min_sel(ge_a, le_a, soft_grad<SOFT>(t_a + kTolIntersect, alpha),
                         -soft_grad<SOFT>(kOnePlusTol - t_a, alpha));
  float ge_b = soft<SOFT>(t_b + kTolIntersect, alpha);
  float le_b = soft<SOFT>(kOnePlusTol - t_b, alpha);
  float inr_b = pmin(ge_b, le_b);
  float dinr_b = min_sel(ge_b, le_b, soft_grad<SOFT>(t_b + kTolIntersect, alpha),
                         -soft_grad<SOFT>(kOnePlusTol - t_b, alpha));
  float hit = pmin(inr_a, inr_b);
  float g_a = min_sel(inr_a, inr_b, dinr_a, 0.0f);
  float g_b = min_sel(inr_a, inr_b, 0.0f, dinr_b);
  // Zero (not inf) t in the partials where den == 0: inv_den = 0 kills
  // them, and inf * 0 would be NaN.
  float ts_a = dz ? 0.0f : t_a;
  float ts_b = dz ? 0.0f : t_b;
  float dta_cx = (-bvy - cvy - ts_a * avy) * inv_den;
  float dta_cy = (cvx + bvx + ts_a * avx) * inv_den;
  float dta_dx = (cvy + ts_a * avy) * inv_den;
  float dta_dy = (-cvx - ts_a * avx) * inv_den;
  float dtb_cx = (avy - ts_b * avy) * inv_den;
  float dtb_cy = (-avx + ts_b * avx) * inv_den;
  float dtb_dx = (ts_b * avy) * inv_den;
  float dtb_dy = (-ts_b * avx) * inv_den;
  dcx = g_a * dta_cx + g_b * dtb_cx;
  dcy = g_a * dta_cy + g_b * dtb_cy;
  ddx = g_a * dta_dx + g_b * dtb_dx;
  ddy = g_a * dta_dy + g_b * dtb_dy;
  return hit;
}

// Jacobian state of the path points of one candidate: point k is the
// transmitter (k = 0), bounce k - 1, or the pixel (k = O + 1).
template <int O>
struct Chain {
  float x[O + 2], y[O + 2];
  int st[O + 2];
  float sdx[O + 2], sdy[O + 2], sgx[O + 2], sgy[O + 2];

  // (w . d point_k / d pixel)
  __device__ __forceinline__ void contract(int k, float wx, float wy, float& ox,
                                           float& oy) const {
    if (st[k] == ST_Z) {
      ox = 0.0f;
      oy = 0.0f;
    } else if (st[k] == ST_P) {
      ox = wx;
      oy = wy;
    } else {
      float kk = wx * sdx[k] + wy * sdy[k];
      ox = kk * sgx[k];
      oy = kk * sgy[k];
    }
  }
};

// Contribution valid * power of one candidate of order O (and, with G, its
// pixel gradient).  `ids` holds the O wall indices.
template <bool G, int SOFT, int O>
__device__ __forceinline__ void contrib(const WallRec* __restrict__ sw, int W,
                                        const int* __restrict__ ids, float txx,
                                        float txy, float px, float py,
                                        const Scalars& s, float& val, float& gx,
                                        float& gy) {
  int id[O > 0 ? O : 1];
#pragma unroll
  for (int j = 0; j < O; ++j) id[j] = __ldg(ids + j);

  // Forward mirror images of the transmitter (a vertex is the identity).
  float imx[O > 0 ? O : 1], imy[O > 0 ? O : 1];
  {
    float ix = txx, iy = txy;
#pragma unroll
    for (int j = 0; j < O; ++j) {
      const WallRec& r = sw[id[j]];
      if (r.kind != KIND_VERTEX) {
        float d = (ix - r.ax) * r.nx + (iy - r.ay) * r.ny;
        ix = ix - 2.0f * d * r.nx;
        iy = iy - 2.0f * d * r.ny;
      }
      imx[j] = ix;
      imy[j] = iy;
    }
  }

  // Backward bounce recursion (vertex pinning); with G, the rank-1
  // Jacobians ride along: the downstream point starts at the pixel, after
  // a wall bounce it lives on that wall's line, after a vertex it is
  // constant.
  Chain<O> ch;
  ch.x[0] = txx;
  ch.y[0] = txy;
  ch.st[0] = ST_Z;
  ch.x[O + 1] = px;
  ch.y[O + 1] = py;
  ch.st[O + 1] = ST_P;
  {
    float ptx = px, pty = py;
    int state = ST_P;
    float pdx = 0.0f, pdy = 0.0f, pgx = 0.0f, pgy = 0.0f;
#pragma unroll
    for (int j = O - 1; j >= 0; --j) {
      const WallRec& r = sw[id[j]];
      if (r.kind == KIND_VERTEX) {
        ptx = r.ax;
        pty = r.ay;
        state = ST_Z;
        ch.x[j + 1] = ptx;
        ch.y[j + 1] = pty;
        ch.st[j + 1] = ST_Z;
        continue;
      }
      float ux = ptx - imx[j], uy = pty - imy[j];
      float un = ux * r.nx + uy * r.ny;
      bool unz = un == 0.0f;
      float safe_un = unz ? 1.0f : un;
      float vn = (r.ax - ptx) * r.nx + (r.ay - pty) * r.ny;
      float sc = unz ? 0.0f : vn / safe_un;
      float nbx = ptx + sc * ux, nby = pty + sc * uy;
      if (G) {
        // dt_j/dq with db/dq = (c/un)(I - u n^T / un); at un == 0 the
        // guard selects b = q, i.e. db/dq = I.
        float c_im = (r.ax - imx[j]) * r.nx + (r.ay - imy[j]) * r.ny;
        float f = unz ? 0.0f : c_im / safe_un;
        float g = unz ? 0.0f : (ux * r.dx + uy * r.dy) / safe_un;
        float vx = unz ? r.dx / r.sq : f * (r.dx - g * r.nx) / r.sq;
        float vy = unz ? r.dy / r.sq : f * (r.dy - g * r.ny) / r.sq;
        float gtx, gty;
        if (state == ST_P) {
          gtx = vx;
          gty = vy;
        } else if (state == ST_R) {
          float k = vx * pdx + vy * pdy;
          gtx = k * pgx;
          gty = k * pgy;
        } else {
          gtx = 0.0f;
          gty = 0.0f;
        }
        state = ST_R;
        pdx = r.dx;
        pdy = r.dy;
        pgx = gtx;
        pgy = gty;
        ch.sdx[j + 1] = r.dx;
        ch.sdy[j + 1] = r.dy;
        ch.sgx[j + 1] = gtx;
        ch.sgy[j + 1] = gty;
      }
      ch.st[j + 1] = ST_R;
      ptx = nbx;
      pty = nby;
      ch.x[j + 1] = ptx;
      ch.y[j + 1] = pty;
    }
  }

  // A vertex before a wall/RIS bounce breaks the image chain: the
  // stationarity shortcuts no longer hold for that candidate.
  bool broken[O > 0 ? O : 1];
  bool chain_broken = false;
  {
    bool seen_vertex = false;
#pragma unroll
    for (int j = 0; j < O; ++j) {
      broken[j] = seen_vertex;
      int k = sw[id[j]].kind;
      if (seen_vertex && k != KIND_VERTEX) chain_broken = true;
      if (k == KIND_VERTEX) seen_vertex = true;
    }
  }

  // Residual loss; with G, its gradient for RIS terms and for wall terms
  // of a broken chain (elsewhere it is identically zero in the pixel).
  float loss = 0.0f, glx = 0.0f, gly = 0.0f;
  bool has_loss_grad = false;
#pragma unroll
  for (int j = 0; j < O; ++j) {
    const WallRec& r = sw[id[j]];
    if (r.kind == KIND_VERTEX) continue;
    float axc = ch.x[j], ayc = ch.y[j];
    float bxc = ch.x[j + 1], byc = ch.y[j + 1];
    float cxc = ch.x[j + 2], cyc = ch.y[j + 2];
    float rx_, ry_;
    normalize(cxc - bxc, cyc - byc, rx_, ry_);
    if (r.kind == KIND_RIS) {
      float sin_a = (-rx_) * r.ny - (-ry_) * r.nx;
      float cos_a = (-rx_) * r.nx + (-ry_) * r.ny;
      float es = sin_a - r.sinp, ec = cos_a - r.cosp;
      loss = loss + es * es + ec * ec;
      if (G) {
        has_loss_grad = true;
        float wx = 2.0f * es * (-r.ny) + 2.0f * ec * (-r.nx);
        float wy = 2.0f * es * r.nx + 2.0f * ec * (-r.ny);
        float vxs = cxc - bxc, vys = cyc - byc;
        float vn2 = vxs * vxs + vys * vys;
        bool vz = vn2 == 0.0f;
        float inv_vn = vz ? 0.0f : 1.0f / sqrtf(vz ? 1.0f : vn2);
        float rw = rx_ * wx + ry_ * wy;
        float qx = (wx - rx_ * rw) * inv_vn;
        float qy = (wy - ry_ * rw) * inv_vn;
        float cgx, cgy, bgx, bgy;
        ch.contract(j + 2, qx, qy, cgx, cgy);
        ch.contract(j + 1, qx, qy, bgx, bgy);
        glx = glx + cgx - bgx;
        gly = gly + cgy - bgy;
      }
    } else {
      float ivx, ivy;
      normalize(bxc - axc, byc - ayc, ivx, ivy);
      float d = ivx * r.nx + ivy * r.ny;
      float refx = ivx - 2.0f * d * r.nx, refy = ivy - 2.0f * d * r.ny;
      float ex = rx_ - refx, ey = ry_ - refy;
      loss = loss + ex * ex + ey * ey;
      if (G && broken[j]) {
        // Full specular gradient: d spec = 2e.dr - 2eR.di with both
        // normalize Jacobians.
        has_loss_grad = true;
        float swx = 2.0f * ex, swy = 2.0f * ey;
        float vxs = cxc - bxc, vys = cyc - byc;
        float vn2 = vxs * vxs + vys * vys;
        bool vz = vn2 == 0.0f;
        float inv_vn = vz ? 0.0f : 1.0f / sqrtf(vz ? 1.0f : vn2);
        float vix = bxc - axc, viy = byc - ayc;
        float vi2 = vix * vix + viy * viy;
        bool viz = vi2 == 0.0f;
        float inv_vi = viz ? 0.0f : 1.0f / sqrtf(viz ? 1.0f : vi2);
        float rw = rx_ * swx + ry_ * swy;
        float qcx = (swx - rx_ * rw) * inv_vn;
        float qcy = (swy - ry_ * rw) * inv_vn;
        float ndw = r.nx * swx + r.ny * swy;
        float mx = swx - 2.0f * r.nx * ndw;
        float my = swy - 2.0f * r.ny * ndw;
        float imw = ivx * mx + ivy * my;
        float qax = (mx - ivx * imw) * inv_vi;
        float qay = (my - ivy * imw) * inv_vi;
        float cgx, cgy, bgx, bgy, agx, agy;
        ch.contract(j + 2, qcx, qcy, cgx, cgy);
        ch.contract(j + 1, qcx + qax, qcy + qay, bgx, bgy);
        ch.contract(j, qax, qay, agx, agy);
        glx = glx + cgx - bgx + agx;
        gly = gly + cgy - bgy + agy;
      }
    }
  }

  // On-object test.  The soft value path folds the pre-activation
  // margins (monotone activations commute with min exactly).
  constexpr bool fold = SOFT != SOFT_NONE && !G;
  float zon = INFINITY;
  float on = 1.0f, gonx = 0.0f, gony = 0.0f;
  bool onb = true;
#pragma unroll
  for (int j = 0; j < O; ++j) {
    const WallRec& r = sw[id[j]];
    if (r.kind == KIND_VERTEX) continue;
    float t = ((ch.x[j + 1] - r.ax) * r.dx + (ch.y[j + 1] - r.ay) * r.dy) / r.sq;
    if (fold) {
      zon = pmin(zon, pmin(zmargin<SOFT>(t, s.alpha), zmargin<SOFT>(1.0f - t, s.alpha)));
    } else if (SOFT != SOFT_NONE) {
      float c1 = soft<SOFT>(t, s.alpha);
      float c2 = soft<SOFT>(1.0f - t, s.alpha);
      float contains = pmin(c1, c2);
      if (G) {
        // dt/dpixel is the bounce's own rank-1 gradient.
        float dc = min_sel(c1, c2, soft_grad<SOFT>(t, s.alpha),
                           -soft_grad<SOFT>(1.0f - t, s.alpha));
        gonx = min_sel(on, contains, gonx, dc * ch.sgx[j + 1]);
        gony = min_sel(on, contains, gony, dc * ch.sgy[j + 1]);
      }
      on = pmin(on, contains);
    } else {
      onb = onb && (t >= 0.0f) && (t <= 1.0f);
    }
  }

  // Blocked test: every segment against every non-adjacent, non-vertex
  // wall.  Soft+G keeps a running (value, gradient) max; every other mode
  // keeps the running max of the deferred-clamp margin.
  constexpr bool soft_grad_blk = SOFT != SOFT_NONE && G;
  float blk = soft_grad_blk ? 0.0f : -INFINITY;
  float gbx = 0.0f, gby = 0.0f;
#pragma unroll
  for (int seg = 0; seg <= O; ++seg) {
    int skip0 = seg == 0 ? -1 : id[seg - 1];
    int skip1 = seg == O ? -1 : id[seg];
    float sax = ch.x[seg], say = ch.y[seg];
    float sbx = ch.x[seg + 1], sby = ch.y[seg + 1];
    for (int wi = 0; wi < W; ++wi) {
      const WallRec& w = sw[wi];
      if (wi == skip0 || wi == skip1 || w.kind == KIND_VERTEX) continue;
      if (soft_grad_blk) {
        float dcx, dcy, ddx, ddy;
        float hit = seg_vag<SOFT>(w, sax, say, sbx, sby, s.alpha, dcx, dcy, ddx, ddy);
        float h0x, h0y, h1x, h1y;
        ch.contract(seg, dcx, dcy, h0x, h0y);
        ch.contract(seg + 1, ddx, ddy, h1x, h1y);
        float ghx = h0x + h1x, ghy = h0y + h1y;
        gbx = max_sel(blk, hit, gbx, ghx);
        gby = max_sel(blk, hit, gby, ghy);
        blk = pmax(blk, hit);
      } else {
        blk = pmax(blk, seg_margin<SOFT>(w, sax, say, sbx, sby, s.alpha));
      }
    }
  }

  // Validity.
  float valid, gvx = 0.0f, gvy = 0.0f;
  if (fold) {
    // on and the loss gate fold into one activation of the smaller margin;
    // the blocked complement stays 1 - act(m), as the tracer forms it.
    float z_ol = pmin(zon, zmargin<SOFT>(s.tol - loss, s.alpha));
    float pre;
    if (SOFT == SOFT_SIGMOID) {
      float blk_act = pmin(pmax(sigm(blk), 0.0f), 1.0f);
      pre = pmin(sigm(z_ol), 1.0f - blk_act);
    } else {
      pre = pmin(pmin(pmax(z_ol, 0.0f), 6.0f) / 6.0f, 1.0f - clip01_6(blk));
    }
    valid = nan_to_num(pre);
  } else if (SOFT != SOFT_NONE) {
    float loss_ok = soft<SOFT>(s.tol - loss, s.alpha);
    float m1 = pmin(on, 1.0f - blk);
    float pre = pmin(m1, loss_ok);
    valid = nan_to_num(pre);
    float gm1x = min_sel(on, 1.0f - blk, gonx, -gbx);
    float gm1y = min_sel(on, 1.0f - blk, gony, -gby);
    float glox = 0.0f, gloy = 0.0f;
    if (has_loss_grad) {
      float slo = -soft_grad<SOFT>(s.tol - loss, s.alpha);
      glox = slo * glx;
      gloy = slo * gly;
    }
    gvx = min_sel(m1, loss_ok, gm1x, glox);
    gvy = min_sel(m1, loss_ok, gm1y, gloy);
    if (pre != pre) {
      gvx = 0.0f;
      gvy = 0.0f;
    }
  } else {
    bool blkb = blk > 0.0f;
    valid = (onb && !blkb && (loss < s.tol)) ? 1.0f : 0.0f;
  }

  // Path length and power.  With G: d r/d pixel is the unit vector of the
  // final segment for an unbroken chain (image-method stationarity), the
  // full per-segment sum otherwise.
  float r = 0.0f, drx = 0.0f, dry = 0.0f;
  if (G && chain_broken) {
#pragma unroll
    for (int seg = 0; seg <= O; ++seg) {
      float dx_ = ch.x[seg + 1] - ch.x[seg] + kEps;
      float dy_ = ch.y[seg + 1] - ch.y[seg] + kEps;
      float sl = norm2(dx_, dy_);
      r = r + sl;
      bool z = sl == 0.0f;
      float safe_sl = z ? 1.0f : sl;
      float ux = z ? 0.0f : dx_ / safe_sl;
      float uy = z ? 0.0f : dy_ / safe_sl;
      float hgx, hgy, lgx, lgy;
      ch.contract(seg + 1, ux, uy, hgx, hgy);
      ch.contract(seg, ux, uy, lgx, lgy);
      drx = drx + hgx - lgx;
      dry = dry + hgy - lgy;
    }
  } else {
    float ldx = 0.0f, ldy = 0.0f;
#pragma unroll
    for (int seg = 0; seg <= O; ++seg) {
      float dx_ = ch.x[seg + 1] - ch.x[seg] + kEps;
      float dy_ = ch.y[seg + 1] - ch.y[seg] + kEps;
      r = r + norm2(dx_, dy_);
      ldx = dx_;
      ldy = dy_;
    }
    if (G) {
      float ln = norm2(ldx, ldy);
      bool z = ln == 0.0f;
      float safe_ln = z ? 1.0f : ln;
      drx = z ? 0.0f : ldx / safe_ln;
      dry = z ? 0.0f : ldy / safe_ln;
    }
  }
  float rp = 1.0f;
#pragma unroll
  for (int k = 0; k < O; ++k) rp = rp * s.r_coef;
  float denom = s.height * s.height + r * r;
  float power = rp / denom;
  val = valid * power;
  if (G) {
    float dps = -power * (2.0f * r / denom);
    float dpx = dps * drx, dpy = dps * dry;
    if (SOFT != SOFT_NONE) {
      gx = gvx * power + valid * dpx;
      gy = gvy * power + valid * dpy;
    } else {
      gx = valid * dpx;
      gy = valid * dpy;
    }
  } else {
    gx = 0.0f;
    gy = 0.0f;
  }
}

template <bool G, int SOFT>
__global__ void __launch_bounds__(PM_BLOCK)
    power_map_kernel(const float* __restrict__ px, const float* __restrict__ py,
                     int P, const float* __restrict__ txs, int n_tx,
                     const float* __restrict__ walls,
                     const int* __restrict__ kind,
                     const float* __restrict__ phi, int W,
                     const int* __restrict__ cand, int C, Scalars s,
                     float* __restrict__ out, float* __restrict__ gout) {
  __shared__ WallRec sw[PM_MAX_WALLS];
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
    bool z = len == 0.0f;
    float safe = z ? 1.0f : len;
    r.nx = nx / safe;
    r.ny = ny / safe;
    float sq = r.dx * r.dx + r.dy * r.dy;
    r.sq = sq == 0.0f ? 1.0f : sq;
    r.pax = r.ax - s.patch * r.dx;
    r.pay = r.ay - s.patch * r.dy;
    r.pbx = r.bx + s.patch * r.dx;
    r.pby = r.by + s.patch * r.dy;
    r.sinp = sinf(phi[i]);
    r.cosp = cosf(phi[i]);
    r.kind = kind[i];
    sw[i] = r;
  }
  __syncthreads();

  int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  float x = px[p], y = py[p];
  float v = 0.0f, gx = 0.0f, gy = 0.0f;
  for (int t = 0; t < n_tx; ++t) {
    float txx = __ldg(txs + 2 * t), txy = __ldg(txs + 2 * t + 1);
    float tv = 0.0f, tgx = 0.0f, tgy = 0.0f;
    for (int c = 0; c < C; ++c) {
      const int* row = cand + c * PM_ROW;
      float cv, cgx, cgy;
      switch (__ldg(row)) {
        case 0:
          contrib<G, SOFT, 0>(sw, W, row + 1, txx, txy, x, y, s, cv, cgx, cgy);
          break;
        case 1:
          contrib<G, SOFT, 1>(sw, W, row + 1, txx, txy, x, y, s, cv, cgx, cgy);
          break;
        case 2:
          contrib<G, SOFT, 2>(sw, W, row + 1, txx, txy, x, y, s, cv, cgx, cgy);
          break;
        case 3:
          contrib<G, SOFT, 3>(sw, W, row + 1, txx, txy, x, y, s, cv, cgx, cgy);
          break;
        default:
          contrib<G, SOFT, 4>(sw, W, row + 1, txx, txy, x, y, s, cv, cgx, cgy);
          break;
      }
      tv = tv + cv;
      if (G) {
        tgx = tgx + cgx;
        tgy = tgy + cgy;
      }
    }
    // Per-transmitter maps add up in transmitter order, as the JAX
    // package adds its per-transmitter kernel outputs.
    v = t == 0 ? tv : v + tv;
    if (G) {
      gx = t == 0 ? tgx : gx + tgx;
      gy = t == 0 ? tgy : gy + tgy;
    }
  }
  out[p] = v;
  if (G) {
    gout[2 * p] = gx;
    gout[2 * p + 1] = gy;
  }
}

template <bool G>
int launch(int soft_mode, const float* px, const float* py, int P,
           const float* txs, int n_tx, const float* walls, const int* kind,
           const float* phi, int W, const int* cand, int C, Scalars s,
           float* out, float* gout, cudaStream_t stream) {
  if (P <= 0 || W < 0 || W > PM_MAX_WALLS || C < 0 || n_tx < 0 ||
      soft_mode < SOFT_NONE || soft_mode > SOFT_SIGMOID)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();  // clear any earlier error of this runtime
  dim3 grid((P + PM_BLOCK - 1) / PM_BLOCK), block(PM_BLOCK);
  switch (soft_mode) {
    case SOFT_NONE:
      power_map_kernel<G, SOFT_NONE><<<grid, block, 0, stream>>>(
          px, py, P, txs, n_tx, walls, kind, phi, W, cand, C, s, out, gout);
      break;
    case SOFT_HARD:
      power_map_kernel<G, SOFT_HARD><<<grid, block, 0, stream>>>(
          px, py, P, txs, n_tx, walls, kind, phi, W, cand, C, s, out, gout);
      break;
    default:
      power_map_kernel<G, SOFT_SIGMOID><<<grid, block, 0, stream>>>(
          px, py, P, txs, n_tx, walls, kind, phi, W, cand, C, s, out, gout);
      break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Value map: out[P].  `cand` is int32[C, PM_MAX_ORDER + 1] rows of
// (order, wall indices...).  Returns cudaGetLastError() after the launch.
int power_map_value(int soft_mode, const float* px, const float* py, int P,
                    const float* txs, int n_tx, const float* walls,
                    const int* kind, const float* phi, int W, const int* cand,
                    int C, float alpha, float tol, float patch, float r_coef,
                    float height, float* out, void* stream) {
  Scalars s{alpha, tol, patch, r_coef, height};
  return launch<false>(soft_mode, px, py, P, txs, n_tx, walls, kind, phi, W,
                       cand, C, s, out, nullptr,
                       static_cast<cudaStream_t>(stream));
}

// Value and pixel gradient: out[P], gout[P, 2].
int power_map_vag(int soft_mode, const float* px, const float* py, int P,
                  const float* txs, int n_tx, const float* walls,
                  const int* kind, const float* phi, int W, const int* cand,
                  int C, float alpha, float tol, float patch, float r_coef,
                  float height, float* out, float* gout, void* stream) {
  Scalars s{alpha, tol, patch, r_coef, height};
  return launch<true>(soft_mode, px, py, P, txs, n_tx, walls, kind, phi, W,
                      cand, C, s, out, gout, static_cast<cudaStream_t>(stream));
}

}  // extern "C"

// Device code shared by the power-map kernels of power_map.cu (B1/B2, the
// unrolled TPU kernel's port) and power_map_looped.cu (B3-B5, the looped
// one's), and by opt_solver.cu: wall records, NaN-propagating soft logic,
// the blocked test in margin (value) and value + partials form, the
// redesigned blocked sweep (division-free rejection, winner-only partials,
// warp-wide exits: fast_sweep) over either kernel's walls, and the
// per-candidate contribution with its hand-derived pixel gradient.  The numerics notes
// at the top of power_map.cu hold for all of it (built with -fmad=false,
// expf, explicit [0, 1] clamps).

#pragma once

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <string.h>

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
// d soft(x) / dx: alpha s (1 - s) for the sigmoid; for hard_sigmoid
// alpha / 6 where relu6's input alpha x + 3, rounded as soft() rounds it,
// lies strictly inside (0, 6), as jax.nn.relu6's JVP and PyTorch's relu6
// backward take it, else 0.  So the slope is 0 wherever the activation is
// exactly 0 or 1: alpha x just under 3 gives alpha x + 3 == 6 and an
// activation of exactly 1, where a test on alpha x alone would give
// alpha / 6.  The culling tables rely on saturated values having zero
// partials (a culled candidate's or an unlisted wall's, see
// ops/cull_tables.py).
template <int SOFT>
__device__ __forceinline__ float soft_grad(float x, float alpha) {
  if (SOFT == SOFT_SIGMOID) {
    float s = sigm(alpha * x);
    return alpha * s * (1.0f - s);
  }
  float w = alpha * x + 3.0f;
  return (w > 0.0f && w < 6.0f) ? alpha / 6.0f : 0.0f;
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

// -- the redesigned blocked sweep (power_map_looped.cu, and power_map_vag) -----------

constexpr float kRejectMinDen = 0x1p-90f;  // power_map_kernel.REJECT_MIN_DEN
constexpr int kGateExit = 1;  // `features` bit: the gate exits (power_map_kernel.GATE_EXIT)

// A wall's test record: (pax, pay, pbx - pax, pby - pay), formed once per
// block, so a test reads one 16-byte shared vector.  The
// differences are the ones seg_margin and seg_vag form (w.pbx - w.pax), so
// the numerators and the denominator below are theirs, bit for bit.
__device__ __forceinline__ void test_terms(const float4 v, float cx, float cy, float dx,
                                           float dy, float& num_a, float& num_b,
                                           float& den) {
  float avx = v.z, avy = v.w;
  float bvx = cx - dx, bvy = cy - dy;
  float cvx = v.x - cx, cvy = v.y - cy;
  num_a = bvy * cvx - bvx * cvy;
  num_b = avx * cvy - avy * cvx;
  den = avy * bvx - avx * bvy;
}

// Division-free rejection of a clear miss.  With s = num, d = den (or both
// negated where den < 0: the same quotient, rounded the same), the test's
// parameter is t = fl(s / d).  The host's bounds (power_map_kernel.
// rejection_bounds) are: T_lo, the largest float32 t whose lower margin
// zmargin(t + 0.005) is at or below the floor, and T_hi, the least whose
// upper margin zmargin(1.005 - t) is, both computed in float32 as the
// kernels compute them; tlo = T_lo (1 + 2^-20) rounded down, thi = T_hi
// (1 + 2^-20) rounded up, |T| >= 2^-20.  With d >= 2^-90, the products
// d * tlo and d * thi are normal (or overflow to an infinity, which rejects
// nothing since s is finite), so fl(d * tlo) <= d * tlo (1 - 2^-24) <=
// d * T_lo: s <= fl(d * tlo) gives s / d <= T_lo exactly, and division
// rounds monotonically, so t <= T_lo and the lower margin is at or below the
// floor (the margins are monotone in t, alpha > 0).  Likewise for thi.
// Finite s_a, s_b and d make every one of the four margins a number (no
// NaN: finite den means finite wall and segment vectors), so the test's
// margin, their min, is at or below the floor too.  The floors: hard logic,
// any miss (t_a < -0.005 or > 1.005 gives -1); hard_sigmoid, 0
// (clip01_6 and hsig give exactly 0, with slope 0 under relu6's rule);
// sigmoid, -18 for the value map (1 - clip(sigm(m)) is exactly 1) and -89
// with the gradient (sigm(m) is exactly 0, and so is its slope), each held
// on the card for every float32 below it by sigmoid_band_probe.  Such a
// test leaves the running maximum of the value sweep as it is or below the
// floor, where the validity does not see it (see fast_sweep), so
// skipping it changes no bit.  Where the host cannot bound a side, its
// bound is -inf / inf and it rejects nothing.
__device__ __forceinline__ bool rejected(float num_a, float num_b, float den, float tlo,
                                         float thi) {
  float d = fabsf(den);
  bool neg = den < 0.0f;
  float sa = neg ? -num_a : num_a;
  float sb = neg ? -num_b : num_b;
  if (!(d >= kRejectMinDen && d < INFINITY && fabsf(sa) < INFINITY && fabsf(sb) < INFINITY))
    return false;
  float lo = d * tlo, hi = d * thi;
  return sa <= lo || sa >= hi || sb <= lo || sb >= hi;
}

// seg_margin's result from its numerators, in its order of operations.
template <int SOFT>
__device__ __forceinline__ float margin_of(float num_a, float num_b, float den,
                                           float alpha) {
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

// seg_vag's hit from its numerators, in its order of operations (the same
// value, bit for bit; no partials).
template <int SOFT>
__device__ __forceinline__ float hit_of(float num_a, float num_b, float den, float alpha) {
  bool dz = den == 0.0f;
  float safe_den = dz ? 1.0f : den;
  float t_a = dz ? INFINITY : num_a / safe_den;
  float t_b = dz ? INFINITY : num_b / safe_den;
  float inr_a = pmin(soft<SOFT>(t_a + kTolIntersect, alpha),
                     soft<SOFT>(kOnePlusTol - t_a, alpha));
  float inr_b = pmin(soft<SOFT>(t_b + kTolIntersect, alpha),
                     soft<SOFT>(kOnePlusTol - t_b, alpha));
  return pmin(inr_a, inr_b);
}

// ch.contract(k, ...) for a k known only at run time, without indexing the
// chain's arrays dynamically (which would put them in local memory).
template <int O>
__device__ __forceinline__ void contract_at(const Chain<O>& ch, int k, float wx, float wy,
                                            float& ox, float& oy) {
  ox = 0.0f;
  oy = 0.0f;
#pragma unroll
  for (int j = 0; j < O + 2; ++j)
    if (j == k) ch.contract(j, wx, wy, ox, oy);
}

// Bits of word k with the segment's own walls skip0, skip1 (-1: none)
// cleared: the skips of contrib's sequential sweep, without the record.
__device__ __forceinline__ unsigned drop_own(unsigned bits, int k, int skip0, int skip1) {
  if (skip0 >= 0 && (skip0 >> 5) == k) bits &= ~(1u << (skip0 & 31));
  if (skip1 >= 0 && (skip1 >> 5) == k) bits &= ~(1u << (skip1 & 31));
  return bits;
}

// The redesigned sweep over a blocked-test policy `ws` (ListedWalls,
// AllWalls), which provides the test records sv[W] (16 bytes each: pax,
// pay, pbx - pax, pby - pay), the rejection bounds tlo, thi, the saturation
// margin sat, the warp's lanes vote, the feature bits, NW bit words per
// segment and, per segment, words_of<O>(seg, id) and testable(words, k,
// skip0, skip1): the walls of word k the segment is tested against, set
// bits lowest first, as its sequential sweep (for_each) visits them.
//
// The redesigned blocked test of one candidate.  Returns whether the
// sequential sweep must still run (then blk, gbx, gby are untouched);
// otherwise blk (and, with the soft gradient, gbx, gby) hold exactly what
// the sequential sweep would leave, or values the validity cannot tell
// from them.
//
// Margin form (the value map, and hard logic with or without G): the
// sequential sweep keeps blk = pmax over the tests' margins m_k, from
// -inf, and the validity reads blk only through act(blk) = clip01_6(blk)
// (hard_sigmoid), clip(sigm(blk), 0, 1) (sigmoid) or blk > 0 (hard), as
// pmin(a_ol, 1 - act(blk)) or onb && !(blk > 0) && loss < tol.
// * Rejected tests (see rejected) have margins at or below the floor F,
//   where 1 - act is exactly 1 (hard: blk <= 0 is "not blocked").  If the
//   sweep's true maximum is above F it is a survivor's, and the survivors'
//   pmax (NaN included: a rejected margin is never NaN) is the same; if it
//   is at or below F, both maxima are, and give the same validity.
// * Gate exit: where a_ol, the activation of the folded on/loss margin, is
//   exactly 0 or NaN (hard: !onb or loss >= tol), pmin(a_ol, 1 - act(blk))
//   is 0 or NaN for every blk in [-inf, +inf] or NaN (pmin(0, x) is 0 for
//   x >= 0 and NaN for NaN; pmin(NaN, x) is NaN), and nan_to_num makes
//   both 0; the validity is 0 whatever the sweep gives.  A warp skips the
//   sweep when every lane's is (__all_sync), so no lane waits on another.
// * Saturation exit: act is non-decreasing in blk on [sat, +inf] with
//   act == 1 there (hard_sigmoid: 6; hard: a hit, 1; sigmoid: 19, held on
//   the card for every float32 at or above it), and blk only grows or turns
//   NaN; once blk >= sat, 1 - act(final blk) is 0 or NaN, so pmin(a_ol,
//   .) is 0 or NaN (a_ol >= 0 or NaN) and the validity is 0, as it is for
//   hard logic with blk > 0.  The warp leaves the sweep when every lane's
//   blk is there, checked after each word.
//
// Soft logic with the gradient (winner-only partials): the sequential
// sweep keeps (blk, gb) from (0, 0) with blk = pmax(blk, hit_k) and gb =
// max_sel(blk, hit_k, gb, gh_k), the hit in activation space (seg_vag).
// max_sel resets gb to gh_k at every strict increase, keeps it below, and
// averages at a tie, so with A the final maximum, gb depends only on the
// first test k* with hit A (or the initial (0, 0) if A == 0) and the
// later tests tied at A.  Ties are found on the hits themselves, not the
// margins (hsig's / 6 maps distinct margins onto one float).  Hence:
// * no NaN hit and no later tie at an A strictly inside (0, 1): gb =
//   gh_{k*}, one seg_vag and two contractions, formed as the sweep forms
//   them; blk = A;
// * A == 0 or A == 1: every tied test's hit has slope 0 (relu6's rule on
//   the rounded alpha x + 3; s (1 - s) == 0 for the sigmoid), so its
//   partials are exact zeros and gb = 0.  This rests, like the culling
//   tables' proofs (ops/cull_tables.py: an unlisted wall has a hit of 0
//   with zero partials), on the partials of a saturated test being
//   finite;
// * a NaN hit, or a tie inside (0, 1) not superseded by a later strict
//   increase: the sequential sweep runs (the only exact form of the
//   0.5/0.5 tie rule and of NaN's propagation).
// Rejected tests have a hit of exactly 0 with zero partials (the floors
// above), so they are ties of A == 0 or below A.
// * Gate exit: where on or loss_ok is exactly 0 or NaN, the validity
//   pmin(pmin(on, 1 - blk), loss_ok) is 0 or NaN (nan_to_num: 0) for every
//   blk, and its gradient min_sel(m1, loss_ok, min_sel(on, 1 - blk, g_on,
//   -gb), g_lo) is 0 for every (blk, gb) the sweep can leave: the
//   selected terms are g_on or g_lo of a saturated activation (zero, as
//   above) or gb of a saturated maximum (zero), averaged at ties, and a
//   NaN validity zeroes the gradient.  So (blk, gb) = (0, 0), the
//   sweep's start, gives the same bits; the warp skips the sweep when
//   every lane's gate is dead.
// * Saturation exit: once A == 1, later tests can only tie (zero
//   partials) or be NaN; with blk NaN or 1 the validity is 0 or NaN and
//   its gradient 0 by the same selection, so the warp leaves the sweep
//   when every lane's A is 1 (a NaN seen before still sends the lane to
//   the sequential sweep).  Off with the margin form's (sat = inf).
template <bool G, int SOFT, int O, class Walls>
__device__ __forceinline__ bool fast_sweep(const Walls& ws, const WallRec* __restrict__ sw,
                                           const Chain<O>& ch, const int* id,
                                           const Scalars& s, bool gate_dead, float& blk,
                                           float& gbx, float& gby) {
  bool gate_exit = (ws.features & kGateExit) != 0;  // uniform: the whole warp votes or none
  if constexpr (SOFT != SOFT_NONE && G) {
    if (gate_exit && __all_sync(ws.vote, gate_dead)) return false;
    float A = 0.0f;
    int wseg = 0, wwall = 0;
    bool tie = false, nan = false, done = false;
    bool sat_exit = ws.sat < INFINITY;  // uniform, as gate_exit
#pragma unroll
    for (int seg = 0; seg <= O; ++seg) {
      if (done) break;
      int skip0 = seg == 0 ? -1 : id[seg - 1];
      int skip1 = seg == O ? -1 : id[seg];
      float cx = ch.x[seg], cy = ch.y[seg], dx = ch.x[seg + 1], dy = ch.y[seg + 1];
      const unsigned* words = ws.template words_of<O>(seg, id);
      for (int k = 0; k < ws.NW; ++k) {
        unsigned bits = ws.testable(words, k, skip0, skip1);
        while (bits) {
          int wi = 32 * k + __ffs(bits) - 1;
          bits &= bits - 1u;
          float num_a, num_b, den;
          test_terms(ws.sv[wi], cx, cy, dx, dy, num_a, num_b, den);
          if (rejected(num_a, num_b, den, ws.tlo, ws.thi)) continue;
          float hit = hit_of<SOFT>(num_a, num_b, den, s.alpha);
          if (hit > A) {
            A = hit;
            wseg = seg;
            wwall = wi;
            tie = false;
          } else if (!(hit < A)) {
            if (hit != hit) {
              nan = true;
            } else if (A > 0.0f && A < 1.0f) {
              tie = true;
            }
          }
        }
        if (sat_exit && __all_sync(ws.vote, A == 1.0f)) {
          done = true;
          break;
        }
      }
    }
    if (nan || tie) return true;
    blk = A;
    if (A > 0.0f && A < 1.0f) {
      float cx = ch.x[0], cy = ch.y[0], dx = ch.x[1], dy = ch.y[1];
#pragma unroll
      for (int seg = 1; seg <= O; ++seg) {
        if (seg == wseg) {
          cx = ch.x[seg];
          cy = ch.y[seg];
          dx = ch.x[seg + 1];
          dy = ch.y[seg + 1];
        }
      }
      float dcx, dcy, ddx, ddy;
      seg_vag<SOFT>(sw[wwall], cx, cy, dx, dy, s.alpha, dcx, dcy, ddx, ddy);
      float h0x, h0y, h1x, h1y;
      contract_at<O>(ch, wseg, dcx, dcy, h0x, h0y);
      contract_at<O>(ch, wseg + 1, ddx, ddy, h1x, h1y);
      gbx = h0x + h1x;
      gby = h0y + h1y;
    }
    return false;
  } else {
    if (gate_exit && __all_sync(ws.vote, gate_dead)) return false;
    bool done = false;
#pragma unroll
    for (int seg = 0; seg <= O; ++seg) {
      if (done) break;
      int skip0 = seg == 0 ? -1 : id[seg - 1];
      int skip1 = seg == O ? -1 : id[seg];
      float cx = ch.x[seg], cy = ch.y[seg], dx = ch.x[seg + 1], dy = ch.y[seg + 1];
      const unsigned* words = ws.template words_of<O>(seg, id);
      for (int k = 0; k < ws.NW; ++k) {
        unsigned bits = ws.testable(words, k, skip0, skip1);
        while (bits) {
          int wi = 32 * k + __ffs(bits) - 1;
          bits &= bits - 1u;
          float num_a, num_b, den;
          test_terms(ws.sv[wi], cx, cy, dx, dy, num_a, num_b, den);
          if (!rejected(num_a, num_b, den, ws.tlo, ws.thi))
            blk = pmax(blk, margin_of<SOFT>(num_a, num_b, den, s.alpha));
        }
        if (__all_sync(ws.vote, blk >= ws.sat)) {
          done = true;
          break;
        }
      }
    }
    return false;
  }
}

// Contribution valid * power of one candidate of order O (and, with G, its
// pixel gradient).  `id` holds the O wall indices and imx/imy the
// transmitter's mirror images through them; `blockers` says which walls
// the blocked test of each segment visits (see AllWalls).  With FAST (the
// redesigned sweep of the looped kernels and of power_map_vag) the blocked
// test first goes through blockers.fast_blocked (fast_sweep), which returns
// whether the sequential sweep below must still run; without it (the _seq
// twins and power_map_value) the sweep is the one below, unchanged.
template <bool G, int SOFT, int O, class Blockers, bool FAST = false>
__device__ __forceinline__ void contrib(const WallRec* __restrict__ sw,
                                        const int* id, const float* imx,
                                        const float* imy, float txx, float txy,
                                        float px, float py, const Scalars& s,
                                        const Blockers& blockers, float& val,
                                        float& gx, float& gy) {
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

  // Blocked test: every segment against the non-adjacent, non-vertex walls
  // that `blockers` visits (all of them for AllWalls).  Soft+G keeps a
  // running (value, gradient) max; every other mode keeps the running max
  // of the deferred-clamp margin.
  constexpr bool soft_grad_blk = SOFT != SOFT_NONE && G;
  float blk = soft_grad_blk ? 0.0f : -INFINITY;
  float gbx = 0.0f, gby = 0.0f;
  bool sweep = true;
  if constexpr (FAST) {
    // Whether the on-object and loss gates alone already make the
    // validity exactly 0, whatever the blocked test gives (the argument
    // is at fast_sweep).
    bool gate_dead = false;
    if constexpr (fold) {
      float z_ol = pmin(zon, zmargin<SOFT>(s.tol - loss, s.alpha));
      float a_ol = SOFT == SOFT_SIGMOID ? sigm(z_ol) : pmin(pmax(z_ol, 0.0f), 6.0f) / 6.0f;
      gate_dead = !(a_ol > 0.0f);
    } else if constexpr (SOFT == SOFT_NONE) {
      gate_dead = !(onb && (loss < s.tol));
    } else {
      gate_dead = !(on > 0.0f) || !(soft<SOFT>(s.tol - loss, s.alpha) > 0.0f);
    }
    sweep = blockers.template fast_blocked<G, SOFT, O>(sw, ch, id, s, gate_dead, blk, gbx,
                                                       gby);
  }
#pragma unroll
  for (int seg = 0; seg <= O && sweep; ++seg) {
    int skip0 = seg == 0 ? -1 : id[seg - 1];
    int skip1 = seg == O ? -1 : id[seg];
    float sax = ch.x[seg], say = ch.y[seg];
    float sbx = ch.x[seg + 1], sby = ch.y[seg + 1];
    blockers.template for_each<O>(seg, id, [&](int wi) {
      const WallRec& w = sw[wi];
      if (wi == skip0 || wi == skip1 || w.kind == KIND_VERTEX) return;
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
    });
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

// Blocked-test policy of the unrolled kernels: every segment is tested
// against every wall, in index order (for_each, the sequential sweep).  The
// redesigned sweep (power_map_vag) reads the same walls through the
// non-vertex words `solid` (fast_blocked, see fast_sweep).
struct AllWalls {
  int W;
  // Redesigned sweep only:
  int NW;                 // (W + 31) / 32
  const float4* sv;       // [W] test records, shared memory
  const unsigned* solid;  // [NW] non-vertex walls, shared memory
  float tlo, thi, sat;    // rejection bounds, saturation margin
  unsigned vote;          // lanes of this thread's warp
  int features;           // kGateExit

  template <int O, class F>
  __device__ __forceinline__ void for_each(int, const int*, F&& f) const {
    for (int wi = 0; wi < W; ++wi) f(wi);
  }
  template <int O>
  __device__ __forceinline__ const unsigned* words_of(int, const int*) const {
    return nullptr;
  }
  __device__ __forceinline__ unsigned testable(const unsigned*, int k, int skip0,
                                               int skip1) const {
    return drop_own(solid[k], k, skip0, skip1);
  }
  template <bool G, int SOFT, int O>
  __device__ __forceinline__ bool fast_blocked(const WallRec* __restrict__ sw,
                                               const Chain<O>& ch, const int* id,
                                               const Scalars& s, bool gate_dead, float& blk,
                                               float& gbx, float& gby) const {
    return fast_sweep<G, SOFT, O>(*this, sw, ch, id, s, gate_dead, blk, gbx, gby);
  }
};

// Forward mirror images of the transmitter through walls id[0..O-1] (a
// vertex is the identity).
template <int O>
__device__ __forceinline__ void mirror_chain(const WallRec* __restrict__ sw,
                                             const int* id, float txx, float txy,
                                             float* imx, float* imy) {
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

// Counts the float32 values z in the bit range [lo, hi] where the kernels'
// sigmoid breaks a band the redesigned sweep relies on: test 0, 1 -
// clip(sigm(z), 0, 1) != 1 (value floor); test 1, sigm(z) != 0 (gradient
// floor); test 2, 1 - clip(sigm(z), 0, 1) != 0 (saturation).  A template, so
// that only the sources that export a probe compile it.
template <int Unused = 0>
__global__ void sigmoid_band_kernel(unsigned lo, unsigned hi, int test,
                                    unsigned* __restrict__ fails) {
  unsigned n = hi - lo + 1u;
  unsigned stride = gridDim.x * blockDim.x;
  unsigned bad = 0u;
  for (unsigned i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    unsigned bits = lo + i;
    float z;
    memcpy(&z, &bits, sizeof z);
    float sg = sigm(z);
    float comp = 1.0f - pmin(pmax(sg, 0.0f), 1.0f);
    bool ok = test == 0 ? comp == 1.0f : (test == 1 ? sg == 0.0f : comp == 0.0f);
    bad += ok ? 0u : 1u;
  }
  if (bad) atomicAdd(fails, bad);
}

// Adds to fails[0] the count of float32 values z where the kernels'
// sigmoid breaks band `test` (see sigmoid_band_kernel): every z <= bound
// for tests 0 and 1 (bound < 0), every z >= bound for test 2 (bound > 0),
// infinities included.  The body of each source's exported probe.
inline int sigmoid_band_probe_launch(float bound, int test, unsigned* fails, void* stream) {
  if (test < 0 || test > 2 || !(test == 2 ? bound > 0.0f : bound < 0.0f))
    return static_cast<int>(cudaErrorInvalidValue);
  unsigned bits;
  memcpy(&bits, &bound, sizeof bits);
  unsigned hi = test == 2 ? 0x7f800000u : 0xff800000u;  // +inf, -inf
  cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  sigmoid_band_kernel<<<1024, 256, 0, st>>>(bits, hi, test, fails);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

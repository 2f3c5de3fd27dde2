// Power-map kernels for NVIDIA Hopper (sm_90a): power_map_value and
// power_map_vag, each with its sequential twin (power_map_value_seq,
// power_map_vag_seq).
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
// pixel, so bytes never bound it; the blocked tests are most of the work
// (91 a pixel).  Both kernels run the looped kernels' redesigned blocked
// sweep over all walls (fast_sweep in power_map_common.cuh: a
// division-free rejection of clear misses, warp-wide exits where every
// lane's gates are dead or its path is fully blocked, 16-byte test records
// and shared memory sized to W); power_map_value takes its margin form,
// power_map_vag its winner-only partials (the maximum hit and its first
// test found in activation space, one seg_vag and two contractions for
// that winner after the sweep).  Every bit stays as the sequential sweep
// leaves it, and that sweep, each kernel as it was before its redesign, is
// exported as power_map_value_seq and power_map_vag_seq for checks.
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

#include "power_map_common.cuh"

#define PM_MAX_ORDER 4
#define PM_MAX_WALLS 512
#define PM_ROW (PM_MAX_ORDER + 1)
#define PM_BLOCK 128

namespace {

// One candidate row (its O wall indices) against every wall: the
// transmitter's mirror images are formed per thread.
template <bool G, int SOFT, int O, bool FAST>
__device__ __forceinline__ void contrib_row(const WallRec* __restrict__ sw,
                                            const AllWalls& walls,
                                            const int* __restrict__ ids, float txx,
                                            float txy, float px, float py,
                                            const Scalars& s, float& val, float& gx,
                                            float& gy) {
  int id[O > 0 ? O : 1];
#pragma unroll
  for (int j = 0; j < O; ++j) id[j] = __ldg(ids + j);
  float imx[O > 0 ? O : 1], imy[O > 0 ? O : 1];
  mirror_chain<O>(sw, id, txx, txy, imx, imy);
  contrib<G, SOFT, O, AllWalls, FAST>(sw, id, imx, imy, txx, txy, px, py, s, walls, val, gx,
                                      gy);
}

// FAST = false: every wall's full test (the twins power_map_value_seq and
// power_map_vag_seq), the walls in a static 512-record array, a thread per
// pixel that exits past P.  FAST = true (power_map_value, power_map_vag):
// the redesigned sweep (fast_sweep, with the rejection bounds tlo, thi and
// the saturation margin sat of power_map_kernel.rejection_bounds), the
// walls and their 16-byte test records in dynamic shared memory sized to
// W, and every thread of the last block kept for the warp votes (past P it
// computes a copy of pixel P - 1 and writes nothing).  With G = false the
// sweep takes fast_sweep's margin form, whose argument (power_map_common.cuh,
// at fast_sweep: rejected margins at or below the floor, the gate exit, the
// saturation exit) is the looped value kernel's: the validity reads the
// running maximum only through 1 - act(blk), so every skipped test leaves
// each bit of the map as the sequential sweep leaves it.
template <bool G, int SOFT, bool FAST>
__global__ void __launch_bounds__(PM_BLOCK)
    power_map_kernel(const float* __restrict__ px, const float* __restrict__ py,
                     int P, const float* __restrict__ txs, int n_tx,
                     const float* __restrict__ walls,
                     const int* __restrict__ kind,
                     const float* __restrict__ phi, int W,
                     const int* __restrict__ cand, int C, float tlo, float thi, float sat,
                     Scalars s, float* __restrict__ out,
                     float* __restrict__ gout) {
  __shared__ WallRec sw_static[FAST ? 1 : PM_MAX_WALLS];
  extern __shared__ float4 pm_dyn[];
  int NW = (W + 31) / 32;
  // FAST layout: sv[W], then the records sw[W], then solid[NW].
  float4* sv = pm_dyn;
  WallRec* sw = FAST ? reinterpret_cast<WallRec*>(pm_dyn + W) : sw_static;
  unsigned* solid = reinterpret_cast<unsigned*>(pm_dyn + W + (W * sizeof(WallRec) + 15) / 16);
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
    if constexpr (FAST) sv[i] = make_float4(r.pax, r.pay, r.pbx - r.pax, r.pby - r.pay);
  }
  if constexpr (FAST) {
    for (int k = threadIdx.x; k < NW; k += blockDim.x) {
      unsigned word = 0u;
      for (int b = 0; b < 32 && 32 * k + b < W; ++b)
        if (kind[32 * k + b] != KIND_VERTEX) word |= 1u << b;
      solid[k] = word;
    }
  }
  __syncthreads();

  int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (!FAST && idx >= P) return;
  int p = FAST ? min(idx, P - 1) : idx;
  AllWalls aw{W};
  if constexpr (FAST) aw = AllWalls{W, NW, sv, solid, tlo, thi, sat, 0xffffffffu, kGateExit};
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
          contrib_row<G, SOFT, 0, FAST>(sw, aw, row + 1, txx, txy, x, y, s, cv, cgx, cgy);
          break;
        case 1:
          contrib_row<G, SOFT, 1, FAST>(sw, aw, row + 1, txx, txy, x, y, s, cv, cgx, cgy);
          break;
        case 2:
          contrib_row<G, SOFT, 2, FAST>(sw, aw, row + 1, txx, txy, x, y, s, cv, cgx, cgy);
          break;
        case 3:
          contrib_row<G, SOFT, 3, FAST>(sw, aw, row + 1, txx, txy, x, y, s, cv, cgx, cgy);
          break;
        default:
          contrib_row<G, SOFT, 4, FAST>(sw, aw, row + 1, txx, txy, x, y, s, cv, cgx, cgy);
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
  if (FAST && idx >= P) return;
  out[p] = v;
  if (G) {
    gout[2 * p] = gx;
    gout[2 * p + 1] = gy;
  }
}

// Dynamic shared memory of the FAST kernel: sv[W], sw[W], solid[NW].
size_t fast_smem(int W) {
  size_t recs = (static_cast<size_t>(W) * sizeof(WallRec) + 15) / 16;
  return (static_cast<size_t>(W) + recs) * sizeof(float4) + ((W + 31) / 32) * sizeof(unsigned);
}

using MapKernel = void (*)(const float*, const float*, int, const float*, int, const float*,
                           const int*, const float*, int, const int*, int, float, float, float,
                           Scalars, float*, float*);

template <bool G, bool FAST>
MapKernel select_kernel(int soft_mode) {
  if (soft_mode == SOFT_NONE) return power_map_kernel<G, SOFT_NONE, FAST>;
  if (soft_mode == SOFT_HARD) return power_map_kernel<G, SOFT_HARD, FAST>;
  return power_map_kernel<G, SOFT_SIGMOID, FAST>;
}

bool bad_args(int soft_mode, int P, int n_tx, int W, int C) {
  return P <= 0 || W < 0 || W > PM_MAX_WALLS || C < 0 || n_tx < 0 ||
         soft_mode < SOFT_NONE || soft_mode > SOFT_SIGMOID;
}

template <bool G, bool FAST>
int launch(int soft_mode, const float* px, const float* py, int P,
           const float* txs, int n_tx, const float* walls, const int* kind,
           const float* phi, int W, const int* cand, int C, float tlo, float thi,
           float sat, Scalars s, float* out, float* gout,
           cudaStream_t stream) {
  if (bad_args(soft_mode, P, n_tx, W, C)) return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();  // clear any earlier error of this runtime
  dim3 grid((P + PM_BLOCK - 1) / PM_BLOCK), block(PM_BLOCK);
  select_kernel<G, FAST>(soft_mode)<<<grid, block, FAST ? fast_smem(W) : 0, stream>>>(
      px, py, P, txs, n_tx, walls, kind, phi, W, cand, C, tlo, thi, sat, s, out,
      gout);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Value map through the redesigned sweep: out[P].  `cand` is
// int32[C, PM_MAX_ORDER + 1] rows of (order, wall indices...); tlo, thi and
// sat are the rejection bounds and the saturation margin of
// power_map_kernel.rejection_bounds (grad=False).  Returns
// cudaGetLastError() after the launch.
int power_map_value(int soft_mode, const float* px, const float* py, int P,
                    const float* txs, int n_tx, const float* walls,
                    const int* kind, const float* phi, int W, const int* cand,
                    int C, float tlo, float thi, float sat, float alpha, float tol,
                    float patch, float r_coef, float height, float* out, void* stream) {
  Scalars s{alpha, tol, patch, r_coef, height};
  return launch<false, true>(soft_mode, px, py, P, txs, n_tx, walls, kind, phi, W, cand, C,
                             tlo, thi, sat, s, out, nullptr,
                             static_cast<cudaStream_t>(stream));
}

// The same map through the sequential sweep (every wall's full test, the
// kernel as it was before the redesign): the redesign's bitwise reference,
// called by checks only.  It takes power_map_value's arguments and ignores
// tlo, thi and sat.
int power_map_value_seq(int soft_mode, const float* px, const float* py, int P,
                        const float* txs, int n_tx, const float* walls,
                        const int* kind, const float* phi, int W, const int* cand,
                        int C, float tlo, float thi, float sat, float alpha, float tol,
                        float patch, float r_coef, float height, float* out,
                        void* stream) {
  Scalars s{alpha, tol, patch, r_coef, height};
  return launch<false, false>(soft_mode, px, py, P, txs, n_tx, walls, kind, phi, W, cand, C,
                              tlo, thi, sat, s, out, nullptr,
                              static_cast<cudaStream_t>(stream));
}

// Value and pixel gradient through the redesigned sweep: out[P], gout[P, 2].
// tlo, thi and sat are the rejection bounds and the saturation margin of
// power_map_kernel.rejection_bounds (grad=True).
int power_map_vag(int soft_mode, const float* px, const float* py, int P,
                  const float* txs, int n_tx, const float* walls,
                  const int* kind, const float* phi, int W, const int* cand,
                  int C, float tlo, float thi, float sat, float alpha, float tol,
                  float patch, float r_coef, float height, float* out, float* gout,
                  void* stream) {
  Scalars s{alpha, tol, patch, r_coef, height};
  return launch<true, true>(soft_mode, px, py, P, txs, n_tx, walls, kind, phi, W, cand, C,
                            tlo, thi, sat, s, out, gout,
                            static_cast<cudaStream_t>(stream));
}

// The same map through the sequential sweep (every wall's full test, the
// kernel as it was before the redesign): the redesign's bitwise reference,
// called by checks only.  It takes power_map_vag's arguments and ignores
// tlo, thi and sat.
int power_map_vag_seq(int soft_mode, const float* px, const float* py, int P,
                      const float* txs, int n_tx, const float* walls,
                      const int* kind, const float* phi, int W, const int* cand,
                      int C, float tlo, float thi, float sat, float alpha, float tol,
                      float patch, float r_coef, float height, float* out, float* gout,
                      void* stream) {
  Scalars s{alpha, tol, patch, r_coef, height};
  return launch<true, false>(soft_mode, px, py, P, txs, n_tx, walls, kind, phi, W, cand, C,
                             tlo, thi, sat, s, out, gout,
                             static_cast<cudaStream_t>(stream));
}

// Resident blocks per SM, into *blocks, of the kernel for soft_mode: the
// value (grad 0) or gradient (grad 1) kernel, redesigned (fast 1, W walls)
// or its sequential twin (fast 0).
int power_map_occupancy(int grad, int soft_mode, int fast, int W, int* blocks) {
  if (bad_args(soft_mode, 1, 0, W, 0)) return static_cast<int>(cudaErrorInvalidValue);
  MapKernel k = grad ? (fast ? select_kernel<true, true>(soft_mode)
                             : select_kernel<true, false>(soft_mode))
                     : (fast ? select_kernel<false, true>(soft_mode)
                             : select_kernel<false, false>(soft_mode));
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, k, PM_BLOCK, fast ? fast_smem(W) : 0));
}

// sigmoid_band_probe (power_map_common.cuh) of this build's sigmoid.
int power_map_sigmoid_band_probe(float bound, int test, unsigned* fails, void* stream) {
  return sigmoid_band_probe_launch(bound, test, fails, stream);
}

}  // extern "C"

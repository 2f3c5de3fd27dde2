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

#include "power_map_common.cuh"

#define PM_MAX_ORDER 4
#define PM_MAX_WALLS 512
#define PM_ROW (PM_MAX_ORDER + 1)
#define PM_BLOCK 128

namespace {

// One candidate row (its O wall indices) against every wall: the
// transmitter's mirror images are formed per thread.
template <bool G, int SOFT, int O>
__device__ __forceinline__ void contrib_row(const WallRec* __restrict__ sw, int W,
                                            const int* __restrict__ ids, float txx,
                                            float txy, float px, float py,
                                            const Scalars& s, float& val, float& gx,
                                            float& gy) {
  int id[O > 0 ? O : 1];
#pragma unroll
  for (int j = 0; j < O; ++j) id[j] = __ldg(ids + j);
  float imx[O > 0 ? O : 1], imy[O > 0 ? O : 1];
  mirror_chain<O>(sw, id, txx, txy, imx, imy);
  contrib<G, SOFT, O>(sw, id, imx, imy, txx, txy, px, py, s, AllWalls{W}, val, gx, gy);
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
          contrib_row<G, SOFT, 0>(sw, W, row + 1, txx, txy, x, y, s, cv, cgx, cgy);
          break;
        case 1:
          contrib_row<G, SOFT, 1>(sw, W, row + 1, txx, txy, x, y, s, cv, cgx, cgy);
          break;
        case 2:
          contrib_row<G, SOFT, 2>(sw, W, row + 1, txx, txy, x, y, s, cv, cgx, cgy);
          break;
        case 3:
          contrib_row<G, SOFT, 3>(sw, W, row + 1, txx, txy, x, y, s, cv, cgx, cgy);
          break;
        default:
          contrib_row<G, SOFT, 4>(sw, W, row + 1, txx, txy, x, y, s, cv, cgx, cgy);
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

// Looped power-map kernels for NVIDIA Hopper (sm_90a):
// power_map_looped_value and power_map_looped_vag.
//
// Replaces the looped Pallas TPU kernel
// differt2d_tpu/ops/pallas_kernels.py::build_power_map_kernel_looped
// (pallas_call at :3430) as get_fused_run builds it for the city scenes,
// with cull=True, shadow=True: B3 (the candidate loop over runtime walls),
// B4 (per-tile kept-candidate lists) and B5 in its list form (occluder
// lists for the first, last and line-of-sight segments; candidates of
// order <= 1, so no middle segment).  Both compute, per receiver-grid pixel
// and for one transmitter,
//
//     sum over candidates of valid * r_coef**order / (height**2 + r**2)
//
// with the per-candidate routine of power_map.cu (power_map_common.cuh),
// and power_map_looped_vag adds its hand-derived pixel gradient.
//
// Design: one thread per pixel, and one block per culling tile, a compact
// tile_w x tile_h rectangle of the [rows, cols] grid; tile t is block
// (t % gridDim.x, t / gridDim.x).  The tables are data, read per tile:
//
//   prm[T, C], cnt[T]       kept candidates of tile t, in index order, and
//                            their count (beam proof + first-wall kill,
//                            ops/cull_tables.py::beam_keep_tables);
//   l0w[W, NW]              occluders of a first segment TX -> b1, per
//                            first wall (NW = ceil(W / 32) bit words);
//   lastw[T, W, NW]          occluders of a last segment b1 -> pixel, per
//                            tile and last wall;
//   losw[T, NW]              occluders of the line of sight, per tile.
//
// Every thread of a block reads the same table entries, so the candidate
// loop and the wall loops never diverge.  A candidate off the list
// contributes exact zeros (value and both partials) to every pixel of the
// tile, and a wall off a list has a blocked-test hit of exactly 0 with zero
// partials wherever the candidate's contribution is not already exactly 0,
// so skipping either leaves every output bit as it is (the proofs are in
// ops/cull_tables.py).  Kept candidates and listed walls are visited in
// index order, as the identity tables visit all of them.  With identity
// tables (every candidate, every wall) the program is the unculled looped
// kernel, B3: culled and unculled maps come from one build and one program
// and agree bit for bit, as on the TPU (pallas_kernels.py:2317-2322).  The
// occluder sets are bit words rather than the JAX package's int32[T, W, W]
// index lists (606 MB per map at 1024x1024 with 128-pixel tiles and 136
// walls; the words are 11 MB with 256-pixel tiles), visited set bit by set
// bit, lowest first.
// Per-wall unit normals and patched endpoints (aux[W, 6]) and the
// transmitter's mirror images (img[C, 2]) are per-launch constants that
// the wrapper computes once, the same numbers the tables are proven on.
// One launch per transmitter; with `accumulate` the launch adds its map to
// `out` (transmitter order, as get_fused_run adds its kernel outputs).
//
// Bound on the H100: FP32 compute.  An order <= 1 city map reads 8 B and
// writes 4 B per pixel (12 B/px, 20 B/px with the gradient), and the
// tables (13.5 MB at 1024x1024, 136 walls, 16x16 tiles) are read once per
// block entry; the unculled map needs about (C + 1) x (W - 1) x 2 blocked tests
// of ~18 operations per pixel (0.67 M operations per pixel at 136 walls),
// and the tables leave the kept candidates times their listed occluders,
// summed over tiles (chip_smoke.py counts both).  The tables are the
// design's answer to the bound; within what they leave this first version
// does nothing beyond keeping every intermediate in registers.
//
// Numerics: those of power_map.cu (-fmad=false, expf, NaN-propagating
// min/max, explicit [0, 1] clamps).  sigmoid_probe evaluates the kernels'
// own sigmoid for the wrapper's check of its f32 saturation bands.
// Caps: W <= LP_MAX_WALLS, order <= LP_MAX_ORDER, tile_w * tile_h <=
// LP_MAX_THREADS (power_map_looped.py repeats these defines, and a test
// holds them equal).

#include "power_map_common.cuh"

#define LP_MAX_ORDER 1
#define LP_MAX_WALLS 512
#define LP_MAX_THREADS 256

namespace {

// Blocked-test policy of the looped kernels: the segment's occluder bit
// words, set bits lowest first.  Order 0 has one segment, the line of
// sight; order 1 a first (TX -> b1) and a last (b1 -> pixel) segment.
struct ListedWalls {
  const unsigned* __restrict__ los;   // [NW], this tile's
  const unsigned* __restrict__ l0;    // [W, NW]
  const unsigned* __restrict__ last;  // [W, NW], this tile's
  int NW;

  template <int O, class F>
  __device__ __forceinline__ void for_each(int seg, const int* id, F&& f) const {
    static_assert(O <= LP_MAX_ORDER, "no middle segments in the list form");
    const unsigned* words =
        O == 0 ? los : (seg == 0 ? l0 + id[0] * NW : last + id[O > 0 ? O - 1 : 0] * NW);
    for (int k = 0; k < NW; ++k) {
      unsigned bits = __ldg(words + k);
      while (bits) {
        int b = __ffs(bits) - 1;
        bits &= bits - 1u;
        f(32 * k + b);
      }
    }
  }
};

template <bool G, int SOFT>
__global__ void __launch_bounds__(LP_MAX_THREADS)
    looped_kernel(const float* __restrict__ px, const float* __restrict__ py,
                  int rows, int cols, const float* __restrict__ tx,
                  const float* __restrict__ walls, const float* __restrict__ aux,
                  const int* __restrict__ kind, const float* __restrict__ phi,
                  int W, int has_los, const int* __restrict__ cand,
                  const float* __restrict__ img, int C,
                  const int* __restrict__ prm, const int* __restrict__ cnt,
                  const unsigned* __restrict__ l0w,
                  const unsigned* __restrict__ lastw,
                  const unsigned* __restrict__ losw, Scalars s, int accumulate,
                  float* __restrict__ out, float* __restrict__ gout) {
  __shared__ WallRec sw[LP_MAX_WALLS];
  int nthreads = blockDim.x * blockDim.y;
  for (int i = threadIdx.y * blockDim.x + threadIdx.x; i < W; i += nthreads) {
    WallRec r;
    r.ax = walls[4 * i + 0];
    r.ay = walls[4 * i + 1];
    r.bx = walls[4 * i + 2];
    r.by = walls[4 * i + 3];
    r.dx = r.bx - r.ax;
    r.dy = r.by - r.ay;
    r.nx = aux[6 * i + 0];
    r.ny = aux[6 * i + 1];
    float sq = r.dx * r.dx + r.dy * r.dy;
    r.sq = sq == 0.0f ? 1.0f : sq;
    r.pax = aux[6 * i + 2];
    r.pay = aux[6 * i + 3];
    r.pbx = aux[6 * i + 4];
    r.pby = aux[6 * i + 5];
    r.sinp = sinf(phi[i]);
    r.cosp = cosf(phi[i]);
    r.kind = kind[i];
    sw[i] = r;
  }
  __syncthreads();

  int col = blockIdx.x * blockDim.x + threadIdx.x;
  int row = blockIdx.y * blockDim.y + threadIdx.y;
  if (col >= cols || row >= rows) return;
  int tile = blockIdx.y * gridDim.x + blockIdx.x;
  int NW = (W + 31) / 32;
  ListedWalls lists{losw + static_cast<size_t>(tile) * NW, l0w,
                    lastw + static_cast<size_t>(tile) * W * NW, NW};
  int p = row * cols + col;
  float x = px[p], y = py[p];
  float txx = __ldg(tx), txy = __ldg(tx + 1);
  float v = 0.0f, gx = 0.0f, gy = 0.0f;
  float cv, cgx, cgy;
  if (has_los) {
    int none[1] = {-1};
    float noimg[1] = {0.0f};
    contrib<G, SOFT, 0>(sw, none, noimg, noimg, txx, txy, x, y, s, lists, cv, cgx, cgy);
    v = v + cv;
    if (G) {
      gx = gx + cgx;
      gy = gy + cgy;
    }
  }
  const int* kept = prm + static_cast<size_t>(tile) * C;
  int n = __ldg(cnt + tile);
  for (int i = 0; i < n; ++i) {
    int c = __ldg(kept + i);
    int id[1] = {__ldg(cand + c)};
    float imx[1] = {__ldg(img + 2 * c)}, imy[1] = {__ldg(img + 2 * c + 1)};
    contrib<G, SOFT, 1>(sw, id, imx, imy, txx, txy, x, y, s, lists, cv, cgx, cgy);
    v = v + cv;
    if (G) {
      gx = gx + cgx;
      gy = gy + cgy;
    }
  }
  out[p] = accumulate ? out[p] + v : v;
  if (G) {
    gout[2 * p] = accumulate ? gout[2 * p] + gx : gx;
    gout[2 * p + 1] = accumulate ? gout[2 * p + 1] + gy : gy;
  }
}

__global__ void sigmoid_kernel(const float* __restrict__ z, float* __restrict__ out,
                               int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = sigm(z[i]);
}

template <bool G>
int launch(int soft_mode, const float* px, const float* py, int rows, int cols,
           int tile_w, int tile_h, const float* tx, const float* walls,
           const float* aux, const int* kind, const float* phi, int W,
           int has_los, const int* cand, const float* img, int C, const int* prm,
           const int* cnt, const int* l0w, const int* lastw, const int* losw,
           Scalars s, int accumulate, float* out, float* gout,
           cudaStream_t stream) {
  if (rows <= 0 || cols <= 0 || tile_w <= 0 || tile_h <= 0 ||
      tile_w * tile_h > LP_MAX_THREADS || W < 0 || W > LP_MAX_WALLS || C < 0 ||
      soft_mode < SOFT_NONE || soft_mode > SOFT_SIGMOID)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();  // clear any earlier error of this runtime
  dim3 grid((cols + tile_w - 1) / tile_w, (rows + tile_h - 1) / tile_h);
  dim3 block(tile_w, tile_h);
  const unsigned* l0 = reinterpret_cast<const unsigned*>(l0w);
  const unsigned* last = reinterpret_cast<const unsigned*>(lastw);
  const unsigned* los = reinterpret_cast<const unsigned*>(losw);
  switch (soft_mode) {
    case SOFT_NONE:
      looped_kernel<G, SOFT_NONE><<<grid, block, 0, stream>>>(
          px, py, rows, cols, tx, walls, aux, kind, phi, W, has_los, cand, img, C,
          prm, cnt, l0, last, los, s, accumulate, out, gout);
      break;
    case SOFT_HARD:
      looped_kernel<G, SOFT_HARD><<<grid, block, 0, stream>>>(
          px, py, rows, cols, tx, walls, aux, kind, phi, W, has_los, cand, img, C,
          prm, cnt, l0, last, los, s, accumulate, out, gout);
      break;
    default:
      looped_kernel<G, SOFT_SIGMOID><<<grid, block, 0, stream>>>(
          px, py, rows, cols, tx, walls, aux, kind, phi, W, has_los, cand, img, C,
          prm, cnt, l0, last, los, s, accumulate, out, gout);
      break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Value map of one transmitter: out[rows * cols] (added to out with
// `accumulate`).  `cand` is int32[C] (the wall of each order-1 candidate),
// `img` float32[C, 2] its mirror image of the transmitter, `aux`
// float32[W, 6] each wall's unit normal and patched endpoints; the tables
// are laid out as the header says.  Returns cudaGetLastError() after the
// launch.
int power_map_looped_value(int soft_mode, const float* px, const float* py,
                           int rows, int cols, int tile_w, int tile_h,
                           const float* tx, const float* walls, const float* aux,
                           const int* kind, const float* phi, int W, int has_los,
                           const int* cand, const float* img, int C,
                           const int* prm, const int* cnt, const int* l0w,
                           const int* lastw, const int* losw, float alpha,
                           float tol, float patch, float r_coef, float height,
                           int accumulate, float* out, void* stream) {
  Scalars s{alpha, tol, patch, r_coef, height};
  return launch<false>(soft_mode, px, py, rows, cols, tile_w, tile_h, tx, walls,
                       aux, kind, phi, W, has_los, cand, img, C, prm, cnt, l0w,
                       lastw, losw, s, accumulate, out, nullptr,
                       static_cast<cudaStream_t>(stream));
}

// Value and pixel gradient of one transmitter: out[rows * cols],
// gout[rows * cols, 2].
int power_map_looped_vag(int soft_mode, const float* px, const float* py,
                         int rows, int cols, int tile_w, int tile_h,
                         const float* tx, const float* walls, const float* aux,
                         const int* kind, const float* phi, int W, int has_los,
                         const int* cand, const float* img, int C, const int* prm,
                         const int* cnt, const int* l0w, const int* lastw,
                         const int* losw, float alpha, float tol, float patch,
                         float r_coef, float height, int accumulate, float* out,
                         float* gout, void* stream) {
  Scalars s{alpha, tol, patch, r_coef, height};
  return launch<true>(soft_mode, px, py, rows, cols, tile_w, tile_h, tx, walls,
                      aux, kind, phi, W, has_los, cand, img, C, prm, cnt, l0w,
                      lastw, losw, s, accumulate, out, gout,
                      static_cast<cudaStream_t>(stream));
}

// out[i] = the kernels' sigmoid of z[i] (1 / (1 + expf(-z))).
int sigmoid_probe(const float* z, float* out, int n, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();
  int blocks = (n + 127) / 128;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  sigmoid_kernel<<<blocks, 128, 0, st>>>(z, out, n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

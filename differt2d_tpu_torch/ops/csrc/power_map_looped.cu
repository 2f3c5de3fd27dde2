// Looped power-map kernels for NVIDIA Hopper (sm_90a):
// power_map_looped_value and power_map_looped_vag.
//
// Replaces the looped Pallas TPU kernel
// differt2d_tpu/ops/pallas_kernels.py::build_power_map_kernel_looped
// (pallas_call at :3430) as get_fused_run builds it for the city scenes,
// with cull=True, shadow=True: B3 (the candidate loop over runtime walls),
// B4 (per-tile kept-candidate lists) and B5 (occluder sets of the first,
// last and line-of-sight segments, and, for candidates of order >= 2, of
// the middle segments).  Both compute, per receiver-grid pixel and for one
// transmitter,
//
//     sum over candidates of valid * r_coef**order / (height**2 + r**2)
//
// with the per-candidate routine of power_map.cu (power_map_common.cuh),
// and power_map_looped_vag adds its hand-derived pixel gradient.
//
// Design: one thread per pixel, and one block per culling tile, a compact
// tile_w x tile_h rectangle of the [rows, cols] grid; tile t is block
// (t % gridDim.x, t / gridDim.x).  The line of sight comes first, then one
// candidate group per order (1, 2, ...), as the TPU kernel visits them.
// The tables are data, read per tile:
//
//   prm_o[T, C_o], cnt_o[T] kept candidates of order o in tile t, in index
//                            order, and their count (beam proof, first-wall
//                            and wall-pair kills,
//                            ops/cull_tables.py::beam_keep_tables);
//   l0w[W, NW]              occluders of a first segment TX -> b1, per
//                            first wall (NW = ceil(W / 32) bit words);
//   lastw[T, W, NW]          occluders of a last segment b_o -> pixel, per
//                            tile and last wall;
//   midw[W * W, NW]          occluders of a middle segment b_s -> b_{s+1},
//                            per (upstream, downstream) wall pair, row
//                            i * W + j (order >= 2 only);
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
// occluder sets are bit words, visited set bit by set bit, lowest first,
// for every segment alike.  The JAX package keeps int32[T, W, W] index
// lists for orders <= 1 (606 MB per map at 1024x1024 with 128-pixel tiles
// and 136 walls; the words are 11 MB with 256-pixel tiles) and, for
// orders >= 2, one chunk-occupancy word per 8 walls (a TPU compiler and
// scalar-memory constraint) with a list fallback above 256 walls: the
// per-wall words need neither, and skip every wall the proofs allow.
// The middle-segment words are 370 KB at 136 walls (16.8 MB at 512), read
// through L2 by every block.
// Per-wall unit normals and patched endpoints (aux[W, 6]) and the
// transmitter's mirror-image chains (img_o[C_o, o, 2]) are per-launch
// constants that the wrapper computes once, the same numbers the tables are
// proven on.  One launch per transmitter; with `accumulate` the launch adds
// its map to `out` (transmitter order, as get_fused_run adds its kernel
// outputs).  The kernel is a template on the request's highest order, so an
// order-1 map keeps the registers of an order-1 program.
//
// Bound on the H100: FP32 compute.  A city map reads 8 B and writes 4 B per
// pixel (12 B/px, 20 B/px with the gradient), and the tables are read once
// per block entry; the unculled map needs about (C + 1) x (W - 1) x (o + 1)
// blocked tests of ~18 operations per pixel (0.67 M operations per pixel at
// order <= 1 and 136 walls, 135 M at order 2), and the tables leave the
// kept candidates times their listed occluders, summed over tiles
// (chip_smoke.py counts both).  The tables are the design's answer to the
// bound; within what they leave this first version does nothing beyond
// keeping every intermediate in registers.
//
// Numerics: those of power_map.cu (-fmad=false, expf, NaN-propagating
// min/max, explicit [0, 1] clamps).  sigmoid_probe evaluates the kernels'
// own sigmoid for the wrapper's check of its f32 saturation bands.
// Caps: W <= LP_MAX_WALLS, order <= LP_MAX_ORDER, tile_w * tile_h <=
// LP_MAX_THREADS (power_map_looped.py repeats these defines, and a test
// holds them equal).

#include "power_map_common.cuh"

#define LP_MAX_ORDER 4
#define LP_MAX_WALLS 512
#define LP_MAX_THREADS 256

namespace {

// Blocked-test policy of the looped kernels: the segment's occluder bit
// words, set bits lowest first.  Order 0 has one segment, the line of
// sight; order O >= 1 a first (TX -> b1), O - 1 middle (b_s -> b_{s+1})
// and a last (b_O -> pixel) segment.
struct ListedWalls {
  const unsigned* __restrict__ los;   // [NW], this tile's
  const unsigned* __restrict__ l0;    // [W, NW]
  const unsigned* __restrict__ last;  // [W, NW], this tile's
  const unsigned* __restrict__ mid;   // [W * W, NW]
  int W, NW;

  template <int O, class F>
  __device__ __forceinline__ void for_each(int seg, const int* id, F&& f) const {
    const unsigned* words;
    if (O == 0) {
      words = los;
    } else if (seg == 0) {
      words = l0 + id[0] * NW;
    } else if (seg == O) {
      words = last + id[O > 0 ? O - 1 : 0] * NW;
    } else {
      words = mid + (static_cast<size_t>(id[seg - 1]) * W + id[seg]) * NW;
    }
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

// The candidate groups of one launch, by order 1..LP_MAX_ORDER (index
// order - 1): candidates int32[C, order], mirror-image chains
// float32[C, order, 2], kept lists int32[T, C] and counts int32[T]; C = 0
// for an order without candidates.
struct Groups {
  const int* cand[LP_MAX_ORDER];
  const float* img[LP_MAX_ORDER];
  const int* prm[LP_MAX_ORDER];
  const int* cnt[LP_MAX_ORDER];
  int C[LP_MAX_ORDER];
};

// Adds the kept candidates of order O of this tile to (v, gx, gy).
template <bool G, int SOFT, int O>
__device__ __forceinline__ void order_group(const WallRec* __restrict__ sw,
                                            const Groups& g, int tile,
                                            const ListedWalls& lists, float txx,
                                            float txy, float x, float y,
                                            const Scalars& s, float& v, float& gx,
                                            float& gy) {
  int C = g.C[O - 1];
  if (C == 0) return;
  const int* __restrict__ cand = g.cand[O - 1];
  const float* __restrict__ img = g.img[O - 1];
  const int* kept = g.prm[O - 1] + static_cast<size_t>(tile) * C;
  int n = __ldg(g.cnt[O - 1] + tile);
  for (int i = 0; i < n; ++i) {
    int c = __ldg(kept + i);
    int id[O];
    float imx[O], imy[O];
#pragma unroll
    for (int j = 0; j < O; ++j) {
      id[j] = __ldg(cand + O * c + j);
      imx[j] = __ldg(img + 2 * (O * c + j));
      imy[j] = __ldg(img + 2 * (O * c + j) + 1);
    }
    float cv, cgx, cgy;
    contrib<G, SOFT, O>(sw, id, imx, imy, txx, txy, x, y, s, lists, cv, cgx, cgy);
    v = v + cv;
    if (G) {
      gx = gx + cgx;
      gy = gy + cgy;
    }
  }
}

template <bool G, int SOFT, int MAXO>
__global__ void __launch_bounds__(LP_MAX_THREADS)
    looped_kernel(const float* __restrict__ px, const float* __restrict__ py,
                  int rows, int cols, const float* __restrict__ tx,
                  const float* __restrict__ walls, const float* __restrict__ aux,
                  const int* __restrict__ kind, const float* __restrict__ phi,
                  int W, int has_los, Groups groups,
                  const unsigned* __restrict__ l0w,
                  const unsigned* __restrict__ lastw,
                  const unsigned* __restrict__ losw,
                  const unsigned* __restrict__ midw, Scalars s, int accumulate,
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
                    lastw + static_cast<size_t>(tile) * W * NW, midw, W, NW};
  int p = row * cols + col;
  float x = px[p], y = py[p];
  float txx = __ldg(tx), txy = __ldg(tx + 1);
  float v = 0.0f, gx = 0.0f, gy = 0.0f;
  if (has_los) {
    int none[1] = {-1};
    float noimg[1] = {0.0f};
    float cv, cgx, cgy;
    contrib<G, SOFT, 0>(sw, none, noimg, noimg, txx, txy, x, y, s, lists, cv, cgx, cgy);
    v = v + cv;
    if (G) {
      gx = gx + cgx;
      gy = gy + cgy;
    }
  }
  order_group<G, SOFT, 1>(sw, groups, tile, lists, txx, txy, x, y, s, v, gx, gy);
  if constexpr (MAXO >= 2)
    order_group<G, SOFT, 2>(sw, groups, tile, lists, txx, txy, x, y, s, v, gx, gy);
  if constexpr (MAXO >= 3)
    order_group<G, SOFT, 3>(sw, groups, tile, lists, txx, txy, x, y, s, v, gx, gy);
  if constexpr (MAXO >= 4)
    order_group<G, SOFT, 4>(sw, groups, tile, lists, txx, txy, x, y, s, v, gx, gy);
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

template <bool G, int SOFT>
void launch_order(int max_order, dim3 grid, dim3 block, cudaStream_t stream,
                  const float* px, const float* py, int rows, int cols,
                  const float* tx, const float* walls, const float* aux,
                  const int* kind, const float* phi, int W, int has_los,
                  const Groups& g, const unsigned* l0, const unsigned* last,
                  const unsigned* los, const unsigned* mid, Scalars s,
                  int accumulate, float* out, float* gout) {
#define LP_LAUNCH(MAXO)                                                        \
  looped_kernel<G, SOFT, MAXO><<<grid, block, 0, stream>>>(                    \
      px, py, rows, cols, tx, walls, aux, kind, phi, W, has_los, g, l0, last, \
      los, mid, s, accumulate, out, gout)
  switch (max_order) {
    case 0:
    case 1:
      LP_LAUNCH(1);
      break;
    case 2:
      LP_LAUNCH(2);
      break;
    case 3:
      LP_LAUNCH(3);
      break;
    default:
      LP_LAUNCH(4);
      break;
  }
#undef LP_LAUNCH
}

template <bool G>
int launch(int soft_mode, const float* px, const float* py, int rows, int cols,
           int tile_w, int tile_h, const float* tx, const float* walls,
           const float* aux, const int* kind, const float* phi, int W,
           int has_los, int max_order, const void* const* group_ptrs,
           const int* group_sizes, const int* l0w, const int* lastw,
           const int* losw, const int* midw, Scalars s, int accumulate,
           float* out, float* gout, cudaStream_t stream) {
  if (rows <= 0 || cols <= 0 || tile_w <= 0 || tile_h <= 0 ||
      tile_w * tile_h > LP_MAX_THREADS || W < 0 || W > LP_MAX_WALLS ||
      max_order < 0 || max_order > LP_MAX_ORDER || soft_mode < SOFT_NONE ||
      soft_mode > SOFT_SIGMOID)
    return static_cast<int>(cudaErrorInvalidValue);
  Groups g;
  for (int o = 0; o < LP_MAX_ORDER; ++o) {
    g.cand[o] = static_cast<const int*>(group_ptrs[o]);
    g.img[o] = static_cast<const float*>(group_ptrs[LP_MAX_ORDER + o]);
    g.prm[o] = static_cast<const int*>(group_ptrs[2 * LP_MAX_ORDER + o]);
    g.cnt[o] = static_cast<const int*>(group_ptrs[3 * LP_MAX_ORDER + o]);
    g.C[o] = o < max_order ? group_sizes[o] : 0;
    if (g.C[o] < 0 || (g.C[o] > 0 && (!g.cand[o] || !g.img[o] || !g.prm[o] || !g.cnt[o])))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaGetLastError();  // clear any earlier error of this runtime
  dim3 grid((cols + tile_w - 1) / tile_w, (rows + tile_h - 1) / tile_h);
  dim3 block(tile_w, tile_h);
  const unsigned* l0 = reinterpret_cast<const unsigned*>(l0w);
  const unsigned* last = reinterpret_cast<const unsigned*>(lastw);
  const unsigned* los = reinterpret_cast<const unsigned*>(losw);
  const unsigned* mid = reinterpret_cast<const unsigned*>(midw);
  switch (soft_mode) {
    case SOFT_NONE:
      launch_order<G, SOFT_NONE>(max_order, grid, block, stream, px, py, rows, cols, tx,
                                 walls, aux, kind, phi, W, has_los, g, l0, last, los,
                                 mid, s, accumulate, out, gout);
      break;
    case SOFT_HARD:
      launch_order<G, SOFT_HARD>(max_order, grid, block, stream, px, py, rows, cols, tx,
                                 walls, aux, kind, phi, W, has_los, g, l0, last, los,
                                 mid, s, accumulate, out, gout);
      break;
    default:
      launch_order<G, SOFT_SIGMOID>(max_order, grid, block, stream, px, py, rows, cols,
                                    tx, walls, aux, kind, phi, W, has_los, g, l0, last,
                                    los, mid, s, accumulate, out, gout);
      break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Value map of one transmitter: out[rows * cols] (added to out with
// `accumulate`).  `max_order` is the highest order with candidates;
// `group_ptrs` (host, 4 x LP_MAX_ORDER pointers) holds per order 1..
// LP_MAX_ORDER the device pointers to its candidates int32[C, order],
// mirror images float32[C, order, 2], kept lists int32[T, C] and counts
// int32[T], and `group_sizes` (host, LP_MAX_ORDER) the candidate counts C,
// 0 for an order without candidates; `aux` is float32[W, 6], each wall's
// unit normal and patched endpoints; the occluder words are laid out as the
// header says (midw is read only at orders >= 2).  Returns
// cudaGetLastError() after the launch.
int power_map_looped_value(int soft_mode, const float* px, const float* py,
                           int rows, int cols, int tile_w, int tile_h,
                           const float* tx, const float* walls, const float* aux,
                           const int* kind, const float* phi, int W, int has_los,
                           int max_order, const void* const* group_ptrs,
                           const int* group_sizes, const int* l0w,
                           const int* lastw, const int* losw, const int* midw,
                           float alpha, float tol, float patch, float r_coef,
                           float height, int accumulate, float* out, void* stream) {
  Scalars s{alpha, tol, patch, r_coef, height};
  return launch<false>(soft_mode, px, py, rows, cols, tile_w, tile_h, tx, walls,
                       aux, kind, phi, W, has_los, max_order, group_ptrs,
                       group_sizes, l0w, lastw, losw, midw, s, accumulate, out,
                       nullptr, static_cast<cudaStream_t>(stream));
}

// Value and pixel gradient of one transmitter: out[rows * cols],
// gout[rows * cols, 2].
int power_map_looped_vag(int soft_mode, const float* px, const float* py,
                         int rows, int cols, int tile_w, int tile_h,
                         const float* tx, const float* walls, const float* aux,
                         const int* kind, const float* phi, int W, int has_los,
                         int max_order, const void* const* group_ptrs,
                         const int* group_sizes, const int* l0w, const int* lastw,
                         const int* losw, const int* midw, float alpha, float tol,
                         float patch, float r_coef, float height, int accumulate,
                         float* out, float* gout, void* stream) {
  Scalars s{alpha, tol, patch, r_coef, height};
  return launch<true>(soft_mode, px, py, rows, cols, tile_w, tile_h, tx, walls,
                      aux, kind, phi, W, has_los, max_order, group_ptrs,
                      group_sizes, l0w, lastw, losw, midw, s, accumulate, out,
                      gout, static_cast<cudaStream_t>(stream));
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

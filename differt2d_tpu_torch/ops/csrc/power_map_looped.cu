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
// Design: one thread per pixel; the threads of a block cover one culling
// tile at a time, a compact tile_w x tile_h rectangle of the [rows, cols]
// grid (tile t at tile column t % tiles_x, tile row t / tiles_x).  The
// line of sight comes first, then one
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
// (chip_smoke.py counts both).  The tables are the design's first answer to
// the bound.  Within what they leave, the redesigned sweep (FAST, the
// exported power_map_looped_value / _vag) does less per test and skips
// what the data proves invisible, every bit kept:
//   - wall records for the test as one 16-byte shared vector, vertices and
//     the segment's own walls masked out of the bit words;
//   - a division-free rejection of clear misses (rejected);
//   - a warp skips a candidate's sweep when every lane's on-object or loss
//     gate is dead, and leaves a margin-form sweep once every lane's path
//     is fully blocked (__all_sync);
//   - the gradient sweep keeps the maximum hit and its first test, and
//     forms that one wall's partials after the sweep (a tie inside (0, 1)
//     or a NaN reruns the sequential sweep for the candidate);
//   - a persistent grid takes the tiles longest first.
// The proofs are at fast_sweep and rejected (power_map_common.cuh, where
// power_map_vag shares the sweep).  The sequential sweep
// (FAST = false, exported as power_map_looped_value_seq / _vag_seq) is the
// program as it was before: every listed wall's full test, one block per
// tile in grid order; checks hold the two equal bit for bit.
//
// Numerics: those of power_map.cu (-fmad=false, expf, NaN-propagating
// min/max, explicit [0, 1] clamps).  sigmoid_band_probe checks the kernels'
// own sigmoid over whole float32 bands for the wrapper (sigmoid culling, the
// rejection floors, the saturation exit).
// Caps: W <= LP_MAX_WALLS, order <= LP_MAX_ORDER, tile_w * tile_h <=
// LP_MAX_THREADS (power_map_looped.py repeats these defines, and a test
// holds them equal).

#include "power_map_common.cuh"

#define LP_MAX_ORDER 4
#define LP_MAX_WALLS 512
#define LP_MAX_THREADS 256

namespace {

constexpr int LP_MAX_WORDS = LP_MAX_WALLS / 32;

// Blocked-test policy of the looped kernels: the segment's occluder bit
// words, set bits lowest first.  Order 0 has one segment, the line of
// sight; order O >= 1 a first (TX -> b1), O - 1 middle (b_s -> b_{s+1})
// and a last (b_O -> pixel) segment.  for_each is the sequential sweep
// (contrib's loop, the _seq twins' whole sweep); fast_blocked is the
// redesigned one.
struct ListedWalls {
  const unsigned* __restrict__ los;   // [NW], this tile's
  const unsigned* __restrict__ l0;    // [W, NW]
  const unsigned* __restrict__ last;  // [W, NW], this tile's
  const unsigned* __restrict__ mid;   // [W * W, NW]
  int W, NW;
  // Redesigned sweep only:
  const float4* sv;       // [W] test records, shared memory
  const unsigned* solid;  // [NW] non-vertex walls, shared memory
  float tlo, thi, sat;    // rejection bounds, saturation margin
  unsigned vote;          // lanes of this thread's warp
  int features;           // kGateExit

  template <int O>
  __device__ __forceinline__ const unsigned* words_of(int seg, const int* id) const {
    if (O == 0) return los;
    if (seg == 0) return l0 + id[0] * NW;
    if (seg == O) return last + id[O > 0 ? O - 1 : 0] * NW;
    return mid + (static_cast<size_t>(id[seg - 1]) * W + id[seg]) * NW;
  }

  template <int O, class F>
  __device__ __forceinline__ void for_each(int seg, const int* id, F&& f) const {
    const unsigned* words = words_of<O>(seg, id);
    for (int k = 0; k < NW; ++k) {
      unsigned bits = __ldg(words + k);
      while (bits) {
        int b = __ffs(bits) - 1;
        bits &= bits - 1u;
        f(32 * k + b);
      }
    }
  }

  // Word k of a segment's walls to test: listed, not a vertex, not the
  // segment's own walls (contrib's skips, without the 60-byte record).
  __device__ __forceinline__ unsigned testable(const unsigned* words, int k, int skip0,
                                               int skip1) const {
    return drop_own(__ldg(words + k) & solid[k], k, skip0, skip1);
  }

  // The redesigned blocked test of one candidate (the sweep and its
  // proof are at fast_sweep, power_map_common.cuh).
  template <bool G, int SOFT, int O>
  __device__ __forceinline__ bool fast_blocked(const WallRec* __restrict__ sw,
                                               const Chain<O>& ch, const int* id,
                                               const Scalars& s, bool gate_dead, float& blk,
                                               float& gbx, float& gby) const {
    return fast_sweep<G, SOFT, O>(*this, sw, ch, id, s, gate_dead, blk, gbx, gby);
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
template <bool G, int SOFT, int O, bool FAST>
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
    contrib<G, SOFT, O, ListedWalls, FAST>(sw, id, imx, imy, txx, txy, x, y, s, lists, cv,
                                           cgx, cgy);
    v = v + cv;
    if (G) {
      gx = gx + cgx;
      gy = gy + cgy;
    }
  }
}

// The map (and gradient) of one pixel of one tile: the line of sight,
// then the order groups in order.
template <bool G, int SOFT, int MAXO, bool FAST>
__device__ __forceinline__ void pixel_map(const WallRec* __restrict__ sw, int has_los,
                                          const Groups& groups, int tile,
                                          const ListedWalls& lists, float txx, float txy,
                                          float x, float y, const Scalars& s, float& v,
                                          float& gx, float& gy) {
  v = 0.0f;
  gx = 0.0f;
  gy = 0.0f;
  if (has_los) {
    int none[1] = {-1};
    float noimg[1] = {0.0f};
    float cv, cgx, cgy;
    contrib<G, SOFT, 0, ListedWalls, FAST>(sw, none, noimg, noimg, txx, txy, x, y, s, lists,
                                           cv, cgx, cgy);
    v = v + cv;
    if (G) {
      gx = gx + cgx;
      gy = gy + cgy;
    }
  }
  order_group<G, SOFT, 1, FAST>(sw, groups, tile, lists, txx, txy, x, y, s, v, gx, gy);
  if constexpr (MAXO >= 2)
    order_group<G, SOFT, 2, FAST>(sw, groups, tile, lists, txx, txy, x, y, s, v, gx, gy);
  if constexpr (MAXO >= 3)
    order_group<G, SOFT, 3, FAST>(sw, groups, tile, lists, txx, txy, x, y, s, v, gx, gy);
  if constexpr (MAXO >= 4)
    order_group<G, SOFT, 4, FAST>(sw, groups, tile, lists, txx, txy, x, y, s, v, gx, gy);
}

// FAST = false is the sequential sweep (the _seq twins): one block per tile
// in grid order, every listed wall's full test.  FAST = true is the
// redesigned program: the same per-candidate routine with fast_blocked in
// front of the sweep, and a persistent grid (a few blocks per SM, sized by
// the occupancy of this instantiation) whose blocks take tiles from `order`
// (the tiles by descending blocked-test count, built with the tables)
// through an atomic counter, so the longest tiles start first and the last
// wave is made of the shortest.  A pixel is still computed by one thread,
// so the order moves no bit; the threads of a ragged edge tile's missing
// pixels compute a copy of an edge pixel and write nothing, so every warp
// is whole at its votes.
template <bool G, int SOFT, int MAXO, bool FAST>
__global__ void __launch_bounds__(LP_MAX_THREADS)
    looped_kernel(const float* __restrict__ px, const float* __restrict__ py,
                  int rows, int cols, const float* __restrict__ tx,
                  const float* __restrict__ walls, const float* __restrict__ aux,
                  const int* __restrict__ kind, const float* __restrict__ phi,
                  int W, int has_los, Groups groups,
                  const unsigned* __restrict__ l0w,
                  const unsigned* __restrict__ lastw,
                  const unsigned* __restrict__ losw,
                  const unsigned* __restrict__ midw, const int* __restrict__ order,
                  int* __restrict__ counter, float tlo, float thi, float sat, int features,
                  Scalars s,
                  int accumulate, float* __restrict__ out, float* __restrict__ gout) {
  __shared__ WallRec sw[LP_MAX_WALLS];
  __shared__ float4 sv[FAST ? LP_MAX_WALLS : 1];
  __shared__ unsigned ssolid[FAST ? LP_MAX_WORDS : 1];
  __shared__ int s_next;
  int nthreads = blockDim.x * blockDim.y;
  int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int i = tid; i < W; i += nthreads) {
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
    if constexpr (FAST) sv[i] = make_float4(r.pax, r.pay, r.pbx - r.pax, r.pby - r.pay);
  }
  int NW = (W + 31) / 32;
  if constexpr (FAST) {
    for (int k = tid; k < NW; k += nthreads) {
      unsigned word = 0u;
      for (int b = 0; b < 32 && 32 * k + b < W; ++b)
        if (kind[32 * k + b] != KIND_VERTEX) word |= 1u << b;
      ssolid[k] = word;
    }
  }
  __syncthreads();
  float txx = __ldg(tx), txy = __ldg(tx + 1);

  if constexpr (!FAST) {
    int col = blockIdx.x * blockDim.x + threadIdx.x;
    int row = blockIdx.y * blockDim.y + threadIdx.y;
    if (col >= cols || row >= rows) return;
    int tile = blockIdx.y * gridDim.x + blockIdx.x;
    ListedWalls lists{losw + static_cast<size_t>(tile) * NW, l0w,
                      lastw + static_cast<size_t>(tile) * W * NW, midw, W, NW};
    int p = row * cols + col;
    float v, gx, gy;
    pixel_map<G, SOFT, MAXO, FAST>(sw, has_los, groups, tile, lists, txx, txy, px[p], py[p],
                                   s, v, gx, gy);
    out[p] = accumulate ? out[p] + v : v;
    if (G) {
      gout[2 * p] = accumulate ? gout[2 * p] + gx : gx;
      gout[2 * p + 1] = accumulate ? gout[2 * p + 1] + gy : gy;
    }
  } else {
    int tiles_x = (cols + blockDim.x - 1) / blockDim.x;
    int T = tiles_x * ((rows + blockDim.y - 1) / blockDim.y);
    int lanes = nthreads - (tid & ~31);
    unsigned vote = lanes >= 32 ? 0xffffffffu : (1u << lanes) - 1u;
    for (;;) {
      if (tid == 0) s_next = atomicAdd(counter, 1);
      __syncthreads();
      int i = s_next;
      __syncthreads();
      if (i >= T) break;
      int tile = __ldg(order + i);
      int col = (tile % tiles_x) * blockDim.x + threadIdx.x;
      int row = (tile / tiles_x) * blockDim.y + threadIdx.y;
      bool inside = col < cols && row < rows;
      int p = min(row, rows - 1) * cols + min(col, cols - 1);
      ListedWalls lists{losw + static_cast<size_t>(tile) * NW, l0w,
                        lastw + static_cast<size_t>(tile) * W * NW, midw, W, NW,
                        sv, ssolid, tlo, thi, sat, vote, features};
      float v, gx, gy;
      pixel_map<G, SOFT, MAXO, FAST>(sw, has_los, groups, tile, lists, txx, txy, px[p],
                                     py[p], s, v, gx, gy);
      if (inside) {
        out[p] = accumulate ? out[p] + v : v;
        if (G) {
          gout[2 * p] = accumulate ? gout[2 * p] + gx : gx;
          gout[2 * p + 1] = accumulate ? gout[2 * p + 1] + gy : gy;
        }
      }
    }
  }
}

template <bool G, int SOFT, bool FAST>
int launch_order(int max_order, int T, dim3 grid, dim3 block, cudaStream_t stream,
                 const float* px, const float* py, int rows, int cols, const float* tx,
                 const float* walls, const float* aux, const int* kind, const float* phi,
                 int W, int has_los, const Groups& g, const unsigned* l0,
                 const unsigned* last, const unsigned* los, const unsigned* mid,
                 const int* order, int* counter, float tlo, float thi, float sat,
                 int features, Scalars s, int accumulate, float* out, float* gout) {
#define LP_LAUNCH(MAXO)                                                              \
  do {                                                                               \
    auto kern = looped_kernel<G, SOFT, MAXO, FAST>;                                  \
    dim3 gr = grid;                                                                  \
    if (FAST) {                                                                      \
      int dev = 0, sms = 0, per_sm = 0;                                              \
      cudaGetDevice(&dev);                                                           \
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);             \
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,                   \
                                                    block.x * block.y, 0);           \
      if (sms <= 0 || per_sm <= 0) return static_cast<int>(cudaErrorInvalidValue);   \
      gr = dim3(static_cast<unsigned>(T < sms * per_sm ? T : sms * per_sm));         \
      cudaMemsetAsync(counter, 0, sizeof(int), stream);                              \
    }                                                                                \
    kern<<<gr, block, 0, stream>>>(px, py, rows, cols, tx, walls, aux, kind, phi, W, \
                                   has_los, g, l0, last, los, mid, order, counter,   \
                                   tlo, thi, sat, features, s, accumulate, out,      \
                                   gout);                                            \
  } while (0)
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
  return 0;
}

template <bool G, bool FAST>
int launch(int soft_mode, const float* px, const float* py, int rows, int cols,
           int tile_w, int tile_h, const float* tx, const float* walls,
           const float* aux, const int* kind, const float* phi, int W,
           int has_los, int max_order, const void* const* group_ptrs,
           const int* group_sizes, const int* l0w, const int* lastw,
           const int* losw, const int* midw, const int* order, int* counter,
           float tlo, float thi, float sat, int features, Scalars s, int accumulate,
           float* out, float* gout, cudaStream_t stream) {
  if (rows <= 0 || cols <= 0 || tile_w <= 0 || tile_h <= 0 ||
      tile_w * tile_h > LP_MAX_THREADS || W < 0 || W > LP_MAX_WALLS ||
      max_order < 0 || max_order > LP_MAX_ORDER || soft_mode < SOFT_NONE ||
      soft_mode > SOFT_SIGMOID || (FAST && (!order || !counter)))
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
  int T = static_cast<int>(grid.x * grid.y);
  const unsigned* l0 = reinterpret_cast<const unsigned*>(l0w);
  const unsigned* last = reinterpret_cast<const unsigned*>(lastw);
  const unsigned* los = reinterpret_cast<const unsigned*>(losw);
  const unsigned* mid = reinterpret_cast<const unsigned*>(midw);
  int rc;
  switch (soft_mode) {
    case SOFT_NONE:
      rc = launch_order<G, SOFT_NONE, FAST>(max_order, T, grid, block, stream, px, py, rows,
                                            cols, tx, walls, aux, kind, phi, W, has_los, g,
                                            l0, last, los, mid, order, counter, tlo, thi,
                                            sat, features, s, accumulate, out, gout);
      break;
    case SOFT_HARD:
      rc = launch_order<G, SOFT_HARD, FAST>(max_order, T, grid, block, stream, px, py, rows,
                                            cols, tx, walls, aux, kind, phi, W, has_los, g,
                                            l0, last, los, mid, order, counter, tlo, thi,
                                            sat, features, s, accumulate, out, gout);
      break;
    default:
      rc = launch_order<G, SOFT_SIGMOID, FAST>(max_order, T, grid, block, stream, px, py,
                                               rows, cols, tx, walls, aux, kind, phi, W,
                                               has_los, g, l0, last, los, mid, order,
                                               counter, tlo, thi, sat, features, s,
                                               accumulate, out, gout);
      break;
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The four entry points share one argument list:
//   (soft_mode, px, py, rows, cols, tile_w, tile_h, tx, walls, aux, kind,
//    phi, W, has_los, max_order, group_ptrs, group_sizes, l0w, lastw, losw,
//    midw, order, counter, tlo, thi, sat, features, alpha, tol, patch, r_coef,
//    height, accumulate, out[, gout], stream).
// `max_order` is the highest order with candidates; `group_ptrs` (host,
// 4 x LP_MAX_ORDER pointers) holds per order 1..LP_MAX_ORDER the device
// pointers to its candidates int32[C, order], mirror images float32[C,
// order, 2], kept lists int32[T, C] and counts int32[T], and `group_sizes`
// (host, LP_MAX_ORDER) the candidate counts C, 0 for an order without
// candidates; `aux` is float32[W, 6], each wall's unit normal and patched
// endpoints; the occluder words are laid out as the header says (midw is
// read only at orders >= 2); `order` int32[T] is the tiles' work list and
// `counter` one int32 of device scratch (zeroed by the launch); tlo, thi
// and sat are the rejection bounds and the saturation margin
// (power_map_looped.rejection_bounds), `features` the gate exits' bit
// (kGateExit; cleared only to measure them).  The _seq twins ignore order,
// counter, tlo, thi, sat and features.  Each returns cudaGetLastError() after the
// launch; with `accumulate` the map is added to out (and gout).
#define LP_ARGS                                                                     \
  int soft_mode, const float *px, const float *py, int rows, int cols, int tile_w,   \
      int tile_h, const float *tx, const float *walls, const float *aux,             \
      const int *kind, const float *phi, int W, int has_los, int max_order,          \
      const void *const *group_ptrs, const int *group_sizes, const int *l0w,         \
      const int *lastw, const int *losw, const int *midw, const int *order,          \
      int *counter, float tlo, float thi, float sat, int features, float alpha,      \
      float tol,                                                                     \
      float patch, float r_coef, float height, int accumulate, float *out
#define LP_PASS                                                                      \
  soft_mode, px, py, rows, cols, tile_w, tile_h, tx, walls, aux, kind, phi, W,       \
      has_los, max_order, group_ptrs, group_sizes, l0w, lastw, losw, midw, order,    \
      counter, tlo, thi, sat, features, Scalars{alpha, tol, patch, r_coef, height},   \
      accumulate,                                                                    \
      out

extern "C" {

// Value map of one transmitter, redesigned sweep: out[rows * cols].
int power_map_looped_value(LP_ARGS, void* stream) {
  return launch<false, true>(LP_PASS, nullptr, static_cast<cudaStream_t>(stream));
}

// Value and pixel gradient of one transmitter, redesigned sweep:
// out[rows * cols], gout[rows * cols, 2].
int power_map_looped_vag(LP_ARGS, float* gout, void* stream) {
  return launch<true, true>(LP_PASS, gout, static_cast<cudaStream_t>(stream));
}

// The same maps through the sequential sweep (every listed wall's full
// test, one block per tile in grid order): the redesigned kernels' bitwise
// reference, called by checks only.
int power_map_looped_value_seq(LP_ARGS, void* stream) {
  return launch<false, false>(LP_PASS, nullptr, static_cast<cudaStream_t>(stream));
}

int power_map_looped_vag_seq(LP_ARGS, float* gout, void* stream) {
  return launch<true, false>(LP_PASS, gout, static_cast<cudaStream_t>(stream));
}

// Adds to fails[0] the count of float32 values z where the kernels'
// sigmoid breaks band `test` (see sigmoid_band_kernel): every z <= bound
// for tests 0 and 1 (bound < 0), every z >= bound for test 2 (bound > 0),
// infinities included.
int sigmoid_band_probe(float bound, int test, unsigned* fails, void* stream) {
  return sigmoid_band_probe_launch(bound, test, fails, stream);
}

}  // extern "C"

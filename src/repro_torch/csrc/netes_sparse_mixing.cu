// Sparse NetES mixing (paper Eq. 3 over a padded neighbor list) for
// Hopper, sm_90a.
//
//   out[j, :] = Σ_k m_jk R̃θ_{i_jk} θ[i_jk, :] + σ Σ_k m_jk R̃ε_{i_jk} ε[i_jk, :]
//               − (Σ_k m_jk R̃θ_{i_jk}) θ[j, :]
//
// with i_jk = neighbor_idx[j, k] and m_jk = neighbor_mask[j, k] (the edge
// weight a_ji; 0 on padding, whose slots index row j itself).
//
// Replaces the TPU kernel src/repro/kernels/netes_sparse_mixing.py:62
// `netes_sparse_mixing` (body `_sparse_mixing_kernel`, pallas_call at :83),
// which keeps (N, TILE_P) slabs of θ and ε resident in VMEM and gathers
// the K_max neighbour rows of each receiver from the slab.
//
// The sum is factored, which is the same function:
//
//   out_j = Σ_k m_jk·Y[i_jk] − wsum_j·θ_j,   Y_i = R̃θ_i·θ_i + (σ·R̃ε_i)·ε_i,
//   wsum_j = Σ_k m_jk·R̃θ_{i_jk},
//
// so one row is gathered per slot instead of two, and Y never goes to
// device memory.
//
// Why a slab. The first design (one block per receiver and 512 columns)
// gathered every neighbour row segment from L2: N·K_max·P·8 bytes ≈ 4.7 GB
// per call at N = 1000, K_max = 130, P = 4481, at the L2's own rate: 0.51
// ms on an NVIDIA H100 80GB HBM3 (700 W), level with torch.sparse.mm,
// which hits the same wall. Here a block holds a slab of SLAB = 32
// columns of Y for the senders in shared memory (128 bytes a sender:
// 128 KB at N = 1000) and gathers from there, at 128 bytes a clock per
// SM (≈ 33 TB/s across the card at 1.98 GHz); L2 serves only the
// compacted topology and the staging.
//
// One cooperative launch, two phases and a grid barrier between them (the
// phases and the walk are csrc/_slab.cuh, shared with fused_neighbor_sum;
// this file supplies the operands: the lists' weights and wsum, the
// staging of Y and the epilogue's −wsum_j·θ_j):
//
// 1. Compaction, a warp per (receiver j, sender chunk c) across the grid:
//    the slots of j whose sender lies in chunk c, in slot order, skipping
//    a slot of weight 0 that indexes j itself (padding: its term is 0·Y_j,
//    and out_j carries θ_j through −wsum_j·θ_j), as (byte offset of the
//    sender's slab row, m) in a scratch list, padded with dummies (the
//    zero row, weight 0) to a multiple of 8; the list's length; and the
//    chunk's wsum, lane partials in slot order then a butterfly. This is
//    done once per call, not once per slab.
// 2. Work: the (slab, receiver) units in slab-major order, cut into one
//    equal run per block of a grid of resident blocks (the plan is made by
//    the wrapper, kernels/_slab.py, from this library's occupancy query). A
//    run covers one slab or the tail of one and the head of the next. For
//    each slab of its run and each sender chunk the block stages the slab,
//    then its warps walk the run's receivers, a warp per receiver.
//    - Staging: each lane loads one column of 16 sender rows at a time
//      (32 loads in flight), forms Y in registers and stores it. P = 4481
//      leaves θ's rows 4-byte aligned only: TMA needs 16-byte strides, and
//      4-byte cp.async would need a second (N, 32) buffer for ε, which does
//      not fit beside Y. Columns past P hold 0.
//    - Chunks: when N rows do not fit in the 227 KB a block may use (N >
//      1558), the senders are cut into chunks, staged in turn; a receiver's
//      pass over chunk c takes the list phase 1 made for c (so the result
//      does not depend on the order of a row's indices) and adds
//      Σ m·Y − wsum_c·θ_j to out (the first pass stores it).
//    - Gather: a warp copies its receiver's list into its ring (16-byte
//      cp.async from L2, up to 128 entries a round, one round ahead), then
//      its four 8-lane subgroups take two entries each per step: one
//      16-byte shared load of the two entries, then one 16-byte load of
//      each sender's 32 columns (8 lanes read a row's 128 bytes: no bank
//      conflict whatever the rows, so the row stride needs no swizzle or
//      padding), 8 FMAs. Four steps' loads are issued before their FMAs.
//    - Epilogue: the subgroups' sums meet in a fixed two-step exchange that
//      leaves each lane one column; wsum and θ_j are loaded a receiver
//      ahead; the store is one coalesced 128-byte row segment.
// No atomics, and a fixed order everywhere: two launches give the same
// bits.
//
// What bounds it on the H100: the function's least work, in the factored
// form, is 2·nnz·P + 5·N·P flops (0.92 GFLOP at nnz ≈ 1e5, 0.014 ms at 67
// TFLOP/s) and its compulsory bytes 54.8 MB (θ and ε read, out written,
// the topology: 0.016 ms at 3.35 TB/s), so its bound is 0.016 ms, by
// bytes. This design reads shared memory once per FMA: nnz·P·4 ≈ 1.79 GB,
// ≈ 55 µs at 128 bytes a clock per SM. Beside the gathers:
// each block stages two slabs (θ and ε, 256 KB a slab, from device memory
// or L2), the walk of 141 slabs × 1000 receivers issues the list copies
// and epilogues, and the lists are re-read by every block that touches a
// receiver, slabs·nnz·8 ≈ 115 MB from L2.
//
// The band instance `sparse_mixing_slab_l2` (many sender chunks, few
// slots). Past N = 1558 the slab no longer fits a block and the senders are
// cut into chunks: at N = 16,384, 11 chunks over 141 slabs, so every
// receiver takes 141 · 11 passes (a list copy, a butterfly, θ_j, and its
// out segment read back and written again) for a mean degree of 9.2 (the
// ER cell, G(N, 0.0005) with self-loops, K_max = 22): ≈ 25 M passes and
// ≈ 9.8 GB of out and θ_j traffic against 0.88 GB compulsory, 11.3 ms on
// an NVIDIA H100 80GB HBM3 (700 W). There a warp takes one (receiver j,
// band of W columns) straight from neighbor_idx and neighbor_mask (no
// lists, no scratch, no chunks, one plain launch): lane t loads the slots
// k0 + t, skips padding as phase 1 does, and then for each live slot in
// slot order loads the sender's θ and ε at its columns t, t + 32, .. of
// the band (coalesced 128-byte segments; P = 4481 leaves rows 4-byte
// aligned only), forms Y in registers and accumulates m·Y with fmaf, and
// wsum_j = Σ m·R̃θ likewise; then out = fmaf(−wsum_j, θ_j, Σ m·Y), stored
// once. Blocks are band-major, so the resident blocks gather from one or
// two bands: θ and ε come from device memory about once and a row's ≈ 9
// gathers are served from L2. W = 128 columns, 4 a lane: its band of θ and
// ε for all N senders, N·W·8 bytes, is 16.8 MB at N = 16,384, a third of
// the 50 MB L2 (bands of 64 and 32 columns ran 11% and 49% slower there).
// Past N = 25,600 a band would take more than half the L2; no caller runs
// there, and a narrower band waits for a shape that shows 128 losing.
// What bounds it: θ and ε read once, out written once, the edges' index and
// weight once: 0.88 GB, 0.263 ms at 3.35 TB/s, by bytes; its own traffic
// is the L2 gathers, nnz·P·8 ≈ 5.4 GB at the ER cell. No atomics and a
// fixed order: two launches give the same bits. The slab instance stays
// for N ≤ 1558, where one chunk holds every sender and a receiver's slots
// are read from shared memory once (0.13 ms at N = 1000, K_max ≈ 130, where
// this instance would gather ≈ 4.7 GB from L2), and for lists longer than
// 16 entries a chunk (kernels/netes_sparse_mixing.py: uses_band).
//
// The receiver ≠ sender instance `netes_sparse_mixing_rs_f32` (R receivers
// over S senders of a payload, the sharded fleet's per-shard contraction)
// is the plain slot loop of csrc/_rows.cuh; see its note.
//
// C interface (bound with ctypes): `netes_sparse_mixing_f32` makes the
// cooperative launch and returns its cudaError_t;
// `netes_sparse_mixing_band_f32` the band instance's plain launch, and
// `netes_sparse_mixing_band_occupancy` its resident blocks, registers and
// spills;
// `netes_sparse_mixing_occupancy` reports resident blocks per SM at a
// given shared memory, the SM count, registers and local (spill) bytes per
// thread. Launches on the caller's stream, never synchronises, allocates
// nothing (the wrapper passes the scratch).

#include "_rows.cuh"
#include "_slab.cuh"

namespace {

// The operands of Eq. 3's factored sum for csrc/_slab.cuh: slab rows of 32
// float32 columns of Y; the listed weight of a slot is m.
struct SparseMixing {
  static constexpr int ACC = 4;
  struct Raw {
    float m;
  };
  const float* mask;
  const float* w_theta;
  const float* w_eps;
  const float* theta;
  const float* eps;
  float* wsum;
  float sigma;
  int p, chunks;
  float part = 0.f;          // phase 1: this lane's share of the list's wsum
  float ws = 0.f, th = 0.f;  // phase 2: wsum and θ_j of the receiver

  __device__ __forceinline__ Raw load(size_t at, bool ok) const {
    return {ok ? __ldg(mask + at) : 0.f};
  }
  __device__ __forceinline__ void list_begin() { part = 0.f; }
  // skips padding, a slot of weight 0 that indexes j itself: its term is
  // 0·Y_j, and out_j carries θ_j through −wsum_j·θ_j
  __device__ __forceinline__ bool weigh(Raw r, int i, int j, float& w) {
    if (r.m == 0.f && i == j) return false;
    part = fmaf(r.m, __ldg(w_theta + i), part);
    w = r.m;
    return true;
  }
  // the list's wsum: lane parts in slot order, then a butterfly
  __device__ __forceinline__ void list_end(int jc, int lane) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(~0u, part, o);
    if (lane == 0) wsum[jc] = part;
  }

  // Y[c0 .. c1) of columns [col0, col0 + 32): each lane one column of
  // STAGE_ROWS rows at a time (32 loads in flight), lane t holding row t's
  // R̃θ and σ·R̃ε for the warp. Columns past P hold 0.
  __device__ __forceinline__ void stage(int col0, int c0, int c1,
                                        unsigned char* slab_rows, int warp,
                                        int lane) const {
    using slab::STAGE_ROWS;
    using slab::WARPS;
    float* s_y = reinterpret_cast<float*>(slab_rows);
    const int col = col0 + lane;
    const bool in_p = col < p;
    for (int r = c0 + warp; r < c1; r += WARPS * STAGE_ROWS) {
      const int mine = r + (lane % STAGE_ROWS) * WARPS;
      const float wt_l = mine < c1 ? __ldg(w_theta + mine) : 0.f;
      const float sw_l = mine < c1 ? sigma * __ldg(w_eps + mine) : 0.f;
      float t_th[STAGE_ROWS], t_ep[STAGE_ROWS];
#pragma unroll
      for (int t = 0; t < STAGE_ROWS; ++t) {
        const int row = r + t * WARPS;
        const size_t at = (size_t)row * p + col;
        t_th[t] = row < c1 && in_p ? __ldg(theta + at) : 0.f;
        t_ep[t] = row < c1 && in_p ? __ldg(eps + at) : 0.f;
      }
#pragma unroll
      for (int t = 0; t < STAGE_ROWS; ++t) {
        const int row = r + t * WARPS;
        const float wt = __shfl_sync(~0u, wt_l, t);
        const float sw = __shfl_sync(~0u, sw_l, t);
        if (row < c1)
          s_y[(size_t)(row - c0) * (slab::ROW_BYTES / 4) + lane] =
              in_p ? fmaf(wt, t_th[t], sw * t_ep[t]) : 0.f;
      }
    }
  }

  __device__ __forceinline__ static void fma(float (&acc)[ACC], float w,
                                             uint4 y) {
    acc[0] = fmaf(w, __uint_as_float(y.x), acc[0]);
    acc[1] = fmaf(w, __uint_as_float(y.y), acc[1]);
    acc[2] = fmaf(w, __uint_as_float(y.z), acc[2]);
    acc[3] = fmaf(w, __uint_as_float(y.w), acc[3]);
  }
  __device__ __forceinline__ void fetch(int j, int c, int col) {
    ws = __ldcg(wsum + (size_t)j * chunks + c);
    if (col < p) th = __ldg(theta + (size_t)j * p + col);
  }
  __device__ __forceinline__ float finish(float v, int) const {
    return fmaf(-ws, th, v);
  }
};

__global__ void __launch_bounds__(slab::THREADS, 1)
sparse_mixing_slab(const int* __restrict__ idx, const float* __restrict__ mask,
                   const float* __restrict__ w_theta,
                   const float* __restrict__ w_eps,
                   const float* __restrict__ theta,
                   const float* __restrict__ eps, float* __restrict__ out,
                   uint2* __restrict__ lists, int* __restrict__ lens,
                   float* __restrict__ wsum, float sigma, int n, int k_max,
                   int p, int chunk_rows, int chunks) {
  extern __shared__ __align__(16) unsigned char smem[];
  SparseMixing op{mask, w_theta, w_eps, theta, eps, wsum, sigma, p, chunks};
  slab::run(op, smem, idx, out, lists, lens, n, k_max, p, chunk_rows, chunks);
}

// ---- the band instance: many sender chunks, few slots a receiver ----

namespace band {

// kernels/netes_sparse_mixing.py mirrors THREADS and COLS
constexpr int THREADS = 256;           // a warp per (receiver, band)
constexpr int WARPS = THREADS / 32;
constexpr int COLS = 4;                // columns a lane
constexpr int BAND = 32 * COLS;        // W: columns of a band

// Block b·groups + g takes the receivers [g·WARPS, g·WARPS + WARPS) over
// the columns [b·BAND, (b + 1)·BAND) of band b, a warp a receiver, lane t
// the columns t, t + 32, ... of the band. Bands are block-major, so the
// resident blocks gather from one or two bands of θ and ε at a time.
__global__ void __launch_bounds__(THREADS)
sparse_mixing_slab_l2(const int* __restrict__ idx,
                      const float* __restrict__ mask,
                      const float* __restrict__ w_theta,
                      const float* __restrict__ w_eps,
                      const float* __restrict__ theta,
                      const float* __restrict__ eps, float* __restrict__ out,
                      float sigma, int n, int k_max, int p, int groups) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x / groups;
  const int j = (blockIdx.x - b * groups) * WARPS + (threadIdx.x >> 5);
  if (j >= n) return;
  const int col0 = b * BAND + lane;
  const size_t row_j = (size_t)j * p;
  float own[COLS], acc[COLS];
#pragma unroll
  for (int t = 0; t < COLS; ++t) {
    const int col = col0 + 32 * t;
    own[t] = col < p ? __ldg(theta + row_j + col) : 0.f;
    acc[t] = 0.f;
  }
  float ws = 0.f;
  for (int k0 = 0; k0 < k_max; k0 += 32) {
    // lane t holds slot k0 + t: its sender, weight, R̃θ and σ·R̃ε
    const int k = k0 + lane;
    int i = j;
    float m = 0.f, wt = 0.f, sw = 0.f;
    if (k < k_max) {
      i = __ldg(idx + (size_t)j * k_max + k);
      m = __ldg(mask + (size_t)j * k_max + k);
    }
    // skips padding, a slot of weight 0 that indexes j itself: its term
    // is 0·Y_j, and out_j carries θ_j through −wsum_j·θ_j
    const bool live = k < k_max && !(m == 0.f && i == j);
    if (live) {
      wt = __ldg(w_theta + i);
      sw = sigma * __ldg(w_eps + i);
    }
    // the live slots in slot order, each one's 2·COLS loads before its
    // FMAs (further slots' loads in flight gave no gain: the resident
    // warps keep the L2 busy)
    for (unsigned left = __ballot_sync(~0u, live); left; left &= left - 1u) {
      const int src = __ffs(left) - 1;
      const size_t row = (size_t)__shfl_sync(~0u, i, src) * p;
      const float sm = __shfl_sync(~0u, m, src);
      const float swt = __shfl_sync(~0u, wt, src);
      const float ssw = __shfl_sync(~0u, sw, src);
      float th[COLS], ep[COLS];
#pragma unroll
      for (int t = 0; t < COLS; ++t) {
        const int col = col0 + 32 * t;
        th[t] = col < p ? __ldg(theta + row + col) : 0.f;
        ep[t] = col < p ? __ldg(eps + row + col) : 0.f;
      }
      ws = fmaf(sm, swt, ws);
#pragma unroll
      for (int t = 0; t < COLS; ++t)
        acc[t] = fmaf(sm, fmaf(swt, th[t], ssw * ep[t]), acc[t]);
    }
  }
#pragma unroll
  for (int t = 0; t < COLS; ++t) {
    const int col = col0 + 32 * t;
    if (col < p) out[row_j + col] = fmaf(-ws, own[t], acc[t]);
  }
}

}  // namespace band

// ---- the R × S instance (csrc/_rows.cuh): float32 payload rows ----

struct FloatRows {
  const float* x;
  int cols;
  __device__ __forceinline__ float factor(int) const { return 0.f; }
  __device__ __forceinline__ float value(int i, int col, float) const {
    return __ldg(x + (size_t)i * cols + col);
  }
};

__global__ void __launch_bounds__(rows::THREADS)
sparse_mixing_rs(const int* __restrict__ idx, const float* __restrict__ mask,
                 const float* __restrict__ w, const float* __restrict__ x,
                 const float* __restrict__ theta, float* __restrict__ out,
                 int k_max, int p) {
  rows::slot_rows(FloatRows{x, p}, idx, mask, w, theta, out, k_max, p);
}

}  // namespace

// R receivers over S senders: idx, mask (R, k_max), w (S,), x (S, p),
// theta and out (R, p). Entries of idx lie in [0, S) (the caller's
// contract; the kernel does not check them).
extern "C" int netes_sparse_mixing_rs_f32(const void* idx, const void* mask,
                                          const void* w, const void* x,
                                          const void* theta, void* out, int r,
                                          int s, int k_max, int p,
                                          void* stream) {
  if (!rows::shape_ok(r, s, k_max, p))
    return static_cast<int>(cudaErrorInvalidValue);
  sparse_mixing_rs<<<rows::grid(r, p), rows::THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(idx), static_cast<const float*>(mask),
      static_cast<const float*>(w), static_cast<const float*>(x),
      static_cast<const float*>(theta), static_cast<float*>(out), k_max, p);
  return static_cast<int>(cudaGetLastError());
}

// The band instance: one plain launch of ⌈n/WARPS⌉·⌈p/BAND⌉ blocks; a
// cudaError_t.
extern "C" int netes_sparse_mixing_band_f32(const void* idx, const void* mask,
                                            const void* w_theta,
                                            const void* w_eps,
                                            const void* theta, const void* eps,
                                            void* out, float sigma, int n,
                                            int k_max, int p, void* stream) {
  if (n < 1 || k_max < 1 || p < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int groups = (n + band::WARPS - 1) / band::WARPS;
  const long long grid =
      (long long)groups * ((p + band::BAND - 1) / band::BAND);
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int* a_idx = static_cast<const int*>(idx);
  const float* a_mask = static_cast<const float*>(mask);
  const float* a_wt = static_cast<const float*>(w_theta);
  const float* a_we = static_cast<const float*>(w_eps);
  const float* a_th = static_cast<const float*>(theta);
  const float* a_ep = static_cast<const float*>(eps);
  float* a_out = static_cast<float*>(out);
  void* args[] = {&a_idx, &a_mask, &a_wt, &a_we, &a_th, &a_ep, &a_out,
                  &sigma, &n,     &k_max, &p,   &groups};
  return static_cast<int>(cudaLaunchKernel(
      (const void*)band::sparse_mixing_slab_l2, dim3((unsigned)grid),
      dim3(band::THREADS), args, 0, static_cast<cudaStream_t>(stream)));
}

// Resident blocks per SM, the SM count, registers and local (spill) bytes
// per thread of the band instance; a cudaError_t.
extern "C" int netes_sparse_mixing_band_occupancy(int* resident_per_sm,
                                                  int* sm_count,
                                                  int* registers,
                                                  int* local_bytes) {
  const void* kernel = (const void*)band::sparse_mixing_slab_l2;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      resident_per_sm, kernel, band::THREADS, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  *registers = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      cudaDeviceGetAttribute(sm_count, cudaDevAttrMultiProcessorCount, dev));
}

extern "C" int netes_sparse_mixing_occupancy(int smem, int* resident_per_sm,
                                             int* sm_count, int* registers,
                                             int* local_bytes) {
  return slab::occupancy((const void*)sparse_mixing_slab, smem,
                         resident_per_sm, sm_count, registers, local_bytes);
}

// scratch: the lists, n·chunks lists of ⌈k_max/8⌉·8 (row offset, weight)
// entries, then their lengths, n·chunks ints, then wsum, n·chunks floats.
extern "C" int netes_sparse_mixing_f32(const void* idx, const void* mask,
                                       const void* w_theta, const void* w_eps,
                                       const void* theta, const void* eps,
                                       void* out, void* scratch, float sigma,
                                       int n, int k_max, int p,
                                       int chunk_rows, int chunks, int grid,
                                       void* stream) {
  const int* a_idx = static_cast<const int*>(idx);
  const float* a_mask = static_cast<const float*>(mask);
  const float* a_wt = static_cast<const float*>(w_theta);
  const float* a_we = static_cast<const float*>(w_eps);
  const float* a_th = static_cast<const float*>(theta);
  const float* a_ep = static_cast<const float*>(eps);
  float* a_out = static_cast<float*>(out);
  uint2* lists = static_cast<uint2*>(scratch);
  int* lens = reinterpret_cast<int*>(
      lists + (size_t)n * chunks * slab::list_cap(k_max));
  float* wsum = reinterpret_cast<float*>(lens + (size_t)n * chunks);
  void* args[] = {&a_idx, &a_mask, &a_wt,  &a_we,  &a_th,  &a_ep,
                  &a_out, &lists,  &lens,  &wsum,  &sigma, &n,
                  &k_max, &p,      &chunk_rows,    &chunks};
  return slab::launch((const void*)sparse_mixing_slab, args, n, k_max, p,
                      chunk_rows, chunks, grid, stream);
}

// The column-slab design shared by the two sparse Eq. 3 kernels for Hopper,
// sm_90a: csrc/netes_sparse_mixing.cu and fused_neighbor_sum in
// csrc/netes_fused_mixing.cu. Each includes this header and supplies an
// operand policy; kernels/_slab.py plans the launch with the same
// constants and shared-memory layout. netes_sparse_mixing.cu's note gives
// the design; in short, one cooperative launch in two phases:
//
// 1. compact_slots: a warp per (receiver j, sender chunk c) across the
//    grid lists the live slots of j whose sender lies in chunk c, in slot
//    order, as (byte offset of the sender's slab row, weight), padded with
//    dummies (the zero row, weight 0) to a multiple of 8 entries.
// 2. run: the (slab, receiver) units in slab-major order, one equal run per
//    block; for each slab and chunk the block stages the senders' slab rows
//    in shared memory, then a warp per receiver copies its list into a ring
//    (cp.async) and gathers the listed rows from the slab, 16 bytes a lane;
//    a fixed-order exchange and one coalesced store end each receiver.
//
// An operand policy `Op` provides:
//   ACC                    floats a lane accumulates (4: f32 rows of 32
//                          columns; 8: bf16 rows of 64 columns); a slab row
//                          holds 8·ACC columns in 128 bytes
//   Raw, load(at, ok)      a slot's operands besides its index (defaults
//                          where !ok, past K_max)
//   list_begin(), weigh(r, i, j, w), list_end(jc, lane)
//                          phase 1: weigh is asked, in slot order, about
//                          each slot of receiver j whose sender i lies in
//                          the chunk; it sets the listed weight w and says
//                          whether the slot is listed. list_end runs on
//                          every lane once a list is written
//   stage(col0, c0, c1, s_y, warp, lane)
//                          slab rows c0 .. c1 of columns col0 .. col0 +
//                          8·ACC, 128 bytes a row, columns past the operand
//                          zero
//   fma(acc, w, y)         acc += w · (the ACC values of the 16 bytes y)
//   fetch(j, c, col)       a receiver's epilogue operands, a receiver ahead
//   finish(v, t)           this lane's column col + t of the receiver's
//                          slot sum v, before the chunks are added up
//
// No atomics, and a fixed order everywhere: two launches give the same
// bits.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace slab {

// kernels/_slab.py mirrors THREADS, ROUND, RING, ROW_BYTES, SMEM_MAX and
// the layout below
constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int ROW_BYTES = 128;              // one sender's slab row
constexpr int ROUND = 128;                  // list entries a warp copies at once
constexpr int RING = 2;                     // rounds of a warp's ring
constexpr int PRE_ROUNDS = 4;               // 32-slot rounds in flight, phase 1
constexpr int STAGE_ROWS = 16;              // rows in flight per lane, staging
constexpr int SMEM_MAX = 232448;

// Shared memory: the warps' rings (RING rounds of ROUND (row offset,
// weight) entries each), each round's count and last flag (RING ints per
// warp, padded to 16 bytes), then chunk_rows + 1 slab rows (the last is
// zeros: the dummies point at it).
__host__ __device__ inline size_t meta_offset() {
  return (size_t)WARPS * RING * ROUND * sizeof(uint2);
}
__host__ __device__ inline size_t y_offset() {
  return meta_offset() + ((size_t)WARPS * RING * 4 + 15) / 16 * 16;
}
__host__ __device__ inline size_t smem_bytes(int chunk_rows) {
  return y_offset() + (size_t)(chunk_rows + 1) * ROW_BYTES;
}
// entries of one (receiver, chunk) list
__host__ __device__ inline int list_cap(int k_max) {
  return (k_max + 7) & ~7;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(RING - 1));
}

// Phase 1, a warp per (receiver j, chunk c) over the whole grid: the
// slots of j whose sender lies in chunk c and that Op lists, in slot
// order, as (row offset in the chunk's slab, weight), then dummies (zero
// row, 0) up to a multiple of 8 entries, in a list of list_cap entries;
// and their count.
template <class Op>
__device__ __forceinline__ void compact_slots(
    Op& op, const int* __restrict__ idx, uint2* __restrict__ lists,
    int* __restrict__ lens, int n, int k_max, int chunk_rows, int chunks,
    int warp, int lane) {
  const unsigned below = (1u << lane) - 1u;
  const uint2 dummy = make_uint2((unsigned)chunk_rows * ROW_BYTES, 0u);
  const int cap = list_cap(k_max);
  for (int jc = blockIdx.x * WARPS + warp; jc < n * chunks;
       jc += gridDim.x * WARPS) {
    const int j = jc / chunks, c = jc - j * chunks;
    const int c0 = c * chunk_rows, c1 = min(n, c0 + chunk_rows);
    uint2* dst = lists + (size_t)jc * cap;
    int cnt = 0;
    op.list_begin();
    for (int k0 = 0; k0 < k_max; k0 += 32 * PRE_ROUNDS) {
      int i[PRE_ROUNDS];
      typename Op::Raw r[PRE_ROUNDS];
#pragma unroll
      for (int u = 0; u < PRE_ROUNDS; ++u) {
        const int k = k0 + 32 * u + lane;
        const size_t at = (size_t)j * k_max + k;
        i[u] = k < k_max ? __ldg(idx + at) : -1;
        r[u] = op.load(at, k < k_max);
      }
#pragma unroll
      for (int u = 0; u < PRE_ROUNDS; ++u) {
        float w = 0.f;
        const bool live =
            i[u] >= c0 && i[u] < c1 && op.weigh(r[u], i[u], j, w);
        const unsigned lv = __ballot_sync(~0u, live);
        if (live)
          dst[cnt + __popc(lv & below)] = make_uint2(
              (unsigned)(i[u] - c0) * ROW_BYTES, __float_as_uint(w));
        cnt += __popc(lv);
      }
    }
    if (lane < ((cnt + 7) & ~7) - cnt) dst[cnt + lane] = dummy;
    op.list_end(jc, lane);
    if (lane == 0) lens[jc] = cnt;
  }
}

// S steps of the gather: subgroup g takes entries 8t + 2g and 8t + 2g + 1
// of each step t < S; all loads first, then the FMAs in entry order.
template <class Op, int S>
__device__ __forceinline__ void gather(const uint2* __restrict__ buf,
                                       const unsigned char* __restrict__ s_y,
                                       int g, int q, float (&acc)[Op::ACC]) {
  uint4 two[S], ya[S], yb[S];
#pragma unroll
  for (int t = 0; t < S; ++t)
    two[t] = *reinterpret_cast<const uint4*>(buf + 8 * t + 2 * g);
#pragma unroll
  for (int t = 0; t < S; ++t) {
    ya[t] = *reinterpret_cast<const uint4*>(s_y + two[t].x + q * 16);
    yb[t] = *reinterpret_cast<const uint4*>(s_y + two[t].z + q * 16);
  }
#pragma unroll
  for (int t = 0; t < S; ++t) {
    Op::fma(acc, __uint_as_float(two[t].y), ya[t]);
    Op::fma(acc, __uint_as_float(two[t].w), yb[t]);
  }
}

// the ⌈cnt/8⌉ steps of a round, 4 at a time (dummies fill the last one)
template <class Op>
__device__ __forceinline__ void gather_steps(
    const uint2* __restrict__ buf, const unsigned char* __restrict__ s_y,
    int steps, int g, int q, float (&acc)[Op::ACC]) {
  while (steps > 4) {
    gather<Op, 4>(buf, s_y, g, q, acc);
    buf += 32;
    steps -= 4;
  }
  switch (steps) {
    case 4: gather<Op, 4>(buf, s_y, g, q, acc); break;
    case 3: gather<Op, 3>(buf, s_y, g, q, acc); break;
    case 2: gather<Op, 2>(buf, s_y, g, q, acc); break;
    case 1: gather<Op, 1>(buf, s_y, g, q, acc); break;
  }
}

// The kernel body: out (N, cols) row-major; lists and lens the scratch of
// n·chunks lists and their lengths; smem the block's dynamic shared memory.
template <class Op>
__device__ __forceinline__ void run(Op& op, unsigned char* smem,
                                    const int* __restrict__ idx,
                                    float* __restrict__ out,
                                    uint2* __restrict__ lists,
                                    int* __restrict__ lens, int n, int k_max,
                                    int cols, int chunk_rows, int chunks) {
  constexpr int ACC = Op::ACC;
  constexpr int SLAB = 8 * ACC;               // columns of a slab row
  constexpr int COLS = ACC / 4;               // output columns of a lane
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 3, q = lane & 7;      // subgroup, 16-byte quad
  const int cap = list_cap(k_max);
  compact_slots(op, idx, lists, lens, n, k_max, chunk_rows, chunks, warp,
                lane);

  uint2* ring = reinterpret_cast<uint2*>(smem) + warp * RING * ROUND;
  int* meta = reinterpret_cast<int*>(smem + meta_offset()) + warp * RING;
  unsigned char* s_y = smem + y_offset();
  if (threadIdx.x < ROW_BYTES / 4)
    reinterpret_cast<unsigned*>(s_y + (size_t)chunk_rows * ROW_BYTES)
        [threadIdx.x] = 0u;
  cooperative_groups::this_grid().sync();     // every list is written

  const long long units = (long long)((cols + SLAB - 1) / SLAB) * n;
  const long long u_end = units * (blockIdx.x + 1) / gridDim.x;
  for (long long u = units * blockIdx.x / gridDim.x; u < u_end;) {
    const int s = (int)(u / n);
    const int r0 = (int)(u - (long long)s * n);
    const int r1 = (int)min((long long)n, u_end - (long long)s * n);
    const int col0 = s * SLAB;
    for (int c = 0; c < chunks; ++c) {
      const int c0 = c * chunk_rows, c1 = min(n, c0 + chunk_rows);
      __syncthreads();                 // the last pass is done with the slab
      op.stage(col0, c0, c1, s_y, warp, lane);
      __syncthreads();
      if (r0 + warp >= r1) continue;

      // A warp per receiver j = r0 + warp + WARPS·o (o = 0, 1, ..): its list
      // for chunk c, ROUND entries at a time, is copied into the warp's ring
      // (16-byte cp.async, L2 only: other SMs wrote the lists) RING − 1
      // rounds ahead of its use, with the round's count and last flag. The
      // lists' lengths come 32 receivers at a time.
      auto len_batch = [&](int o) {
        const int jj = r0 + warp + WARPS * (o + lane);
        return jj < r1 ? __ldcg(lens + (size_t)jj * chunks + c) : 0;
      };
      int io = 0, ir = 0, slot = 0, lens_l = len_batch(0);
      int ilen = __shfl_sync(~0u, lens_l, 0);
      auto issue = [&]() {
        const int ij = r0 + warp + WARPS * io;
        int cnt = 0;
        bool last = true;
        if (ij < r1) {
          cnt = min(ROUND, ilen - ROUND * ir);
          last = ROUND * (ir + 1) >= ilen;
          for (int pc = lane; 2 * pc < ((cnt + 7) & ~7); pc += 32)
            cp_async16(ring + slot * ROUND + 2 * pc,
                       lists + ((size_t)ij * chunks + c) * cap +
                           ir * ROUND + 2 * pc);
        }
        if (lane == 0) meta[slot] = cnt | (last ? 0x1000 : 0);
        cp_async_commit();
        slot = slot + 1 == RING ? 0 : slot + 1;
        if (ij < r1) {
          ++ir;
          if (last) {
            ir = 0;
            if ((++io & 31) == 0) lens_l = len_batch(io);
            ilen = __shfl_sync(~0u, lens_l, io & 31);
          }
        }
      };
#pragma unroll
      for (int t = 0; t < RING - 1; ++t) issue();

      float acc[ACC];
#pragma unroll
      for (int t = 0; t < ACC; ++t) acc[t] = 0.f;
      float out_j[COLS];
#pragma unroll
      for (int t = 0; t < COLS; ++t) out_j[t] = 0.f;
      const int col = col0 + ACC * q + COLS * g;  // this lane's columns
      bool fresh = true;
      for (int j = r0 + warp, at = 0; j < r1;) {
        if (fresh) {   // the epilogue's operands, loaded a receiver ahead
          op.fetch(j, c, col);
          if (c > 0) {
#pragma unroll
            for (int t = 0; t < COLS; ++t)
              if (col + t < cols) out_j[t] = out[(size_t)j * cols + col + t];
          }
          fresh = false;
        }
        issue();
        cp_async_wait_ring();
        __syncwarp();
        const uint2* buf = ring + at * ROUND;
        const int m = meta[at];
        at = at + 1 == RING ? 0 : at + 1;
        gather_steps<Op>(buf, s_y, ((m & 0xfff) + 7) >> 3, g, q, acc);
        __syncwarp();

        if (m & 0x1000) {
          // subgroups g and g^2 meet, then g and g^1: lane (g, q) ends with
          // columns ACC·q + COLS·g + t (t < COLS) summed over the four
          // subgroups
          const bool a = g & 2, b = g & 1;
          float k2[ACC / 2];
#pragma unroll
          for (int t = 0; t < ACC / 2; ++t)
            k2[t] = (a ? acc[ACC / 2 + t] : acc[t]) +
                    __shfl_xor_sync(~0u, a ? acc[t] : acc[ACC / 2 + t], 16);
          float v[COLS];
#pragma unroll
          for (int t = 0; t < COLS; ++t)
            v[t] = (b ? k2[COLS + t] : k2[t]) +
                   __shfl_xor_sync(~0u, b ? k2[t] : k2[COLS + t], 8);
#pragma unroll
          for (int t = 0; t < COLS; ++t)
            if (col + t < cols) {
              const float part = op.finish(v[t], t);
              out[(size_t)j * cols + col + t] =
                  c == 0 ? part : out_j[t] + part;
            }
#pragma unroll
          for (int t = 0; t < ACC; ++t) acc[t] = 0.f;
          j += WARPS;
          fresh = true;
        }
      }
      asm volatile("cp.async.wait_all;\n" ::);
    }
    u = (long long)(s + 1) * n;
  }
}

// Resident blocks per SM of `kernel` at `smem` bytes, the SM count, and
// its registers and local (spill) bytes per thread; a cudaError_t.
inline int occupancy(const void* kernel, int smem, int* resident_per_sm,
                     int* sm_count, int* registers, int* local_bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(resident_per_sm,
                                                      kernel, THREADS, smem);
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

// The cooperative launch of `kernel` on the plan (every block resident,
// for the grid barrier between the two phases), after checking the plan;
// a cudaError_t.
inline int launch(const void* kernel, void** args, int n, int k_max,
                  int cols, int chunk_rows, int chunks, int grid,
                  void* stream) {
  const size_t smem = smem_bytes(chunk_rows);
  if (n < 1 || k_max < 1 || cols < 1 || chunk_rows < 1 || grid < 1 ||
      (long long)chunk_rows * chunks < n ||
      (long long)chunk_rows * (chunks - 1) >= n || smem > SMEM_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaLaunchCooperativeKernel(
      kernel, dim3(grid), dim3(THREADS), args, smem,
      static_cast<cudaStream_t>(stream)));
}

}  // namespace slab

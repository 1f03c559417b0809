// RWKV-6 WKV recurrence for Hopper, sm_90a, float32:
//
//   out[b,t,h,j] = Σ_i r[b,t,h,i]·(u[h,i]·k[b,t,h,i]·v[b,t,h,j] + S[i,j])
//   S[i,j]      ← w[b,t,h,i]·S[i,j] + k[b,t,h,i]·v[b,t,h,j]
//
// for every (b, h), over t = 0 .. S−1, from S = s0[b, h] (or 0 when s0 is
// null), over r, k, v, w (B, S, H, n) and u (H, n) → out (B, S, H, n) and
// the final state s_fin (B, H, n, n), n ≤ 64.
//
// Replaces the TPU kernel src/repro/kernels/rwkv6_wkv.py:43 `rwkv6_wkv`
// (body `_wkv_kernel` :22, pallas_call :50), which runs one program per
// (b, h) with the (n, n) state in VMEM and a fori_loop over the sequence.
// It starts from a zero state; this kernel takes an initial state as well,
// so that prefill can continue a cache and decode (S = 1) is one launch.
//
// What bounds it on the H100. At rwkv6-7b's prefill (B = 1, S = 8192,
// H = 64, n = 64) the function reads 4 × 134.2 MB and writes 134.2 MB
// (0.20 ms at 3.35 TB/s) and does 5n² + 4n operations per step and head,
// 10.9 GFLOP (0.16 ms at 67 TFLOP/s). Every block of a head also reads
// that head's r, k and w (the column split below), from L2, which holds
// them (the blocks of a head run side by side): at two blocks a head,
// 0.4 GB more. What really bounds it is the SMs' own throughput: three
// FP32 instructions per state entry and step (r·S, k·v, w·S + kv), which
// cannot be fused further in strict float32 (3n² a step on 132 SMs at 4
// warp-instructions a cycle: ≈ 0.22 ms), and the shared-memory traffic
// that brings each step's r, k, w and v to the threads and carries the
// partial sums (≈ 12 KB a step on each SM with the 4 × 4 tiles below, at
// 128 bytes a cycle: ≈ 0.4 ms).
//
// Design. The state's columns are independent (column j of S and out[j]
// depend on no other column), so a head's columns split exactly across
// blocks: a block per (b, h, column group), the group's width chosen by
// the wrapper's plan (kernels/rwkv6_wkv.py `plan`: 32 columns at n = 64,
// 128 blocks at B = 1). Inside a block each computing thread holds a 4 × 4
// tile of the state in registers: rows 4q .. 4q + 3 of columns 4g .. 4g + 3,
// RS = n/4 threads (q) sharing a quad of columns (g). A step is three FP
// instructions per entry, fed by four 16-byte shared loads a thread (four
// rows' r, k and w, four columns' v): what bounds the step loop is shared
// memory's bandwidth, and a square tile asks the fewest floats of it per
// entry (the operands a step, plus the partial sums a thread writes and
// the reduce pass reads). Each thread sums r_i·S[i, j] over its rows (two
// accumulators a column) and writes its four partial sums to shared
// memory (16 bytes, a warp's 512 contiguous), so no shuffle sits in the
// step; the next step's loads start before this step's arithmetic. After
// each chunk a reduce pass makes out: lane l takes step l mod 16 and CPT
// columns, adds the RS partial sums of each (in q order), and adds
// v_j·bonus_t; the bonus Σ_i r_i·u_i·k_i is computed once a step and
// block, in a pass over the staged chunk (2W lanes a step, joined by
// shuffles), and read from shared memory. out leaves as float4s.
//
// Staging: CHUNK steps at a time, as four TMA boxes of CHUNK rows: r, k
// and w of the head (n + 4 channels a row, the last 4 never read; they pad
// the row to an odd number of 16-byte words, so that the per-step passes'
// 16 steps fall on distinct banks) and v of the group (C + 4), from tensor
// maps of the (B·S, H·n) operands that the launch encodes. A copying warp
// (the block's last) starts them into a ring of four buffers, each with a
// full and an empty mbarrier: the copies complete on the full one, and
// the computing warps arrive on the empty one when they have reduced the
// chunk, so the copying warp runs up to three chunks ahead and never waits
// on the computing warps' barrier (one a chunk, among them only, for the
// partial sums). The computing warps start no copy: their dispatch slots
// bound the kernel, and four boxes a chunk are all the copying there is.
// Rows past S hold other rows, or zeros past the tensor's end, and are
// never used. The step loop is unrolled over a whole chunk; a shorter last
// chunk breaks out of it. A decode step (S = 1) runs a kernel of its own
// on the same grid (wkv6_step_kernel below). Partial sums and bonuses are
// double-buffered, a step's C·RS partial sums padded to an odd number of
// 16-byte words. No spill, no atomics: two launches on the same inputs
// give the same bits.
//
// The kernel takes n = NP (8, 16, 32 or 64) and 16-byte aligned operands
// (the boxes' unit, and its float4 loads and stores); the wrapper pads
// other heads with zero channels, which leave the recurrence as it was.
//
// C interface (bound with ctypes): `rwkv6_wkv_f32` returns
// cudaGetLastError() after the launch; `rwkv6_wkv_query` reports the grid,
// resident blocks per SM, registers and local (spill) bytes per thread of
// a launch. Launches on the caller's stream, never synchronises,
// allocates nothing.

#include <cuda.h>            // CUtensorMap and its enums (no libcuda link)
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int CHUNK = 16;    // steps staged at a time
constexpr int RING = 4;      // chunk buffers: two in flight, computed, reduced
constexpr int MAX_DEVICES = 64;

// The instances (NP, RS, W): head width, threads sharing a column quad
// (NP / 4), computing warps per block. kernels/rwkv6_wkv.py mirrors this
// list and plans with it.
#define WKV_INSTANCES(X) \
  X(8, 2, 1)             \
  X(16, 4, 1)            \
  X(32, 8, 2)            \
  X(64, 16, 4)

// an odd number of 16-byte words at or above `floats`: rows of that stride
// put 8 consecutive steps on 8 distinct bank groups
constexpr int odd_words(int floats) {
  return floats + ((floats / 4) % 2 == 0 ? 4 : 0);
}

template <int NP_, int RS_, int W_>
struct Shape {
  static constexpr int NP = NP_, RS = RS_, W = W_;
  static constexpr int R = NP / RS;           // state rows per thread: 4
  static constexpr int QUADS = 32 / RS;       // column quads per warp
  static constexpr int C = 4 * QUADS * W;     // state columns per block
  static constexpr int THREADS = 32 * (W + 1);   // W computing, 1 copying
  // A chunk buffer holds four boxes of CHUNK rows: r, k, w (NP + 4 floats
  // a row: the head's channels, then 4 the kernel never reads) and v
  // (C + 4: the group's columns, then 4 more). Those widths are odd
  // numbers of 16-byte words, and every box starts on 128 bytes.
  static constexpr int RP = NP + 4, VP = C + 4;
  static constexpr int OPB = CHUNK * RP;      // floats of an r, k or w box
  static constexpr int BUF = 3 * OPB + CHUNK * VP;    // of a chunk buffer
  static constexpr int PSTEP = odd_words(C * RS);     // partials of a step
  static constexpr int PBUF = CHUNK * PSTEP;
  static constexpr int CPT = C / (2 * W);     // columns a thread reduces
  static constexpr int LPS = 2 * W;           // lanes a step in the bonus pass
  static constexpr int BX = NP / (4 * LPS);   // float4s of a lane there
  static_assert(R == 4 && RS >= 2 && 32 % RS == 0, "thread layout");
  static_assert(CPT % 4 == 0 && BX >= 1, "reduce and bonus layouts");
  static_assert(CHUNK == 16, "two lanes per step in the reduce pass");
  // dynamic shared memory at a sequence of `chunks` chunks: the ring, the
  // partials and the bonuses (double-buffered), u, the ring's full and
  // empty barriers
  static constexpr size_t smem(int chunks) {
    return sizeof(float) * ((chunks < RING ? chunks : RING) * BUF +
                            (chunks < 2 ? chunks : 2) * (PBUF + CHUNK) + NP) +
           sizeof(uint64_t) * 2 * RING;
  }
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}
// the computing warps only (barrier 0 is __syncthreads)
__device__ __forceinline__ void compute_sync(int threads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(threads) : "memory");
}
// one arrival (the issuing lane's) and `bytes` of copies still to land
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}
// a TMA copy of the box of `map` at (x, y) (channel, row of B·S), into
// 128-byte aligned shared memory; elements past the tensor's ends land as 0
__device__ __forceinline__ void box_copy(float* dst, const CUtensorMap* map,
                                         int x, int y, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(
          smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y),
      "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ float lane4(const float4& x, int a) {
  return a == 0 ? x.x : a == 1 ? x.y : a == 2 ? x.z : x.w;
}

// One step's operands for this thread: r, k, w of its four rows and v of
// its four columns.
struct StepIn {
  float4 r, k, w, v;
};

template <class Sh>
__device__ __forceinline__ void load_step(StepIn& in, const float* rowq,
                                          const float* rowv) {
  in.r = *reinterpret_cast<const float4*>(rowq);
  in.k = *reinterpret_cast<const float4*>(rowq + Sh::OPB);
  in.w = *reinterpret_cast<const float4*>(rowq + 2 * Sh::OPB);
  in.v = *reinterpret_cast<const float4*>(rowv);
}

// The recurrence for one step on this thread's 4 × 4 entries: its rows'
// parts of out[4g .. 4g + 3] (two accumulators each) into `part`, then the
// update.
__device__ __forceinline__ void compute_step(const StepIn& in,
                                             float (&st)[4][4], float* part) {
  float acc[4][2] = {};
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const float ri = lane4(in.r, a), ki = lane4(in.k, a),
                wi = lane4(in.w, a);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      acc[c][a & 1] = fmaf(ri, st[c][a], acc[c][a & 1]);
      st[c][a] = fmaf(wi, st[c][a], ki * lane4(in.v, c));
    }
  }
  *reinterpret_cast<float4*>(part) =
      make_float4(acc[0][0] + acc[0][1], acc[1][0] + acc[1][1],
                  acc[2][0] + acc[2][1], acc[3][0] + acc[3][1]);
}

// The steps of a chunk, each step's loads started before the previous
// step's arithmetic. FULL: all CHUNK steps, no test.
template <class Sh, bool FULL>
__device__ __forceinline__ void run_chunk(const float* rowq,
                                          const float* rowv, float* part,
                                          int steps, float (&st)[4][4]) {
  StepIn cur, nxt;
  load_step<Sh>(cur, rowq, rowv);
#pragma unroll
  for (int j = 0; j < CHUNK; ++j) {
    if (!FULL && j >= steps) break;
    if (j + 1 < CHUNK)
      load_step<Sh>(nxt, rowq + (j + 1) * Sh::RP, rowv + (j + 1) * Sh::VP);
    compute_step(cur, st, part + j * Sh::PSTEP);
    if (j + 1 < CHUNK) cur = nxt;
  }
}

// The bonus Σ_i r_i·u_i·k_i of every step of a staged chunk, once a block:
// LPS lanes a step, each over BX float4s of channels, joined by shuffles;
// the first lane of a step writes it to `bons`.
template <class Sh>
__device__ __forceinline__ void bonus_pass(const float* buf, const float* us,
                                           float* bons) {
  const int j = threadIdx.x / Sh::LPS, sub = threadIdx.x % Sh::LPS;
  const float* row = buf + j * Sh::RP + 4 * sub;
  float acc = 0.f;
#pragma unroll
  for (int x = 0; x < Sh::BX; ++x) {
    const int off = 4 * Sh::LPS * x;
    const float4 r4 = *reinterpret_cast<const float4*>(row + off);
    const float4 k4 = *reinterpret_cast<const float4*>(row + Sh::OPB + off);
    const float4 u4 = *reinterpret_cast<const float4*>(us + 4 * sub + off);
#pragma unroll
    for (int a = 0; a < 4; ++a)
      acc = fmaf(lane4(r4, a) * lane4(u4, a), lane4(k4, a), acc);
  }
#pragma unroll
  for (int off = 1; off < Sh::LPS; off <<= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (sub == 0) bons[j] = acc;
}

// out for the steps of a staged, computed chunk: lane l takes step
// l mod CHUNK and CPT columns; each column sums the RS parts of its quad
// (in q order), then adds v·bonus.
template <class Sh>
__device__ __forceinline__ void reduce_chunk(const float* part,
                                             const float* buf,
                                             const float* bons, int steps,
                                             float* o, int t0, size_t step,
                                             int ncols) {
  const int lane = threadIdx.x & 31, j = lane % CHUNK;
  const int c0 = (2 * (threadIdx.x >> 5) + lane / CHUNK) * Sh::CPT;
  if (j >= steps || c0 >= ncols) return;
  const float bonus = bons[j];
  const float* pj = part + j * Sh::PSTEP + c0 * Sh::RS;
  const float* vj = buf + 3 * Sh::OPB + j * Sh::VP + c0;
  float* oj = o + (size_t)(t0 + j) * step + c0;
#pragma unroll
  for (int g = 0; g < Sh::CPT / 4; ++g) {
    if (c0 + 4 * g >= ncols) break;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int q = 0; q < Sh::RS; ++q) {
      const float4 x =
          *reinterpret_cast<const float4*>(pj + 4 * (Sh::RS * g + q));
      sum.x += x.x;
      sum.y += x.y;
      sum.z += x.z;
      sum.w += x.w;
    }
    const float4 v4 = *reinterpret_cast<const float4*>(vj + 4 * g);
    *reinterpret_cast<float4*>(oj + 4 * g) =
        make_float4(fmaf(v4.x, bonus, sum.x), fmaf(v4.y, bonus, sum.y),
                    fmaf(v4.z, bonus, sum.z), fmaf(v4.w, bonus, sum.w));
  }
}

template <int NP, int RS, int W>
__global__ void __launch_bounds__(32 * (W + 1), 1)
    wkv6_kernel(const __grid_constant__ CUtensorMap tm_r,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_w,
                const __grid_constant__ CUtensorMap tm_v,
                const float* __restrict__ u, const float* __restrict__ s0,
                float* __restrict__ out, float* __restrict__ s_fin, int seq,
                int heads, int groups) {
  using Sh = Shape<NP, RS, W>;
  constexpr int n = NP;
  extern __shared__ __align__(128) float4 smem4[];
  const int chunks = (seq + CHUNK - 1) / CHUNK;
  const int ring = min(chunks, RING), pring = min(chunks, 2);
  float* const bufs = reinterpret_cast<float*>(smem4);
  float* const parts = bufs + ring * Sh::BUF;
  float* const bons = parts + pring * Sh::PBUF;  // CHUNK bonuses a chunk
  float* const us = bons + pring * CHUNK;        // u of the head, NP floats
  uint64_t* const full = reinterpret_cast<uint64_t*>(us + NP);
  uint64_t* const empty = full + RING;     // per buffer: landed, released

  const int bh = blockIdx.x / groups, grp = blockIdx.x - bh * groups;
  const int b = bh / heads, h = bh - b * heads;
  const int tid = threadIdx.x, lane = tid & 31;
  const int col0 = grp * Sh::C;
  const int ncols = min(Sh::C, n - col0);         // live columns
  const size_t step = (size_t)heads * n;          // one time step
  const size_t base = (size_t)b * seq * step + (size_t)h * n;
  const size_t sb = (size_t)bh * n * n;

  if (tid < ring) {
    mbar_init(full + tid, 1);
    mbar_init(empty + tid, W);
  }
  for (int i = tid; i < NP; i += Sh::THREADS) us[i] = u[(size_t)h * n + i];
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();

  if (tid >= 32 * W) {
    // The copying warp's lane 0: chunk c into buffer c mod ring, once the
    // computing warps have released the chunk it held: four boxes, counted
    // on the buffer's full barrier.
    if (lane == 0)
      for (int c = 0; c < chunks; ++c) {
        const int slot = c % ring;
        float* buf = bufs + slot * Sh::BUF;
        if (c >= ring) mbar_wait(empty + slot, (c / ring - 1) & 1);
        mbar_expect(full + slot, sizeof(float) * Sh::BUF);
        const int y = b * seq + c * CHUNK;
        box_copy(buf, &tm_r, h * n, y, full + slot);
        box_copy(buf + Sh::OPB, &tm_k, h * n, y, full + slot);
        box_copy(buf + 2 * Sh::OPB, &tm_w, h * n, y, full + slot);
        box_copy(buf + 3 * Sh::OPB, &tm_v, h * n + col0, y, full + slot);
      }
    return;
  }

  const int quad = (tid >> 5) * Sh::QUADS + lane / RS;    // in the block
  const int q = lane % RS;
  const int j0 = col0 + 4 * quad;               // my columns j0 .. j0 + 3
  const bool live = j0 < n;
  float st[4][4];                                // [column][row]
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const float4 x = s0 != nullptr && live
                         ? *reinterpret_cast<const float4*>(
                               s0 + sb + (size_t)(4 * q + a) * n + j0)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int c = 0; c < 4; ++c) st[c][a] = lane4(x, c);
  }
  float* const o = out + base + col0;

  for (int c = 0; c < chunks; ++c) {
    mbar_wait(full + c % ring, (c / ring) & 1);   // chunk c has landed
    compute_sync(32 * W);        // chunk c − 1's partials and bonuses
    const float* buf = bufs + (c % ring) * Sh::BUF;
    if (c > 0) {
      reduce_chunk<Sh>(parts + ((c - 1) % pring) * Sh::PBUF,
                       bufs + ((c - 1) % ring) * Sh::BUF,
                       bons + ((c - 1) % pring) * CHUNK, CHUNK, o,
                       (c - 1) * CHUNK, step, ncols);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + (c - 1) % ring);   // released
    }
    bonus_pass<Sh>(buf, us, bons + (c % pring) * CHUNK);
    const float* rowq = buf + 4 * q;
    const float* rowv = buf + 3 * Sh::OPB + 4 * quad;
    float* part = parts + (c % pring) * Sh::PBUF + 4 * (quad * RS + q);
    const int steps = min(CHUNK, seq - c * CHUNK);
    if (steps == CHUNK)
      run_chunk<Sh, true>(rowq, rowv, part, steps, st);
    else
      run_chunk<Sh, false>(rowq, rowv, part, steps, st);
  }
  compute_sync(32 * W);
  const int last = chunks - 1;
  reduce_chunk<Sh>(parts + (last % pring) * Sh::PBUF,
                   bufs + (last % ring) * Sh::BUF,
                   bons + (last % pring) * CHUNK, seq - last * CHUNK, o,
                   last * CHUNK, step, ncols);

  if (live)
#pragma unroll
    for (int a = 0; a < 4; ++a)
      *reinterpret_cast<float4*>(s_fin + sb + (size_t)(4 * q + a) * n + j0) =
          make_float4(st[0][a], st[1][a], st[2][a], st[3][a]);
}

// A decode step (S = 1): the same grid and thread layout, no staging and
// no copying warp. Each thread reads its rows' r, k, w, u and its quad's v
// straight from global memory (the lanes that share them get them in one
// load), sums r_i·S[i, j] + v_j·r_i·u_i·k_i over its rows for its four
// columns (the bonus's rows fall to the threads that hold them), updates
// its entries, and log2 RS shuffles a column add the RS threads' sums.
template <int NP, int RS, int W>
__global__ void __launch_bounds__(32 * W)
    wkv6_step_kernel(const float* __restrict__ r, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ w,
                     const float* __restrict__ u,
                     const float* __restrict__ s0, float* __restrict__ out,
                     float* __restrict__ s_fin, int heads, int groups) {
  using Sh = Shape<NP, RS, W>;
  constexpr int n = NP;
  const int bh = blockIdx.x / groups, grp = blockIdx.x - bh * groups;
  const int h = bh % heads;
  const int lane = threadIdx.x & 31;
  const int q = lane % RS;
  const int j0 =
      grp * Sh::C + 4 * ((threadIdx.x >> 5) * Sh::QUADS + lane / RS);
  const bool live = j0 < n;        // a quad past n (NP = 8, 16: C > NP)
  const size_t x0 = (size_t)bh * n, sb = (size_t)bh * n * n;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const float4 vj =
      live ? *reinterpret_cast<const float4*>(v + x0 + j0) : zero;
  const float4 r4 = *reinterpret_cast<const float4*>(r + x0 + 4 * q);
  const float4 k4 = *reinterpret_cast<const float4*>(k + x0 + 4 * q);
  const float4 w4 = *reinterpret_cast<const float4*>(w + x0 + 4 * q);
  const float4 u4 =
      *reinterpret_cast<const float4*>(u + (size_t)h * n + 4 * q);
  float acc[4][2] = {}, bon = 0.f;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const float ri = lane4(r4, a), ki = lane4(k4, a), wi = lane4(w4, a);
    float* row = s_fin + sb + (size_t)(4 * q + a) * n + j0;
    const float4 x =
        s0 != nullptr && live
            ? *reinterpret_cast<const float4*>(s0 + sb +
                                               (size_t)(4 * q + a) * n + j0)
            : zero;
    float nx[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      acc[c][a & 1] = fmaf(ri, lane4(x, c), acc[c][a & 1]);
      nx[c] = fmaf(wi, lane4(x, c), ki * lane4(vj, c));
    }
    bon = fmaf(ri * lane4(u4, a), ki, bon);
    if (live)
      *reinterpret_cast<float4*>(row) = make_float4(nx[0], nx[1], nx[2], nx[3]);
  }
  float o[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    o[c] = fmaf(lane4(vj, c), bon, acc[c][0] + acc[c][1]);
#pragma unroll
    for (int off = 1; off < RS; off <<= 1)
      o[c] += __shfl_xor_sync(0xffffffffu, o[c], off);
  }
  if (q == 0 && live)
    *reinterpret_cast<float4*>(out + x0 + j0) =
        make_float4(o[0], o[1], o[2], o[3]);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// cuTensorMapEncodeTiled, through the runtime's entry-point query (no link
// to libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// (B·S, H·n) float32 rows seen as a 2-D tensor, boxes of CHUNK rows of
// `width` channels
bool box_map(CUtensorMap* map, const void* base, int row, long long rows,
             int width) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)row, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)row * sizeof(float)};
  const cuuint32_t box[2] = {(cuuint32_t)width, (cuuint32_t)CHUNK};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(base),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Dynamic shared memory above 48 KB needs the attribute (at the largest,
// a sequence of RING chunks or more), once per device.
template <int NP, int RS, int W>
cudaError_t prepare() {
  using Sh = Shape<NP, RS, W>;
  static bool done[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!done[dev]) {
    err = cudaFuncSetAttribute(wkv6_kernel<NP, RS, W>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(Sh::smem(RING)));
    if (err != cudaSuccess) return err;
    done[dev] = true;
  }
  return cudaSuccess;
}

template <int NP, int RS, int W>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const void* s0, void* out, void* s_fin, int b,
           int s, int h, cudaStream_t stream) {
  using Sh = Shape<NP, RS, W>;
  const int groups = (NP + Sh::C - 1) / Sh::C;
  if (s == 1) {
    wkv6_step_kernel<NP, RS, W><<<dim3((unsigned)b * h * groups), 32 * W, 0,
                                  stream>>>(
        static_cast<const float*>(r), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(w),
        static_cast<const float*>(u), static_cast<const float*>(s0),
        static_cast<float*>(out), static_cast<float*>(s_fin), h, groups);
    return static_cast<int>(cudaGetLastError());
  }
  cudaError_t err = prepare<NP, RS, W>();
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap tm[4];
  const long long rows = (long long)b * s;
  if (!box_map(tm, r, h * NP, rows, Sh::RP) ||
      !box_map(tm + 1, k, h * NP, rows, Sh::RP) ||
      !box_map(tm + 2, w, h * NP, rows, Sh::RP) ||
      !box_map(tm + 3, v, h * NP, rows, Sh::VP))
    return static_cast<int>(cudaErrorInvalidValue);
  const int chunks = (s + CHUNK - 1) / CHUNK;
  wkv6_kernel<NP, RS, W><<<dim3((unsigned)b * h * groups), Sh::THREADS,
                           Sh::smem(chunks), stream>>>(
      tm[0], tm[1], tm[2], tm[3], static_cast<const float*>(u),
      static_cast<const float*>(s0), static_cast<float*>(out),
      static_cast<float*>(s_fin), s, h, groups);
  return static_cast<int>(cudaGetLastError());
}

template <int NP, int RS, int W>
int query(int b, int s, int h, int* grid, int* resident, int* registers,
          int* local_bytes) {
  using Sh = Shape<NP, RS, W>;
  cudaError_t err = prepare<NP, RS, W>();
  if (err != cudaSuccess) return static_cast<int>(err);
  *grid = b * h * ((NP + Sh::C - 1) / Sh::C);
  const void* fn = s == 1 ? (const void*)wkv6_step_kernel<NP, RS, W>
                          : (const void*)wkv6_kernel<NP, RS, W>;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      resident, fn, s == 1 ? 32 * W : Sh::THREADS,
      s == 1 ? 0 : Sh::smem((s + CHUNK - 1) / CHUNK));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  *registers = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  return 0;
}

}  // namespace

// b, s, h ≥ 1, n one of the instances' widths 8, 16, 32, 64, every
// operand 16-byte aligned, and (rs, warps) an instance for n (anything
// else returns cudaErrorInvalidValue); s0 may be null (a zero state). The
// wrapper checks shapes and layout, pads n and plans (rs, warps) before
// the call.
extern "C" int rwkv6_wkv_f32(const void* r, const void* k, const void* v,
                             const void* w, const void* u, const void* s0,
                             void* out, void* s_fin, int b, int s, int h,
                             int n, int rs, int warps, void* stream) {
  if (b < 1 || s < 1 || h < 1 || !aligned16(r) || !aligned16(k) ||
      !aligned16(v) || !aligned16(w) || !aligned16(u) ||
      (s0 != nullptr && !aligned16(s0)) || !aligned16(out) ||
      !aligned16(s_fin))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define WKV_LAUNCH(NP_, RS_, W_)                                        \
  if (n == NP_ && rs == RS_ && warps == W_)                             \
    return launch<NP_, RS_, W_>(r, k, v, w, u, s0, out, s_fin, b, s, h, \
                                st);
  WKV_INSTANCES(WKV_LAUNCH)
#undef WKV_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

// The grid of the launch at (b, s, h, n, rs, warps), and the resident
// blocks per SM, registers and local (spill) bytes per thread of the
// kernel it launches (the step kernel at s = 1) on the current device.
extern "C" int rwkv6_wkv_query(int b, int s, int h, int n, int rs, int warps,
                               int* grid, int* resident_per_sm,
                               int* registers, int* local_bytes) {
  if (b < 1 || s < 1 || h < 1)
    return static_cast<int>(cudaErrorInvalidValue);
#define WKV_QUERY(NP_, RS_, W_)                                              \
  if (n == NP_ && rs == RS_ && warps == W_)                                  \
    return query<NP_, RS_, W_>(b, s, h, grid, resident_per_sm, registers, \
                               local_bytes);
  WKV_INSTANCES(WKV_QUERY)
#undef WKV_QUERY
  return static_cast<int>(cudaErrorInvalidValue);
}

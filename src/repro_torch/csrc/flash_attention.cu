// Blocked online-softmax attention with grouped-query heads (GQA) for
// Hopper, sm_90a, float32:
//
//   out[b, q, h, :] = Σ_k softmax_k(scale · q[b,q,h]·k[b,k,h/G] + bias) v[b,k,h/G]
//
// with q and k (B, Sq | Sk, H | Hkv, dk), v (B, Sk, Hkv, dv), G = H / Hkv
// (query head h reads KV head h / G, the reference's reshape(b, s, hkv, g,
// hd)), and the
// masks of the reference at key position kp for query position qp:
// kp < Sk (padded keys), causal qp ≥ kp, window qp − kp < window, chunk
// qp / chunk == kp / chunk. A masked score is −1e30, the online softmax
// starts from m = −1e30, and out = acc / max(l, 1e-30).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:82
// `flash_attention` (body `_flash_kernel` :29, pallas_call :109), which runs
// one program per (batch · KV head, 128-row query tile) with the G query
// heads inside the tile and streams every 128-key tile of the sequence.
//
// What bounds it on the H100: operations. A causal prefill at B = 1,
// S = 8192, H = 32, hd = 128 does 4·H·hd·S(S+1)/2 = 550 GFLOP of float32
// multiply-adds (8.2 ms at the CUDA cores' 67 TFLOP/s) and moves 0.4 GB
// (0.13 ms at 3.35 TB/s). The computation stays in float32 on the CUDA
// cores (no TF32, whose 10-bit mantissa would miss the float32 tolerances
// of the checks), so what decides the time is how much of the issue rate
// goes to FMAs.
//
// The first design of this kernel took 16.91–17.15 ms at G = 4 and
// 8.93–9.02 ms at G = 1 (moonshot, 16/16 heads) (NVIDIA H100 80GB HBM3,
// 700 W): a block per (64 query positions, query head, batch), so each of
// the G heads of a KV head loaded its own copy of every K and V tile;
// 4 × 4 dot products along d for QKᵀ (64 FMAs per 8 shared loads);
// synchronous tile loads behind four barriers per key tile; the mask and
// `expf` on every score.
// This design:
//
// - A block per (query tile, batch, KV head), one block per SM (256
//   threads, ≤ 255 registers, 226 KB of shared memory at hd 128). Its BR =
//   128 rows are (position, head) pairs, position-major, of the G query
//   heads that read the KV head: 128/G positions (any G; the last tile is
//   ragged), so one K/V tile in shared memory serves all of them. The masks
//   depend on the position only. The grid is one-dimensional with the
//   query tile slowest and last-first, so the longest causal tiles of every
//   head start first.
// - Thread (ty, tx) of 16 × 16 owns the rows ty·4 + {0..3} and
//   64 + ty·4 + {0..3}: in S = QKᵀ the keys tx + 16·j (j < 4) of the 64-key
//   tile, in O the columns 64·c + 4·tx + {0..3}. Qᵀ (d-major, with
//   scale·log2 e folded in once) and Pᵀ (key-major) give each thread its 8
//   rows as two float4; K stays row-major with its 16-byte chunks swizzled
//   (conflict-free without padding), so S takes 128 FMAs per 12 shared
//   loads and P·V 64 FMAs per 4. Both loops are unrolled 16 deep, which
//   lets the loads of one step overlap the FMAs of another (faster than 2
//   or 4 deep; fully unrolled, the code outgrows the instruction cache and
//   runs several times slower).
// - K and V double-buffered: 16-byte cp.async (zero-filled past Sk) brings
//   tile t + 1 while tile t is computed. One block barrier per key tile; a
//   row's P is written and read by the 16 threads of one half warp, so P·V
//   needs only a warp barrier.
// - Key tiles that every row of the tile may see in full run without a
//   mask (a separate instance of the softmax step); only the tiles that
//   cross the diagonal, a window or chunk edge or Sk test each score
//   against the row's key range (kept in shared memory).
// - exp2 on log2-scaled scores.
// Key tiles that are masked for every row of the query tile are skipped:
// this is exact for every row with a valid key. When a row of the tile has
// no valid key at all, every key tile is streamed, so that row gets the
// reference's value, the mean of v over the Sk keys (each masked key
// counts exp2(0) = 1 while m stays at −1e30); a padded key (kp ≥ Sk)
// always adds nothing to l.
//
// This design took 12.2–12.3 ms at G = 4 (67% of the 8.2 ms bound;
// F.scaled_dot_product_attention in float32, whose products run on the
// tensor cores as three TF32 products, 11.9–12.1 ms) and 6.2 ms at G = 1
// (SDPA 6.3 ms) on the same card (`chip_smoke.py`; PERF.md §6, row 5).
//
// head_dim 256 (gemma3-4b, 8/4 heads): the tiling above would need 416 KB
// of shared memory (the block gets 227 KB) and 256 accumulator registers a
// thread (the limit is 255). That instance takes BR = 64 rows and BKN = 32
// keys a tile (`Tile<256, 256>`): Qᵀ 64 KB, K and V double-buffered 2 × 32 KB
// each, Pᵀ 8.5 KB, 201 KB in all; a thread owns the rows ty·4 + {0..3},
// the keys tx + {0, 16} of S and the columns 64·c + 4·tx + {0..3}
// (c < 4) of O, 64 accumulators. Everything else (masks, skipped tiles,
// one barrier per key tile, the grid order) is the same code. Its S step
// takes 32 FMAs per 6 shared loads (128 per 12 at hd 128). It took 8.13 ms
// at gemma's global prefill of 1 × 8192 (50% of the 4.10 ms bound; SDPA
// 7.73 ms) and 2.12 ms with window 1024 (45% of 0.96 ms; SDPA given the
// mask 15.1 ms), 185 registers, no spill (NVIDIA H100 80GB HBM3, 700 W;
// PERF.md §6, row 5).
//
// head_dim 32 (whisper-tiny-smoke, 4 heads of 32; the contract linter's
// nano LM, 2 heads of 32): the hd ≤ 128 tiling (BR = 128 rows, BKN = 64
// keys) with its own map of O's columns, since 16 threads of 4 columns
// would cover 64: a thread owns the columns 2·tx + {0, 1} (`Tile<32, 32>::CW`),
// read from V and written out as float2. Qᵀ 16 KB, K and V
// double-buffered 2 × 2 × 8 KB, Pᵀ 33 KB: 82 KB in all, so two blocks fit
// on an SM (`__launch_bounds__` asks the register budget of two). Every
// other part of the code is the hd ≤ 128 instances'.
//
// Query/key width 192, value width 128 (moonlight-16b-a3b's latent
// attention: 128 + 64 rotary query/key columns a head, values of 128):
// the key and value widths are two template parameters, DK and DV, the
// instances above being DK = DV. At DK = 192 the hd ≤ 128 tiling would
// need 290 KB of shared memory; this instance keeps BR = 128 rows (so
// P·V keeps its 64 FMAs per 4 shared loads) and takes BKN = 32 keys a
// tile: Qᵀ 96 KB, K double-buffered 2 × 24 KB, V 2 × 16 KB, Pᵀ 16.5 KB,
// 194 KB in all. A thread owns the rows of the hd-128 instance, the keys
// tx + {0, 16} of S and the columns 64·c + 4·tx + {0..3} (c < 2) of O,
// 64 accumulators; its S step takes 64 FMAs per 10 shared loads. K's rows
// of 48 chunks take the same swizzle (48 is a multiple of 8).
//
// C interface (bound with ctypes): `flash_attention_f32` returns
// cudaGetLastError() after the launch; `flash_attention_query` reports the
// grid size and the resident blocks per SM at a shape. Launches on the
// caller's stream, never synchronises, allocates nothing.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int THREADS = 256;
constexpr float NEG_INF = -1e30f;

// The tiling of the instance for key width DK and value width DV: BR
// (position, head) rows per block, BKN keys per tile. A thread of the
// 16 × 16 grid owns RT = BR / 16 rows and KT = BKN / 16 keys of S, and RT
// rows of O, in which it holds the columns 64·c + CW·tx + e (c < NCH,
// e < CW): 4 a 64-column chunk, or 2 of the 32 at DV 32.
template <int DK, int DV>
struct Tile {
  static constexpr int BR = DK == 256 ? 64 : 128;
  static constexpr int BKN = DK <= 128 ? 64 : 32;
  static constexpr int RT = BR / 16;
  static constexpr int KT = BKN / 16;
  static constexpr int CW = DV >= 64 ? 4 : 2;
  static constexpr int NCH = DV >= 64 ? DV / 64 : 1;
  static constexpr int MIN_BLOCKS = DK == 32 ? 2 : 1;   // resident per SM
};

// Shared memory: Qᵀ, two K and two V tiles, Pᵀ and the rows' key ranges.
// K's 16-byte chunks are swizzled (chunk c of key r at c ^ (r % 8)), so that
// the keys tx + 16j of a quarter warp hit distinct banks without padding;
// Pᵀ's rows are padded by 4 floats for the same reason.
template <int DK, int DV>
struct Layout {
  static constexpr int BR = Tile<DK, DV>::BR, BKN = Tile<DK, DV>::BKN;
  static constexpr int PSTRIDE = BR + 4;
  static constexpr int Q = DK * BR;       // Qᵀ [DK][BR]
  static constexpr int K = BKN * DK;      // K  [BKN][DK], swizzled
  static constexpr int V = BKN * DV;      // V  [BKN][DV]
  static constexpr int P = BKN * PSTRIDE; // Pᵀ [BKN][BR + 4]
  static constexpr size_t BYTES = (size_t)(Q + 2 * K + 2 * V + P) * sizeof(float) +
                                  2 * BR * sizeof(int);
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes, or 16 zero bytes when !valid (src-size 0 reads nothing)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// The keys [lo, hi] that query position qp may attend to (empty if lo > hi).
// Both ends are non-decreasing in qp.
__device__ __forceinline__ void key_range(int qp, int sk, bool causal,
                                          int window, int chunk, int* lo,
                                          int* hi) {
  int a = 0, b = sk - 1;
  if (causal) b = min(b, qp);
  if (window > 0) a = max(a, qp - window + 1);
  if (chunk > 0) {
    const int start = (qp / chunk) * chunk;
    a = max(a, start);
    b = min(b, start + chunk - 1);
  }
  *lo = a;
  *hi = b;
}

// 2^x on the MUFU unit (the instruction exp2f compiles to, without its
// handling of results below 2^-126, which flush to 0 here: no sum of the
// softmax notices, its largest term being 1).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The online-softmax update of a key tile for a thread's RT rows and KT
// keys (a row's BKN keys lie on the 16 threads of one half warp): mask
// (only if MASKED, a tile that crosses a row's key range or Sk), new row
// maxima, P = 2^(s − m) in place of s, l, and O rescaled. Row i of the
// thread is 64·(i / 4) + 4·ty + i % 4, key j is k0 + tx + 16·j.
template <bool MASKED, int RT, int KT, int NCH, int CW>
__device__ __forceinline__ void online_softmax(float (&s)[RT][KT], float (&m)[RT],
                                               float (&l)[RT], float (&o)[RT][NCH][CW],
                                               const int* row_lo, const int* row_hi,
                                               int k0, int sk, int ty, int tx) {
  if (MASKED) {
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int r = 64 * (i >> 2) + 4 * ty + (i & 3);
      const int lo = row_lo[r], hi = row_hi[r];
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        const int kp = k0 + tx + 16 * j;
        if (kp < lo || kp > hi) s[i][j] = NEG_INF;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    float row_max = s[i][0];
#pragma unroll
    for (int j = 1; j < KT; ++j) row_max = fmaxf(row_max, s[i][j]);
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, off));
    const float m_new = fmaxf(m[i], row_max);
    const float corr = exp2_ftz(m[i] - m_new);
    m[i] = m_new;
    float row_sum = 0.f;
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      float p = exp2_ftz(s[i][j] - m_new);
      // a padded key (kp ≥ Sk) is no key: it adds nothing to l
      if (MASKED && k0 + tx + 16 * j >= sk) p = 0.f;
      s[i][j] = p;
      row_sum += p;
    }
    l[i] = l[i] * corr + row_sum;
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int e = 0; e < CW; ++e) o[i][c][e] *= corr;
  }
}

// Keys [k0, k0 + BKN) of a (Sk, Hkv, HD) slab at one KV head into HD-float
// rows, chunk c of row r at c ^ (r % 8) if SWIZZLE; keys at or past Sk are
// zero.
template <int HD, int BKN, bool SWIZZLE>
__device__ __forceinline__ void load_keys(float* dst, const float* __restrict__ src,
                                          int k0, int sk, int hkv) {
  constexpr int C4 = HD / 4;
#pragma unroll
  for (int it = 0; it < BKN * C4 / THREADS; ++it) {
    const int f = threadIdx.x + it * THREADS, r = f / C4, c = f % C4;
    const bool valid = k0 + r < sk;
    cp_async16(dst + r * HD + 4 * (SWIZZLE ? c ^ (r & 7) : c),
               src + (size_t)(valid ? k0 + r : 0) * hkv * HD + 4 * c, valid);
  }
}

template <int DK, int DV>
__global__ void __launch_bounds__(THREADS, Tile<DK, DV>::MIN_BLOCKS)
flash_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out,
                       int batch, int sq, int sk, int h, int hkv,
                       bool causal, int window, int chunk, float qscale,
                       int tiles) {
  using L = Layout<DK, DV>;
  using T = Tile<DK, DV>;
  constexpr int BR = T::BR, BKN = T::BKN;
  constexpr int RT = T::RT, KT = T::KT;
  constexpr int NCH = T::NCH;  // 64-column chunks of the output
  constexpr int CW = T::CW;    // a thread's columns of a chunk
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks0 = qs + L::Q;            // K tiles: ks0 + (t & 1)·L::K
  float* vs0 = ks0 + 2 * L::K;       // V tiles: vs0 + (t & 1)·L::V
  float* ps = vs0 + 2 * L::V;
  int* row_lo = reinterpret_cast<int*>(ps + L::P);
  int* row_hi = row_lo + BR;

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int g = h / hkv, rows = sq * g;
  // block order: query tile (last first) slowest, then batch, then KV head,
  // so that the longest causal tiles of every head start first
  const int heads = hkv * batch;
  const int r0 = (tiles - 1 - (int)blockIdx.x / heads) * BR;
  const int kvh = blockIdx.x % heads % hkv, b = blockIdx.x % heads / hkv;
  const int p_first = r0 / g, p_last = (min(r0 + BR, rows) - 1) / g;
  const float* kb = k + ((size_t)b * sk * hkv + kvh) * DK;
  const float* vb = v + ((size_t)b * sk * hkv + kvh) * DV;

  // each row's key range; a row past the end sees nothing
  for (int r = tid; r < BR; r += THREADS) {
    int lo = 1, hi = 0;
    if (r0 + r < rows) key_range((r0 + r) / g, sk, causal, window, chunk, &lo, &hi);
    row_lo[r] = lo;
    row_hi[r] = hi;
  }
  bool empty_row = false;
  for (int pp = p_first + tid; pp <= p_last; pp += THREADS) {
    int lo, hi;
    key_range(pp, sk, causal, window, chunk, &lo, &hi);
    empty_row |= lo > hi;
  }
  const bool stream_all = __syncthreads_or(empty_row);
  // the union of the rows' ranges is [lo(p_first), hi(p_last)]; every row
  // sees all of [lo(p_last), hi(p_first)]
  int lo_first, hi_first, lo_last, hi_last;
  key_range(p_first, sk, causal, window, chunk, &lo_first, &hi_first);
  key_range(p_last, sk, causal, window, chunk, &lo_last, &hi_last);
  const int kt_begin = stream_all ? 0 : lo_first / BKN;
  const int kt_end = stream_all ? (sk - 1) / BKN : hi_last / BKN;

  load_keys<DK, BKN, true>(ks0, kb, kt_begin * BKN, sk, hkv);
  load_keys<DV, BKN, false>(vs0, vb, kt_begin * BKN, sk, hkv);
  cp_async_commit();

  // Qᵀ, scaled by scale·log2 e: rows are (position, head), position-major
#pragma unroll 4
  for (int it = 0; it < BR * (DK / 4) / THREADS; ++it) {
    const int f = tid + it * THREADS, r = f % BR, c = f / BR, row = r0 + r;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < rows) {
      const int pos = row / g, head = kvh * g + row % g;
      val = reinterpret_cast<const float4*>(
          q + (((size_t)b * sq + pos) * h + head) * DK)[c];
    }
    qs[(4 * c + 0) * BR + r] = val.x * qscale;
    qs[(4 * c + 1) * BR + r] = val.y * qscale;
    qs[(4 * c + 2) * BR + r] = val.z * qscale;
    qs[(4 * c + 3) * BR + r] = val.w * qscale;
  }

  float m[RT], l[RT], o[RT][NCH][CW];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int e = 0; e < CW; ++e) o[i][c][e] = 0.f;
  }

  const int sw = tx & 7;   // the swizzle of this thread's keys tx + 16j
  for (int kt = kt_begin; kt <= kt_end; ++kt) {
    const int k0 = kt * BKN, buf = (kt - kt_begin) & 1;
    const float* ks = ks0 + buf * L::K;
    const float* vs = vs0 + buf * L::V;
    cp_async_wait_all();
    __syncthreads();     // K(kt), V(kt), Qᵀ visible; everyone is done with tile kt − 1
    if (kt < kt_end) {   // tile kt + 1 into the buffers tile kt − 1 used
      load_keys<DK, BKN, true>(ks0 + (buf ^ 1) * L::K, kb, k0 + BKN, sk, hkv);
      load_keys<DV, BKN, false>(vs0 + (buf ^ 1) * L::V, vb, k0 + BKN, sk, hkv);
      cp_async_commit();
    }

    // S = Qᵀᵀ K for rows 64·(i / 4) + ty·4 + i % 4 and keys tx + 16j
    float s[RT][KT];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < KT; ++j) s[i][j] = 0.f;
#pragma unroll 16
    for (int d4 = 0; d4 < DK / 4; ++d4) {
      float4 kv[KT];
      const int kc = 4 * (d4 ^ sw);
#pragma unroll
      for (int j = 0; j < KT; ++j)
        kv[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * DK + kc);
#pragma unroll
      for (int dd = 0; dd < 4; ++dd) {
        const float* qrow = qs + (4 * d4 + dd) * BR;
        float qv[RT];
#pragma unroll
        for (int gi = 0; gi < RT / 4; ++gi) {
          const float4 qa = *reinterpret_cast<const float4*>(qrow + 64 * gi + 4 * ty);
          qv[4 * gi + 0] = qa.x;
          qv[4 * gi + 1] = qa.y;
          qv[4 * gi + 2] = qa.z;
          qv[4 * gi + 3] = qa.w;
        }
#pragma unroll
        for (int j = 0; j < KT; ++j) {
          const float kd = dd == 0 ? kv[j].x : dd == 1 ? kv[j].y
                         : dd == 2 ? kv[j].z : kv[j].w;
#pragma unroll
          for (int i = 0; i < RT; ++i) s[i][j] = fmaf(qv[i], kd, s[i][j]);
        }
      }
    }

    // masks on the tiles that need them only
    if (!stream_all && k0 >= lo_last && k0 + BKN - 1 <= hi_first)
      online_softmax<false>(s, m, l, o, row_lo, row_hi, k0, sk, ty, tx);
    else
      online_softmax<true>(s, m, l, o, row_lo, row_hi, k0, sk, ty, tx);
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      float* prow = ps + (tx + 16 * j) * L::PSTRIDE;
#pragma unroll
      for (int gi = 0; gi < RT / 4; ++gi)
        *reinterpret_cast<float4*>(prow + 64 * gi + 4 * ty) = make_float4(
            s[4 * gi][j], s[4 * gi + 1][j], s[4 * gi + 2][j], s[4 * gi + 3][j]);
    }
    // a row's P lies on the 16 threads of one half warp, which also
    // compute its O: no block barrier
    __syncwarp();

    // O += P V over the BKN keys of the tile
#pragma unroll 16
    for (int kk = 0; kk < BKN; ++kk) {
      const float* prow = ps + kk * L::PSTRIDE;
      float pv[RT];
#pragma unroll
      for (int gi = 0; gi < RT / 4; ++gi) {
        const float4 pa = *reinterpret_cast<const float4*>(prow + 64 * gi + 4 * ty);
        pv[4 * gi + 0] = pa.x;
        pv[4 * gi + 1] = pa.y;
        pv[4 * gi + 2] = pa.z;
        pv[4 * gi + 3] = pa.w;
      }
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        if constexpr (CW == 4) {
          const float4 vv = *reinterpret_cast<const float4*>(vs + kk * DV + 64 * c + 4 * tx);
#pragma unroll
          for (int i = 0; i < RT; ++i) {
            o[i][c][0] = fmaf(pv[i], vv.x, o[i][c][0]);
            o[i][c][1] = fmaf(pv[i], vv.y, o[i][c][1]);
            o[i][c][2] = fmaf(pv[i], vv.z, o[i][c][2]);
            o[i][c][3] = fmaf(pv[i], vv.w, o[i][c][3]);
          }
        } else {   // DV 32: the columns 2·tx, 2·tx + 1
          const float2 vv = *reinterpret_cast<const float2*>(vs + kk * DV + 2 * tx);
#pragma unroll
          for (int i = 0; i < RT; ++i) {
            o[i][c][0] = fmaf(pv[i], vv.x, o[i][c][0]);
            o[i][c][1] = fmaf(pv[i], vv.y, o[i][c][1]);
          }
        }
      }
    }
  }

  // l: the partial sums of the row's 16 threads; out = o / max(l, 1e-30)
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    float total = l[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      total += __shfl_xor_sync(0xffffffffu, total, off);
    const int row = r0 + 64 * (i >> 2) + 4 * ty + (i & 3);
    if (row >= rows) continue;
    const float denom = fmaxf(total, 1e-30f);
    const int pos = row / g, head = kvh * g + row % g;
    float* orow = out + (((size_t)b * sq + pos) * h + head) * DV;
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      if constexpr (CW == 4) {
        *reinterpret_cast<float4*>(orow + 64 * c + 4 * tx) = make_float4(
            o[i][c][0] / denom, o[i][c][1] / denom, o[i][c][2] / denom,
            o[i][c][3] / denom);
      } else {
        *reinterpret_cast<float2*>(orow + 2 * tx) =
            make_float2(o[i][c][0] / denom, o[i][c][1] / denom);
      }
    }
  }
}

template <int DK, int DV>
int query_tiles(int sq, int h, int hkv) {
  return (sq * (h / hkv) + Tile<DK, DV>::BR - 1) / Tile<DK, DV>::BR;
}

template <int DK, int DV>
cudaError_t prepare() {
  return cudaFuncSetAttribute(flash_attention_kernel<DK, DV>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)Layout<DK, DV>::BYTES);
}

template <int DK, int DV>
int launch(const float* q, const float* k, const float* v, float* out, int b,
           int sq, int sk, int h, int hkv, int causal, int window, int chunk,
           float qscale, int tiles, cudaStream_t stream) {
  if (tiles != query_tiles<DK, DV>(sq, h, hkv))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = prepare<DK, DV>();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_attention_kernel<DK, DV>
      <<<tiles * hkv * b, THREADS, Layout<DK, DV>::BYTES, stream>>>(
          q, k, v, out, b, sq, sk, h, hkv, causal != 0, window, chunk, qscale,
          tiles);
  return static_cast<int>(cudaGetLastError());
}

template <int DK, int DV>
int query(int b, int sq, int h, int hkv, int* grid_blocks, int* resident) {
  cudaError_t err = prepare<DK, DV>();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      resident, flash_attention_kernel<DK, DV>, THREADS, Layout<DK, DV>::BYTES);
  *grid_blocks = query_tiles<DK, DV>(sq, h, hkv) * hkv * b;
  return static_cast<int>(err);
}

}  // namespace

// (hd, hdv) must be (32, 32), (64, 64), (128, 128), (256, 256) or
// (192, 128) (anything else returns cudaErrorInvalidValue), and `tiles` the
// wrapper's count of query tiles per (batch, KV head), checked against this
// source's; the wrapper checks shapes, layout and alignment before the call.
extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* out, int b, int sq,
                                   int sk, int h, int hkv, int hd, int hdv,
                                   int causal, int window, int chunk,
                                   float scale, int tiles, void* stream) {
  if (hkv <= 0 || h % hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  auto* of = static_cast<float*>(out);
  auto* st = static_cast<cudaStream_t>(stream);
  // scores in log2 units: exp(scale·x) = exp2(scale·log2 e·x)
  const float qscale = static_cast<float>((double)scale * 1.4426950408889634);
#define FLASH_LAUNCH(DK, DV)                                                  \
  if (hd == DK && hdv == DV)                                                  \
    return launch<DK, DV>(qf, kf, vf, of, b, sq, sk, h, hkv, causal, window,  \
                          chunk, qscale, tiles, st);
  FLASH_LAUNCH(256, 256)
  FLASH_LAUNCH(128, 128)
  FLASH_LAUNCH(64, 64)
  FLASH_LAUNCH(32, 32)
  FLASH_LAUNCH(192, 128)
#undef FLASH_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int flash_attention_query(int b, int sq, int h, int hkv, int hd,
                                     int hdv, int* grid_blocks,
                                     int* resident_per_sm) {
  if (hkv <= 0 || h % hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
#define FLASH_QUERY(DK, DV) \
  if (hd == DK && hdv == DV) return query<DK, DV>(b, sq, h, hkv, grid_blocks, resident_per_sm);
  FLASH_QUERY(256, 256)
  FLASH_QUERY(128, 128)
  FLASH_QUERY(64, 64)
  FLASH_QUERY(32, 32)
  FLASH_QUERY(192, 128)
#undef FLASH_QUERY
  return static_cast<int>(cudaErrorInvalidValue);
}

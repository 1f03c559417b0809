// Blocked online-softmax attention with grouped-query heads (GQA) for
// Hopper, sm_90a, float32:
//
//   out[b, q, h, :] = Σ_k softmax_k(scale · q[b,q,h]·k[b,k,h/G] + bias) v[b,k,h/G]
//
// with q (B, Sq, H, hd), k and v (B, Sk, Hkv, hd), G = H / Hkv (query head h
// reads KV head h / G, the reference's reshape(b, s, hkv, g, hd)), and the
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
// (0.13 ms at 3.35 TB/s). The computation stays in float32 (no TF32, whose
// 10-bit mantissa would miss the float32 tolerances of the checks).
//
// Design, a first simple one: one block of 256 threads per (query tile of
// 64 rows, query head, batch); query tiles are issued last-first, so the
// long causal tiles start early. The block keeps its Q tile and one K and
// one V tile of 64 keys in shared memory (rows padded by 4 floats, so the
// 16-byte loads of a quarter warp hit distinct banks). Thread (ty, tx) of a
// 16 × 16 grid owns query rows 4·ty .. 4·ty + 3 and, per key tile, the
// scores of keys tx + 16·j (j < 4); the softmax state (m, partial l) and
// its 4 × hd/16 slice of the output (columns 64·c + 4·tx .. + 3) stay in
// registers. Row maxima are reduced over the 16 threads of a row with warp
// shuffles. P goes through shared memory (over the K tile, which is dead
// by then) for the P·V product. Key tiles that are masked for every row
// of the query tile are skipped: this is exact for every row with a valid
// key. When a row of the tile has no valid key at all, every key tile is
// streamed, so that row gets the reference's value, the mean of v over the
// Sk keys (each masked key counts exp(0) = 1 while m stays at −1e30).
//
// C interface (bound with ctypes): returns cudaGetLastError() after the
// launch. Launches on the caller's stream, never synchronises, allocates
// nothing.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int THREADS = 256;
constexpr int BQ = 64;               // query rows per block
constexpr int BK = 64;               // keys per tile
constexpr int ROWS = 4;              // query rows per thread
constexpr int KEYS = 4;              // keys per thread and tile
constexpr float NEG_INF = -1e30f;

// The keys [lo, hi] that query position qp may attend to (empty if lo > hi).
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

// Copy 64 rows of hd floats, rows [row0, row0 + 64) of a (rows, heads, hd)
// slab at head `head`, into shared memory with row stride hd + 4; rows at
// or past `n_rows` are zero.
template <int HD>
__device__ __forceinline__ void load_tile(float* dst,
                                          const float* __restrict__ src,
                                          int row0, int n_rows, int heads,
                                          int head) {
  constexpr int VEC = HD / 4;
  constexpr int STRIDE = HD + 4;
#pragma unroll
  for (int f = threadIdx.x; f < BK * VEC; f += THREADS) {
    const int r = f / VEC, c = f % VEC;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n_rows) {
      val = reinterpret_cast<const float4*>(
          src + ((size_t)(row0 + r) * heads + head) * HD)[c];
    }
    *reinterpret_cast<float4*>(dst + r * STRIDE + 4 * c) = val;
  }
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 2)
flash_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out,
                       int sq, int sk, int h, int hkv, bool causal,
                       int window, int chunk, float scale) {
  constexpr int STRIDE = HD + 4;     // shared row stride of Q, K, V
  constexpr int PSTRIDE = BK + 4;    // shared row stride of P
  constexpr int NCH = HD / 64;       // 64-column chunks of the output
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + BQ * STRIDE;
  float* vs = ks + BK * STRIDE;
  float* ps = ks;                    // P reuses the K tile once S is done

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int head = blockIdx.y, b = blockIdx.z;
  const int kvh = head / (h / hkv);
  const float* qb = q + (size_t)b * sq * h * HD;
  const float* kb = k + (size_t)b * sk * hkv * HD;
  const float* vb = v + (size_t)b * sk * hkv * HD;

  // The key tiles this query tile needs: key_range is non-decreasing in
  // both ends, so the union over its rows lies in [lo(q0), hi(q_last)].
  const int q_last = min(q0 + BQ - 1, sq - 1);
  int lo, hi, unused;
  bool empty_row = false;
  if (tid < BQ && q0 + tid < sq) {
    key_range(q0 + tid, sk, causal, window, chunk, &lo, &hi);
    empty_row = lo > hi;
  }
  const bool stream_all = __syncthreads_or(empty_row);
  key_range(q0, sk, causal, window, chunk, &lo, &unused);
  key_range(q_last, sk, causal, window, chunk, &unused, &hi);
  const int kt_begin = stream_all ? 0 : lo / BK;
  const int kt_end = stream_all ? (sk - 1) / BK : hi / BK;

  load_tile<HD>(qs, qb, q0, sq, h, head);

  float m[ROWS], l[ROWS], acc[ROWS][NCH][4];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.f;
  }

  for (int kt = kt_begin; kt <= kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();                 // the previous P·V is done with ks, vs
    load_tile<HD>(ks, kb, k0, sk, hkv, kvh);
    load_tile<HD>(vs, vb, k0, sk, hkv, kvh);
    __syncthreads();

    // S = Q Kᵀ for rows 4·ty + i and keys tx + 16·j
    float s[ROWS][KEYS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < KEYS; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qv[ROWS], kv[KEYS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qs + (4 * ty + i) * STRIDE + d);
#pragma unroll
      for (int j = 0; j < KEYS; ++j)
        kv[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * STRIDE + d);
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int j = 0; j < KEYS; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

    // scale and mask, then the online-softmax update of each row
    float corr[ROWS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int qp = q0 + 4 * ty + i;
      float row_max = NEG_INF;
#pragma unroll
      for (int j = 0; j < KEYS; ++j) {
        const int kp = k0 + tx + 16 * j;
        bool ok = kp < sk;
        if (causal) ok = ok && qp >= kp;
        if (window > 0) ok = ok && qp - kp < window;
        if (chunk > 0) ok = ok && qp / chunk == kp / chunk;
        s[i][j] = ok ? s[i][j] * scale : NEG_INF;
        row_max = fmaxf(row_max, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, off));
      const float m_new = fmaxf(m[i], row_max);
      corr[i] = expf(m[i] - m_new);
      m[i] = m_new;
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < KEYS; ++j) {
        // a padded key (kp ≥ Sk) is no key: it adds nothing to l
        const float p = k0 + tx + 16 * j < sk ? expf(s[i][j] - m_new) : 0.f;
        s[i][j] = p;
        row_sum += p;
      }
      l[i] = l[i] * corr[i] + row_sum;
    }
    __syncthreads();                 // every thread is done reading ks
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < KEYS; ++j)
        ps[(4 * ty + i) * PSTRIDE + tx + 16 * j] = s[i][j];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int c = 0; c < NCH; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][c][e] *= corr[i];
    __syncthreads();

    // acc += P V over the 64 keys of the tile
#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float4 pv[ROWS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
        pv[i] = *reinterpret_cast<const float4*>(ps + (4 * ty + i) * PSTRIDE + kk);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
#pragma unroll
        for (int c = 0; c < NCH; ++c) {
          const float4 vv = *reinterpret_cast<const float4*>(
              vs + (kk + t) * STRIDE + 64 * c + 4 * tx);
#pragma unroll
          for (int i = 0; i < ROWS; ++i) {
            const float p = t == 0 ? pv[i].x : t == 1 ? pv[i].y
                          : t == 2 ? pv[i].z : pv[i].w;
            acc[i][c][0] = fmaf(p, vv.x, acc[i][c][0]);
            acc[i][c][1] = fmaf(p, vv.y, acc[i][c][1]);
            acc[i][c][2] = fmaf(p, vv.z, acc[i][c][2]);
            acc[i][c][3] = fmaf(p, vv.w, acc[i][c][3]);
          }
        }
      }
    }
  }

  // l: the partial sums of the row's 16 threads; out = acc / max(l, 1e-30)
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    float total = l[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      total += __shfl_xor_sync(0xffffffffu, total, off);
    const int qp = q0 + 4 * ty + i;
    if (qp >= sq) continue;
    const float denom = fmaxf(total, 1e-30f);
    float* orow = out + (((size_t)b * sq + qp) * h + head) * HD;
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      *reinterpret_cast<float4*>(orow + 64 * c + 4 * tx) = make_float4(
          acc[i][c][0] / denom, acc[i][c][1] / denom, acc[i][c][2] / denom,
          acc[i][c][3] / denom);
    }
  }
}

template <int HD>
int launch(const float* q, const float* k, const float* v, float* out, int b,
           int sq, int sk, int h, int hkv, int causal, int window, int chunk,
           float scale, cudaStream_t stream) {
  const size_t smem = (size_t)(BQ + 2 * BK) * (HD + 4) * sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + BQ - 1) / BQ, h, b);
  flash_attention_kernel<HD><<<grid, THREADS, smem, stream>>>(
      q, k, v, out, sq, sk, h, hkv, causal != 0, window, chunk, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// hd must be 64 or 128 (anything else returns cudaErrorInvalidValue);
// the wrapper checks shapes, layout and alignment before the call.
extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* out, int b, int sq,
                                   int sk, int h, int hkv, int hd, int causal,
                                   int window, int chunk, float scale,
                                   void* stream) {
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  auto* of = static_cast<float*>(out);
  auto* st = static_cast<cudaStream_t>(stream);
  if (hd == 128)
    return launch<128>(qf, kf, vf, of, b, sq, sk, h, hkv, causal, window,
                       chunk, scale, st);
  if (hd == 64)
    return launch<64>(qf, kf, vf, of, b, sq, sk, h, hkv, causal, window,
                      chunk, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

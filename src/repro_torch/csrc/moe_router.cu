// MoE top-k router for Hopper, sm_90a, float32:
//
//   p[t, :]     = exp(l[t, :] − max_e l[t, e]) / Σ_e exp(l[t, e] − max)
//   ids[t, r]   = the r-th largest p[t, :] (r < k), ties to the lower index
//   gates[t, r] = p[t, ids[t, r]] / max(Σ_r p[t, ids[t, r]], 1e-9)
//
// over logits (T, E) → gates (T, k) float32, ids (T, k) int32.
//
// Replaces the TPU kernel src/repro/kernels/moe_router.py:45 `moe_topk`
// (body `_router_kernel` :22, pallas_call :53), which keeps a (256, E) tile
// of logits in VMEM and runs k rounds of masked argmax over the tile's
// probabilities. The ranking is on p, as there, not on the logits or the
// exps: the division can round two distinct exps to one p, and then the
// lower index must win, as it does in `lax.top_k`. A chosen expert is
// taken out of the ranking (below every p ≥ 0), where the Pallas kernel
// multiplies it by 0; the two differ only where a probability underflows
// to 0 within the top k, and there this kernel gives what `lax.top_k` (the
// model's own router, `ref.moe_topk_ref`) gives: no expert twice.
//
// What bounds it on the H100: bytes, and in practice the launch. At a
// prefill of T = 8192 tokens over E = 64 experts it reads 2.10 MB and
// writes 0.39 MB (0.74 µs at 3.35 TB/s) and does ≈ 11 operations per
// logit (≈ 0.1 µs at 67 TFLOP/s); at decode T is the batch, and the launch
// is all there is. Every row fits on the card at once (8 rows a block), so
// the time is one row's chain of dependent warp operations after the
// loads: that chain is what the design shortens.
//
// Design. A row takes LANES lanes (32, or E rounded up to a power of two
// when E ≤ 16: then 32 / LANES rows share a warp); lane l holds the
// experts l + LANES·j (j < SLOTS) in registers, the layout of PyTorch's
// own warp softmax, so both sum the exps in the same order. The row max is
// one `redux.sync` max over an order-preserving integer image of the
// floats (exact); the sum is the butterfly of __shfl_xor_sync that
// PyTorch takes; p uses expf and an IEEE division. Selection: p ≥ 0, so
// its bits order as an unsigned int; an expert's key is bits(p) + 1 (0
// for padding). Each lane sorts its SLOTS keys (high first, the lower
// index first among equal keys). Each of the k rounds is then two
// `redux.sync` over the lanes' heads: the max key over the row, then the
// min index among the heads that hold it, which breaks ties toward the
// lower index; the winner's lane pops its head. Every lane keeps every
// round's value and index (the reductions' results are the same in all
// lanes), and lane r writes round r at the end, divided by the sum of the
// k values in rank order. Instances are templated on (E, k) for the
// registry's routers (64 / 6, 16 / 2), with every loop unrolled; a generic
// instance takes any E ≤ 128 and k ≤ 8 with four slots. The loads of a row
// are coalesced (LANES consecutive floats per slot).
//
// The sigmoid instance (moonlight-16b-a3b's router, DeepSeek-V3's noaux_tc
// with one group), over logits (T, E) and a bias (E,):
//
//   s[t, :]     = 1 / (1 + exp(−l[t, :]))
//   ids[t, r]   = the r-th largest s[t, :] + bias, ties to the lower index
//   gates[t, r] = s[t, ids[t, r]] / (Σ_r s[t, ids[t, r]] + 1e-20) · scale
//
// `moe_topk_sigmoid_kernel` takes the softmax kernel's lanes, slots and
// rounds, with no row max and no sum before the selection: a lane's key
// is the ordered image of s + bias (s + bias may be negative; 0 is
// padding, below every float's image), and each lane carries its slots'
// s beside the keys through its sort, so that a round's winner hands its
// s to the row by one shuffle from the winner's lane. The softmax kernel
// is a separate function, untouched. Instanced at (64, 6) with every loop
// unrolled, and generic.
//
// C interface (bound with ctypes): `moe_topk_f32` and
// `moe_topk_sigmoid_f32` return cudaGetLastError() after the launch;
// `moe_topk_query` and `moe_topk_sigmoid_query` report the grid, resident
// blocks per SM, registers and local (spill) bytes per thread of the
// instance a shape takes. Launches on the caller's stream, never
// synchronises, allocates nothing.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int WARP = 32;
constexpr int WARPS = 8;                  // warps per block
constexpr int MAX_E = 128;                // experts
constexpr int MAX_K = 8;                  // choices per token
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned NONE = 0xffffffffu;    // no candidate index

// (E, K) = (0, 0): the generic instance, E and k at run time.
template <int E, int K>
struct Router {
  static constexpr int LANES = E == 0 || E > 16 ? WARP
                               : E > 8 ? 16 : E > 4 ? 8 : E > 2 ? 4 : 2;
  static constexpr int SLOTS = E == 0 ? MAX_E / WARP
                                      : (E + LANES - 1) / LANES;
  static constexpr int ROWS = WARPS * (WARP / LANES);   // rows per block
};

// an unsigned image of a float whose order is the floats' order
__device__ __forceinline__ unsigned ordered(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : u | 0x80000000u;
}
__device__ __forceinline__ float unordered(unsigned o) {
  return __uint_as_float((o & 0x80000000u) ? o & 0x7fffffffu : ~o);
}

template <int E, int K>
__global__ void __launch_bounds__(WARP * WARPS)
    moe_topk_kernel(const float* __restrict__ logits,
                    float* __restrict__ gates, int* __restrict__ ids, int t,
                    int e_run, int k_run) {
  using Rt = Router<E, K>;
  constexpr int LANES = Rt::LANES, SLOTS = Rt::SLOTS;
  const int e = E == 0 ? e_run : E;
  const int k = K == 0 ? k_run : K;
  const int lane = threadIdx.x & (WARP - 1);
  const int l = lane % LANES, sub = lane / LANES;
  const int row = (blockIdx.x * WARPS + threadIdx.x / WARP)
                      * (WARP / LANES) + sub;
  if (row >= t) return;  // a whole row's lanes: the others keep their mask
  const unsigned mask = (FULL >> (WARP - LANES)) << (sub * LANES);
  const float* lrow = logits + (size_t)row * e;
  const float neg_inf = __int_as_float(0xff800000);

  float p[SLOTS];
  float m = neg_inf;
#pragma unroll
  for (int j = 0; j < SLOTS; ++j) {
    const int x = l + LANES * j;
    p[j] = x < e ? lrow[x] : neg_inf;
    m = fmaxf(m, p[j]);
  }
  m = unordered(__reduce_max_sync(mask, ordered(m)));
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < SLOTS; ++j) {
    p[j] = l + LANES * j < e ? expf(p[j] - m) : 0.f;
    s += p[j];
  }
#pragma unroll
  for (int off = LANES / 2; off > 0; off >>= 1)
    s += __shfl_xor_sync(mask, s, off);
  // each lane's keys sorted by key, high first, lower index first among
  // equal keys (a bubble pass of neighbours, which keeps that order)
  unsigned key[SLOTS], idx[SLOTS];
#pragma unroll
  for (int j = 0; j < SLOTS; ++j) {
    idx[j] = l + LANES * j;
    key[j] = (int)idx[j] < e ? __float_as_uint(p[j] / s) + 1u : 0u;
  }
#pragma unroll
  for (int pass = 1; pass < SLOTS; ++pass)
#pragma unroll
    for (int j = 0; j + pass < SLOTS; ++j)
      if (key[j + 1] > key[j]) {
        const unsigned tk = key[j], ti = idx[j];
        key[j] = key[j + 1];
        idx[j] = idx[j + 1];
        key[j + 1] = tk;
        idx[j + 1] = ti;
      }

  // round r: the top key over the row, the lowest index holding it (each
  // lane offers its head), whose lane pops its head
  constexpr int ROUNDS = K == 0 ? MAX_K : K;
  float val[ROUNDS];
  unsigned win[ROUNDS];
  float total = 0.f;
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) {
    val[r] = 0.f;
    win[r] = 0u;
    if (K == 0 && r >= k) continue;
    const unsigned top = __reduce_max_sync(mask, key[0]);
    win[r] = __reduce_min_sync(mask, key[0] == top ? idx[0] : NONE);
    if (win[r] == idx[0]) {
#pragma unroll
      for (int j = 0; j + 1 < SLOTS; ++j) {
        key[j] = key[j + 1];
        idx[j] = idx[j + 1];
      }
      key[SLOTS - 1] = 0u;
    }
    val[r] = __uint_as_float(top - 1u);
    total += val[r];
  }
  // lane r < k writes round r
  float mine_v = val[0];
  unsigned mine_i = win[0];
#pragma unroll
  for (int r = 1; r < ROUNDS; ++r)
    if (l == r) {
      mine_v = val[r];
      mine_i = win[r];
    }
  if (l < k) {
    gates[(size_t)row * k + l] = mine_v / fmaxf(total, 1e-9f);
    ids[(size_t)row * k + l] = (int)mine_i;
  }
}

template <int E, int K>
__global__ void __launch_bounds__(WARP * WARPS)
    moe_topk_sigmoid_kernel(const float* __restrict__ logits,
                            const float* __restrict__ bias,
                            float* __restrict__ gates, int* __restrict__ ids,
                            int t, int e_run, int k_run, float scale) {
  using Rt = Router<E, K>;
  constexpr int LANES = Rt::LANES, SLOTS = Rt::SLOTS;
  const int e = E == 0 ? e_run : E;
  const int k = K == 0 ? k_run : K;
  const int lane = threadIdx.x & (WARP - 1);
  const int l = lane % LANES, sub = lane / LANES;
  const int row = (blockIdx.x * WARPS + threadIdx.x / WARP)
                      * (WARP / LANES) + sub;
  if (row >= t) return;  // a whole row's lanes: the others keep their mask
  const unsigned mask = (FULL >> (WARP - LANES)) << (sub * LANES);
  const float* lrow = logits + (size_t)row * e;

  // each lane's slots: s, and the key of s + bias, sorted by key, high
  // first, lower index first among equal keys
  unsigned key[SLOTS], idx[SLOTS];
  float sc[SLOTS];
#pragma unroll
  for (int j = 0; j < SLOTS; ++j) {
    idx[j] = l + LANES * j;
    const bool live = (int)idx[j] < e;
    sc[j] = live ? 1.f / (1.f + expf(-lrow[idx[j]])) : 0.f;
    key[j] = live ? ordered(sc[j] + bias[idx[j]]) : 0u;
  }
#pragma unroll
  for (int pass = 1; pass < SLOTS; ++pass)
#pragma unroll
    for (int j = 0; j + pass < SLOTS; ++j)
      if (key[j + 1] > key[j]) {
        const unsigned tk = key[j], ti = idx[j];
        const float ts = sc[j];
        key[j] = key[j + 1];
        idx[j] = idx[j + 1];
        sc[j] = sc[j + 1];
        key[j + 1] = tk;
        idx[j + 1] = ti;
        sc[j + 1] = ts;
      }

  constexpr int ROUNDS = K == 0 ? MAX_K : K;
  float val[ROUNDS];
  unsigned win[ROUNDS];
  float total = 0.f;
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) {
    val[r] = 0.f;
    win[r] = 0u;
    if (K == 0 && r >= k) continue;
    const unsigned top = __reduce_max_sync(mask, key[0]);
    win[r] = __reduce_min_sync(mask, key[0] == top ? idx[0] : NONE);
    // the winner's s, from its lane (expert x sits on lane x % LANES)
    val[r] = __shfl_sync(mask, sc[0], sub * LANES + win[r] % LANES);
    if (win[r] == idx[0]) {
#pragma unroll
      for (int j = 0; j + 1 < SLOTS; ++j) {
        key[j] = key[j + 1];
        idx[j] = idx[j + 1];
        sc[j] = sc[j + 1];
      }
      key[SLOTS - 1] = 0u;
    }
    total += val[r];
  }
  float mine_v = val[0];
  unsigned mine_i = win[0];
#pragma unroll
  for (int r = 1; r < ROUNDS; ++r)
    if (l == r) {
      mine_v = val[r];
      mine_i = win[r];
    }
  if (l < k) {
    gates[(size_t)row * k + l] = mine_v / (total + 1e-20f) * scale;
    ids[(size_t)row * k + l] = (int)mine_i;
  }
}

template <int E, int K>
int launch(const void* logits, void* gates, void* ids, int t, int e, int k,
           cudaStream_t stream) {
  const dim3 grid((t + Router<E, K>::ROWS - 1) / Router<E, K>::ROWS);
  moe_topk_kernel<E, K><<<grid, WARP * WARPS, 0, stream>>>(
      static_cast<const float*>(logits), static_cast<float*>(gates),
      static_cast<int*>(ids), t, e, k);
  return static_cast<int>(cudaGetLastError());
}

template <int E, int K>
int query(int t, int* grid, int* resident, int* registers, int* local) {
  *grid = (t + Router<E, K>::ROWS - 1) / Router<E, K>::ROWS;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      resident, moe_topk_kernel<E, K>, WARP * WARPS, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, moe_topk_kernel<E, K>);
  if (err != cudaSuccess) return static_cast<int>(err);
  *registers = attr.numRegs;
  *local = static_cast<int>(attr.localSizeBytes);
  return 0;
}

template <int E, int K>
int launch_sigmoid(const void* logits, const void* bias, void* gates,
                   void* ids, int t, int e, int k, float scale,
                   cudaStream_t stream) {
  const dim3 grid((t + Router<E, K>::ROWS - 1) / Router<E, K>::ROWS);
  moe_topk_sigmoid_kernel<E, K><<<grid, WARP * WARPS, 0, stream>>>(
      static_cast<const float*>(logits), static_cast<const float*>(bias),
      static_cast<float*>(gates), static_cast<int*>(ids), t, e, k, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int E, int K>
int query_sigmoid(int t, int* grid, int* resident, int* registers,
                  int* local) {
  *grid = (t + Router<E, K>::ROWS - 1) / Router<E, K>::ROWS;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      resident, moe_topk_sigmoid_kernel<E, K>, WARP * WARPS, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, moe_topk_sigmoid_kernel<E, K>);
  if (err != cudaSuccess) return static_cast<int>(err);
  *registers = attr.numRegs;
  *local = static_cast<int>(attr.localSizeBytes);
  return 0;
}

bool valid(int t, int e, int k) {
  return t >= 1 && e >= 1 && e <= MAX_E && k >= 1 && k <= MAX_K && k <= e;
}

}  // namespace

// 1 ≤ k ≤ min(e, 8) and e ≤ 128, t ≥ 1 (anything else returns
// cudaErrorInvalidValue); the wrapper checks shapes and layout before the
// call.
extern "C" int moe_topk_f32(const void* logits, void* gates, void* ids,
                            int t, int e, int k, void* stream) {
  if (!valid(t, e, k)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (e == 64 && k == 6) return launch<64, 6>(logits, gates, ids, t, e, k, st);
  if (e == 16 && k == 2) return launch<16, 2>(logits, gates, ids, t, e, k, st);
  return launch<0, 0>(logits, gates, ids, t, e, k, st);
}

// The grid of the launch at (t, e, k), and its instance's resident blocks
// per SM, registers and local (spill) bytes per thread.
extern "C" int moe_topk_query(int t, int e, int k, int* grid,
                              int* resident_per_sm, int* registers,
                              int* local_bytes) {
  if (!valid(t, e, k)) return static_cast<int>(cudaErrorInvalidValue);
  if (e == 64 && k == 6)
    return query<64, 6>(t, grid, resident_per_sm, registers, local_bytes);
  if (e == 16 && k == 2)
    return query<16, 2>(t, grid, resident_per_sm, registers, local_bytes);
  return query<0, 0>(t, grid, resident_per_sm, registers, local_bytes);
}

// The sigmoid instance: bias (e,) float32 and the scaling factor besides.
extern "C" int moe_topk_sigmoid_f32(const void* logits, const void* bias,
                                    void* gates, void* ids, int t, int e,
                                    int k, float scale, void* stream) {
  if (!valid(t, e, k)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (e == 64 && k == 6)
    return launch_sigmoid<64, 6>(logits, bias, gates, ids, t, e, k, scale, st);
  return launch_sigmoid<0, 0>(logits, bias, gates, ids, t, e, k, scale, st);
}

extern "C" int moe_topk_sigmoid_query(int t, int e, int k, int* grid,
                                      int* resident_per_sm, int* registers,
                                      int* local_bytes) {
  if (!valid(t, e, k)) return static_cast<int>(cudaErrorInvalidValue);
  if (e == 64 && k == 6)
    return query_sigmoid<64, 6>(t, grid, resident_per_sm, registers,
                                local_bytes);
  return query_sigmoid<0, 0>(t, grid, resident_per_sm, registers,
                             local_bytes);
}

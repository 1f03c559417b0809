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
// masked to −1 (below every p ≥ 0), where the Pallas kernel multiplies it
// by 0; the two differ only where a probability underflows to 0 within the
// top k, and there this kernel gives what `lax.top_k` (the model's own
// router, `ref.moe_topk_ref`) gives: no expert twice.
//
// What bounds it on the H100: bytes, and in practice the launch. At a
// prefill of T = 8192 tokens over E = 64 experts it reads 2.10 MB and
// writes 0.39 MB (0.74 µs at 3.35 TB/s) and does ≈ 11 operations per
// logit (≈ 0.1 µs at 67 TFLOP/s); at decode T is the batch, and the launch
// is all there is.
//
// Design, a simple one: one warp per token row, eight rows per block of
// 256 threads. Lane l holds the probabilities of experts l + 32·j
// (j < E/32 ≤ 4) in registers, the layout of PyTorch's own warp softmax,
// so both sum the exps in the same order. The row max and the sum are
// warp butterflies (__shfl_xor_sync); p uses expf and an IEEE division.
// Each of the k rounds is a butterfly argmax over (p, index) — larger p
// first, then the lower index — after which every lane holds the winner;
// its owner masks it. Lane r keeps round r's value and writes it at the
// end, divided by the sum of the k values taken in rank order. The loads
// of a row are coalesced (32 consecutive floats per warp load).
//
// C interface (bound with ctypes): returns cudaGetLastError() after the
// launch. Launches on the caller's stream, never synchronises, allocates
// nothing.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int WARP = 32;
constexpr int ROWS = 8;                   // token rows (warps) per block
constexpr int MAX_E = 128;                // experts
constexpr int MAX_K = 8;                  // choices per token
constexpr int SLOTS = MAX_E / WARP;       // experts per lane
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(WARP * ROWS)
    moe_topk_kernel(const float* __restrict__ logits,
                    float* __restrict__ gates, int* __restrict__ ids, int t,
                    int e, int k) {
  const int lane = threadIdx.x & (WARP - 1);
  const int row = blockIdx.x * ROWS + (threadIdx.x / WARP);
  if (row >= t) return;  // the whole warp: one row per warp
  const float* lrow = logits + (size_t)row * e;
  const float neg_inf = __int_as_float(0xff800000);

  float p[SLOTS];
  float m = neg_inf;
#pragma unroll
  for (int j = 0; j < SLOTS; ++j) {
    const int x = lane + WARP * j;
    p[j] = x < e ? lrow[x] : neg_inf;
    m = fmaxf(m, p[j]);
  }
#pragma unroll
  for (int off = WARP / 2; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(FULL, m, off));
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < SLOTS; ++j) {
    p[j] = lane + WARP * j < e ? expf(p[j] - m) : 0.f;
    s += p[j];
  }
#pragma unroll
  for (int off = WARP / 2; off > 0; off >>= 1)
    s += __shfl_xor_sync(FULL, s, off);
#pragma unroll
  for (int j = 0; j < SLOTS; ++j)
    p[j] = lane + WARP * j < e ? p[j] / s : -1.f;  // padding: never chosen

  float mine_v = 0.f, total = 0.f;
  int mine_i = 0;
#pragma unroll
  for (int r = 0; r < MAX_K; ++r) {
    if (r >= k) break;
    // this lane's best: strict > keeps the lowest j, the lowest index
    float bv = p[0];
    int bi = lane;
#pragma unroll
    for (int j = 1; j < SLOTS; ++j) {
      if (p[j] > bv) {
        bv = p[j];
        bi = lane + WARP * j;
      }
    }
#pragma unroll
    for (int off = WARP / 2; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(FULL, bv, off);
      const int oi = __shfl_xor_sync(FULL, bi, off);
      if (ov > bv || (ov == bv && oi < bi)) {
        bv = ov;
        bi = oi;
      }
    }
    total += bv;
    if (lane == r) {
      mine_v = bv;
      mine_i = bi;
    }
    if ((bi & (WARP - 1)) == lane) {
      const int jw = bi / WARP;
#pragma unroll
      for (int j = 0; j < SLOTS; ++j)
        if (j == jw) p[j] = -1.f;
    }
  }
  if (lane < k) {
    gates[(size_t)row * k + lane] = mine_v / fmaxf(total, 1e-9f);
    ids[(size_t)row * k + lane] = mine_i;
  }
}

}  // namespace

// 1 ≤ k ≤ min(e, 8) and e ≤ 128, t ≥ 1 (anything else returns
// cudaErrorInvalidValue); the wrapper checks shapes and layout before the
// call.
extern "C" int moe_topk_f32(const void* logits, void* gates, void* ids,
                            int t, int e, int k, void* stream) {
  if (t < 1 || e < 1 || e > MAX_E || k < 1 || k > MAX_K || k > e)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((t + ROWS - 1) / ROWS);
  moe_topk_kernel<<<grid, WARP * ROWS, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), static_cast<float*>(gates),
      static_cast<int*>(ids), t, e, k);
  return static_cast<int>(cudaGetLastError());
}

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
// H = 64, n = 64) it reads 4 × 134.2 MB and writes 134.2 MB (0.20 ms at
// 3.35 TB/s) and does ≈ 6n² operations per step and head, 12.9 GFLOP
// (0.19 ms at 67 TFLOP/s). Neither is the real limit: each head is a chain
// of 8192 dependent steps, and a step is a 64-term sum per column.
//
// Design, a simple one. One block per (b, h). Column j of the state and
// out[j] depend on no other column, so the columns split exactly across
// threads: four threads per column (RS), each holding a quarter of the
// column's rows in registers (rows q, q + 4, …), 4n threads a block. Each
// step, every thread sums r_i·S[i, j] and r_i·u_i·k_i over its rows and
// updates them; two shuffles add the four partial sums of a column. The
// inputs are staged CHUNK steps at a time in shared memory as one float4
// (r, k, v, w) per channel: the four rows a warp reads at once are
// neighbours (no bank conflict), and every thread of the block loads one
// operand's channel per step, 256-byte rows read whole. The next chunk's
// loads are issued into registers before the current chunk is computed,
// so their latency hides behind CHUNK steps of arithmetic; two barriers a
// chunk, none inside it. A head narrower than the template's NP (8, 16,
// 32 or 64) pads with zero channels, which leave the state zero.
//
// C interface (bound with ctypes): returns cudaGetLastError() after the
// launch. Launches on the caller's stream, never synchronises, allocates
// nothing.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int RS = 4;        // threads per state column
constexpr int CHUNK = 16;    // steps staged in shared memory at a time
constexpr int MAX_N = 64;
constexpr unsigned FULL = 0xffffffffu;

template <int NP>
__global__ void __launch_bounds__(NP * RS)
    wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ u, const float* __restrict__ s0,
                float* __restrict__ out, float* __restrict__ s_fin, int seq,
                int heads, int n) {
  constexpr int ROWS = NP / RS;          // state rows per thread
  __shared__ float4 stage[CHUNK][NP];    // (r, k, v, w) of step t, channel i

  const int bh = blockIdx.x;
  const int b = bh / heads, h = bh - b * heads;
  const int tid = threadIdx.x;
  const int col = tid / RS, q = tid - col * RS;   // state column, row phase
  const int op = tid / NP, ch = tid - op * NP;    // staged operand, channel
  const bool col_live = col < n, ch_live = ch < n;

  const size_t step = (size_t)heads * n;          // one time step
  const size_t base = (size_t)b * seq * step + (size_t)h * n;
  const float* in = (op == 0 ? r : op == 1 ? k : op == 2 ? v : w) + base + ch;
  float* o = out + base + col;
  const size_t sb = (size_t)bh * n * n;

  float st[ROWS], uu[ROWS];
#pragma unroll
  for (int ii = 0; ii < ROWS; ++ii) {
    const int i = ii * RS + q;
    uu[ii] = i < n ? u[(size_t)h * n + i] : 0.f;
    st[ii] = (s0 != nullptr && i < n && col_live)
                 ? s0[sb + (size_t)i * n + col] : 0.f;
  }

  float pre[CHUNK];                      // this thread's operand, next chunk
#pragma unroll
  for (int j = 0; j < CHUNK; ++j)
    pre[j] = (ch_live && j < seq) ? in[(size_t)j * step] : 0.f;

  for (int t0 = 0; t0 < seq; t0 += CHUNK) {
    __syncthreads();                     // the previous chunk is consumed
#pragma unroll
    for (int j = 0; j < CHUNK; ++j)
      reinterpret_cast<float*>(&stage[j][ch])[op] = pre[j];
    __syncthreads();
    const int next = t0 + CHUNK;
#pragma unroll
    for (int j = 0; j < CHUNK; ++j)
      pre[j] = (ch_live && next + j < seq) ? in[(size_t)(next + j) * step]
                                           : 0.f;
    const int steps = min(CHUNK, seq - t0);
    for (int j = 0; j < steps; ++j) {
      const float vj = stage[j][col].z;
      float acc = 0.f, bonus = 0.f;
#pragma unroll
      for (int ii = 0; ii < ROWS; ++ii) {
        const float4 x = stage[j][ii * RS + q];   // r, k, v, w of row i
        acc = fmaf(x.x, st[ii], acc);
        bonus = fmaf(x.x * uu[ii], x.y, bonus);
        st[ii] = fmaf(x.w, st[ii], x.y * vj);
      }
      float part = fmaf(vj, bonus, acc);
      part += __shfl_xor_sync(FULL, part, 1);
      part += __shfl_xor_sync(FULL, part, 2);
      if (q == 0 && col_live) o[(size_t)(t0 + j) * step] = part;
    }
  }

#pragma unroll
  for (int ii = 0; ii < ROWS; ++ii) {
    const int i = ii * RS + q;
    if (i < n && col_live) s_fin[sb + (size_t)i * n + col] = st[ii];
  }
}

template <int NP>
void launch(const void* r, const void* k, const void* v, const void* w,
            const void* u, const void* s0, void* out, void* s_fin, int b,
            int s, int h, int n, cudaStream_t stream) {
  wkv6_kernel<NP><<<dim3((unsigned)b * (unsigned)h), NP * RS, 0, stream>>>(
      static_cast<const float*>(r), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<float*>(out), static_cast<float*>(s_fin), s, h, n);
}

}  // namespace

// b, s, h ≥ 1 and 1 ≤ n ≤ 64 (anything else returns
// cudaErrorInvalidValue); s0 may be null (a zero state). The wrapper
// checks shapes and layout before the call.
extern "C" int rwkv6_wkv_f32(const void* r, const void* k, const void* v,
                             const void* w, const void* u, const void* s0,
                             void* out, void* s_fin, int b, int s, int h,
                             int n, void* stream) {
  if (b < 1 || s < 1 || h < 1 || n < 1 || n > MAX_N)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 8)
    launch<8>(r, k, v, w, u, s0, out, s_fin, b, s, h, n, st);
  else if (n <= 16)
    launch<16>(r, k, v, w, u, s0, out, s_fin, b, s, h, n, st);
  else if (n <= 32)
    launch<32>(r, k, v, w, u, s0, out, s_fin, b, s, h, n, st);
  else
    launch<64>(r, k, v, w, u, s0, out, s_fin, b, s, h, n, st);
  return static_cast<int>(cudaGetLastError());
}

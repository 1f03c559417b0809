// Mamba selective-scan recurrence for Hopper, sm_90a, float32:
//
//   h[b,t,d,n] = decay[b,t,d,n] · h[b,t−1,d,n] + drive[b,t,d,n]
//
// for t = 0 .. S−1, from h[b,−1] = h0[b] (or 0 when h0 is null), over
// decay and drive (B, S, D, N) → every h_t, h (B, S, D, N).
//
// Replaces the TPU kernel src/repro/kernels/mamba_scan.py:41 `mamba_scan`
// (body `_scan_kernel` :22, pallas_call :51), which runs one program per
// (b, 256-channel tile) with the (256, N) state in VMEM and a fori_loop
// over the sequence. It starts from zero; this kernel takes an initial
// state as well, so that a decode step (S = 1) continues the cache in one
// launch.
//
// What bounds it on the H100: bytes. Each element of decay and drive is
// read once and each h_t written once, 12 bytes per (b, t, d, n), against
// one FMA: at jamba-v0.1-52b's prefill (B = 1, S = 8192, D = 8192,
// N = 16) 12.9 GB, 3.85 ms at 3.35 TB/s, while 2.1 GFLOP take 0.03 ms.
//
// Design, a simple one. Every (b, d, n) is an independent scalar chain
// (131,072 of them at B = 1), so one thread runs one chain in a register
// and consecutive threads take consecutive (d, n): each warp's load or
// store of a step is 128 contiguous bytes. The loads of decay and drive
// do not depend on h, so a thread issues the next U steps' loads before
// it computes the current U steps: 2U loads in flight per thread, enough
// bytes in flight across the card to approach its memory rate. That
// takes 80 registers a thread, so three blocks of 256 fit on an SM. A
// sequence shorter than PREFETCH steps (a decode step, S = 1) has nothing
// to load ahead: its instance takes U = 1, fewer registers and all of an
// SM's 2048 threads, so that more chains load at once. No shared memory, no
// barrier, no atomics. A D·N that is not a multiple of the block leaves
// the last block's tail threads idle; an S that is not a multiple of U
// masks the last group's steps.
//
// C interface (bound with ctypes): returns cudaGetLastError() after the
// launch. Launches on the caller's stream, never synchronises, allocates
// nothing.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int BLOCK = 256;   // threads (chains) per block
constexpr int PREFETCH = 8;  // steps loaded ahead per group, S ≥ PREFETCH

template <int U>
__global__ void __launch_bounds__(BLOCK)
    mamba_scan_kernel(const float* __restrict__ decay,
                      const float* __restrict__ drive,
                      const float* __restrict__ h0, float* __restrict__ h,
                      int seq, long long dn) {
  const long long i = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (i >= dn) return;
  const size_t b = blockIdx.y;
  const size_t step = (size_t)dn;                 // one time step
  const size_t base = b * (size_t)seq * step + (size_t)i;
  const float* a_in = decay + base;
  const float* x_in = drive + base;
  float* out = h + base;

  float state = h0 != nullptr ? h0[b * step + (size_t)i] : 0.f;
  float a_cur[U], x_cur[U], a_nxt[U], x_nxt[U];
#pragma unroll
  for (int j = 0; j < U; ++j) {
    const bool live = j < seq;
    a_cur[j] = live ? a_in[(size_t)j * step] : 0.f;
    x_cur[j] = live ? x_in[(size_t)j * step] : 0.f;
  }
  for (int t0 = 0; t0 < seq; t0 += U) {
    const int t1 = t0 + U;
#pragma unroll
    for (int j = 0; j < U; ++j) {                  // the next group's loads
      const bool live = t1 + j < seq;
      a_nxt[j] = live ? a_in[(size_t)(t1 + j) * step] : 0.f;
      x_nxt[j] = live ? x_in[(size_t)(t1 + j) * step] : 0.f;
    }
    if (t1 <= seq) {
#pragma unroll
      for (int j = 0; j < U; ++j) {
        state = fmaf(a_cur[j], state, x_cur[j]);
        out[(size_t)(t0 + j) * step] = state;
      }
    } else {
#pragma unroll
      for (int j = 0; j < U; ++j) {
        if (t0 + j < seq) {
          state = fmaf(a_cur[j], state, x_cur[j]);
          out[(size_t)(t0 + j) * step] = state;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < U; ++j) {
      a_cur[j] = a_nxt[j];
      x_cur[j] = x_nxt[j];
    }
  }
}

}  // namespace

// b, s, d, n ≥ 1 and b ≤ 65535 (anything else returns
// cudaErrorInvalidValue); h0 may be null (a zero state). The wrapper
// checks shapes and layout before the call.
extern "C" int mamba_scan_f32(const void* decay, const void* drive,
                              const void* h0, void* h, int b, int s, int d,
                              int n, void* stream) {
  if (b < 1 || b > 65535 || s < 1 || d < 1 || n < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long dn = (long long)d * n;
  const dim3 grid((unsigned)((dn + BLOCK - 1) / BLOCK), (unsigned)b);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(decay);
  const float* x = static_cast<const float*>(drive);
  const float* z = static_cast<const float*>(h0);
  float* out = static_cast<float*>(h);
  if (s >= PREFETCH)
    mamba_scan_kernel<PREFETCH><<<grid, BLOCK, 0, st>>>(a, x, z, out, s, dn);
  else
    mamba_scan_kernel<1><<<grid, BLOCK, 0, st>>>(a, x, z, out, s, dn);
  return static_cast<int>(cudaGetLastError());
}

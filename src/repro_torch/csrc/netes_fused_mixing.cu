// Fused wire-form kernels of a quantizing channel (DESIGN.md §12) for
// Hopper, sm_90a. Two entry points:
//
// 1. fused_neighbor_sum_f32 — Eq. 3's neighbor contraction straight from the
//    int8 wire codes:
//
//      out[j, :] = Σ_k ws[j, k] · codes[idx[j, k], :]
//
//    with ws the (N, K_max) slot weights into which the caller has folded
//    mask · coeff · edge_mask · decode scale (kernels/ref.py:folded_weights).
//    The decoded float32 payload and the (N, K, D) gather never exist.
//
//    Replaces the TPU kernel src/repro/kernels/netes_fused_mixing.py:112
//    `fused_neighbor_sum` (body `_fused_neighbor_sum_kernel` :91,
//    pallas_call :163), which keeps the whole (N, 512) int8 slab and the
//    (N, K) weights in VMEM and loops over the K_max slots with row gathers.
//
//    What bounds it on the H100: the operations are 2·nnz·D flops (0.9
//    GFLOP at N = 1000, nnz ≈ 1e5, D = 4481 → 14 µs at 67 TFLOP/s); the
//    compulsory bytes (codes read once, out written once) take 7 µs. The
//    real traffic is the gathers: N·K_max·D bytes of int8 (583 MB), an
//    eighth of the float32 sparse kernel's, served from L2 once the 4.5 MB
//    of codes are resident there.
//
//    Design: the float32 sparse kernel's (csrc/netes_sparse_mixing.cu). One
//    block per (receiver j, 512-column tile of D). The block loads row j's
//    indices and folded weights into shared memory. Each thread owns 4
//    columns strided by the block width, so each warp reads one 32-byte
//    segment of a gathered row; the codes are widened to float in
//    registers and accumulated with FMAs in slot order, as the reference's
//    slot loop adds them. Padded slots index row j with weight 0.
//
// 2. fused_broadcast_select_f32 — the quantized broadcast of the best agent:
//
//      out[j, :] = flag ? codes[:] · scale : theta[j, :]
//
//    Replaces src/repro/kernels/netes_fused_mixing.py:192
//    `fused_broadcast_select` (body `_broadcast_select_kernel` :182,
//    pallas_call :214). The flag and the scale are read on the device, so
//    the caller never synchronises. Bound by bytes: θ read and out written
//    once (2·N·D·4 bytes); with the flag set θ is not read at all.
//    Design: one block per (row j, 512-column tile), coalesced columns;
//    the decoded value is codes · scale, the reference's one product.
//
// C interface (bound with ctypes): each returns cudaGetLastError() after
// its launch. Launches on the caller's stream, never synchronises,
// allocates nothing.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int COLS = 4;                     // columns per thread
constexpr int TILE_D = THREADS * COLS;      // columns per block

__global__ void __launch_bounds__(THREADS)
fused_neighbor_sum_kernel(const int* __restrict__ idx,
                          const float* __restrict__ ws,
                          const int8_t* __restrict__ codes,
                          float* __restrict__ out, int k_max, int d) {
  extern __shared__ float smem[];
  float* s_ws = smem;
  int* s_idx = reinterpret_cast<int*>(smem + k_max);

  const int j = blockIdx.x;
  const int col0 = blockIdx.y * TILE_D + threadIdx.x;
  const size_t row = (size_t)j * k_max;
  for (int k = threadIdx.x; k < k_max; k += THREADS) {
    s_idx[k] = idx[row + k];
    s_ws[k] = ws[row + k];
  }
  __syncthreads();

  float acc[COLS];
#pragma unroll
  for (int c = 0; c < COLS; ++c) acc[c] = 0.f;
#pragma unroll 4
  for (int k = 0; k < k_max; ++k) {
    const float w = s_ws[k];
    const int8_t* __restrict__ src = codes + (size_t)s_idx[k] * d;
    float v[COLS];
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      const int col = col0 + c * THREADS;
      v[c] = col < d ? static_cast<float>(__ldg(src + col)) : 0.f;
    }
#pragma unroll
    for (int c = 0; c < COLS; ++c) acc[c] = fmaf(w, v[c], acc[c]);
  }

  float* __restrict__ oj = out + (size_t)j * d;
#pragma unroll
  for (int c = 0; c < COLS; ++c) {
    const int col = col0 + c * THREADS;
    if (col < d) oj[col] = acc[c];
  }
}

__global__ void __launch_bounds__(THREADS)
fused_broadcast_select_kernel(const int8_t* __restrict__ codes,
                              const float* __restrict__ scale,
                              const bool* __restrict__ flag,
                              const float* __restrict__ theta,
                              float* __restrict__ out, int d) {
  const bool take = *flag;
  const float s = *scale;
  const size_t row = (size_t)blockIdx.x * d;
  const int col0 = blockIdx.y * TILE_D + threadIdx.x;
#pragma unroll
  for (int c = 0; c < COLS; ++c) {
    const int col = col0 + c * THREADS;
    if (col < d) {
      out[row + col] = take ? static_cast<float>(codes[col]) * s
                            : theta[row + col];
    }
  }
}

}  // namespace

extern "C" int fused_neighbor_sum_f32(const void* idx, const void* ws,
                                      const void* codes, void* out, int n,
                                      int k_max, int d, void* stream) {
  const size_t smem = (size_t)k_max * (sizeof(float) + sizeof(int));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_neighbor_sum_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(n, (d + TILE_D - 1) / TILE_D);
  fused_neighbor_sum_kernel<<<grid, THREADS, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(idx), static_cast<const float*>(ws),
      static_cast<const int8_t*>(codes), static_cast<float*>(out), k_max, d);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fused_broadcast_select_f32(const void* codes,
                                          const void* scale,
                                          const void* flag, const void* theta,
                                          void* out, int n, int d,
                                          void* stream) {
  const dim3 grid(n, (d + TILE_D - 1) / TILE_D);
  fused_broadcast_select_kernel<<<grid, THREADS, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(codes), static_cast<const float*>(scale),
      static_cast<const bool*>(flag), static_cast<const float*>(theta),
      static_cast<float*>(out), d);
  return static_cast<int>(cudaGetLastError());
}

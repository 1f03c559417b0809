// Sparse NetES mixing (paper Eq. 3 over a padded neighbor list) for
// Hopper, sm_90a.
//
//   out[j, :] = Σ_k m_jk R̃θ_{i_jk} θ[i_jk, :] + σ Σ_k m_jk R̃ε_{i_jk} ε[i_jk, :]
//               − (Σ_k m_jk R̃θ_{i_jk}) θ[j, :]
//
// with i_jk = neighbor_idx[j, k] and m_jk = neighbor_mask[j, k] (the edge
// weight a_ji; 0 on padding, whose slots index row j itself, so every
// gather stays in bounds).
//
// Replaces the TPU kernel src/repro/kernels/netes_sparse_mixing.py:62
// `netes_sparse_mixing` (body `_sparse_mixing_kernel`, pallas_call at :83),
// which keeps (N, TILE_P) slabs of θ and ε resident in VMEM and loops over
// the K_max slots with row gathers from the slab.
//
// What bounds it on the H100: the row gathers. Each output row reads K_max
// rows of θ and of ε: N·K_max·P·8 bytes (≈ 4.7 GB at N = 1000, K_max ≈ 130,
// P = 4481). θ and ε together are 36 MB and fit in the 50 MB L2, so most of
// those bytes come from L2, not device memory; the compulsory device traffic
// (θ, ε read once, out written once) is only ≈ 54 MB.
//
// Design: one block per (receiver j, 512-column tile of P). The block loads
// row j's K_max indices and forms the weights m·R̃θ[idx] and σ·m·R̃ε[idx] in
// shared memory. Each thread owns 4 columns strided by the block width, so
// every gathered row segment is read coalesced; the slot loop issues the
// 8 independent loads of a slot before their FMAs. The row sum wsum_j is
// accumulated in the same loop, and the epilogue subtracts wsum_j·θ[j, p].
//
// C interface (bound with ctypes): returns cudaGetLastError() after the
// launch. Launches on the caller's stream, never synchronises, allocates
// nothing.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int THREADS = 128;
constexpr int COLS = 4;                     // columns per thread
constexpr int TILE_P = THREADS * COLS;      // columns per block

__global__ void __launch_bounds__(THREADS)
netes_sparse_mixing_kernel(const int* __restrict__ idx,
                           const float* __restrict__ mask,
                           const float* __restrict__ w_theta,
                           const float* __restrict__ w_eps,
                           const float* __restrict__ theta,
                           const float* __restrict__ eps,
                           float* __restrict__ out,
                           float sigma, int k_max, int p) {
  extern __shared__ float smem[];
  float* s_wt = smem;                                   // m·R̃θ[idx]
  float* s_we = smem + k_max;                           // σ·m·R̃ε[idx]
  int* s_idx = reinterpret_cast<int*>(smem + 2 * k_max);

  const int j = blockIdx.x;
  const int col0 = blockIdx.y * TILE_P + threadIdx.x;
  const size_t row = (size_t)j * k_max;
  for (int k = threadIdx.x; k < k_max; k += THREADS) {
    const int i = idx[row + k];
    const float m = mask[row + k];
    s_idx[k] = i;
    s_wt[k] = m * w_theta[i];
    s_we[k] = sigma * (m * w_eps[i]);
  }
  __syncthreads();

  float wsum = 0.f;
  float acc[COLS];
#pragma unroll
  for (int c = 0; c < COLS; ++c) acc[c] = 0.f;
#pragma unroll 4
  for (int k = 0; k < k_max; ++k) {
    const float wt = s_wt[k], we = s_we[k];
    wsum += wt;
    const float* __restrict__ th = theta + (size_t)s_idx[k] * p;
    const float* __restrict__ ep = eps + (size_t)s_idx[k] * p;
    float tv[COLS], ev[COLS];
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      const int col = col0 + c * THREADS;
      tv[c] = col < p ? __ldg(th + col) : 0.f;
      ev[c] = col < p ? __ldg(ep + col) : 0.f;
    }
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      acc[c] = fmaf(wt, tv[c], acc[c]);
      acc[c] = fmaf(we, ev[c], acc[c]);
    }
  }

  const float* __restrict__ thj = theta + (size_t)j * p;
  float* __restrict__ oj = out + (size_t)j * p;
#pragma unroll
  for (int c = 0; c < COLS; ++c) {
    const int col = col0 + c * THREADS;
    if (col < p) oj[col] = acc[c] - wsum * thj[col];
  }
}

}  // namespace

extern "C" int netes_sparse_mixing_f32(const void* idx, const void* mask,
                                       const void* w_theta, const void* w_eps,
                                       const void* theta, const void* eps,
                                       void* out, float sigma, int n,
                                       int k_max, int p, void* stream) {
  const size_t smem = (size_t)k_max * (2 * sizeof(float) + sizeof(int));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        netes_sparse_mixing_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(n, (p + TILE_P - 1) / TILE_P);
  netes_sparse_mixing_kernel<<<grid, THREADS, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(idx), static_cast<const float*>(mask),
      static_cast<const float*>(w_theta), static_cast<const float*>(w_eps),
      static_cast<const float*>(theta), static_cast<const float*>(eps),
      static_cast<float*>(out), sigma, k_max, p);
  return static_cast<int>(cudaGetLastError());
}

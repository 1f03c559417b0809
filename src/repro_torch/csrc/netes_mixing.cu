// Dense NetES mixing (paper Eq. 3) for Hopper, sm_90a.
//
//   out[j, :] = Σ_i a_ji R̃θ_i θ[i, :] + σ Σ_i a_ji R̃ε_i ε[i, :] − (Σ_i a_ji R̃θ_i) θ[j, :]
//
// Replaces the TPU kernel src/repro/kernels/netes_mixing.py:55 `netes_mixing`
// (body `_mixing_kernel`, pallas_call at :71). That kernel keeps the whole
// (N, N) adjacency resident in VMEM and runs two MXU matmuls per parameter
// tile. At N = 1000 the adjacency is 4 MB, far above the 227 KB of shared
// memory one block may use, so the design is not carried over.
//
// What bounds it on the H100: operations. At N = 1000, P = 4481 the two
// contractions are 2·2·N²·P ≈ 17.9 GFLOP against ≈ 58 MB of compulsory
// traffic, i.e. ≈ 0.27 ms at the 67 TFLOP/s float32 CUDA-core peak against
// ≈ 0.02 ms at 3.35 TB/s. The reference computes in float32, so the
// products stay strict f32 FMAs on the CUDA cores (no TF32 tensor cores).
//
// Design: a tiled SGEMM over the stacked source axis [θ; ε] (K = 2N). One
// block computes one BM×BN output tile (rows j, columns p) in registers,
// 8×8 per thread, and walks the source axis in BK-deep shared-memory
// stages: first the θ pass, then the ε pass. The weighted adjacency tile
// a_ji·R̃θ_i (or σ·a_ji·R̃ε_i) is formed while it is loaded, so no (N, N)
// weight matrix ever exists in device memory, and the row sum
// wsum_j = Σ_i a_ji R̃θ_i is accumulated from the same shared tile during the
// θ pass. The epilogue subtracts wsum_j·θ[j, p]. Ragged edges (N, P not
// multiples of the tile) are zero-filled on load and masked on store.
//
// C interface (bound with ctypes): returns cudaGetLastError() after the
// launch. Launches on the caller's stream, never synchronises, allocates
// nothing.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int BM = 128;     // output rows (receivers j) per block
constexpr int BN = 128;     // output columns (parameters p) per block
constexpr int BK = 8;       // source agents i per shared-memory stage
constexpr int THREADS = 256;
constexpr int APAD = 4;     // row padding of As: conflict-free transposed stores

__global__ void __launch_bounds__(THREADS)
netes_mixing_kernel(const float* __restrict__ adj,
                    const float* __restrict__ w_theta,
                    const float* __restrict__ w_eps,
                    const float* __restrict__ theta,
                    const float* __restrict__ eps,
                    float* __restrict__ out,
                    float sigma, int n, int p) {
  // As[k][r]: weighted adjacency, transposed so a thread's rows are one
  // float4 pair; Bs[k][c]: the θ or ε tile.
  __shared__ __align__(16) float As[BK][BM + APAD];
  __shared__ __align__(16) float Bs[BK][BN];
  __shared__ float wsum_s[BM];

  const int tid = threadIdx.x;
  const int tx = tid % 16;    // thread's columns: tx*4 + {0..3}, 64 + tx*4 + {0..3}
  const int ty = tid / 16;    // thread's rows:    ty*4 + {0..3}, 64 + ty*4 + {0..3}
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;

  float acc[8][8];
#pragma unroll
  for (int m = 0; m < 8; ++m) {
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[m][q] = 0.f;
  }
  float wsum = 0.f;   // threads tid < BM own row row0 + tid

  for (int pass = 0; pass < 2; ++pass) {
    const float* __restrict__ w = pass == 0 ? w_theta : w_eps;
    const float* __restrict__ src = pass == 0 ? theta : eps;
    for (int k0 = 0; k0 < n; k0 += BK) {
#pragma unroll
      for (int r = 0; r < BM * BK / THREADS; ++r) {
        const int e = tid + r * THREADS;
        const int ar = e / BK, ac = e % BK;
        const int j = row0 + ar, i = k0 + ac;
        float v = 0.f;
        if (j < n && i < n) {
          const float a = adj[(size_t)j * n + i];
          v = pass == 0 ? a * w[i] : sigma * (a * w[i]);
        }
        As[ac][ar] = v;
      }
#pragma unroll
      for (int r = 0; r < BK * BN / THREADS; ++r) {
        const int e = tid + r * THREADS;
        const int br = e / BN, bc = e % BN;
        const int i = k0 + br, c = col0 + bc;
        Bs[br][bc] = (i < n && c < p) ? src[(size_t)i * p + c] : 0.f;
      }
      __syncthreads();
      if (pass == 0 && tid < BM) {
#pragma unroll
        for (int k = 0; k < BK; ++k) wsum += As[k][tid];
      }
#pragma unroll
      for (int k = 0; k < BK; ++k) {
        const float4 a0 = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
        const float4 a1 = *reinterpret_cast<const float4*>(&As[k][64 + ty * 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
        const float4 b1 = *reinterpret_cast<const float4*>(&Bs[k][64 + tx * 4]);
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int m = 0; m < 8; ++m) {
#pragma unroll
          for (int q = 0; q < 8; ++q) acc[m][q] = fmaf(a[m], b[q], acc[m][q]);
        }
      }
      __syncthreads();
    }
  }

  if (tid < BM) wsum_s[tid] = wsum;
  __syncthreads();
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const int lr = (m < 4 ? 0 : 64) + ty * 4 + (m & 3);
    const int j = row0 + lr;
    if (j >= n) continue;
    const float ws = wsum_s[lr];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int c = col0 + (q < 4 ? 0 : 64) + tx * 4 + (q & 3);
      if (c < p) {
        const size_t o = (size_t)j * p + c;
        out[o] = acc[m][q] - ws * theta[o];
      }
    }
  }
}

}  // namespace

extern "C" int netes_mixing_f32(const void* adj, const void* w_theta,
                                const void* w_eps, const void* theta,
                                const void* eps, void* out, float sigma,
                                int n, int p, void* stream) {
  const dim3 grid((p + BN - 1) / BN, (n + BM - 1) / BM);
  netes_mixing_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(adj), static_cast<const float*>(w_theta),
      static_cast<const float*>(w_eps), static_cast<const float*>(theta),
      static_cast<const float*>(eps), static_cast<float*>(out), sigma, n, p);
  return static_cast<int>(cudaGetLastError());
}

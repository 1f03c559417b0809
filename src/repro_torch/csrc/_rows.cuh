// The receiver ≠ sender (R × S) instances of the two sparse Eq. 3 kernels
// for Hopper, sm_90a: sparse_mixing_rs in csrc/netes_sparse_mixing.cu and
// fused_neighbor_sum_rs in csrc/netes_fused_mixing.cu. They are the
// per-shard contraction of the sharded NetES fleet
// (distributed/fleet_shard.py): R receivers, whose own θ_j the correction
// term reads, against S sender rows of the exchanged payload (a shard's
// slab and its halo, or all N senders after a gather):
//
//   out[j, :] = Σ_k w_jk · x[i_jk, :] − (Σ_k w_jk) · θ[j, :],
//   w_jk = m_jk · w[i_jk],   i_jk = idx[j, k] in [0, S),
//
// in slot order k = 0, 1, .., each weight, product and sum rounded on its
// own (__fmul_rn, __fadd_rn: no FMA contraction), as the plain versions
// (kernels/ref.py: slot_contract) compute it. A row's bits then depend on
// its own slots alone: not on R, S, the buffer's layout or which shard
// holds the row, so a sharded fleet's trajectory is the same for every
// shard count (DESIGN.md §13), and equal to the plain version's.
//
// Design: a block of THREADS threads per (receiver j, TILE columns), each
// thread COLS columns THREADS apart (coalesced rows of x); UNROLL slots'
// loads are issued before their adds. A slot of weight 0 adds nothing (its
// term is 0·x = ±0 for a finite payload, and the sum is never −0) and is
// skipped; its weight still enters the row sum, as in the plain version.
// The senders are read from L2 or device memory once per receiver that
// lists them: R·nnz_j·D elements a call, against the slab kernels' one
// shared-memory read per slot (the cost of a row order that is free of
// the chunk layout; PERF.md §6 rows 2–3).
//
// A payload policy `Src` provides `float factor(i)` (a sender's decode
// scale, read once per slot) and `float value(i, col, factor)` (the
// sender's decoded payload at a column).

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace rows {

constexpr int THREADS = 256;
constexpr int COLS = 4;                  // columns per thread
constexpr int TILE = THREADS * COLS;     // columns per block
constexpr int UNROLL = 4;                // slots whose loads go out together

template <class Src>
__device__ __forceinline__ void slot_rows(const Src& src,
                                          const int* __restrict__ idx,
                                          const float* __restrict__ mask,
                                          const float* __restrict__ w,
                                          const float* __restrict__ theta,
                                          float* __restrict__ out, int k_max,
                                          int cols) {
  const size_t j = blockIdx.x;
  const int col0 = blockIdx.y * TILE + threadIdx.x;
  const int* ij = idx + j * k_max;
  const float* mj = mask + j * k_max;
  float acc[COLS];
#pragma unroll
  for (int c = 0; c < COLS; ++c) acc[c] = 0.f;
  float ws = 0.f;
  for (int k0 = 0; k0 < k_max; k0 += UNROLL) {
    int i[UNROLL];
    float wk[UNROLL], f[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int k = k0 + u;
      i[u] = k < k_max ? __ldg(ij + k) : 0;
      wk[u] = k < k_max ? __fmul_rn(__ldg(mj + k), __ldg(w + i[u])) : 0.f;
      f[u] = src.factor(i[u]);
    }
    float v[UNROLL][COLS];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
#pragma unroll
      for (int c = 0; c < COLS; ++c) {
        const int col = col0 + c * THREADS;
        v[u][c] = wk[u] != 0.f && col < cols ? src.value(i[u], col, f[u])
                                              : 0.f;
      }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (k0 + u >= k_max) break;
      ws = __fadd_rn(ws, wk[u]);
      if (wk[u] != 0.f) {
#pragma unroll
        for (int c = 0; c < COLS; ++c)
          acc[c] = __fadd_rn(acc[c], __fmul_rn(wk[u], v[u][c]));
      }
    }
  }
#pragma unroll
  for (int c = 0; c < COLS; ++c) {
    const int col = col0 + c * THREADS;
    if (col < cols) {
      const size_t o = j * cols + col;
      out[o] = __fsub_rn(acc[c], __fmul_rn(ws, __ldg(theta + o)));
    }
  }
}

// the grid of R receivers by ⌈cols/TILE⌉ column tiles
inline dim3 grid(int r, int cols) {
  return dim3(r, (cols + TILE - 1) / TILE);
}

inline bool shape_ok(int r, int s, int k_max, int cols) {
  return r > 0 && s > 0 && k_max > 0 && cols > 0 &&
         (cols + TILE - 1) / TILE <= 65535;
}

}  // namespace rows

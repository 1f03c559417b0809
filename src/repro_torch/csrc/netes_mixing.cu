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
// What bounds it on the H100: operations. The map is one (N × 2N)·(2N × P)
// product plus a rank-1 epilogue: 2·2·N²·P ≈ 17.9 GFLOP at N = 1000,
// P = 4481 against ≈ 58 MB of compulsory traffic, i.e. ≈ 0.27 ms at the
// 67 TFLOP/s float32 CUDA-core peak against ≈ 0.02 ms at 3.35 TB/s. The
// reference computes in float32, so the products stay strict f32 FMAs on
// the CUDA cores (no TF32 tensor cores).
//
// The first design of this kernel took 1.154–1.168 ms there (NVIDIA H100
// 80GB HBM3, 700 W; `torch.matmul` of the same product 0.455–0.462 ms): its 288
// tiles of 128 × 128 ran in two rounds on 264 resident slots, every BK = 8
// stage waited for its global loads, and the adjacency was loaded scalar,
// strided and re-weighted in each of the 36 column blocks. This design:
//
// 1. `mixing_weights` builds the K-major operand once per call,
//    Wt[i][j] = a_ji·R̃θ_i and Wt[kh + i][j] = σ·(a_ji·R̃ε_i) (each half
//    padded to kh = ⌈N/16⌉·16 rows, columns to npad = ⌈N/128⌉·128, zeros in
//    the padding), so that Wt's rows start on 16-byte boundaries; other
//    blocks of the same launch sum wsum_j = Σ_i a_ji·R̃θ_i, a warp per row,
//    in a fixed order.
// 2. `mixing_gemm`: a 128 × 128 output tile per block of 256 threads,
//    8 × 8 per thread, over the K = 2·kh source axis in BK = 16 stages,
//    three stages in flight: 16-byte cp.async for Wt, 4-byte cp.async for
//    θ and ε (P is odd, so their rows are not 16-byte aligned), neighbouring
//    threads on neighbouring p, each thread walking one column down the
//    stage with one predicate for the whole stage where no row of it lies
//    past N. The grid fills the card: the tiles that make whole waves of
//    resident blocks run whole; the tiles of the last, partial wave are
//    each split along K into `split` pieces, so that the last wave too
//    occupies (nearly) every slot (the plan is made by the wrapper from
//    this library's occupancy query). A whole tile's epilogue subtracts
//    wsum_j·θ[j, p] and stores through shared memory, coalesced.
// 3. `mixing_fixup` sums a split tile's partial slabs in piece order and
//    applies the same epilogue.
// Kernels 2 and 3 are launched as programmatic dependents of the kernel
// before them: their blocks are scheduled while it finishes and wait for
// it (griddepcontrol.wait) before they read what it wrote.
// No atomics: two launches on the same inputs give the same bits.
//
// This design took 0.470–0.471 ms there (57% of the bound; `torch.matmul`,
// a cuBLAS CUDA-core FFMA kernel with W built outside the call, 0.462 ms)
// and 3.92 ms at N = 3000 (61%; `torch.matmul` 3.47 ms) on the same card
// (`chip_smoke.py`; PERF.md §6, row 1).
//
// The receiver ≠ sender instance `netes_mixing_rs_f32` (R receivers over
// S senders of a payload, the sharded fleet's per-shard contraction) is a
// plain tiled kernel of its own; see its note below.
//
// C interface (bound with ctypes): `netes_mixing_f32` launches the three
// kernels and returns cudaGetLastError(); `netes_mixing_occupancy` reports
// the resident blocks per SM of `mixing_gemm` and the SM count. Launches
// on the caller's stream, never synchronises, allocates nothing (the
// wrapper passes the scratch).

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int BM = 128;      // output rows (receivers j) per tile
constexpr int BN = 128;      // output columns (parameters p) per tile
constexpr int BK = 16;       // source rows per shared-memory stage
constexpr int STAGES = 3;
constexpr int TN = 8;                     // output columns per GEMM thread
constexpr int GT = (BM / 8) * (BN / TN);  // GEMM threads: 8 rows × TN columns each
constexpr int CG = TN / 4;                // a thread's float4 column groups
constexpr int CSTRIDE = BN / CG;          // and their stride
constexpr int THREADS = 256;              // threads of the two small kernels
constexpr int WCHUNK = 64;   // source rows per block of mixing_weights
constexpr int A_STAGE = BK * BM;
constexpr int B_STAGE = BK * BN;
constexpr int EPI_FLOATS = 64 * BN + BM;  // the epilogue's staging and row sums
constexpr size_t GEMM_SMEM =
    sizeof(float) * (STAGES * (A_STAGE + B_STAGE) > EPI_FLOATS
                         ? STAGES * (A_STAGE + B_STAGE) : EPI_FLOATS);
static_assert(GT % BN == 0 && A_STAGE % (4 * GT) == 0, "load mapping");

struct Plan {
  int n, p;
  int kh;          // rows of each half of Wt: ⌈n / BK⌉·BK
  int npad;        // columns of Wt: row_tiles·BM
  int row_tiles;   // ⌈n / BM⌉
  int k_tiles;     // 2·kh / BK
  int w_chunks;    // ⌈kh / WCHUNK⌉
  int full;        // tiles computed whole, blocks [0, full)
  int split;       // pieces of each remaining tile
  int rem;         // remaining tiles, blocks [full, full + rem·split)
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
               "l"(src));
}

// 4 bytes, or 4 zero bytes when !valid (src-size 0 reads nothing)
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING));
}

// Blocks (32 columns j, WCHUNK rows i) of 32 × 8 threads write Wt's two
// halves for those rows and columns. The last WSUM_ROWS rows of blocks
// (blockIdx.y ≥ w_chunks) sum wsum_j = Σ_i a_ji·R̃θ_i instead, a warp per
// row j, in a fixed order: lane l adds i ≡ l (mod 32) in four interleaved
// partial sums, which are added in order, then the lanes by a butterfly.
constexpr int WSUM_ROWS = 32 / (THREADS / 32);

__global__ void __launch_bounds__(THREADS)
mixing_weights(const float* __restrict__ adj, const float* __restrict__ w_theta,
               const float* __restrict__ w_eps, float* __restrict__ wt,
               float* __restrict__ wsum, float sigma, int n, int kh, int npad,
               int w_chunks) {
  __shared__ float tile[32][WCHUNK + 1];
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const int j0 = blockIdx.x * 32;
  asm volatile("griddepcontrol.launch_dependents;");  // mixing_gemm may be scheduled
  if ((int)blockIdx.y >= w_chunks) {
    const int j = j0 + ((int)blockIdx.y - w_chunks) * (THREADS / 32) + ty;
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    if (j < n) {
      const float* row = adj + (size_t)j * n;
      int i = tx;
      for (; i + 96 < n; i += 128) {
#pragma unroll
        for (int u = 0; u < 4; ++u) s[u] += row[i + 32 * u] * w_theta[i + 32 * u];
      }
      if (i < n) s[0] += row[i] * w_theta[i];
      if (i + 32 < n) s[1] += row[i + 32] * w_theta[i + 32];
      if (i + 64 < n) s[2] += row[i + 64] * w_theta[i + 64];
    }
    float t = (s[0] + s[1]) + (s[2] + s[3]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) t += __shfl_xor_sync(0xffffffffu, t, off);
    if (tx == 0) wsum[j] = t;
    return;
  }
  const int i0 = blockIdx.y * WCHUNK;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int jj = ty + 8 * r, j = j0 + jj;
#pragma unroll
    for (int c = 0; c < WCHUNK / 32; ++c) {
      const int i = i0 + tx + 32 * c;
      tile[jj][tx + 32 * c] = (j < n && i < n) ? adj[(size_t)j * n + i] : 0.f;
    }
  }
  __syncthreads();
  const int j = j0 + tx;
#pragma unroll
  for (int ii = ty; ii < WCHUNK; ii += 8) {
    const int i = i0 + ii;
    if (i >= kh) break;
    const float a = tile[tx][ii];
    wt[(size_t)i * npad + j] = i < n ? a * w_theta[i] : 0.f;
    wt[(size_t)(kh + i) * npad + j] = i < n ? sigma * (a * w_eps[i]) : 0.f;
  }
}

__global__ void __launch_bounds__(GT, 2)
mixing_gemm(const float* __restrict__ wt, const float* __restrict__ wsum,
            const float* __restrict__ theta, const float* __restrict__ eps,
            float* __restrict__ out, float* __restrict__ partial, Plan pl) {
  extern __shared__ float4 smem4[];
  float* as_all = reinterpret_cast<float*>(smem4);
  float* bs_all = as_all + STAGES * A_STAGE;

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);  // columns g·CSTRIDE + tx·4 + {0..3}, g < CG
  const int ty = tid / (BN / TN);  // rows ty·4 + {0..3}, 64 + ty·4 + {0..3}

  // which tile, and which stretch of the K axis
  int tile, kt0, kt1, slab = -1;
  if ((int)blockIdx.x < pl.full) {
    tile = blockIdx.x;
    kt0 = 0;
    kt1 = pl.k_tiles;
  } else {
    slab = blockIdx.x - pl.full;
    const int piece = slab % pl.split;
    tile = pl.full + slab / pl.split;
    kt0 = piece * pl.k_tiles / pl.split;
    kt1 = (piece + 1) * pl.k_tiles / pl.split;
  }
  const int row0 = (tile % pl.row_tiles) * BM;
  const int col0 = (tile / pl.row_tiles) * BN;
  const int n = pl.n, p = pl.p, kh = pl.kh, npad = pl.npad;
  const int cb = tid % BN;          // this thread's column of the θ/ε tiles
  const bool col_ok = col0 + cb < p;

  auto load_stage = [&](int kt, int stage) {
    float* as = as_all + stage * A_STAGE;
    float* bs = bs_all + stage * B_STAGE;
    const float* a_src = wt + (size_t)kt * BK * npad + row0;
#pragma unroll
    for (int it = 0; it < A_STAGE / 4 / GT; ++it) {
      const int f = tid + it * GT;
      const int k = f / (BM / 4), m4 = f % (BM / 4);
      cp_async16(as + k * BM + 4 * m4, a_src + (size_t)k * npad + 4 * m4);
    }
    const bool second = kt * BK >= kh;
    const int ib = kt * BK - (second ? kh : 0);
    const float* b_src =
        (second ? eps : theta) + (size_t)(ib + tid / BN) * p + col0 + cb;
    const size_t step = (size_t)(GT / BN) * p;
    if (ib + BK <= n) {
#pragma unroll
      for (int it = 0; it < B_STAGE / GT; ++it) {
        const int k = it * (GT / BN) + tid / BN;
        cp_async4(bs + k * BN + cb, col_ok ? b_src : theta, col_ok);
        b_src += step;
      }
    } else {
#pragma unroll
      for (int it = 0; it < B_STAGE / GT; ++it) {
        const int k = it * (GT / BN) + tid / BN;
        const bool valid = col_ok && ib + k < n;
        cp_async4(bs + k * BN + cb, valid ? b_src : theta, valid);
        b_src += step;
      }
    }
  };

  asm volatile("griddepcontrol.wait;" ::: "memory");  // Wt and wsum are written
  asm volatile("griddepcontrol.launch_dependents;");  // mixing_fixup may be scheduled
  float acc[8][TN];
#pragma unroll
  for (int m = 0; m < 8; ++m)
#pragma unroll
    for (int q = 0; q < TN; ++q) acc[m][q] = 0.f;

  const int nk = kt1 - kt0;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_stage(kt0 + s, s);
    cp_async_commit();
  }
  for (int t = 0; t < nk; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();   // stage t visible; everyone is done with stage t − 1
    const int nt = t + STAGES - 1;
    if (nt < nk) load_stage(kt0 + nt, nt % STAGES);
    cp_async_commit();
    const float* as = as_all + (t % STAGES) * A_STAGE;
    const float* bs = bs_all + (t % STAGES) * B_STAGE;
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(as + k * BM + ty * 4);
      const float4 a1 = *reinterpret_cast<const float4*>(as + k * BM + 64 + ty * 4);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      float b[TN];
#pragma unroll
      for (int g = 0; g < CG; ++g) {
        const float4 bg =
            *reinterpret_cast<const float4*>(bs + k * BN + g * CSTRIDE + tx * 4);
        b[4 * g] = bg.x;
        b[4 * g + 1] = bg.y;
        b[4 * g + 2] = bg.z;
        b[4 * g + 3] = bg.w;
      }
#pragma unroll
      for (int m = 0; m < 8; ++m)
#pragma unroll
        for (int q = 0; q < TN; ++q) acc[m][q] = fmaf(a[m], b[q], acc[m][q]);
    }
  }
  cp_async_wait<0>();

  if (slab >= 0) {
    // a piece of a split tile: its partial slab, summed by mixing_fixup
    float* dst = partial + (size_t)slab * BM * BN;
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      const int lr = (m < 4 ? 0 : 64) + ty * 4 + (m & 3);
#pragma unroll
      for (int g = 0; g < CG; ++g)
        *reinterpret_cast<float4*>(dst + lr * BN + g * CSTRIDE + tx * 4) =
            make_float4(acc[m][4 * g], acc[m][4 * g + 1], acc[m][4 * g + 2],
                        acc[m][4 * g + 3]);
    }
    return;
  }

  // epilogue of a whole tile, 64 rows at a time through shared memory:
  // out[j, c] = acc − wsum_j·θ[j, c], coalesced along c
  float* stage = as_all;          // 64 × BN floats, the pipeline is drained
  float* ws = stage + 64 * BN;    // wsum of the tile's BM rows
  __syncthreads();
  for (int r = tid; r < BM; r += GT) ws[r] = row0 + r < n ? wsum[row0 + r] : 0.f;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
#pragma unroll
    for (int mm = 0; mm < 4; ++mm) {
      const int m = half * 4 + mm;
      float* srow = stage + (ty * 4 + mm) * BN;
#pragma unroll
      for (int g = 0; g < CG; ++g)
        *reinterpret_cast<float4*>(srow + g * CSTRIDE + tx * 4) =
            make_float4(acc[m][4 * g], acc[m][4 * g + 1], acc[m][4 * g + 2],
                        acc[m][4 * g + 3]);
    }
    __syncthreads();
#pragma unroll 4
    for (int e = tid; e < 64 * BN; e += GT) {
      const int r = e / BN, c = e % BN;
      const int lr = half * 64 + r, j = row0 + lr, col = col0 + c;
      if (j < n && col < p) {
        const size_t o = (size_t)j * p + col;
        out[o] = stage[e] - ws[lr] * theta[o];
      }
    }
    __syncthreads();
  }
}

// One thread per element of the split tiles: the pieces' partial slabs
// summed in piece order, then the epilogue.
__global__ void __launch_bounds__(THREADS)
mixing_fixup(const float* __restrict__ partial, const float* __restrict__ wsum,
             const float* __restrict__ theta, float* __restrict__ out, Plan pl) {
  asm volatile("griddepcontrol.wait;" ::: "memory");  // the slabs are written
  const int e = blockIdx.x * THREADS + threadIdx.x;
  const int r = e / (BM * BN), within = e % (BM * BN);
  const int tile = pl.full + r;
  const int j = (tile % pl.row_tiles) * BM + within / BN;
  const int col = (tile / pl.row_tiles) * BN + within % BN;
  if (r >= pl.rem || j >= pl.n || col >= pl.p) return;
  const float* src = partial + (size_t)r * pl.split * BM * BN + within;
  float s = 0.f;
  for (int q = 0; q < pl.split; ++q) s += src[(size_t)q * BM * BN];
  const size_t o = (size_t)j * pl.p + col;
  out[o] = s - wsum[j] * theta[o];
}

// ---- the receiver ≠ sender (R × S) instance ----
//
// out[j, :] = Σ_s (a_js·w_s)·x[s, :] − (Σ_s a_js·w_s)·θ[j, :] for R
// receivers over S senders, the sharded fleet's per-shard contraction
// (distributed/fleet_shard.py): a row block of the adjacency against all
// S senders' payload x, with the receivers' own θ in the correction.
// The sum runs over s = 0, 1, .., S − 1 in order for every row, each
// weight, product and sum rounded on its own (__fmul_rn, __fadd_rn), as
// the plain version (kernels/ref.py: dense_contract) computes it. K is not
// split: a row's bits depend on its own adjacency row and the senders
// alone, not on R or on the tile that holds it, so the sharded trajectory
// is the same for every shard count (DESIGN.md §13).
//
// A 64 × 64 output tile per block of 256 threads, 4 × 4 a thread (rows
// ty + 16·a, columns tx + 16·b), over S in stages of 16 senders through
// shared memory; the weighted adjacency a_js·w_s is formed as the stage is
// loaded. Separate multiply and add run at half the FMA rate: the cost of
// the rounding the plain version fixes (PERF.md §6 row 1).

constexpr int RS_BM = 64, RS_BN = 64, RS_BK = 16, RS_THREADS = 256;

__global__ void __launch_bounds__(RS_THREADS)
mixing_rs(const float* __restrict__ adj, const float* __restrict__ w,
          const float* __restrict__ x, const float* __restrict__ theta,
          float* __restrict__ out, int r, int s, int p) {
  __shared__ float sa[RS_BK][RS_BM + 1];   // a_js·w_s, sender-major
  __shared__ float sx[RS_BK][RS_BN];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int row0 = blockIdx.y * RS_BM, col0 = blockIdx.x * RS_BN;
  float acc[4][4], ws[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    ws[a] = 0.f;
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
  }
  for (int k0 = 0; k0 < s; k0 += RS_BK) {
    for (int e = threadIdx.x; e < RS_BM * RS_BK; e += RS_THREADS) {
      const int rr = e / RS_BK, kk = e % RS_BK;
      const int gr = row0 + rr, gk = k0 + kk;
      sa[kk][rr] = gr < r && gk < s
                       ? __fmul_rn(__ldg(adj + (size_t)gr * s + gk),
                                   __ldg(w + gk))
                       : 0.f;
    }
    for (int e = threadIdx.x; e < RS_BK * RS_BN; e += RS_THREADS) {
      const int kk = e / RS_BN, cc = e % RS_BN;
      const int gk = k0 + kk, gc = col0 + cc;
      sx[kk][cc] = gk < s && gc < p ? __ldg(x + (size_t)gk * p + gc) : 0.f;
    }
    __syncthreads();
    // senders past S hold weight 0 and payload 0: their terms add +0
    const int kn = min(RS_BK, s - k0);
    for (int kk = 0; kk < kn; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) av[a] = sa[kk][ty + 16 * a];
#pragma unroll
      for (int b = 0; b < 4; ++b) bv[b] = sx[kk][tx + 16 * b];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        ws[a] = __fadd_rn(ws[a], av[a]);
#pragma unroll
        for (int b = 0; b < 4; ++b)
          acc[a][b] = __fadd_rn(acc[a][b], __fmul_rn(av[a], bv[b]));
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int gr = row0 + ty + 16 * a;
    if (gr >= r) continue;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int gc = col0 + tx + 16 * b;
      if (gc < p) {
        const size_t o = (size_t)gr * p + gc;
        out[o] = __fsub_rn(acc[a][b], __fmul_rn(ws[a], __ldg(theta + o)));
      }
    }
  }
}

bool plan_is_consistent(const Plan& pl) {
  const int col_tiles = (pl.p + BN - 1) / BN;
  return pl.n > 0 && pl.p > 0 && pl.kh == (pl.n + BK - 1) / BK * BK &&
         pl.row_tiles == (pl.n + BM - 1) / BM && pl.npad == pl.row_tiles * BM &&
         pl.k_tiles == 2 * pl.kh / BK &&
         pl.w_chunks == (pl.kh + WCHUNK - 1) / WCHUNK && pl.split >= 1 &&
         pl.rem >= 0 && pl.full >= 0 &&
         pl.full + pl.rem == pl.row_tiles * col_tiles &&
         (pl.rem == 0 || (pl.split > 1 && pl.split <= pl.k_tiles));
}

}  // namespace

extern "C" int netes_mixing_occupancy(int* resident_per_sm, int* sm_count) {
  cudaError_t err = cudaFuncSetAttribute(
      mixing_gemm, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)GEMM_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(resident_per_sm, mixing_gemm,
                                                      GT, GEMM_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      cudaDeviceGetAttribute(sm_count, cudaDevAttrMultiProcessorCount, dev));
}

// scratch: Wt (2·kh × npad), then wsum (npad), then rem·split partial
// slabs of BM × BN; all float32.
extern "C" int netes_mixing_f32(const void* adj, const void* w_theta,
                                const void* w_eps, const void* theta,
                                const void* eps, void* out, void* scratch,
                                float sigma, int n, int p, int kh, int npad,
                                int row_tiles, int k_tiles, int w_chunks,
                                int full, int split, int rem, void* stream) {
  const Plan pl{n, p, kh, npad, row_tiles, k_tiles, w_chunks, full, split, rem};
  if (!plan_is_consistent(pl)) return static_cast<int>(cudaErrorInvalidValue);
  auto* st = static_cast<cudaStream_t>(stream);
  float* wt = static_cast<float*>(scratch);
  float* wsum = wt + (size_t)2 * kh * npad;
  float* partial = wsum + npad;
  mixing_weights<<<dim3(npad / 32, w_chunks + WSUM_ROWS), THREADS, 0, st>>>(
      static_cast<const float*>(adj), static_cast<const float*>(w_theta),
      static_cast<const float*>(w_eps), wt, wsum, sigma, n, kh, npad, w_chunks);
  cudaError_t err = cudaFuncSetAttribute(
      mixing_gemm, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)GEMM_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  // kernels 2 and 3: programmatic dependent launches (see the note at the top)
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(full + rem * split);
  cfg.blockDim = dim3(GT);
  cfg.dynamicSmemBytes = GEMM_SMEM;
  cfg.stream = st;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, mixing_gemm, (const float*)wt, (const float*)wsum,
                           static_cast<const float*>(theta), static_cast<const float*>(eps),
                           static_cast<float*>(out), partial, pl);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rem > 0) {
    cfg.gridDim = dim3(rem * (BM * BN / THREADS));
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = 0;
    err = cudaLaunchKernelEx(&cfg, mixing_fixup, (const float*)partial, (const float*)wsum,
                             static_cast<const float*>(theta), static_cast<float*>(out), pl);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

// R receivers over S senders: adj (R, S), w (S,), x (S, p), theta and out
// (R, p); all float32, row-major.
extern "C" int netes_mixing_rs_f32(const void* adj, const void* w,
                                   const void* x, const void* theta,
                                   void* out, int r, int s, int p,
                                   void* stream) {
  if (r < 1 || s < 1 || p < 1 || (r + RS_BM - 1) / RS_BM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((p + RS_BN - 1) / RS_BN, (r + RS_BM - 1) / RS_BM);
  mixing_rs<<<grid, RS_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(adj), static_cast<const float*>(w),
      static_cast<const float*>(x), static_cast<const float*>(theta),
      static_cast<float*>(out), r, s, p);
  return static_cast<int>(cudaGetLastError());
}

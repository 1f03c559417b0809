// Fused wire-form kernels of a quantizing channel (DESIGN.md §12) for
// Hopper, sm_90a. Two entry points:
//
// 1. fused_neighbor_sum_f32 — Eq. 3's neighbor contraction straight from the
//    int8 wire codes:
//
//      out[j, :] = Σ_k ws[j, k] · codes[idx[j, k], :],
//      ws[j, k]  = ((m[j, k] · coeff[i]) · em[j, k]) · scale[i],  i = idx[j, k]
//
//    The slot weights are folded inside the kernel, each product rounded
//    on its own (__fmul_rn) in the reference's order, so they equal
//    kernels/ref.py:folded_weights bit for bit (without an edge mask:
//    (m · coeff[i]) · scale[i]). One launch per call; the decoded float32
//    payload and the (N, K, D) gather never exist.
//
//    Replaces the TPU kernel src/repro/kernels/netes_fused_mixing.py:112
//    `fused_neighbor_sum` (body `_fused_neighbor_sum_kernel` :91,
//    pallas_call :163), which keeps the whole (N, 512) int8 slab and the
//    (N, K) weights in VMEM and loops over the K_max slots with row gathers.
//
//    Design: the two-phase slab design of csrc/netes_sparse_mixing.cu (see
//    its note for the work split, chunks, lists, ring, gather steps and
//    the fixed-order epilogue; the code is csrc/_slab.cuh), on codes. Phase 1 folds each slot's weight
//    once per call and lists the slots whose weight is not 0 (padding and
//    dropped links go: their term is 0·code = ±0 exactly, codes being
//    finite, so the sum is unchanged; a NaN weight is kept). Phase 2 holds
//    64 columns of the senders' codes in shared memory, 128 bytes a sender,
//    as bf16: each code is converted once while the slab is staged (I2F,
//    then the upper 16 bits, exact for any int8: at most 8 significant
//    bits), N·64 conversions per slab instead of one per gathered code
//    (I2F runs at 16 a clock per SM: one per gathered code, ≈ 4·10⁸ a
//    call, would cost ≈ 95 µs). In the gather, the bf16 pair of a 32-bit
//    word widens to two floats with one shift and one mask (bf16 is the
//    top half of a float32), at the ALU's full rate: a 16-byte shared load
//    gives 8 codes, 8 FMAs. The first design (one block per receiver and
//    512 columns, int8 gathers from L2, weights folded by the wrapper in
//    four launches) took 0.255–0.260 ms at N = 1000, K_max = 130, D = 4481
//    on an NVIDIA H100 80GB HBM3 (700 W), level with torch.sparse.mm; its
//    warp loads gave 32 bytes each.
//
//    What bounds it on the H100: the operations are 2·nnz·D flops (0.8
//    GFLOP after dropout, 0.012 ms at 67 TFLOP/s); the compulsory bytes
//    (codes once, out once) take 7 µs. This design reads shared memory
//    once per 8 FMAs' worth of 2-byte codes: nnz·D·2 ≈ 0.8 GB at 90% of
//    links kept, ≈ 25 µs at 128 bytes a clock per SM, and issues one
//    widening per FMA. Beside them: the stagings, 64 KB of codes a slab,
//    and the walk of 71 slabs × 1000 receivers.
//
// 1b. fused_neighbor_sum_rs_f32 — the receiver ≠ sender instance for the
//    sharded fleet (R receivers over S senders in wire form, with the
//    Eq. 3 correction −(Σ_k w_jk)·θ_j): the payload decoded code · scale
//    per slot, then the plain slot loop of csrc/_rows.cuh (see its note).
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
// C interface (bound with ctypes): `fused_neighbor_sum_f32` makes the
// cooperative launch and returns its cudaError_t; `fused_broadcast_select_f32`
// returns cudaGetLastError() after its launch; `fused_neighbor_sum_occupancy`
// reports resident blocks per SM at a given shared memory, the SM count,
// registers and local (spill) bytes per thread. Launches on the caller's
// stream, never synchronises, allocates nothing (the wrapper passes the
// scratch).

#include "_rows.cuh"
#include "_slab.cuh"

namespace {

// ---- fused_neighbor_sum: the operands for csrc/_slab.cuh ----

__device__ __forceinline__ unsigned bf16_bits(int8_t v) {
  return __float_as_uint(static_cast<float>(v)) >> 16;
}
__device__ __forceinline__ float lo_half(unsigned w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float hi_half(unsigned w) {
  return __uint_as_float(w & 0xffff0000u);
}

// Slab rows of 64 columns of codes as bf16; the listed weight of a slot is
// its folded weight, and a slot of weight 0 is not listed (padding and
// dropped links: their term is 0·code = ±0 exactly, codes being finite;
// a NaN weight is kept).
struct NeighborSum {
  static constexpr int ACC = 8;
  struct Raw {
    float m, em;
  };
  const float* mask;
  const float* coeff;
  const float* edge_mask;    // may be null: no channel mask
  const float* scale;
  const int8_t* codes;
  int d;

  __device__ __forceinline__ Raw load(size_t at, bool ok) const {
    return {ok ? __ldg(mask + at) : 0.f,
            ok && edge_mask != nullptr ? __ldg(edge_mask + at) : 1.f};
  }
  __device__ __forceinline__ void list_begin() {}
  // ((m · coeff[i]) · em) · scale[i], each product rounded alone
  __device__ __forceinline__ bool weigh(Raw r, int i, int, float& w) const {
    w = __fmul_rn(r.m, __ldg(coeff + i));
    if (edge_mask != nullptr) w = __fmul_rn(w, r.em);
    w = __fmul_rn(w, __ldg(scale + i));
    return w != 0.f;
  }
  __device__ __forceinline__ void list_end(int, int) const {}

  // codes[c0 .. c1) of columns [col0, col0 + 64) as bf16 pairs: word w of
  // a row holds column col0 + 2w in its low half, col0 + 2w + 1 in its
  // high half; each lane one word of STAGE_ROWS rows at a time (32 loads
  // in flight). Columns past D hold 0.
  __device__ __forceinline__ void stage(int col0, int c0, int c1,
                                        unsigned char* slab_rows, int warp,
                                        int lane) const {
    using slab::STAGE_ROWS;
    using slab::WARPS;
    unsigned* s_y = reinterpret_cast<unsigned*>(slab_rows);
    const int col = col0 + 2 * lane;
    const bool ok_lo = col < d, ok_hi = col + 1 < d;
    for (int r = c0 + warp; r < c1; r += WARPS * STAGE_ROWS) {
      int8_t lo[STAGE_ROWS], hi[STAGE_ROWS];
#pragma unroll
      for (int t = 0; t < STAGE_ROWS; ++t) {
        const int row = r + t * WARPS;
        const int8_t* src = codes + (size_t)row * d + col;
        lo[t] = row < c1 && ok_lo ? __ldg(src) : int8_t(0);
        hi[t] = row < c1 && ok_hi ? __ldg(src + 1) : int8_t(0);
      }
#pragma unroll
      for (int t = 0; t < STAGE_ROWS; ++t) {
        const int row = r + t * WARPS;
        if (row < c1)
          s_y[(size_t)(row - c0) * (slab::ROW_BYTES / 4) + lane] =
              (bf16_bits(hi[t]) << 16) | bf16_bits(lo[t]);
      }
    }
  }

  // 8 codes of a 16-byte word: a bf16 widens to a float by a shift or a
  // mask (bf16 is the top half of a float32), at the ALU's full rate
  __device__ __forceinline__ static void fma(float (&acc)[ACC], float w,
                                             uint4 y) {
    acc[0] = fmaf(w, lo_half(y.x), acc[0]);
    acc[1] = fmaf(w, hi_half(y.x), acc[1]);
    acc[2] = fmaf(w, lo_half(y.y), acc[2]);
    acc[3] = fmaf(w, hi_half(y.y), acc[3]);
    acc[4] = fmaf(w, lo_half(y.z), acc[4]);
    acc[5] = fmaf(w, hi_half(y.z), acc[5]);
    acc[6] = fmaf(w, lo_half(y.w), acc[6]);
    acc[7] = fmaf(w, hi_half(y.w), acc[7]);
  }
  __device__ __forceinline__ void fetch(int, int, int) const {}
  __device__ __forceinline__ float finish(float v, int) const { return v; }
};

__global__ void __launch_bounds__(slab::THREADS, 1)
fused_neighbor_sum_slab(const int* __restrict__ idx,
                        const float* __restrict__ mask,
                        const float* __restrict__ coeff,
                        const float* __restrict__ edge_mask,
                        const int8_t* __restrict__ codes,
                        const float* __restrict__ scale,
                        float* __restrict__ out, uint2* __restrict__ lists,
                        int* __restrict__ lens, int n, int k_max, int d,
                        int chunk_rows, int chunks) {
  extern __shared__ __align__(16) unsigned char smem[];
  NeighborSum op{mask, coeff, edge_mask, scale, codes, d};
  slab::run(op, smem, idx, out, lists, lens, n, k_max, d, chunk_rows, chunks);
}

// ---- the R × S instance of the neighbor sum (csrc/_rows.cuh) ----

// a sender's payload decoded from its codes: code · scale, the one decode
// of core/wire_format.decode
struct CodeRows {
  const int8_t* codes;
  const float* scale;
  int cols;
  __device__ __forceinline__ float factor(int i) const {
    return __ldg(scale + i);
  }
  __device__ __forceinline__ float value(int i, int col, float s) const {
    return __fmul_rn(static_cast<float>(codes[(size_t)i * cols + col]), s);
  }
};

__global__ void __launch_bounds__(rows::THREADS)
fused_neighbor_sum_rs(const int* __restrict__ idx,
                      const float* __restrict__ mask,
                      const float* __restrict__ w,
                      const int8_t* __restrict__ codes,
                      const float* __restrict__ scale,
                      const float* __restrict__ theta,
                      float* __restrict__ out, int k_max, int d) {
  rows::slot_rows(CodeRows{codes, scale, d}, idx, mask, w, theta, out, k_max,
                  d);
}

// ---- fused_broadcast_select ----

constexpr int THREADS = 128;
constexpr int COLS = 4;                     // columns per thread
constexpr int TILE_D = THREADS * COLS;      // columns per block

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

extern "C" int fused_neighbor_sum_occupancy(int smem, int* resident_per_sm,
                                            int* sm_count, int* registers,
                                            int* local_bytes) {
  return slab::occupancy((const void*)fused_neighbor_sum_slab, smem,
                         resident_per_sm, sm_count, registers, local_bytes);
}

// edge_mask may be null (no channel mask): the fold is then
// (m · coeff[i]) · scale[i]. scratch: the lists, n·chunks lists of
// ⌈k_max/8⌉·8 (row offset, weight) entries, then their lengths, n·chunks
// ints.
extern "C" int fused_neighbor_sum_f32(const void* idx, const void* mask,
                                      const void* coeff, const void* edge_mask,
                                      const void* codes, const void* scale,
                                      void* out, void* scratch, int n,
                                      int k_max, int d, int chunk_rows,
                                      int chunks, int grid, void* stream) {
  const int* a_idx = static_cast<const int*>(idx);
  const float* a_mask = static_cast<const float*>(mask);
  const float* a_coeff = static_cast<const float*>(coeff);
  const float* a_em = static_cast<const float*>(edge_mask);
  const int8_t* a_codes = static_cast<const int8_t*>(codes);
  const float* a_scale = static_cast<const float*>(scale);
  float* a_out = static_cast<float*>(out);
  uint2* lists = static_cast<uint2*>(scratch);
  int* lens = reinterpret_cast<int*>(
      lists + (size_t)n * chunks * slab::list_cap(k_max));
  void* args[] = {&a_idx,   &a_mask, &a_coeff, &a_em,  &a_codes,
                  &a_scale, &a_out,  &lists,   &lens,  &n,
                  &k_max,   &d,      &chunk_rows,      &chunks};
  return slab::launch((const void*)fused_neighbor_sum_slab, args, n, k_max,
                      d, chunk_rows, chunks, grid, stream);
}

// R receivers over S senders in wire form: idx, mask (R, k_max), w (S,),
// codes (S, d) int8, scale (S,), theta and out (R, d); entries of idx in
// [0, S).
extern "C" int fused_neighbor_sum_rs_f32(const void* idx, const void* mask,
                                         const void* w, const void* codes,
                                         const void* scale, const void* theta,
                                         void* out, int r, int s, int k_max,
                                         int d, void* stream) {
  if (!rows::shape_ok(r, s, k_max, d))
    return static_cast<int>(cudaErrorInvalidValue);
  fused_neighbor_sum_rs<<<rows::grid(r, d), rows::THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(idx), static_cast<const float*>(mask),
      static_cast<const float*>(w), static_cast<const int8_t*>(codes),
      static_cast<const float*>(scale), static_cast<const float*>(theta),
      static_cast<float*>(out), k_max, d);
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

// Whole pendulum episodes of the paper's policy for Hopper, sm_90a,
// float32: for every episode i of a call, from its reset state (θ, θ̇) and
// the parameters θ_p of row p = i / per_theta,
//
//   for t < steps:
//     obs    = (cos θ, sin θ, θ̇ / max_speed)
//     a      = tanh(W3ᵀ tanh(W2ᵀ tanh(W1ᵀ obs + b1) + b2) + b3)
//     u      = clamp(a, −1, 1) · max_torque
//     cost   = ang(θ)² + 0.1 θ̇² + 0.001 u²,  ang(θ) = ((θ + π) mod 2π) − π
//     θ̇      = clamp(θ̇ + (3g / 2l · sin θ + 3 / (m l²) · u) · dt, ±max_speed)
//     θ      = θ + θ̇ · dt
//     R     += −cost
//
// over thetas (P, 4481) (the policy 3 → 64 → 64 → 1 flattened as
// `envs/policy.MLPPolicy` lays it out: per layer W row-major (din, dout),
// then b) and states (P · per_theta, 2) → returns R (P · per_theta,).
//
// Replaces no TPU kernel. The reference runs the episode as a `lax.scan`
// (src/repro/envs/rollout.py:19 `episode_return`, the scan at :35) that
// XLA compiles into one program; the port ran it as a Python loop of ≈ 37
// launches a step, whose batched matrix-vector products read every
// candidate's 4481 parameters from device memory at every one of the 200
// steps (117 GB for NetES's 2N = 32,768 episodes at N = 16,384). This
// kernel reads each parameter row once and keeps it on chip for the whole
// episode.
//
// What bounds it on the H100: operations. An episode step is 4352
// multiply-adds of the policy (8704 flops), against 17.9 KB of
// parameters read once an episode: at 2N = 32,768 episodes, 5.70e10
// flops take 0.85 ms at 66.9 TFLOP/s, and the 587 MB of parameters
// 0.18 ms at 3.35 TB/s. Beside the products each step runs seven accurate
// transcendental functions a lane (four tanh of the hidden units, the
// action's tanh, sin and cos of θ), fmodf and the environment's scalar
// chain, so the instructions issued, not the flops, set the time.
//
// Design. One warp runs one episode, with its policy in registers: lane l
// holds hidden units l and l + 32 of both layers (W1's and W2's columns,
// their biases, W3's two entries), 141 floats. Layer 1 is 3 FMAs a unit.
// The 64 values of h1 go through a 256-byte row of shared memory (a
// shuffle each would cost 64 shuffles a step against 16 broadcast 16-byte
// loads); layer 2 is 64 FMAs a unit in PARTS partial sums, so that each
// lane has 2 · PARTS independent chains in flight; layer 3 is two FMAs and
// a butterfly of __shfl_xor_sync, which leaves the same sum, bit for bit,
// in every lane. Every lane then steps the same scalar environment (the
// warp issues it once). Nothing is reduced across warps, no block-wide
// barrier: episodes are independent, and a block of WARPS warps exists
// only to share an SM's shared memory. 168 registers a thread let three
// blocks (12 warps) reside on an SM, so 32,768 episodes take ≈ 21 waves.
//
// Numerics: the policy's products are float32 FMAs on the CUDA cores (no
// tensor core, no TF32), summed in another order than cuBLAS's batched
// gemv: the only difference from the Python loop. tanhf, sinf, cosf and
// fmodf are the accurate ones (no fast-math flag, no intrinsic). The
// environment's arithmetic is that of the loop's PyTorch elementwise
// kernels on CUDA, one rounding each, in its order, never contracted
// into an FMA (__fmul_rn, __fadd_rn): a Python float enters as the
// float32 it rounds to; `θ̇ / max_speed` multiplies by the float32
// reciprocal, as PyTorch's division by a scalar does on CUDA; the floor
// mod is `torch.remainder`'s (fmodf, then the divisor added where the
// signs differ and the remainder is not 0); a clamp passes NaN through.
// The coefficients 3g / 2l and 3 / (m l²) are computed in double on the
// host, as Python computes them, then rounded. The return is summed in
// step order from 0, as `total = total + reward`.
//
// C interface (bound with ctypes): `pendulum_rollout_f32` returns
// cudaGetLastError() after the launch; `pendulum_rollout_query` reports
// the grid, resident blocks per SM, registers and local (spill) bytes per
// thread. Launches on the caller's stream, never synchronises, allocates
// nothing.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int WARP = 32;
constexpr int WARPS = 4;         // episodes per block
constexpr int BLOCK = WARP * WARPS;
constexpr int MIN_BLOCKS = 3;    // resident per SM: ≤ 168 registers
constexpr int PARTS = 4;         // partial sums per hidden unit of layer 2

constexpr int OBS = 3, HID = 64;
constexpr int W1 = 0, B1 = W1 + OBS * HID, W2 = B1 + HID,
              B2 = W2 + HID * HID, W3 = B2 + HID, B3 = W3 + HID,
              DIM = B3 + 1;
static_assert(DIM == 4481, "the paper's policy has 4481 parameters");
static_assert(HID == 2 * WARP, "a lane holds two hidden units");
static_assert(HID % (4 * PARTS) == 0 && PARTS == 4,
              "layer 2 reads h1 four values at a time, one per part");

// The float32 scalars the loop's elementwise kernels see.
struct Dynamics {
  float inv_speed;   // 1 / max_speed, for the observation
  float speed;       // the clamp of θ̇
  float torque;      // max_torque
  float dt;
  float c_sin;       // 3 g / (2 l)
  float c_u;         // 3 / (m l²)
  int steps;
};

__device__ __forceinline__ float clamp_nan(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

__global__ void __launch_bounds__(BLOCK, MIN_BLOCKS)
    pendulum_rollout_kernel(const float* __restrict__ thetas,
                            const float* __restrict__ states,
                            float* __restrict__ returns, int episodes,
                            int per_theta, Dynamics dyn) {
  __shared__ __align__(16) float h1_rows[WARPS][HID];
  const int lane = threadIdx.x % WARP;
  const int warp = threadIdx.x / WARP;
  const int ep = blockIdx.x * WARPS + warp;
  if (ep >= episodes) return;                 // the whole warp leaves
  const float* p = thetas + (size_t)(ep / per_theta) * DIM;
  float* h1_row = h1_rows[warp];

  // lane's units j = lane (a) and lane + 32 (b); every row coalesced
  float w1a[OBS], w1b[OBS], w2a[HID], w2b[HID];
#pragma unroll
  for (int i = 0; i < OBS; ++i) {
    w1a[i] = p[W1 + i * HID + lane];
    w1b[i] = p[W1 + i * HID + lane + WARP];
  }
#pragma unroll
  for (int i = 0; i < HID; ++i) {
    w2a[i] = p[W2 + i * HID + lane];
    w2b[i] = p[W2 + i * HID + lane + WARP];
  }
  const float b1a = p[B1 + lane], b1b = p[B1 + lane + WARP];
  const float b2a = p[B2 + lane], b2b = p[B2 + lane + WARP];
  const float w3a = p[W3 + lane], w3b = p[W3 + lane + WARP];
  const float b3 = p[B3];

  // Python floats of the loop, rounded to float32 as PyTorch rounds them
  const float pi = static_cast<float>(3.141592653589793);
  const float two_pi = static_cast<float>(2.0 * 3.141592653589793);
  const float c_thdot = static_cast<float>(0.1);
  const float c_u2 = static_cast<float>(0.001);

  float th = states[2 * (size_t)ep];
  float thdot = states[2 * (size_t)ep + 1];
  float total = 0.f;
  for (int t = 0; t < dyn.steps; ++t) {
    const float s = sinf(th), c = cosf(th);
    const float o2 = __fmul_rn(thdot, dyn.inv_speed);

    float a = fmaf(c, w1a[0], b1a), b = fmaf(c, w1b[0], b1b);
    a = fmaf(s, w1a[1], a);
    b = fmaf(s, w1b[1], b);
    a = fmaf(o2, w1a[2], a);
    b = fmaf(o2, w1b[2], b);
    __syncwarp();                  // the last step's reads of h1 are done
    h1_row[lane] = tanhf(a);
    h1_row[lane + WARP] = tanhf(b);
    __syncwarp();

    float pa[PARTS], pb[PARTS];
#pragma unroll
    for (int k = 0; k < PARTS; ++k) pa[k] = pb[k] = 0.f;
    pa[0] = b2a;
    pb[0] = b2b;
#pragma unroll
    for (int q = 0; q < HID / 4; ++q) {
      const float4 h = reinterpret_cast<const float4*>(h1_row)[q];
      pa[0] = fmaf(h.x, w2a[4 * q], pa[0]);
      pb[0] = fmaf(h.x, w2b[4 * q], pb[0]);
      pa[1] = fmaf(h.y, w2a[4 * q + 1], pa[1]);
      pb[1] = fmaf(h.y, w2b[4 * q + 1], pb[1]);
      pa[2] = fmaf(h.z, w2a[4 * q + 2], pa[2]);
      pb[2] = fmaf(h.z, w2b[4 * q + 2], pb[2]);
      pa[3] = fmaf(h.w, w2a[4 * q + 3], pa[3]);
      pb[3] = fmaf(h.w, w2b[4 * q + 3], pb[3]);
    }
    const float h2a = tanhf((pa[0] + pa[1]) + (pa[2] + pa[3]));
    const float h2b = tanhf((pb[0] + pb[1]) + (pb[2] + pb[3]));

    float out = fmaf(h2b, w3b, h2a * w3a);
#pragma unroll
    for (int o = WARP / 2; o > 0; o /= 2)
      out += __shfl_xor_sync(0xffffffffu, out, o);
    const float act = tanhf(out + b3);

    // the environment, as pendulum.py's step on the batched state
    const float u = __fmul_rn(clamp_nan(act, -1.f, 1.f), dyn.torque);
    float ang = fmodf(__fadd_rn(th, pi), two_pi);
    if (ang != 0.f && ((two_pi < 0.f) != (ang < 0.f)))
      ang = __fadd_rn(ang, two_pi);
    ang = __fsub_rn(ang, pi);
    const float cost = __fadd_rn(
        __fadd_rn(__fmul_rn(ang, ang),
                  __fmul_rn(c_thdot, __fmul_rn(thdot, thdot))),
        __fmul_rn(c_u2, __fmul_rn(u, u)));
    const float drive =
        __fadd_rn(__fmul_rn(dyn.c_sin, s), __fmul_rn(dyn.c_u, u));
    thdot = clamp_nan(__fadd_rn(thdot, __fmul_rn(drive, dyn.dt)),
                      -dyn.speed, dyn.speed);
    th = __fadd_rn(th, __fmul_rn(thdot, dyn.dt));
    total = __fadd_rn(total, -cost);
  }
  if (lane == 0) returns[ep] = total;
}

bool valid(int episodes, int per_theta, int steps) {
  return episodes >= 1 && per_theta >= 1 && episodes % per_theta == 0 &&
         steps >= 0;
}

int grid_of(int episodes) { return (episodes + WARPS - 1) / WARPS; }

}  // namespace

// episodes ≥ 1, a multiple of per_theta ≥ 1, steps ≥ 0 (anything else
// returns cudaErrorInvalidValue); thetas (episodes / per_theta, 4481),
// states (episodes, 2) and returns (episodes,) float32, contiguous: the
// wrapper checks them before the call.
extern "C" int pendulum_rollout_f32(const void* thetas, const void* states,
                                    void* returns, int episodes,
                                    int per_theta, double max_speed,
                                    double max_torque, double dt, double g,
                                    double m, double length, int steps,
                                    void* stream) {
  if (!valid(episodes, per_theta, steps))
    return static_cast<int>(cudaErrorInvalidValue);
  Dynamics dyn;
  dyn.inv_speed = 1.0f / static_cast<float>(max_speed);
  dyn.speed = static_cast<float>(max_speed);
  dyn.torque = static_cast<float>(max_torque);
  dyn.dt = static_cast<float>(dt);
  dyn.c_sin = static_cast<float>(3.0 * g / (2.0 * length));
  dyn.c_u = static_cast<float>(3.0 / (m * (length * length)));
  dyn.steps = steps;
  pendulum_rollout_kernel<<<grid_of(episodes), BLOCK, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(thetas), static_cast<const float*>(states),
      static_cast<float*>(returns), episodes, per_theta, dyn);
  return static_cast<int>(cudaGetLastError());
}

// The launch of `episodes` episodes: its grid, and the kernel's resident
// blocks per SM, registers and local (spill) bytes per thread.
extern "C" int pendulum_rollout_query(int episodes, int* grid,
                                      int* resident_per_sm, int* registers,
                                      int* local_bytes) {
  if (episodes < 1) return static_cast<int>(cudaErrorInvalidValue);
  *grid = grid_of(episodes);
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      resident_per_sm, pendulum_rollout_kernel, BLOCK, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, pendulum_rollout_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  *registers = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  return 0;
}

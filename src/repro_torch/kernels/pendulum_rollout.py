"""Whole pendulum episodes of the paper's policy: the wrapper of
``csrc/pendulum_rollout.cu``.

One launch runs every episode of a call, 200 steps each, with each
candidate's 3 → 64 → 64 → 1 policy held on chip (see the source's note).
Replaces no TPU kernel: the reference's rollout is a ``lax.scan``. Its
plain version is the Python loop of ``envs.rollout.episode_return``, which
takes CPU tensors, other environments and other policies; that function
chooses between the two (``envs.rollout.uses_kernel``). This wrapper takes
float32 CUDA tensors only, and raises on anything else: it never falls
back. On fake and meta tensors (a dry run's trace) it returns an empty
result of the kernel's shape and reports its costs, launching nothing.
"""
from __future__ import annotations

import ctypes

import torch

from ._build import CudaKernel
from ._checks import check_operand, on_cpu, report, shape_only

KERNEL = CudaKernel("pendulum_rollout", "pendulum_rollout_f32",
                    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
                    + [ctypes.c_double] * 6 + [ctypes.c_int, ctypes.c_void_p])

DIM = 4481                      # the policy 3 → 64 → 64 → 1, flattened
STATE_DIM = 2                   # (θ, θ̇)
# the policy's multiply-adds an episode step, as flops (2 a product)
FLOPS_PER_STEP = 2 * (3 * 64 + 64 * 64 + 64 * 1)
MAX_EPISODES = 2**31 - 1        # the kernel's episode index is an int


def launch_info(episodes: int, device_index: int) -> dict:
    """The grid of a launch of ``episodes`` episodes and the kernel's
    resident blocks per SM, registers and local (spill) bytes per thread,
    from the library's query on CUDA device ``device_index``."""
    query = KERNEL.function("pendulum_rollout_query", [ctypes.c_int]
                            + [ctypes.POINTER(ctypes.c_int)] * 4)
    vals = [ctypes.c_int(0) for _ in range(4)]
    with torch.cuda.device(device_index):
        err = query(episodes, *(ctypes.byref(x) for x in vals))
    grid, resident, regs, local = (x.value for x in vals)
    if err != 0 or resident < 1:
        raise RuntimeError(f"pendulum_rollout_query: cudaError_t {err}, "
                           f"{resident} resident blocks")
    return {"grid": grid, "resident": resident, "registers": regs,
            "local_bytes": local}


def pendulum_rollout(env, thetas: torch.Tensor, states: torch.Tensor,
                     per_theta: int = 1) -> torch.Tensor:
    """The return of one episode of ``env`` (an ``envs.Pendulum``: its
    seven fields enter the kernel) per row of ``states (M, 2)``, row i
    run by the parameters ``thetas[i // per_theta]`` of ``thetas
    (M / per_theta, 4481)``. Returns (M,) float32."""
    if thetas.dim() != 2 or thetas.shape[1] != DIM:
        raise ValueError(f"thetas: shape {tuple(thetas.shape)}, expected "
                         f"(P, {DIM})")
    if per_theta < 1:
        raise ValueError(f"per_theta = {per_theta}: must be ≥ 1")
    episodes = thetas.shape[0] * per_theta
    if not 1 <= episodes <= MAX_EPISODES:
        raise ValueError(f"{episodes} episodes: the kernel takes 1 to "
                         f"{MAX_EPISODES}")
    check_operand("thetas", thetas, torch.float32, (thetas.shape[0], DIM))
    check_operand("states", states, torch.float32, (episodes, STATE_DIM))
    fake = shape_only([thetas, states])
    if not fake and on_cpu([thetas, states]):
        raise ValueError("pendulum_rollout takes CUDA tensors; on the CPU "
                         "envs.rollout.episode_return runs the plain loop")
    out = torch.empty(episodes, dtype=torch.float32, device=thetas.device)
    report("pendulum_rollout",
           float(episodes) * env.episode_len * FLOPS_PER_STEP,
           (thetas, states, out))
    if fake:
        return out
    KERNEL.launch(thetas.data_ptr(), states.data_ptr(), out.data_ptr(),
                  episodes, per_theta, env.max_speed, env.max_torque,
                  env.dt, env.g, env.m, env.length, env.episode_len,
                  torch.cuda.current_stream(thetas.device).cuda_stream)
    return out

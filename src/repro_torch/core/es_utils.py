"""ES machinery shared by NetES (Salimans et al. 2017 tricks).

* fitness shaping — centered-rank transform of returns [Wierstra et al. 14]
* plain standardization, for ablations
* decoupled weight decay on parameters
* seeded noise streams (``stream_seed``, ``agent_noise_seed``,
  ``sample_noise``) and the antithetic pair
"""
from __future__ import annotations

import torch


def centered_rank(returns: torch.Tensor) -> torch.Tensor:
    """Fitness shaping: map returns to centered uniform ranks in [−.5, .5].

    Double-argsort rank, scaled to [0, 1], minus 0.5 (OpenAI ES
    ``compute_centered_ranks``). Both sorts are stable, as ``jnp.argsort``
    is, so tied returns rank in index order exactly as in the reference.
    """
    flat = returns.reshape(-1)
    ranks = torch.argsort(torch.argsort(flat, stable=True), stable=True)
    shaped = ranks.to(torch.float32) / (flat.shape[0] - 1) - 0.5
    return shaped.reshape(returns.shape)


def normalize_returns(returns: torch.Tensor) -> torch.Tensor:
    """Plain standardization (population std, ddof 0 as ``jnp.std``)."""
    mu = returns.mean()
    sd = returns.std(correction=0) + 1e-8
    return (returns - mu) / sd


def apply_weight_decay(theta: torch.Tensor, update: torch.Tensor,
                       wd: float) -> torch.Tensor:
    """u ← u − wd·θ  (decoupled weight decay, as in the OpenAI ES impl)."""
    return update - wd * theta


# ---------------------------------------------------------------------------
# seeded noise streams
# ---------------------------------------------------------------------------
#
# The reference keys every stream with threefry's fold_in. The port has no
# threefry: a stream's seed is a hash of integer parts (SplitMix64's
# finalizer, chained), and its numbers are those of a torch.Generator
# seeded with it. Streams with different parts are independent; the same
# parts give the same numbers again on the same device (not across
# devices: the CPU and CUDA generators differ, so a comparison of the two
# injects one device's draws into the other).

_M64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def stream_seed(*parts: int) -> int:
    """A 63-bit generator seed from non-negative integer ``parts``, in
    order: the port's counterpart of a chain of ``fold_in``s."""
    h = 0x6A09E667F3BCC908
    for part in parts:
        if part < 0:
            raise ValueError(f"stream_seed takes non-negative parts: {parts}")
        h = _splitmix64(h ^ (part & _M64))
    return h >> 1


def agent_noise_seed(base_seed: int, agent_idx: int, step: int) -> int:
    """The seed of one agent's noise at one iteration: every agent can
    regenerate every other agent's ε from the shared base seed, which is
    what lets the seed-replay mixing move rewards instead of ε."""
    return stream_seed(base_seed, agent_idx, step)


def sample_noise(generator: torch.Generator, shape, dtype=torch.float32,
                 out: torch.Tensor = None) -> torch.Tensor:
    """Standard normal noise of ``shape`` from ``generator``, on its
    device (into ``out`` if given)."""
    if out is not None:
        return torch.randn(shape, generator=generator, dtype=dtype, out=out)
    return torch.randn(shape, generator=generator, dtype=dtype,
                       device=generator.device)


def antithetic_pair(eps: torch.Tensor) -> torch.Tensor:
    """Stack (+ε, −ε) along a leading axis of size 2."""
    return torch.stack([eps, -eps], dim=0)

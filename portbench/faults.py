"""Faults planted under a cell's timed path, to show that its comparison
catches them: a step that returns its state unchanged; half of the batch
left out, the mean taken over the rest; an answer altered where it is
produced. (No cell runs across chips, so none can leave out an exchange
between them.) Each is a context manager that patches the port's module
while it is open; ``FAULTS[runner][name]``."""
from __future__ import annotations

import contextlib
import dataclasses

import torch


@contextlib.contextmanager
def _patched(module, name, make):
    real = getattr(module, name)
    setattr(module, name, make(real))
    try:
        yield
    finally:
        setattr(module, name, real)


# --------------------------------------------------------------------------
# NetES on a policy population
# --------------------------------------------------------------------------

def rl_unchanged():
    from repro_torch.core import netes

    def make(real):
        def step(state, *a, **kw):
            new, chan, metrics = real(state, *a, **kw)
            return (dataclasses.replace(new, thetas=state.thetas), chan,
                    metrics)
        return step
    return _patched(netes, "netes_step", make)


def rl_half_batch():
    """Eq. 3 over the first half of the agents, scaled to their mean."""
    from repro_torch.core import netes

    def make(real):
        def mixing(topo, thetas, eps, shaped, cfg, **kw):
            half = shaped.clone()
            half[shaped.shape[0] // 2:] = 0
            return real(topo, thetas, eps, 2.0 * half, cfg, **kw)
        return mixing
    return _patched(netes, "mixing_update", make)


def rl_altered():
    """One candidate's return (the first) raised above every other."""
    from repro_torch.core import netes

    def make(real):
        def step(state, topo, reward_fn, *a, **kw):
            def altered(params, evals):
                r = reward_fn(params, evals).clone()
                r[0] = r.max() + 1.0
                return r
            altered.draw = reward_fn.draw
            return real(state, topo, altered, *a, **kw)
        return step
    return _patched(netes, "netes_step", make)


# --------------------------------------------------------------------------
# consensus training of a language model
# --------------------------------------------------------------------------

def lm_unchanged():
    from repro_torch.distributed import netes_dist

    def make(_real):
        def update(params, replica, r_pos, r_neg, draws, degree, ncfg,
                   channel=None):
            raw = torch.cat([r_pos, r_neg])
            return {"reward_mean": raw.mean(), "reward_max": raw.max(),
                    "loss_mean": -raw.mean(),
                    "broadcast": torch.zeros((), device=raw.device)}
        return update
    return _patched(netes_dist, "consensus_update", make)


def lm_half_batch():
    """Each member's loss over the first half of its sequence."""
    from repro_torch.distributed import netes_dist

    def make(real):
        def rewards(cfg, params, batch, noise, sigma, replica):
            s = batch["tokens"].shape[-1] // 2
            return real(cfg, params, {k: v[..., :s] for k, v in
                                      batch.items()}, noise, sigma, replica)
        return rewards
    return _patched(netes_dist, "member_rewards", make)


def lm_altered():
    """Member 0's +σ loss raised by 1%."""
    from repro_torch.distributed import netes_dist

    def make(real):
        def rewards(*a, **kw):
            r_pos, r_neg = real(*a, **kw)
            r_pos = r_pos.clone()
            r_pos[0] = r_pos[0] * 1.01
            return r_pos, r_neg
        return rewards
    return _patched(netes_dist, "member_rewards", make)


FAULTS = {
    "netes_rl": {"unchanged": rl_unchanged, "half_batch": rl_half_batch,
                 "altered": rl_altered},
    "consensus_lm": {"unchanged": lm_unchanged,
                     "half_batch": lm_half_batch, "altered": lm_altered},
}

"""Carry NetES state across from the JAX reference, given as numpy arrays.

The reference draws θ⁽⁰⁾ with ``init_state(PRNGKey(seed), n, dim,
init_fn=policy.init)``; the port's generators give other numbers, so a
comparison starts both packages from the reference's state through here.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

from ._device import resolve_device
from .comm.channel import ChannelState
from .core.netes import NetESState
from .core.topology_repr import Topology


def state_from_reference(thetas, best_theta, best_reward, step, *,
                         seed: int = 0,
                         device: Union[str, torch.device] = "cuda"
                         ) -> NetESState:
    """The reference's ``NetESState`` leaves → the port's state. The PRNG
    key has no counterpart: the state gets a fresh generator seeded with
    ``seed`` (draws are injected where trajectories must match)."""
    dev = resolve_device(device)
    return NetESState(
        thetas=torch.as_tensor(np.array(thetas, np.float32), device=dev),
        generator=torch.Generator(device=dev).manual_seed(seed),
        step=torch.as_tensor(np.array(step, np.int32), device=dev),
        best_reward=torch.as_tensor(np.array(best_reward, np.float32),
                                    device=dev),
        best_theta=torch.as_tensor(np.array(best_theta, np.float32),
                                   device=dev))


def topology_from_reference(kind: str, n: int, deg, *, adj=None,
                            neighbor_idx=None, neighbor_mask=None,
                            offsets: Optional[Sequence[int]] = None,
                            device: Union[str, torch.device] = "cuda"
                            ) -> Topology:
    """The reference ``Topology``'s leaves → the port's ``Topology``."""
    dev = resolve_device(device)

    def t(a, dtype):
        return None if a is None else torch.as_tensor(np.array(a, dtype),
                                                      device=dev)

    if kind == "circulant" and offsets is None:
        raise ValueError("a circulant topology needs its offsets")
    return Topology(kind=kind, n=n, deg=t(deg, np.float32),
                    adj=t(adj, np.float32),
                    neighbor_idx=t(neighbor_idx, np.int32),
                    neighbor_mask=t(neighbor_mask, np.float32),
                    offsets=None if offsets is None else tuple(offsets))


def channel_state_from_reference(last_sent, msgs, *, seed: int = 0,
                                 draws: int = 0,
                                 device: Union[str, torch.device] = "cuda"
                                 ) -> ChannelState:
    """The reference's ``ChannelState`` leaves → the port's state.
    ``last_sent`` is the payload-shaped array, or None (the reference's
    ``()``) without an event stage; ``msgs`` the cumulative count. The
    threefry key has no counterpart: the port's dropout PRF is keyed by
    ``seed`` (the dropout stage's seed) and the count ``draws`` of masks
    drawn so far, so the port draws other masks than the reference from
    here on; a comparison injects the reference's masks
    (``core.netes.Draws.edge_mask``)."""
    dev = resolve_device(device)
    has_last = last_sent is not None and np.size(last_sent) > 0
    return ChannelState(
        seed=torch.tensor(seed, dtype=torch.int64, device=dev),
        draws=torch.tensor(draws, dtype=torch.int64, device=dev),
        last_sent=(torch.as_tensor(np.array(last_sent, np.float32),
                                   device=dev) if has_last else None),
        msgs=torch.as_tensor(np.array(msgs, np.float32), device=dev))

"""Plain reference of a NetES iteration on the pendulum task (paper §5.2,
Algorithm 1, Eq. 3), written from the paper and gym's Pendulum-v1.

It imports nothing of the program. ``precision`` is ``"f64"`` (the
reference) or ``"tf32"`` (the control: float32 arithmetic with every
matrix product's operands rounded to TF32's 10-bit mantissa, the
precision a float32 program falls to when TF32 is switched on).

Policy layout (the paper's MLP, Salimans et al.): for each layer W
row-major (din, dout), then b (dout,); 3 → 64 → 64 → 1, tanh between the
layers and on the action.
"""
from __future__ import annotations

import math

import torch

OBS_DIM, ACT_DIM, HIDDEN = 3, 1, (64, 64)
MAX_SPEED, MAX_TORQUE, DT, G, MASS, LENGTH = 8.0, 2.0, 0.05, 10.0, 1.0, 1.0
EPISODE_LEN = 200


def layer_shapes():
    dims = (OBS_DIM,) + HIDDEN + (ACT_DIM,)
    out = []
    for din, dout in zip(dims[:-1], dims[1:], strict=True):
        out += [(din, dout), (dout,)]
    return out


def leaf_slices():
    """(start, stop) of each policy leaf in the flat parameter vector."""
    out, at = [], 0
    for shape in layer_shapes():
        size = math.prod(shape)
        out.append((at, at + size))
        at += size
    return out


DIM = leaf_slices()[-1][1]


def dtype_of(precision: str) -> torch.dtype:
    return torch.float64 if precision == "f64" else torch.float32


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x (float32) rounded to nearest on TF32's 10-bit mantissa."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "tf32":
        return torch.matmul(tf32(a), tf32(b))
    return torch.matmul(a, b)


def rollout_returns(params: torch.Tensor, resets: torch.Tensor,
                    precision: str, block: int = 8192) -> torch.Tensor:
    """Return of one 200-step episode per row: params (M, D), resets (M, 2)
    → (M,), in blocks of rows."""
    dt = dtype_of(precision)
    out = []
    for r0 in range(0, params.shape[0], block):
        p = params[r0:r0 + block].to(dt)
        s = resets[r0:r0 + block].to(dt)
        m = p.shape[0]
        ws = []
        for (a, b), shape in zip(leaf_slices(), layer_shapes(), strict=True):
            ws.append(p[:, a:b].reshape((m,) + shape))
        th, thdot = s[:, 0].clone(), s[:, 1].clone()
        total = torch.zeros(m, dtype=dt, device=p.device)
        for _ in range(EPISODE_LEN):
            h = torch.stack([torch.cos(th), torch.sin(th),
                             thdot / MAX_SPEED], dim=1)[:, None, :]
            for layer in range(3):
                w, bias = ws[2 * layer], ws[2 * layer + 1]
                h = torch.tanh(matmul(h, w, precision) + bias[:, None, :])
            u = torch.clamp(h[:, 0, 0], -1.0, 1.0) * MAX_TORQUE
            ang = torch.remainder(th + math.pi, 2 * math.pi) - math.pi
            total = total - (ang ** 2 + 0.1 * thdot ** 2 + 0.001 * u ** 2)
            thdot = torch.clamp(
                thdot + (3 * G / (2 * LENGTH) * torch.sin(th)
                         + 3.0 / (MASS * LENGTH ** 2) * u) * DT,
                -MAX_SPEED, MAX_SPEED)
            th = th + thdot * DT
        out.append(total)
    return torch.cat(out)


def centered_ranks(x: torch.Tensor) -> torch.Tensor:
    """Ranks of x (ties in index order) scaled to [−0.5, 0.5]."""
    ranks = torch.empty_like(x)
    order = torch.sort(x, stable=True).indices
    ranks[order] = torch.arange(x.numel(), dtype=x.dtype, device=x.device)
    return ranks / (x.numel() - 1) - 0.5


def mix(adj: torch.Tensor, coeff: torch.Tensor, payload: torch.Tensor,
        thetas: torch.Tensor, precision: str,
        edge_block: int = 1 << 16) -> torch.Tensor:
    """Σ_i a_ji c_i (x_i − θ_j) for every receiver j. A graph with few
    edges is summed edge by edge in blocks, a dense one by a matrix
    product."""
    n = adj.shape[0]
    nnz = int((adj != 0).sum())
    dt = dtype_of(precision)
    w = adj.to(dt) * coeff.to(dt)[None, :]
    if nnz > n * n // 8:
        return (matmul(w, payload, precision)
                - w.sum(dim=1, keepdim=True) * thetas)
    rows, cols = torch.nonzero(adj, as_tuple=True)
    out = torch.zeros_like(thetas)
    for e0 in range(0, rows.numel(), edge_block):
        r, c = rows[e0:e0 + edge_block], cols[e0:e0 + edge_block]
        out.index_add_(0, r, w[r, c][:, None] * (payload[c] - thetas[r]))
    return out


def netes_iteration(thetas, adj, eps, resets, beta, cfg, precision,
                    pick=None, shape_from=None):
    """One iteration from ``thetas`` (N, D). ``cfg``: alpha, sigma,
    p_broadcast, weight_decay. ``pick(returns) -> index`` chooses the
    broadcast candidate among the 2N (default: the first best);
    ``shape_from`` (2N,), when given, are the returns the fitness is
    shaped from in place of this iteration's own. Returns (new thetas,
    the 2N returns, the update before the broadcast, the broadcast index
    or None)."""
    dt = dtype_of(precision)
    n = thetas.shape[0]
    thetas = thetas.to(dt)
    eps = eps.to(dt)
    sigma = cfg["sigma"]
    plus = thetas + sigma * eps
    cands = torch.cat([plus, thetas - sigma * eps])
    returns = rollout_returns(cands, torch.cat([resets, resets]), precision)
    ranks = centered_ranks(returns if shape_from is None
                           else shape_from.to(dt))
    shaped = ranks[:n] - ranks[n:]
    mixed = mix(adj, shaped, plus, thetas, precision)
    update = (cfg["alpha"] / (n * sigma ** 2)) * mixed
    update = update - cfg["weight_decay"] * thetas
    new = thetas + update
    best = None
    if float(beta) < cfg["p_broadcast"]:
        best = int(torch.argmax(returns)) if pick is None else pick(returns)
        new = cands[best][None, :].expand(n, -1).clone()
    return new, returns, update, best

"""The WKV-6 recurrence's plain version and the CPU route of its wrapper
against the JAX reference's oracle ``repro.kernels.ref.rwkv6_wkv_ref``
(``repro.kernels`` imports on this jax, so the reference runs in this
process; its Pallas kernel does not run on this jax, ROADMAP queue 3,
item b). The CUDA kernel itself runs only on the card: ``chip_smoke.py``
holds it against this plain version and float64 there.

Inputs as the reference's own sweep (tests/test_kernels.py): r, k, v and
u unit normal, w uniform in (0.9, 0.999), at its three shapes and at
rwkv6-7b's head width n = 64; each from a zero and from a random initial
state, over a prompt and over one step (a decode step).

Tolerance: |port − reference| ≤ 1e-5 · S elementwise, where S is the
same recurrence run over absolute values (|r|, |k|, |v|, w, |u|, |s0|) in
float64: the scale of the sums that make each output and state entry.
Both sides run the float32 recurrence and sum the n terms of each output
in other orders, which leaves ≈ 1e-7 of S (at most n·u ≈ 4e-6 of it at
n = 64). The reference's own test holds its kernel to rtol = atol = 1e-5
for n ≤ 32, where the sums stay small; at n = 64 outputs near 0 from sums
of magnitude 50 differ by 2e-5, so the bound is taken relative to S.
Leaving out the bonus, the initial state or one step's decay moves an
output by ≥ 1e-3 of S.

The CUDA kernel's decomposition (``kernels/rwkv6_wkv.plan``: heads padded
with zero channels to the instance's width, a block per (b, h, column
group), each thread's rows summed apart, the bonus Σ r·u·k once a step
and added as v_j·bonus) is replayed in float64 numpy:
within 1e-12·S of the plain version in float64 (the two differ only in
the order of the sums, ≈ 1e-15·S), and within 3e-5·S of the JAX oracle
in float32 (``chip_smoke.py``'s bound on the kernel against float64).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ref
from repro_torch.kernels import rwkv6_wkv as rw

TOL_REL = 1e-5
# (B, S, H, n): the reference's sweep, then rwkv6-7b's head width
SHAPES = [(1, 16, 2, 8), (2, 48, 3, 16), (1, 64, 4, 32), (1, 64, 2, 64)]
IDS = ["x".join(map(str, s)) for s in SHAPES]


def operands(b, s, h, n, seed, s0=False):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(b, s, h, n)).astype(np.float32)
               for _ in range(3))
    w = rng.uniform(0.9, 0.999, (b, s, h, n)).astype(np.float32)
    u = rng.normal(size=(h, n)).astype(np.float32)
    z = rng.normal(size=(b, h, n, n)).astype(np.float32) if s0 else None
    return r, k, v, w, u, z


def reference(r, k, v, w, u, s0):
    out, s_fin = jref.rwkv6_wkv_ref(
        *(jnp.asarray(a) for a in (r, k, v, w, u)),
        None if s0 is None else jnp.asarray(s0))
    return np.asarray(out), np.asarray(s_fin)


def torch_args(r, k, v, w, u, s0):
    return [torch.from_numpy(a) for a in (r, k, v, w, u)] + [
        None if s0 is None else torch.from_numpy(s0)]


def scales(r, k, v, w, u, s0):
    """The recurrence over absolute values, in float64: (out, state)."""
    out, s_fin = ref.rwkv6_wkv_ref(
        *(torch.from_numpy(np.abs(a)).double() for a in (r, k, v)),
        torch.from_numpy(w).double(), torch.from_numpy(np.abs(u)).double(),
        None if s0 is None else torch.from_numpy(np.abs(s0)).double())
    return out.numpy(), s_fin.numpy()


def assert_within(got, want, scale):
    err = np.abs(got.astype(np.float64) - want)
    assert (err <= TOL_REL * scale).all(), (err / scale).max()


def check(fn, args):
    want_out, want_s = reference(*args)
    scale_out, scale_s = scales(*args)
    rw.KERNEL.launches = 0
    out, s_fin = fn(*torch_args(*args))
    assert rw.KERNEL.launches == 0          # CPU tensors: the plain version
    assert out.dtype == s_fin.dtype == torch.float32
    assert_within(out.numpy(), want_out, scale_out)
    assert_within(s_fin.numpy(), want_s, scale_s)


@pytest.mark.parametrize("fn", [ref.rwkv6_wkv_ref, rw.rwkv6_wkv],
                         ids=["plain", "wrapper"])
@pytest.mark.parametrize("s0", [False, True], ids=["zero", "s0"])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_matches_reference(fn, s0, shape):
    check(fn, operands(*shape, seed=sum(shape), s0=s0))


@pytest.mark.parametrize("fn", [ref.rwkv6_wkv_ref, rw.rwkv6_wkv],
                         ids=["plain", "wrapper"])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_decode_step_matches_reference(fn, shape):
    b, _, h, n = shape
    check(fn, operands(b, 1, h, n, seed=n, s0=True))


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_state_carries_across_calls(shape):
    """Two calls over the halves of a sequence, the second from the first's
    final state, give the outputs and the state of one call over all."""
    np_args = operands(*shape, seed=7, s0=True)
    scale_out, scale_s = scales(*np_args)
    *seq, u, s0 = torch_args(*np_args)
    half = shape[1] // 2
    out, s_fin = rw.rwkv6_wkv(*seq, u, s0)
    out1, s1 = rw.rwkv6_wkv(*(a[:, :half].contiguous() for a in seq), u, s0)
    out2, s2 = rw.rwkv6_wkv(*(a[:, half:].contiguous() for a in seq), u, s1)
    assert_within(torch.cat([out1, out2], 1).numpy(), out.numpy(), scale_out)
    assert_within(s2.numpy(), s_fin.numpy(), scale_s)


def test_plain_version_is_float64_for_float64():
    np_args = operands(1, 5, 2, 8, seed=1, s0=True)
    args = torch_args(*np_args)
    out, s_fin = ref.rwkv6_wkv_ref(*(a.double() for a in args))
    assert out.dtype == s_fin.dtype == torch.float64
    out32, _ = ref.rwkv6_wkv_ref(*args)
    assert_within(out32.numpy(), out.numpy(), scales(*np_args)[0])


def _bad(change):
    """The wrapper's operands for (1, 4, 2, 8) with one of them changed."""
    r, k, v, w, u, s0 = torch_args(*operands(1, 4, 2, 8, seed=2, s0=True))
    ops = dict(r=r, k=k, v=v, w=w, u=u, s0=s0)
    ops.update(change(ops))
    return ops


@pytest.mark.parametrize("change,error,match", [
    (lambda o: {"r": o["r"].double()}, TypeError, "float32"),
    (lambda o: {"u": o["u"].double()}, TypeError, "float32"),
    (lambda o: {"s0": o["s0"].double()}, TypeError, "float32"),
    (lambda o: {"k": o["k"][:, :3]}, ValueError, "shape"),
    (lambda o: {"u": o["u"][:1]}, ValueError, "shape"),
    (lambda o: {"s0": o["s0"][..., :4]}, ValueError, "shape"),
    (lambda o: {"r": o["r"][0]}, ValueError, "shape"),
    (lambda o: {"v": o["v"].transpose(1, 2).contiguous().transpose(1, 2)},
     ValueError, "contiguous"),
    (lambda o: {k: torch.zeros(1, 4, 2, 72) for k in "rkvw"}
     | {"u": torch.zeros(2, 72), "s0": None}, ValueError, "n ≤ 64"),
    (lambda o: {k: torch.zeros(1, 0, 2, 8) for k in "rkvw"},
     ValueError, "S ≥ 1"),
], ids=["r_float64", "u_float64", "s0_float64", "k_shape", "u_shape",
        "s0_shape", "r_3d", "v_not_contiguous", "n_72", "s_0"])
def test_wrapper_raises_on_what_the_kernel_does_not_take(change, error,
                                                         match):
    ops = _bad(change)
    with pytest.raises(error, match=match):
        rw.rwkv6_wkv(ops["r"], ops["k"], ops["v"], ops["w"], ops["u"],
                     ops["s0"])


def test_wrapper_refuses_operands_on_two_devices():
    r, k, v, w, u, s0 = torch_args(*operands(1, 4, 2, 8, seed=3, s0=True))
    with pytest.raises(ValueError, match="several devices"):
        rw.rwkv6_wkv(r, k, v, w, u.to("meta"), s0)


def replay(pl, r, k, v, w, u, s0):
    """The kernel's arithmetic in float64 numpy, block by block of the
    plan, on the operands padded to its head width: per step the bonus
    once, each thread's rows' part of r·S, the parts summed, v_j·bonus
    added, then the state update (a decode step adds each thread's rows'
    share of the bonus before the sum: the same sum in float64). Returns
    the unpadded outputs."""
    n = r.shape[-1]
    r, k, v, w, u, s0 = (None if x is None else x.double().numpy()
                         for x in rw.pad_heads(*torch_args(r, k, v, w, u, s0),
                                               pl.n - n))
    b, s, h, _ = r.shape
    out = np.full((b, s, h, pl.n), np.nan)
    s_fin = np.full((b, h, pl.n, pl.n), np.nan)
    rows = [np.arange(4 * q, 4 * q + 4) for q in range(pl.rs)]
    for block in range(pl.grid):
        bb, hh, cols = rw.block_work(pl, block)
        cols = np.array(cols)
        state = (np.zeros((pl.n, len(cols))) if s0 is None
                 else s0[bb, hh][:, cols])
        for t in range(s):
            rt, kt, wt = (x[bb, t, hh] for x in (r, k, w))
            vt = v[bb, t, hh, cols]
            bonus = (rt * u[hh] * kt).sum()
            parts = sum(rt[x] @ state[x] for x in rows)
            out[bb, t, hh, cols] = parts + vt * bonus
            state = wt[:, None] * state + np.outer(kt, vt)
        s_fin[bb, hh][:, cols] = state
    return out[..., :n], s_fin[..., :n, :n]


# (B, S, H, n): every instance's width, a padded one (40), a chunk and a
# half, a decode step
REPLAY = [(2, 23, 3, 8), (1, 33, 5, 16), (2, 17, 2, 32), (1, 20, 2, 40),
          (1, 24, 2, 64), (2, 1, 3, 64)]


@pytest.mark.parametrize("b,s,h,n", REPLAY,
                         ids=["x".join(map(str, x)) for x in REPLAY])
def test_replay_of_the_kernels_decomposition(b, s, h, n):
    np_args = operands(b, s, h, n, seed=b + s + h + n, s0=True)
    pl = rw.plan(b, h, n)
    got_out, got_s = replay(pl, *np_args)
    want_out, want_s = (x.numpy() for x in ref.rwkv6_wkv_ref(
        *(a.double() for a in torch_args(*np_args[:5], None)[:5]),
        torch.from_numpy(np_args[5]).double()))
    scale_out, scale_s = scales(*np_args)
    assert (np.abs(got_out - want_out) <= 1e-12 * scale_out).all()
    assert (np.abs(got_s - want_s) <= 1e-12 * scale_s).all()
    jax_out, jax_s = reference(*np_args)
    assert (np.abs(got_out - jax_out) <= 3e-5 * scale_out).all()
    assert (np.abs(got_s - jax_s) <= 3e-5 * scale_s).all()

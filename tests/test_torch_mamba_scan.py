"""The mamba selective-scan recurrence's plain version and the CPU route of
its wrapper against the JAX reference's oracle
``repro.kernels.ref.mamba_scan_ref`` (``repro.kernels`` imports on this
jax, so the reference runs in this process; its Pallas kernel does not run
on this jax, ROADMAP queue 3, item b). The CUDA kernel itself runs only on
the card: ``chip_smoke.py`` holds it against this plain version and
float64 there.

Inputs as the reference's own sweep (tests/test_kernels.py): decay uniform
in (0.8, 0.999), drive unit normal, at its three shapes and at
jamba-v0.1-52b's state width N = 16; each from a zero and from a random
initial state h0 (the reference starts from zero: its h0 case runs one
step more, decay 0 and drive h0, and drops it), over a prompt and over one
step (a decode step).

Tolerance: |port − reference| ≤ 1e-5 · S elementwise, where S is the same
recurrence run over |drive| (and |h0|) in float64: the scale of the sum
that makes each h_t. Both sides run the float32 recurrence, the kernel's
plain version as a multiply and an add where XLA may fuse them, which
leaves ≈ 1e-7 of S; leaving out one step's drive or decay moves an entry
by ≥ 1e-3 of S.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import mamba_scan as ms
from repro_torch.kernels import ref

TOL_REL = 1e-5
# (B, S, D, N): the reference's sweep, then jamba's state width
SHAPES = [(1, 32, 64, 8), (2, 64, 300, 16), (1, 128, 512, 4),
          (1, 48, 96, 16)]
IDS = ["x".join(map(str, s)) for s in SHAPES]


def operands(b, s, d, n, seed, h0=False):
    rng = np.random.default_rng(seed)
    decay = rng.uniform(0.8, 0.999, (b, s, d, n)).astype(np.float32)
    drive = rng.normal(size=(b, s, d, n)).astype(np.float32)
    z = rng.normal(size=(b, d, n)).astype(np.float32) if h0 else None
    return decay, drive, z


def reference(decay, drive, h0):
    """The reference's zero-state scan; an initial state enters as one
    step more in front (decay 0, drive h0), dropped from the result."""
    if h0 is not None:
        decay = np.concatenate([np.zeros_like(decay[:, :1]), decay], axis=1)
        drive = np.concatenate([h0[:, None], drive], axis=1)
    h = np.asarray(jref.mamba_scan_ref(jnp.asarray(decay),
                                       jnp.asarray(drive)))
    return h if h0 is None else h[:, 1:]


def torch_args(decay, drive, h0):
    return [torch.from_numpy(decay), torch.from_numpy(drive),
            None if h0 is None else torch.from_numpy(h0)]


def scale(decay, drive, h0):
    """The recurrence over |drive| and |h0|, in float64."""
    return ref.mamba_scan_ref(
        torch.from_numpy(decay).double(),
        torch.from_numpy(np.abs(drive)).double(),
        None if h0 is None else torch.from_numpy(np.abs(h0)).double()
    ).numpy()


def assert_within(got, want, s):
    err = np.abs(got.astype(np.float64) - want)
    assert (err <= TOL_REL * s).all(), (err / s).max()


def check(fn, args):
    ms.KERNEL.launches = 0
    h = fn(*torch_args(*args))
    assert ms.KERNEL.launches == 0          # CPU tensors: the plain version
    assert h.dtype == torch.float32
    assert_within(h.numpy(), reference(*args), scale(*args))


@pytest.mark.parametrize("fn", [ref.mamba_scan_ref, ms.mamba_scan],
                         ids=["plain", "wrapper"])
@pytest.mark.parametrize("h0", [False, True], ids=["zero", "h0"])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_matches_reference(fn, h0, shape):
    check(fn, operands(*shape, seed=sum(shape), h0=h0))


@pytest.mark.parametrize("fn", [ref.mamba_scan_ref, ms.mamba_scan],
                         ids=["plain", "wrapper"])
@pytest.mark.parametrize("h0", [False, True], ids=["zero", "h0"])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_one_step_matches_reference(fn, h0, shape):
    """S = 1: a decode step, from the cached state or from zero."""
    b, _, d, n = shape
    check(fn, operands(b, 1, d, n, seed=n, h0=h0))


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_state_carries_across_calls(shape):
    """Two calls over the halves of a sequence, the second from the first's
    last state, give the states of one call over all."""
    np_args = operands(*shape, seed=7, h0=True)
    s = scale(*np_args)
    decay, drive, h0 = torch_args(*np_args)
    half = shape[1] // 2
    h = ms.mamba_scan(decay, drive, h0)
    h1 = ms.mamba_scan(decay[:, :half].contiguous(),
                       drive[:, :half].contiguous(), h0)
    h2 = ms.mamba_scan(decay[:, half:].contiguous(),
                       drive[:, half:].contiguous(), h1[:, -1].contiguous())
    assert_within(torch.cat([h1, h2], 1).numpy(), h.numpy(), s)


def test_plain_version_is_float64_for_float64():
    np_args = operands(1, 5, 6, 4, seed=1, h0=True)
    args = torch_args(*np_args)
    h = ref.mamba_scan_ref(*(a.double() for a in args))
    assert h.dtype == torch.float64
    assert_within(ref.mamba_scan_ref(*args).numpy(), h.numpy(),
                  scale(*np_args))


def _bad(change):
    """The wrapper's operands for (1, 4, 6, 4) with one of them changed."""
    decay, drive, h0 = torch_args(*operands(1, 4, 6, 4, seed=2, h0=True))
    ops = dict(decay=decay, drive=drive, h0=h0)
    ops.update(change(ops))
    return ops


@pytest.mark.parametrize("change,error,match", [
    (lambda o: {"decay": o["decay"].double()}, TypeError, "float32"),
    (lambda o: {"drive": o["drive"].double()}, TypeError, "float32"),
    (lambda o: {"h0": o["h0"].double()}, TypeError, "float32"),
    (lambda o: {"drive": o["drive"][:, :3]}, ValueError, "shape"),
    (lambda o: {"h0": o["h0"][..., :2]}, ValueError, "shape"),
    (lambda o: {"decay": o["decay"][0]}, ValueError, "shape"),
    (lambda o: {"drive": o["drive"].transpose(2, 3).contiguous()
                .transpose(2, 3)}, ValueError, "contiguous"),
    (lambda o: {"h0": o["h0"].transpose(1, 2).contiguous().transpose(1, 2)},
     ValueError, "contiguous"),
    (lambda o: {k: torch.zeros(1, 0, 6, 4) for k in ("decay", "drive")},
     ValueError, "S ≥ 1"),
], ids=["decay_float64", "drive_float64", "h0_float64", "drive_shape",
        "h0_shape", "decay_3d", "drive_not_contiguous", "h0_not_contiguous",
        "s_0"])
def test_wrapper_raises_on_what_the_kernel_does_not_take(change, error,
                                                         match):
    ops = _bad(change)
    with pytest.raises(error, match=match):
        ms.mamba_scan(ops["decay"], ops["drive"], ops["h0"])


def test_wrapper_refuses_operands_on_two_devices():
    decay, drive, h0 = torch_args(*operands(1, 4, 6, 4, seed=3, h0=True))
    with pytest.raises(ValueError, match="several devices"):
        ms.mamba_scan(decay, drive, h0.to("meta"))

"""The MoE router's plain version and the CPU route of its wrapper against
the JAX reference: its Pallas kernel ``repro.kernels.moe_router.moe_topk``
in interpret mode and its oracle ``repro.kernels.ref.moe_topk_ref``
(``lax.top_k``). ``repro.kernels`` imports on this jax, so the reference
runs in this process. The CUDA kernel itself runs only on the card:
``chip_smoke.py`` holds it against this plain version there.

Tolerances: ids EQUAL; gates within atol 1e-6 (they are probabilities,
≤ 1, renormalised over k ≤ 8 of them: both sides round a softmax and a
sum of ≤ 8 terms, ≈ 1e-7; a wrong expert or a missing renormalisation
moves them by ≥ 1e-3). Ids can only differ where two probabilities of a
row lie within the two packages' rounding (an ulp or two) of each other,
so each input's smallest gap between neighbours among its k + 1 largest
probabilities, relative to the larger one, is asserted to be above 1e-6
(8 float32 ulps); the tie rows are exact ties, which both sides break
toward the lower index.

The CUDA kernel's selection (``csrc/moe_router.cu``: keys bits(p) + 1,
taken → 0, each round the max key over the row's lanes, then the min
index among the lanes that hold it, each lane offering the lowest index
of its slots that hold the max) is replayed in torch on the plain
version's probabilities, in the lanes and slots of the instance a shape
takes: its ids must EQUAL the plain version's, on exact ties, on rows
whose top k hold underflowed zeros, and at E = 40 (not a multiple of 32)
and k = E.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import moe_router as jmr
from repro.kernels import ref as jref
from repro_torch.kernels import moe_router as mr
from repro_torch.kernels import ref

GATE_ATOL = 1e-6
MIN_REL_GAP = 1e-6  # 8 float32 ulps

# the reference's own sweep (tests/test_kernels.py) and the model's shape
SHAPES = [(100, 8, 2), (500, 16, 6), (64, 64, 8), (257, 128, 1),
          (300, 64, 6)]


def _ties() -> np.ndarray:
    """Rows of exact ties: all equal, ties inside the top k, and a tie
    across the k-th place."""
    x = np.zeros((4, 8), np.float32)
    x[1] = [1, 1, 0, 0, 1, 2, 2, 0]
    x[2] = [-1, 5, 5, 5, 5, -1, 0, 5]
    x[3] = [3, 0, 2, 2, 0, 3, 2, 1]
    return x


def _reference(logits: np.ndarray, k: int):
    gates, ids = jmr.moe_topk(jnp.asarray(logits), k, tile_t=128)
    r_gates, r_ids = jref.moe_topk_ref(jnp.asarray(logits), k)
    np.testing.assert_array_equal(np.asarray(ids), np.asarray(r_ids))
    return np.asarray(gates), np.asarray(ids)


def _smallest_rel_gap(logits: np.ndarray, k: int) -> float:
    p = torch.softmax(torch.from_numpy(logits).double(), dim=-1)
    top = torch.sort(p, dim=-1, descending=True).values[:, :k + 1]
    return ((top[:, :-1] - top[:, 1:]) / top[:, :-1]).min().item()


def _check(logits: np.ndarray, k: int):
    want_gates, want_ids = _reference(logits, k)
    t = torch.from_numpy(logits)
    mr.KERNEL.launches = 0
    routed = mr.moe_topk(t, k)
    assert mr.KERNEL.launches == 0          # CPU tensors: the plain version
    plain = ref.moe_topk_ref(t, k)
    for gates, ids in (routed, plain):
        assert ids.dtype == torch.int32 and gates.dtype == torch.float32
        np.testing.assert_array_equal(ids.numpy(), want_ids)
        np.testing.assert_allclose(gates.numpy(), want_gates, rtol=0,
                                   atol=GATE_ATOL)


@pytest.mark.parametrize("t,e,k", SHAPES)
def test_cpu_route_matches_pallas_kernel_and_oracle(t, e, k):
    logits = np.random.default_rng(t + e + k).standard_normal(
        (t, e)).astype(np.float32)
    assert _smallest_rel_gap(logits, min(k, e - 1)) > MIN_REL_GAP
    _check(logits, k)


@pytest.mark.parametrize("k", [1, 3, 6])
def test_exact_ties_go_to_the_lower_index(k):
    _check(_ties(), k)
    ids = mr.moe_topk(torch.from_numpy(_ties()), 3)[1]
    assert ids.tolist() == [[0, 1, 2], [5, 6, 0], [1, 2, 3], [0, 5, 2]]


def test_plain_version_computes_in_float64_for_float64():
    logits = np.random.default_rng(5).standard_normal((50, 16))
    gates, ids = ref.moe_topk_ref(torch.from_numpy(logits), 4)
    assert gates.dtype == torch.float64 and ids.dtype == torch.int32
    p = np.exp(logits - logits.max(1, keepdims=True))
    p /= p.sum(1, keepdims=True)
    want_ids = np.argsort(-p, axis=1, kind="stable")[:, :4]
    want = np.take_along_axis(p, want_ids, 1)
    np.testing.assert_array_equal(ids.numpy(), want_ids)
    np.testing.assert_allclose(gates.numpy(), want / want.sum(1, keepdims=True),
                               rtol=1e-12)


@pytest.mark.parametrize("logits,k,err", [
    (torch.zeros(4, 8, dtype=torch.float64), 2, TypeError),
    (torch.zeros(2, 4, 8), 2, ValueError),
    (torch.zeros(4, 129), 2, ValueError),
    (torch.zeros(4, 16), 9, ValueError),
    (torch.zeros(4, 4), 5, ValueError),
    (torch.zeros(4, 4), 0, ValueError)])
def test_wrapper_refuses_what_the_kernel_does_not_take(logits, k, err):
    with pytest.raises(err):
        mr.moe_topk(logits, k)


def test_wrapper_takes_no_rows():
    gates, ids = mr.moe_topk(torch.zeros(0, 64), 6)
    assert gates.shape == ids.shape == (0, 6)


def _lanes_slots(e: int, k: int):
    """The lanes a row takes and the slots a lane holds in the instance
    ``moe_topk_f32`` launches at (E, k)."""
    if (e, k) == (16, 2):
        return 16, 1
    if (e, k) == (64, 6):
        return 32, 2
    return 32, 4                       # the generic instance


def _replay_selection(p: torch.Tensor, k: int, lanes: int, slots: int):
    """The kernel's k rounds on probabilities p (T, E) float32, expert
    l + lanes·j in slot j of lane l."""
    t, e = p.shape
    key = torch.zeros(t, slots * lanes, dtype=torch.int64)
    key[:, :e] = p.view(torch.int32).to(torch.int64) + 1
    index = torch.arange(slots * lanes).view(slots, lanes)
    rows = torch.arange(t)
    ids = []
    for _ in range(k):
        per_lane = key.view(t, slots, lanes)
        top = per_lane.max(dim=1).values.max(dim=1).values        # redux max
        cand = torch.where(per_lane == top[:, None, None], index,
                           2 ** 31).min(dim=1).values              # my lowest
        win = cand.min(dim=1).values                               # redux min
        key[rows, win] = 0
        ids.append(win)
    return torch.stack(ids, dim=1).to(torch.int32)


def _selection_cases():
    rng = np.random.default_rng(11)
    ties = np.zeros((4, 64), np.float32)
    ties[1, ::3] = 1.0
    ties[2] = np.arange(64) % 4
    ties[3, 5:9] = 2.0
    under = np.zeros((3, 64), np.float32)
    under[0, :2] = 200.0             # 62 probabilities underflow to 0
    under[1, 40] = 200.0
    under[2, [3, 63]] = [200.0, 100.0]
    return {
        "ties": (ties, (1, 6, 8)),
        "underflow": (under, (6, 8)),
        "e40": (rng.standard_normal((200, 40)).astype(np.float32), (6, 8)),
        "e16": (rng.standard_normal((200, 16)).astype(np.float32), (2, 8)),
        "e64": (rng.standard_normal((200, 64)).astype(np.float32), (6, 8)),
        "e128": (rng.standard_normal((200, 128)).astype(np.float32), (1, 8)),
        "k_is_e": (rng.standard_normal((50, 8)).astype(np.float32), (8,)),
        "k_is_e_ties": (np.zeros((3, 16), np.float32), (16,)),
    }


@pytest.mark.parametrize("case", sorted(_selection_cases()))
def test_replay_of_the_kernels_key_selection(case):
    logits, ks = _selection_cases()[case]
    for width in sorted({logits.shape[1], 16, 40, 64}):
        if width > logits.shape[1]:
            continue
        x = torch.from_numpy(np.ascontiguousarray(logits[:, :width]))
        p = torch.softmax(x, dim=-1)
        for k in ks:
            if k > width:
                continue
            want = ref.moe_topk_ref(x, k)[1]
            got = _replay_selection(p, k, *_lanes_slots(width, k))
            assert torch.equal(got, want), (width, k)
            assert (got.sort(dim=1).values.diff(dim=1) > 0).all()  # no twice

"""The flash-attention kernel's plain version and the CPU route of its
wrapper against the JAX reference's oracle, ``repro.kernels.ref.
flash_attention_ref`` (naive softmax attention).

The reference's Pallas kernel does not run on this jax (``pl.load`` is
gone, ROADMAP queue 3, item b), so its jnp oracle is the reference. The
CUDA kernel itself runs only on the card: ``chip_smoke.py`` holds it
against this plain version there.

Tolerance: rtol = atol = 1e-5, float32. Both sides take a softmax over at
most a few hundred keys of unit-scale scores and sum in other orders, which
moves the outputs by ≈ 3e-7; 1e-5 leaves a margin of 30, while a wrong
mask, a wrong KV head or a missing scale moves them by ≥ 1e-2.
"""
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref

TOL = dict(rtol=1e-5, atol=1e-5)

# (B, Sq, Sk, H, Hkv, hd, causal, window, chunk)
CASES = {
    "causal_g4": (2, 40, 40, 8, 2, 16, True, 0, 0),
    "causal_g1_ragged": (1, 77, 77, 2, 2, 8, True, 0, 0),
    "window_g4": (2, 100, 100, 4, 1, 8, True, 16, 0),
    "chunk_g1": (1, 90, 90, 2, 2, 8, True, 0, 32),
    "sq_ne_sk_noncausal": (1, 20, 33, 4, 1, 8, False, 0, 0),
    "sq_ne_sk_causal": (1, 50, 30, 4, 2, 8, True, 0, 0),
    # rows 40 .. 59 have no valid key (40 − 7 > 29): the mean of v
    "rows_without_a_key": (1, 60, 30, 4, 2, 8, True, 8, 0),
    "noncausal_window": (1, 70, 45, 2, 1, 8, False, 10, 0),
    "noncausal_chunk_empty_rows": (1, 64, 20, 2, 1, 8, False, 0, 16),
    # head_dim 256 (gemma3-4b's; the kernel's third instance): a window, a
    # chunk, rows 40 .. 59 without a valid key, G = 2 off the 64-row tile
    "hd256_window_g2": (2, 70, 70, 4, 2, 256, True, 16, 0),
    "hd256_chunk_g2": (1, 90, 90, 4, 2, 256, True, 0, 32),
    "hd256_rows_without_a_key": (1, 60, 30, 4, 2, 256, True, 8, 0),
    "hd256_noncausal_g2": (1, 33, 50, 4, 2, 256, False, 0, 0),
}


def _inputs(case, seed):
    b, sq, sk, h, hkv, hd = case[:6]
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, hd)).astype(np.float32),
            rng.standard_normal((b, sk, hkv, hd)).astype(np.float32),
            rng.standard_normal((b, sk, hkv, hd)).astype(np.float32))


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_version_and_cpu_route_match_reference(name):
    case = CASES[name]
    causal, window, chunk = case[6:]
    q, k, v = _inputs(case, seed=len(name))
    want = np.asarray(jref.flash_attention_ref(
        q, k, v, causal=causal, window=window, chunk=chunk))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    kw = dict(causal=causal, window=window, chunk=chunk)
    plain = ref.flash_attention_ref(tq, tk, tv, **kw)
    fa.KERNEL.launches = 0
    routed = fa.flash_attention(tq, tk, tv, **kw)
    assert fa.KERNEL.launches == 0          # CPU tensors: the plain version
    np.testing.assert_allclose(plain.numpy(), want, **TOL)
    np.testing.assert_allclose(routed.numpy(), want, **TOL)


def test_a_row_without_a_key_gets_the_mean_of_v():
    q, k, v = _inputs(CASES["rows_without_a_key"], seed=3)
    out = fa.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=True,
                             window=8)
    g = q.shape[2] // k.shape[2]
    mean_v = np.repeat(v.mean(axis=1), g, axis=1)          # (B, H, hd)
    np.testing.assert_allclose(out[0, 40:].numpy(),
                               np.broadcast_to(mean_v[0], (20, *mean_v.shape[1:])),
                               **TOL)


def test_explicit_scale_matches_reference():
    case = CASES["causal_g4"]
    q, k, v = _inputs(case, seed=9)
    want = np.asarray(jref.flash_attention_ref(q, k, v, scale=0.3))
    got = fa.flash_attention(*map(torch.from_numpy, (q, k, v)), scale=0.3)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("bad", ["dtype", "gqa", "rank", "window"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    q, k, v = map(torch.from_numpy, _inputs(CASES["causal_g4"], seed=1))
    kw = {}
    if bad == "dtype":
        q, k, v = q.double(), k.double(), v.double()
    elif bad == "gqa":
        k, v = k[:, :, :1].expand(-1, -1, 3, -1), v[:, :, :1].expand(-1, -1, 3, -1)
    elif bad == "rank":
        q = q[0]
    else:
        kw = dict(window=-1)
    with pytest.raises((TypeError, ValueError)):
        fa.flash_attention(q, k, v, **kw)

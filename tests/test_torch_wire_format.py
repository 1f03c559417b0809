"""The port's wire codec (``repro_torch.core.wire_format``) and the channel's
fake-quant against the JAX package's, on seeded float32 payloads.

Tolerances:
* q8 and q4: codes EQUAL, scale and decode BIT-EQUAL to the reference
  (both compute absmax, absmax/levels and round(x/s) in float32, each
  operation correctly rounded);
* q1: codes EQUAL; the scale is mean|x|, a float32 sum in another order
  than XLA's. Two sums of m positive terms in different pairwise orders
  differ by at most 2·ceil(log2 m)·u relatively (u = 2⁻²⁴), which is the
  tolerance here.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import channel as ref_cc
from repro.core import wire_format as ref_wf
from repro_torch.comm import channel
from repro_torch.core import wire_format

SHAPES = [(8, 700), (64, 33), (257, 7)]


def _payload(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) * rng.uniform(0.01, 3.0)).astype(np.float32)


def _q1_rtol(m):
    return 2 * math.ceil(math.log2(max(m, 2))) * 2.0 ** -24


@pytest.mark.parametrize("bits", [8, 4, 1])
@pytest.mark.parametrize("batched", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_encode_matches_reference(bits, batched, shape):
    x = _payload(shape, seed=bits * 100 + shape[0])
    want = ref_wf.encode(jnp.asarray(x), bits, batched)
    got = wire_format.encode(torch.as_tensor(x), bits, batched)
    assert got.codes.dtype == torch.int8 and got.scale.dtype == torch.float32
    assert got.shape == tuple(want.codes.shape)
    assert tuple(got.scale.shape) == tuple(want.scale.shape)
    np.testing.assert_array_equal(got.codes.numpy(), np.asarray(want.codes))
    dec = wire_format.decode_payload(got).numpy()
    fake = channel._quantize(torch.as_tensor(x), bits, batched).numpy()
    np.testing.assert_array_equal(dec, fake)
    if bits == 1:
        m = x[0].size if batched else x.size
        np.testing.assert_allclose(got.scale.numpy(), np.asarray(want.scale),
                                   rtol=_q1_rtol(m), atol=0)
        return
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    np.testing.assert_array_equal(
        dec, np.asarray(ref_cc._quantize(jnp.asarray(x), bits, batched)))


def test_zero_message_and_block_decode():
    """An all-zero message keeps scale 0 and codes 0 (the reference divides
    by 1 there), and ``decode`` applies to any aligned block of codes and
    scales, as the kernels use it."""
    x = _payload((4, 9), seed=0)
    x[2] = 0.0
    for bits in (8, 4, 1):
        wp = wire_format.encode(torch.as_tensor(x), bits, True)
        ref = ref_wf.encode(jnp.asarray(x), bits, True)
        assert float(wp.scale[2, 0]) == 0.0
        assert not wp.codes[2].any()
        np.testing.assert_array_equal(wp.codes.numpy(), np.asarray(ref.codes))
        block = wire_format.decode(wp.codes[1:3, 2:5], wp.scale[1:3])
        np.testing.assert_array_equal(
            block.numpy(), wire_format.decode_payload(wp)[1:3, 2:5].numpy())
    assert channel.decode_block is wire_format.decode

"""The port's fused wire kernels (``repro_torch.kernels.netes_fused_mixing``),
the wire and edge-mask cases of ``topology_repr``, and the channel-aware
representation choice, against the JAX package.

On the CPU the kernel wrappers run their plain versions (``kernels/ref.py``);
``chip_smoke.py`` holds the CUDA kernels against those on the card. Here the
plain versions meet the reference's Pallas kernels in interpret mode (as
tests/test_fused_mixing.py runs them), its XLA lowering and its jnp oracles.

Tolerances:
* ``fused_neighbor_sum``: rtol = atol = 2e-5, the reference's own between
  its kernel and oracle (tests/test_fused_mixing.py:129): ≤ 2N float32
  products of codes ≤ 127 and folded weights ≲ 1e-2, summed in another
  order;
* ``fused_broadcast_select``: EXACT (one product codes · scale per element,
  then a select);
* the weighted sums with edge masks and wire payloads: rtol = atol = 1e-5,
  as tests/test_torch_mixing.py's weighted sums;
* representation choice: EQUAL.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_ref import port_topology
from repro.comm import channel as ref_cc
from repro.core import topology as ref_topology
from repro.core import topology_repr as ref_repr
from repro.core import wire_format as ref_wf
from repro.kernels import netes_fused_mixing as ref_nfm
from repro.kernels import ref as ref_oracles
from repro_torch.comm import channel
from repro_torch.core import topology_repr, wire_format
from repro_torch.kernels import netes_fused_mixing as nfm
from repro_torch.kernels import ref

D = 700          # not a multiple of the Pallas kernels' 512-wide tile
TOL = dict(rtol=2e-5, atol=2e-5)


def _sparse_case(n, seed, bits=8, density=0.3):
    rng = np.random.default_rng(seed)
    ref_topo = ref_repr.from_spec(ref_topology.TopologySpec(
        family="erdos_renyi", n_agents=n, p=density, seed=seed), "sparse")
    coeff = rng.normal(size=n).astype(np.float32)
    x = rng.normal(size=(n, D)).astype(np.float32)
    wp = ref_wf.encode(jnp.asarray(x), bits, True)
    return ref_topo, coeff, x, wp


@pytest.mark.parametrize("n", [8, 64, 257])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("bits", [8, 4])
def test_fused_neighbor_sum_matches_pallas_xla_and_oracle(n, masked, bits):
    ref_topo, coeff, _, wp = _sparse_case(n, seed=n + bits, bits=bits)
    em = (np.asarray(ref_cc.dropout_mask(jax.random.PRNGKey(n), ref_topo,
                                         0.4)) if masked else None)
    args = (ref_topo.neighbor_idx, ref_topo.neighbor_mask,
            jnp.asarray(coeff), wp.codes, wp.scale,
            None if em is None else jnp.asarray(em))
    got = nfm.fused_neighbor_sum(
        torch.tensor(np.asarray(ref_topo.neighbor_idx)),
        torch.tensor(np.asarray(ref_topo.neighbor_mask)),
        torch.as_tensor(coeff), torch.tensor(np.asarray(wp.codes)),
        torch.tensor(np.asarray(wp.scale)),
        None if em is None else torch.as_tensor(em)).numpy()
    assert got.shape == (n, D) and got.dtype == np.float32
    for name, want in (
            ("pallas", ref_nfm.fused_neighbor_sum(*args, backend="pallas",
                                                  interpret=True)),
            ("xla", ref_nfm.fused_neighbor_sum(*args, backend="xla")),
            ("oracle", ref_oracles.fused_neighbor_sum_ref(*args))):
        np.testing.assert_allclose(got, np.asarray(want), err_msg=name, **TOL)


def test_folded_weights_follow_the_reference_order():
    """ws = ((m·coeff[idx])·em)·scale[idx], bit for bit with the
    reference's ``_folded_weights``."""
    ref_topo, coeff, _, wp = _sparse_case(64, seed=1)
    em = np.asarray(ref_cc.dropout_mask(jax.random.PRNGKey(2), ref_topo, 0.3))
    want = ref_nfm._folded_weights(ref_topo.neighbor_idx,
                                   ref_topo.neighbor_mask, jnp.asarray(coeff),
                                   wp.scale, jnp.asarray(em))
    got = ref.folded_weights(
        torch.tensor(np.asarray(ref_topo.neighbor_idx)),
        torch.tensor(np.asarray(ref_topo.neighbor_mask)),
        torch.as_tensor(coeff), torch.tensor(np.asarray(wp.scale)),
        torch.as_tensor(em))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("flag", [True, False])
@pytest.mark.parametrize("bits", [8, 4, 1])
def test_broadcast_select_is_exact(flag, bits):
    rng = np.random.default_rng(bits)
    theta = rng.normal(size=(33, D)).astype(np.float32)
    best = rng.normal(size=(D,)).astype(np.float32)
    wp = ref_wf.encode(jnp.asarray(best), bits, False)
    args = (wp.codes, wp.scale, jnp.asarray(flag), jnp.asarray(theta))
    got = nfm.fused_broadcast_select(
        torch.tensor(np.asarray(wp.codes)),
        torch.tensor(np.asarray(wp.scale)), torch.tensor(flag),
        torch.as_tensor(theta)).numpy()
    plain = ref.broadcast_select_ref(
        torch.tensor(np.asarray(wp.codes)),
        torch.tensor(np.asarray(wp.scale)), torch.tensor(flag),
        torch.as_tensor(theta)).numpy()
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(got, np.asarray(
        ref_nfm.fused_broadcast_select(*args, backend="pallas",
                                       interpret=True)))
    np.testing.assert_array_equal(got, np.asarray(
        ref_oracles.broadcast_select_ref(*args)))


def _topologies(n, p=0.3, seed=0):
    for family, rep in (("erdos_renyi", "dense"), ("erdos_renyi", "sparse"),
                        ("circulant_erdos_renyi", "circulant")):
        ref_topo = ref_repr.from_spec(ref_topology.TopologySpec(
            family=family, n_agents=n, p=p, seed=seed), rep)
        yield rep, ref_topo, port_topology(ref_topo)


@pytest.mark.parametrize("n", [8, 64])
def test_masked_and_wire_weighted_sums_match_reference(n):
    """``weighted_neighbor_sum``/``weighted_row_sum`` with an edge mask, and
    with a ``WirePayload`` (sparse: the fused kernel; dense and circulant:
    decode and recurse), on every representation."""
    rng = np.random.default_rng(n)
    coeff = rng.normal(size=n).astype(np.float32)
    values = rng.normal(size=(n, 9)).astype(np.float32)
    for rep, ref_topo, topo in _topologies(n, seed=n):
        em = np.asarray(ref_cc.dropout_mask(jax.random.PRNGKey(n + 1),
                                            ref_topo, 0.3))
        for mask in (None, em):
            jm = None if mask is None else jnp.asarray(mask)
            tm = None if mask is None else torch.as_tensor(mask)
            want = ref_repr.weighted_neighbor_sum(
                ref_topo, jnp.asarray(coeff), jnp.asarray(values), jm)
            got = topology_repr.weighted_neighbor_sum(
                topo, torch.as_tensor(coeff), torch.as_tensor(values), tm)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       err_msg=rep, rtol=1e-5, atol=1e-5)
            want = ref_repr.weighted_row_sum(ref_topo, jnp.asarray(coeff), jm)
            got = topology_repr.weighted_row_sum(
                topo, torch.as_tensor(coeff), tm)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       err_msg=rep, rtol=1e-5, atol=1e-5)
            ref_wp = ref_wf.encode(jnp.asarray(values), 8, True)
            wp = wire_format.encode(torch.as_tensor(values), 8, True)
            want = ref_repr.weighted_neighbor_sum(ref_topo, jnp.asarray(coeff),
                                                  ref_wp, jm)
            got = topology_repr.weighted_neighbor_sum(
                topo, torch.as_tensor(coeff), wp, tm)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       err_msg=f"wire {rep}", rtol=1e-5,
                                       atol=1e-5)


@pytest.mark.parametrize("text", [None, "quantize(bits=8)",
                                  "quantize(bits=8)|dropout(p=0.1)",
                                  "topk(frac=0.5)|quantize(bits=4)",
                                  "quantize(bits=8)|topk(frac=0.5)"])
@pytest.mark.parametrize("fused", [True, False])
def test_select_representation_with_channel_matches_reference(text, fused):
    """The fused cutoff (0.5·N) picks sparse where the reference does: ER
    graphs around both cutoffs, and fully connected."""
    n = 64
    ref_ch = None if text is None else ref_cc.compile_channel(text, n, fused)
    ch = None if text is None else channel.compile_channel(text, n, fused)
    picks = []
    for family, p in (("erdos_renyi", 0.15), ("erdos_renyi", 0.3),
                      ("erdos_renyi", 0.4), ("erdos_renyi", 0.7),
                      ("fully_connected", 1.0)):
        adj = ref_topology.TopologySpec(family=family, n_agents=n, p=p,
                                        seed=0).build()
        want = ref_repr.select_representation(adj, channel=ref_ch)
        assert topology_repr.select_representation(adj, channel=ch) == want
        spec = topology_repr.topo_gen.TopologySpec(family=family, n_agents=n,
                                                   p=p, seed=0)
        assert topology_repr.from_spec(spec, device="cpu",
                                       channel=ch).kind == want
        picks.append(want)
    # p = 0.3 has K_max = 27, between 0.25·N and 0.5·N
    fused_cut = ch is not None and ch.fused and ch.wire_quantized
    assert picks[1] == ("sparse" if fused_cut else "dense")


def test_fused_wrappers_reject_what_the_kernels_do_not_take():
    meta = torch.empty(4, 4, device="meta")
    # meta operands take the shape-only path: an empty result, no launch
    out = nfm.fused_neighbor_sum(meta.int(), meta, meta[0],
                                 meta.to(torch.int8),
                                 meta[:, :1].contiguous())
    assert out.device.type == "meta" and out.shape == (4, 4)
    out = nfm.fused_broadcast_select(meta[0].to(torch.int8), meta[0, :1],
                                     meta[0, 0].bool(), meta)
    assert out.device.type == "meta" and out.shape == (4, 4)
    with pytest.raises(ValueError, match="several devices"):
        nfm.fused_broadcast_select(torch.zeros(4, dtype=torch.int8),
                                   torch.ones(1), torch.tensor(True), meta)

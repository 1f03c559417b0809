"""The port's lossy channel (``repro_torch.comm.channel``) against the JAX
package's ``repro.comm.channel``, with the reference's own dropout masks
injected where the two must agree step for step.

Tolerances:
* spec parsing, labels, ``wire_quantized``, ``wire_fused``, byte models,
  realized message counts, trigger and drop fractions: EQUAL (counts are
  integers far below 2²⁴ in float32);
* payloads after quantize (q8, q4), topk and event stages: BIT-EQUAL (the
  same float32 operations on the same inputs; top-k breaks ties in
  magnitude toward the lower index, as ``lax.top_k`` does, which a topk
  after a quantize meets on every message); q1 payloads: the q1 scale's
  tolerance of tests/test_torch_wire_format.py;
* the port's own dropout mask: EXACT properties (symmetric, self-loops
  kept, one link fate in every representation), and a drop rate within
  five binomial standard deviations of p.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_ref import port_topology, reference_edge_mask
from repro.comm import channel as ref_cc
from repro.core import topology as ref_topology
from repro.core import topology_repr as ref_repr
from repro_torch import convert
from repro_torch.comm import channel
from repro_torch.comm.channel import ChannelSpec
from repro_torch.core import topology_repr, wire_format

N = 24
SPECS = ["lossless", "quantize(bits=8)", "quantize(bits=4)",
         "quantize(bits=1)", "topk(frac=0.25)", "dropout(p=0.3,seed=2)",
         "event_triggered(threshold=0.5)|quantize(bits=8)",
         "quantize(bits=8)|dropout(p=0.1,seed=0)",
         "topk(frac=0.5)|quantize(bits=4)|dropout(p=0.2,seed=1)",
         "quantize(bits=8)|topk(frac=0.5)",
         "event_triggered(threshold=0.01)|quantize(bits=4)|dropout(p=0.1,"
         "seed=0)"]
REPS = ["dense", "sparse", "circulant"]


def _ref_topo(rep, n=N, p=0.3, seed=0):
    family = "circulant_erdos_renyi" if rep == "circulant" else "erdos_renyi"
    return ref_repr.from_spec(ref_topology.TopologySpec(
        family=family, n_agents=n, p=p, seed=seed), rep)


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("text", SPECS + [
    "lossless|quantize(bits=8)", " quantize ( bits=4 ) ",
    "topk(frac=0.1)|dropout(p=0.05,seed=7)"])
def test_parse_and_label_match_reference(text):
    got, want = ChannelSpec.parse(text), ref_cc.ChannelSpec.parse(text)
    assert got.label() == want.label()
    assert got.lossless == want.lossless
    assert [_fields(s) for s in got.stages] == \
        [_fields(s) for s in want.stages]
    # written back out with every argument, the spec parses to itself
    text_out = "|".join(
        f"{s.kind}(bits={s.bits},frac={s.frac!r},threshold={s.threshold!r},"
        f"p={s.p!r},seed={s.seed})" for s in got.stages) or "lossless"
    assert ChannelSpec.parse(text_out) == got


def _fields(stage):
    return (stage.kind, stage.bits, stage.frac, stage.threshold, stage.p,
            stage.seed)


@pytest.mark.parametrize("text", [
    "quantize(bits=3)", "warp(x=1)", "dropout(p=1.5)", "topk(frac=0)",
    "dropout(p=0.1)|dropout(p=0.2)", "quantize(0.5)",
    "event_triggered(threshold=-1)", "quantize(bits=8,nope=1)",
    "event_triggered(threshold=0.1)|event_triggered(threshold=0.2)"])
def test_parse_rejects_what_the_reference_rejects(text):
    with pytest.raises(ValueError):
        ref_cc.ChannelSpec.parse(text)
    with pytest.raises(ValueError):
        ChannelSpec.parse(text)


@pytest.mark.parametrize("text", SPECS)
@pytest.mark.parametrize("fused", [True, False])
def test_channel_properties_match_reference(text, fused):
    got = channel.compile_channel(text, N, fused=fused)
    want = ref_cc.compile_channel(text, N, fused=fused)
    assert got.lossless == want.lossless
    assert got.wire_quantized == want.wire_quantized
    assert got.elem_bytes == want.elem_bytes
    assert got.payload_bytes(4481) == want.payload_bytes(4481)
    for rep in REPS:
        ref_topo = _ref_topo(rep)
        assert got.wire_fused(port_topology(ref_topo)) == \
            want.wire_fused(ref_topo), rep
    assert got.transforms_payload == any(
        s.kind in ("quantize", "topk", "event_triggered")
        for s in want.spec.stages)
    assert channel.compile_channel(None, N).lossless


# ---------------------------------------------------------------------------
# one channel step
# ---------------------------------------------------------------------------

def _assert_payload_equal(got, want, text, batched_m):
    if "bits=1" in text:
        rtol = 2 * int(np.ceil(np.log2(batched_m))) * 2.0 ** -24
        np.testing.assert_allclose(got, want, rtol=rtol, atol=0)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("rep", REPS)
@pytest.mark.parametrize("text", SPECS)
def test_apply_matches_reference(text, rep):
    """Two steps of ``apply`` (and of ``apply_wire`` where the pipeline is
    wire-encodable) from the same state, with the reference's masks."""
    d = 33
    rng = np.random.default_rng(len(text) + len(rep))
    ref_topo = _ref_topo(rep)
    topo = port_topology(ref_topo)
    ref_ch = ref_cc.compile_channel(text, N)
    ch = channel.compile_channel(text, N)
    payload0 = rng.normal(size=(N, d)).astype(np.float32)
    ref_state = ref_ch.init(jnp.asarray(payload0))
    state = ch.init(torch.as_tensor(payload0))
    for step in range(2):
        # the second payload moves half of the rows by far less than the
        # event threshold and the rest by far more
        x = (payload0 if step == 0 else payload0 + np.where(
            np.arange(N)[:, None] % 2 == 0, 1e-4, 2.0).astype(np.float32)
             * rng.normal(size=(N, d)).astype(np.float32))
        em = reference_edge_mask(ref_ch, ref_state, ref_topo)
        em_t = None if em is None else torch.tensor(em)
        wire_ok = ref_ch.wire_quantized
        if wire_ok:
            ref_wp, _, _, _ = ref_ch.apply_wire(ref_state, ref_topo,
                                                jnp.asarray(x))
            wp, _, _, _ = ch.apply_wire(state, topo, torch.as_tensor(x),
                                        edge_mask=em_t)
            assert isinstance(wp, wire_format.WirePayload)
            np.testing.assert_array_equal(wp.codes.numpy(),
                                          np.asarray(ref_wp.codes))
            _assert_payload_equal(wp.scale.numpy(), np.asarray(ref_wp.scale),
                                  text, d)
        ref_out, ref_mask, ref_state, ref_info = ref_ch.apply(
            ref_state, ref_topo, jnp.asarray(x))
        out, mask, state, info = ch.apply(state, topo, torch.as_tensor(x),
                                          edge_mask=em_t)
        where = f"{text} {rep} step {step}"
        _assert_payload_equal(out.numpy(), np.asarray(ref_out), text, d)
        assert (mask is None) == (ref_mask is None), where
        if mask is not None:
            np.testing.assert_array_equal(mask.numpy(), np.asarray(ref_mask))
        for k in ("msgs", "trigger_frac", "drop_frac"):
            assert float(info[k]) == float(ref_info[k]), (where, k)
        assert float(state.msgs) == float(ref_state.msgs), where
        if ch.event_stage is not None:
            _assert_payload_equal(state.last_sent.numpy(),
                                  np.asarray(ref_state.last_sent), text, d)
            if step == 1:
                assert 0.0 < float(info["trigger_frac"]) < 1.0, where
        assert int(state.draws) == step + 1 if ch.dropout_stage else \
            int(state.draws) == 0


@pytest.mark.parametrize("text", ["quantize(bits=8)", "quantize(bits=4)",
                                  "topk(frac=0.25)|quantize(bits=8)",
                                  "quantize(bits=8)|topk(frac=0.5)"])
def test_codec_and_encode_wire_match_reference(text):
    """The broadcast payload's codec: one unbatched message."""
    x = np.random.default_rng(4).normal(size=(4481,)).astype(np.float32)
    got = channel.compile_channel(text, N).codec(torch.as_tensor(x))
    want = ref_cc.compile_channel(text, N).codec(jnp.asarray(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    ch = channel.compile_channel(text, N)
    if not ch.wire_quantized:
        with pytest.raises(ValueError, match="wire"):
            ch.encode_wire(torch.as_tensor(x))
        return
    wp = ch.encode_wire(torch.as_tensor(x))
    ref_wp = ref_cc.compile_channel(text, N).encode_wire(jnp.asarray(x))
    np.testing.assert_array_equal(wp.codes.numpy(), np.asarray(ref_wp.codes))
    np.testing.assert_array_equal(wp.scale.numpy(), np.asarray(ref_wp.scale))
    assert tuple(wp.scale.shape) == (1,)


def test_apply_rejects_what_it_cannot_do():
    topo = port_topology(_ref_topo("sparse"))
    x = torch.zeros(N, 5)
    ch = channel.compile_channel("quantize(bits=8)", N)
    with pytest.raises(ValueError, match="dropout stage"):
        ch.apply(ch.init(x), topo, x, edge_mask=torch.ones(N, topo.k_max))
    ch = channel.compile_channel("quantize(bits=8)|topk(frac=0.5)", N)
    with pytest.raises(ValueError, match="wire-encodable"):
        ch.apply_wire(ch.init(x), topo, x)


@pytest.mark.parametrize("rep", REPS)
def test_realized_messages_match_reference(rep):
    ref_topo = _ref_topo(rep, n=40, p=0.25, seed=3)
    topo = port_topology(ref_topo)
    trig = np.random.default_rng(5).random(40) < 0.6
    key = jax.random.PRNGKey(9)
    em = np.asarray(ref_cc.dropout_mask(key, ref_topo, 0.35))
    for mask, tr in ((None, None), (em, None), (None, trig), (em, trig)):
        want = ref_cc.realized_messages(
            ref_topo, None if mask is None else jnp.asarray(mask),
            None if tr is None else jnp.asarray(tr))
        got = channel.realized_messages(
            topo, None if mask is None else torch.as_tensor(mask),
            None if tr is None else torch.as_tensor(tr))
        assert float(got) == float(want)


# ---------------------------------------------------------------------------
# the port's own dropout PRF
# ---------------------------------------------------------------------------

def test_dropout_mask_properties():
    """Symmetric; self-loops kept; the same link fate in dense, sparse and
    circulant form; a new mask per draw; and a drop rate within five
    binomial standard deviations of p over the links of a 300-agent
    graph and 8 draws."""
    n, p = 300, 0.3
    ref_dense = _ref_topo("dense", n=n, p=0.2, seed=1)
    dense, sparse = (port_topology(ref_dense),
                     port_topology(ref_repr.from_dense(
                         np.asarray(ref_dense.adj), "sparse")))
    adj = dense.adj.numpy()
    seed = torch.tensor(5, dtype=torch.int64)
    links, dropped, masks = 0, 0, []
    for draw in range(8):
        key = channel.step_key(seed, torch.tensor(draw))
        m = channel.dropout_mask(key, dense, p).numpy()
        np.testing.assert_array_equal(m, m.T)
        np.testing.assert_array_equal(np.diag(m), np.ones(n))
        assert set(np.unique(m)) <= {0.0, 1.0}
        ms = channel.dropout_mask(key, sparse, p).numpy()
        idx = sparse.neighbor_idx.numpy()
        np.testing.assert_array_equal(ms, m[np.arange(n)[:, None], idx])
        iu = np.triu_indices(n, 1)
        live = adj[iu] != 0
        links += int(live.sum())
        dropped += int((m[iu][live] == 0).sum())
        masks.append(m)
    assert not np.array_equal(masks[0], masks[1])
    sd = np.sqrt(p * (1 - p) / links)
    assert abs(dropped / links - p) <= 5 * sd, (dropped / links, sd)

    ref_circ = _ref_topo("circulant", n=64, p=0.3, seed=2)
    circ = port_topology(ref_circ)
    as_dense = port_topology(ref_repr.from_dense(
        np.asarray(ref_circ.to_dense()), "dense"))
    key = channel.step_key(seed, torch.tensor(3))
    mc = channel.dropout_mask(key, circ, p).numpy()
    md = channel.dropout_mask(key, as_dense, p).numpy()
    j = np.arange(64)
    for k, d in enumerate(topology_repr.circulant_shifts(circ)):
        np.testing.assert_array_equal(mc[k], md[j, (j + d) % 64])


def test_dropout_p0_keeps_every_link_and_hash_is_exact():
    """p = 0 keeps every link; the 32-bit multiply-hash equals its Python
    integer definition (so it cannot overflow or differ by device)."""
    topo = port_topology(_ref_topo("dense"))
    key = channel.step_key(torch.tensor(0), torch.tensor(0))
    assert channel.dropout_mask(key, topo, 0.0).all()
    xs = np.random.default_rng(0).integers(0, 2 ** 32, size=1000,
                                           dtype=np.int64)
    got = channel._mix32(torch.as_tensor(xs)).numpy()

    def mix(x):
        x ^= x >> 16
        x = (x * 0x7FEB352D) & 0xFFFFFFFF
        x ^= x >> 15
        x = (x * 0x846CA68B) & 0xFFFFFFFF
        return x ^ (x >> 16)

    assert got.tolist() == [mix(int(x)) for x in xs]


def test_channel_state_from_reference():
    ref_ch = ref_cc.compile_channel(
        "event_triggered(threshold=0.1)|quantize(bits=8)|dropout(p=0.1,"
        "seed=4)", N)
    ref_state = ref_ch.init(jnp.ones((N, 6)))
    ref_state = ref_state._replace(msgs=jnp.float32(123.0))
    got = convert.channel_state_from_reference(
        np.asarray(ref_state.last_sent), np.asarray(ref_state.msgs), seed=4,
        draws=2, device="cpu")
    assert float(got.msgs) == 123.0 and int(got.draws) == 2
    assert int(got.seed) == 4
    np.testing.assert_array_equal(got.last_sent.numpy(), np.zeros((N, 6)))
    plain = ref_cc.compile_channel("quantize(bits=8)", N).init(jnp.ones(3))
    got = convert.channel_state_from_reference(plain.last_sent, plain.msgs,
                                               device="cpu")
    assert got.last_sent is None and float(got.msgs) == 0.0

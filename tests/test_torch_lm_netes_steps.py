"""The port's NetES over LM agents without the reference's dumps: the
dtypes ``loss_fn`` takes, the reference's in-process pieces (the neighbor
column, the slice stack), then the port alone (seed replay against gather,
probes, the noise contract, ``train_lm_netes`` and the ``lm`` launcher,
the wrappers' column limits, the channel over a tree, Eq. 3 on every
payload, a schedule, the serving steps). Tolerances as in
``tests/_torch_lm_netes_common.py``.
"""
import json
import math
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from _torch_lm_netes_common import NCFG
from _torch_lm_ref import NETES_CHANNEL, NETES_MODES, NETES_N
from repro.core import topology_repr as ref_topology_repr
from repro.core import wire_format as ref_wire_format
from repro_torch.comm.channel import compile_channel
from repro_torch.configs import get_config
from repro_torch.core import topology_repr, wire_format
from repro_torch.core.topology import TopologySpec
from repro_torch.core.tree import flatten, tree_map
from repro_torch.distributed import netes_dist
from repro_torch.kernels import _checks
from repro_torch.kernels import netes_fused_mixing as nfm
from repro_torch.kernels import netes_mixing as nm
from repro_torch.kernels import netes_sparse_mixing as nsm
from repro_torch.models import transformer
from repro_torch.obs import compile_probes
from repro_torch.train.loop import TrainConfig, train_lm_netes

SRC = pathlib.Path(__file__).resolve().parent.parent / "src"


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_loss_fn_takes_float32_and_float64_only(dtype):
    """float32 runs the kernel path and float64 the plain layers, which
    agree to float32's rounding; any other dtype is refused, on the CPU
    as on the card, rather than run by the plain layers unannounced."""
    cfg = get_config(SMOKE)
    params = transformer.init_params(cfg, seed=0, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 32),
                           generator=torch.Generator().manual_seed(0))
    batch = {"tokens": tokens, "labels": tokens}
    got = transformer.loss_fn(params, cfg, batch)
    want = transformer.loss_fn(tree_map(lambda t: t.double(), params), cfg,
                               batch)
    assert want.dtype == torch.float64
    np.testing.assert_allclose(got.item(), want.item(), rtol=1e-5)
    with pytest.raises(TypeError, match="float32"):
        transformer.loss_fn(tree_map(lambda t: t.to(dtype), params), cfg,
                            batch)


def test_neighbor_column_matches_reference():
    rng = np.random.default_rng(0)
    n = 12
    for family, rep in (("erdos_renyi", "dense"), ("erdos_renyi", "sparse"),
                        ("circulant_erdos_renyi", "circulant")):
        spec = TopologySpec(family=family, n_agents=n, p=0.4, seed=3)
        port = topology_repr.from_spec(spec, representation=rep,
                                       device="cpu")
        ref_topo = ref_topology_repr.from_dense(
            port.to_dense().numpy(), rep)
        assert ref_topo.kind == rep
        masks = [None]
        if rep == "dense":
            m = (rng.random((n, n)) > 0.3).astype(np.float32)
            masks.append(np.minimum(m, m.T))
        elif rep == "sparse":
            masks.append((rng.random(port.neighbor_idx.shape) > 0.3)
                         .astype(np.float32))
        else:
            masks.append((rng.random((len(topology_repr.circulant_shifts(
                port)), n)) > 0.3).astype(np.float32))
        for mask in masks:
            for i in range(n):
                got = topology_repr.neighbor_column(
                    port, i, None if mask is None else torch.as_tensor(mask))
                want = ref_topology_repr.neighbor_column(
                    ref_topo, i, None if mask is None else jax.numpy.asarray(
                        mask))
                np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_slice_stack_matches_reference():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 3, 5, 6)).astype(np.float32)
    ref_wp = ref_wire_format.encode(jax.numpy.asarray(x), 8, batched=True)
    wp = wire_format.encode(torch.as_tensor(x), 8, batched=True)
    for r in range(3):
        got = wire_format.slice_stack(wp, r)
        want = ref_wire_format.slice_stack(ref_wp, r)
        np.testing.assert_array_equal(got.codes.numpy(),
                                      np.asarray(want.codes))
        np.testing.assert_array_equal(got.scale.numpy(),
                                      np.asarray(want.scale))
        assert got.dtype == torch.float32


# ---------------------------------------------------------------------------
# the port alone
# ---------------------------------------------------------------------------

SMOKE = "gemma3-4b-smoke"


def smoke_run(mode, mixing="seed_replay", probes=None, steps=2, arch=SMOKE):
    """``steps`` steps of the port's own draws from one seed, the leaves
    cut in slabs of 50,000 columns (the embedding in several); the
    parameters and each step's metrics."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(netes_dist, "SLAB_COLUMNS", 50_000)
        return _smoke_run(mode, mixing, probes, steps, arch)


def _smoke_run(mode, mixing, probes, steps, arch):
    family, rep, chan_text = NETES_MODES[mode]
    cfg = get_config(arch)
    n = NETES_N
    topo = topology_repr.from_spec(TopologySpec(family=family, n_agents=n,
                                                p=0.5, seed=0),
                                   representation=rep, device="cpu")
    chan = compile_channel(chan_text, n) if chan_text else None
    probe = compile_probes(probes, channel=chan) if probes else None
    step = netes_dist.make_replica_train_step(
        cfg, NCFG, n, mixing=mixing, microbatch=1, topology=topo,
        channel=chan, probes=probe)
    params = netes_dist.init_population(cfg, n, seed=0, device="cpu")
    states = [s for s in (chan.init(params) if chan else None,
                          probe.init("cpu") if probe else None)
              if s is not None]
    history = []
    for t in range(steps):
        gen = torch.Generator().manual_seed(t)
        tokens = torch.randint(0, cfg.vocab_size, (n, 1, 32), generator=gen,
                               dtype=torch.int32)
        out = step(params, None, {"tokens": tokens, "labels": tokens},
                   netes_dist.draw(5, t, "cpu"), *states)
        params, metrics, states = out[0], out[1], list(out[2:])
        history.append({k: v.clone() for k, v in metrics.items()})
    return params, history, states


@pytest.mark.parametrize("mode", ["fc", "er"])
def test_seed_replay_equals_gather(mode):
    a, ha, _ = smoke_run(mode, "seed_replay")
    b, hb, _ = smoke_run(mode, "gather")
    for x, y in zip(flatten(a), flatten(b),
                    strict=True):
        assert torch.equal(x, y)
    assert all(torch.equal(m[k], n[k]) for m, n in zip(ha, hb) for k in m)


@pytest.mark.parametrize("mode, stages", [("fc", "fitness|consensus|graph"),
                                          ("chan", "all")])
def test_probed_equals_unprobed(mode, stages):
    a, ha, _ = smoke_run(mode)
    b, hb, states = smoke_run(mode, probes=stages)
    for x, y in zip(flatten(a), flatten(b),
                    strict=True):
        assert torch.equal(x, y)
    for m, p in zip(ha, hb):
        assert all(torch.equal(m[k], p[k]) for k in m)
        assert p["theta_spread"] >= 0 and p["update_var"] >= 0
    ring = states[-1]
    assert int(ring.cursor) == 2
    assert torch.isfinite(ring.buf[:, :2]).all()


def test_noise_stream_contract(monkeypatch):
    """ε of (agent, leaf, slab) is the same whenever it is drawn, and the
    streams of different agents, leaves, slabs and steps differ."""
    s = netes_dist.NoiseStream(seed=3, step=2)
    a, b = torch.empty(100), torch.empty(100)
    s(a, 1, 2, 0, 0)
    s(b, 1, 2, 0, 0)
    assert torch.equal(a, b)
    for args, other in (((0, 2, 0), s), ((1, 3, 0), s), ((1, 2, 1), s),
                        ((1, 2, 0), netes_dist.NoiseStream(seed=3, step=1))):
        c = torch.empty(100)
        other(c, *args, 0)
        assert not torch.equal(a, c)
    monkeypatch.setattr(netes_dist, "SLAB_COLUMNS", 8)
    pert = netes_dist.perturb_params({"w": torch.zeros(10, 3)}, s, 1, 0.5)
    e0, e1 = torch.empty(8), torch.empty(2)
    s(e0, 1, 0, 0, 0)
    s(e1, 1, 0, 1, 8)
    assert torch.equal(pert["w"].reshape(-1)[:8], 0.5 * e0)
    assert torch.equal(pert["w"].reshape(-1)[8:10], 0.5 * e1)


def test_train_lm_netes_runs_and_is_deterministic():
    tc = TrainConfig(n_agents=4, iters=3, density=0.5, seed=2,
                     channel=NETES_CHANNEL, probes="all", netes=NCFG)
    h1 = train_lm_netes(get_config(SMOKE), tc, seq_len=32, device="cpu")
    h2 = train_lm_netes(get_config(SMOKE), tc, seq_len=32, device="cpu")
    assert h1["loss_mean"] == h2["loss_mean"]
    assert len(h1["loss_mean"]) == 3 and "step_ms" not in h1
    assert all(math.isfinite(v) for v in h1["loss_mean"])
    assert h1["probes"]["cursor"] == 3


def test_launch_lm_exits_zero_with_finite_losses(tmp_path):
    out = tmp_path / "lm.json"
    env = dict(os.environ, PYTHONPATH=str(SRC))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "lm", "--arch",
         "gemma3-4b-smoke", "--agents", "4", "--iters", "2", "--seq-len",
         "32", "--device", "cpu", "--out", str(out)],
        env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    assert "loss:" in res.stdout
    hist = json.loads(out.read_text())["history"]
    assert len(hist["loss_mean"]) == 2
    assert all(math.isfinite(v) for v in hist["loss_mean"])


# ---------------------------------------------------------------------------
# the kernels' column ranges
# ---------------------------------------------------------------------------

def _wide(n, cols, dtype=torch.float32):
    """An (n, cols) tensor that allocates one element (stride 0)."""
    return torch.zeros(1, dtype=dtype).expand(n, cols)


@pytest.mark.parametrize("kernel", ["netes_mixing", "netes_sparse_mixing",
                                    "fused_neighbor_sum",
                                    "fused_broadcast_select"])
def test_wrappers_refuse_columns_their_kernels_cannot_address(kernel):
    n = 8
    idx = torch.zeros(n, 2, dtype=torch.int32)
    mask = torch.ones(n, 2)
    w = torch.ones(n)
    calls = {
        "netes_mixing": (nm.MAX_COLUMNS, lambda c: nm.netes_mixing(
            torch.ones(n, n), w, w, _wide(n, c), _wide(n, c), sigma=1.0)),
        "netes_sparse_mixing": (_checks.SLAB_MAX_COLUMNS,
                                lambda c: nsm.netes_sparse_mixing(
                                    idx, mask, w, w, _wide(n, c),
                                    _wide(n, c), sigma=1.0)),
        "fused_neighbor_sum": (_checks.SLAB_MAX_COLUMNS,
                               lambda c: nfm.fused_neighbor_sum(
                                   idx, mask, w, _wide(n, c, torch.int8),
                                   torch.ones(n, 1))),
        "fused_broadcast_select": (nfm.SELECT_MAX_COLUMNS,
                                   lambda c: nfm.fused_broadcast_select(
                                       _wide(1, c, torch.int8)[0],
                                       torch.ones(1), torch.tensor(True),
                                       _wide(n, c))),
    }
    limit, call = calls[kernel]
    for cols in (limit + 1, 2**31, 2**33):
        with pytest.raises(ValueError, match="column index"):
            call(cols)
    # the embedding of gemma3-4b, one slab of the replica step, fits
    assert netes_dist.SLAB_COLUMNS <= limit
    assert nfm.SELECT_MAX_COLUMNS == 65535 * 512
    assert nm.MAX_COLUMNS == 2**31 - 1 - nm.BN


@pytest.mark.parametrize("bits", [8, 4, 1])
def test_encode_columns_equals_encode(bits):
    x = torch.randn(5, 3, 7, generator=torch.Generator().manual_seed(bits))
    x[2] = 0.0
    want = wire_format.encode(x, bits, batched=True)
    for cols in (1, 4, 21, 100):
        got = wire_format.encode_columns(x, bits, cols)
        assert torch.equal(got.codes, want.codes)
        assert torch.equal(got.scale, want.scale)
        assert got.scale.shape == (5, 1, 1)


def test_channel_takes_a_tree_as_one_message_an_agent():
    """Quantize per leaf and agent; the event trigger on the RMS over all
    of an agent's leaves; one drop mask for the whole tree."""
    gen = torch.Generator().manual_seed(0)
    tree = {"a": torch.randn(4, 3, generator=gen),
            "b": [torch.randn(4, 2, 2, generator=gen)]}
    topo = topology_repr.from_spec(TopologySpec(
        family="erdos_renyi", n_agents=4, p=0.5, seed=0),
        representation="sparse", device="cpu")
    chan = compile_channel("quantize(bits=8)|dropout(p=0.3,seed=1)", 4)
    single = compile_channel("quantize(bits=8)|dropout(p=0.3,seed=1)", 4)
    out, mask, _, info = chan.apply(chan.init(tree), topo, tree)
    lone, lone_mask, _, _ = single.apply(single.init(tree["a"]), topo,
                                         tree["a"])
    assert torch.equal(out["a"], lone) and torch.equal(mask, lone_mask)
    b_lone = single.apply(single.init(tree["b"][0]), topo, tree["b"][0])[0]
    assert torch.equal(out["b"][0], b_lone)
    wire = chan.apply_wire(chan.init(tree), topo, tree)[0]
    assert torch.equal(wire_format.decode_payload(wire["b"][0]),
                       out["b"][0])
    event = compile_channel("event_triggered(threshold=0.9)", 4)
    sent, _, state, info = event.apply(event.init(tree), topo, tree)
    flat = torch.cat([tree["a"], tree["b"][0].reshape(4, -1)], dim=1)
    rms = flat.pow(2).mean(dim=1).sqrt()
    fired = rms > 0.9
    assert torch.equal(info["trigger_frac"], fired.float().mean())
    for leaf, new in ((tree["a"], sent["a"]), (tree["b"][0], sent["b"][0])):
        keep = fired.reshape((4,) + (1,) * (leaf.ndim - 1))
        assert torch.equal(new, torch.where(keep, leaf,
                                            torch.zeros_like(leaf)))
    assert state.last_sent["b"][0] is sent["b"][0]


# ---------------------------------------------------------------------------
# the mixing dispatch and the remaining step cases
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rep", ["dense", "sparse", "circulant"])
@pytest.mark.parametrize("payload", ["theta", "quantized", "wire",
                                     "wire_eps"])
def test_mixer_is_eq3_on_every_payload(rep, payload):
    """``_Mixer`` against Eq. 3 written out with the plain neighbor sums:
    Σ_i a_ji em_ji (w_θi x_i + σ w_εi e_i) − (Σ_i a_ji em_ji w_θi) θ_j,
    for θ itself, a fake-quantized θ (the dense and sparse kernels on x
    with the wsum·(x − θ) correction), its wire form (the fused sum on a
    sparse graph, decoded otherwise) and wire forms of θ and ε (gather
    mode through a quantizing channel); with a dropout mask. rtol = atol
    = 1e-5: float32 sums of ≤ 2N terms of ≈ 1 in other orders."""
    n, p, sigma = 9, 37, 0.3
    gen = torch.Generator().manual_seed(11)
    family = "circulant_erdos_renyi" if rep == "circulant" else "erdos_renyi"
    topo = topology_repr.from_spec(TopologySpec(
        family=family, n_agents=n, p=0.4, seed=2), representation=rep,
        device="cpu")
    chan = compile_channel("quantize(bits=8)|dropout(p=0.3,seed=4)", n)
    theta = torch.randn(n, p, generator=gen)
    eps = torch.randn(n, p, generator=gen)
    w_theta = torch.randn(n, generator=gen)
    w_eps = torch.randn(n, generator=gen)
    _, mask, _, _ = chan.apply(chan.init(theta), topo, theta)
    wt_sum = topology_repr.weighted_row_sum(topo, w_theta, mask)
    mix = netes_dist._Mixer(topo, w_theta, w_eps, sigma, mask, wt_sum,
                            fused=True)
    wire = wire_format.encode(theta, 8, batched=True)
    wire_eps = wire_format.encode(eps, 8, batched=True)
    x, e = {"theta": (None, None),
            "quantized": (wire_format.decode_payload(wire), None),
            "wire": (wire, None), "wire_eps": (wire, wire_eps)}[payload]
    got = mix(theta, eps, x, e)
    xv = theta if x is None else (wire_format.decode_payload(x)
                                  if isinstance(x, wire_format.WirePayload)
                                  else x)
    ev = eps if e is None else wire_format.decode_payload(e)
    want = (topology_repr.weighted_neighbor_sum(topo, w_theta, xv, mask)
            + sigma * topology_repr.weighted_neighbor_sum(topo, w_eps, ev,
                                                          mask)
            - wt_sum[:, None] * theta)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_gather_mode_through_a_quantizing_channel():
    """In gather mode ε rides the wire too (the reference's codec on ε):
    the parameters move, stay finite, and differ from seed replay's."""
    a, ha, _ = smoke_run("chan", "gather")
    b, hb, _ = smoke_run("chan", "seed_replay")
    assert all(torch.isfinite(x).all() for x in flatten(a))
    assert not all(torch.equal(x, y) for x, y in zip(
        flatten(a), flatten(b), strict=True))
    assert torch.equal(ha[0]["loss_mean"], hb[0]["loss_mean"])


def test_replica_step_under_a_schedule():
    """The step mixes over the schedule's live graph and returns its
    advanced state: ``resample_er(period=1)`` redraws the list each step."""
    from repro_torch.core.topology_sched import (ScheduleSpec,
                                                 compile_schedule)
    cfg = get_config(SMOKE)
    spec = TopologySpec(family="erdos_renyi", n_agents=NETES_N, p=0.5,
                        seed=0)
    schedule = compile_schedule(ScheduleSpec.parse("resample_er(period=1)"),
                                spec, "sparse")
    sstate = schedule.init(device="cpu")
    step = netes_dist.make_replica_train_step(cfg, NCFG, NETES_N,
                                              microbatch=1,
                                              schedule=schedule)
    params = netes_dist.init_population(cfg, NETES_N, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (NETES_N, 1, 16),
                           generator=torch.Generator().manual_seed(0),
                           dtype=torch.int32)
    lists = [sstate.topo.neighbor_idx.clone()]
    for t in range(3):
        params, metrics, sstate = step(params, None,
                                       {"tokens": tokens, "labels": tokens},
                                       netes_dist.draw(1, t, "cpu"), sstate)
        lists.append(sstate.topo.neighbor_idx.clone())
        assert math.isfinite(float(metrics["loss_mean"]))
    assert sstate.t == 3
    assert any(not torch.equal(lists[0], x) for x in lists[1:])
    with pytest.raises(TypeError, match="sched_state"):
        step(params, None, {"tokens": tokens, "labels": tokens},
             netes_dist.draw(1, 9, "cpu"))


def test_serve_steps_are_the_models_forward_and_decode():
    cfg = get_config(SMOKE)
    params = transformer.init_params(cfg, seed=3, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 8),
                           generator=torch.Generator().manual_seed(1))
    logits = netes_dist.make_prefill_step(cfg)(params, {"tokens": tokens})
    assert torch.equal(logits, transformer.forward(params, cfg,
                                                   {"tokens": tokens}))
    cache = transformer.init_cache(cfg, 2, 12, torch.float32, "cpu")
    ref_cache = transformer.init_cache(cfg, 2, 12, torch.float32, "cpu")
    pos = torch.zeros(2, dtype=torch.long)
    got, _ = netes_dist.make_decode_step(cfg)(params, tokens[:, :1], cache,
                                              pos)
    want, _ = transformer.decode_step(params, cfg, tokens[:, :1], ref_cache,
                                      pos)
    assert torch.equal(got, want)

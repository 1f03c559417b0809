"""The port's NetES over LM agents (``distributed.netes_dist``,
``models.transformer.loss_fn``, ``train.loop.train_lm_netes``, the ``lm``
launcher) against the JAX reference's replica step.

``repro.distributed.netes_dist`` imports ``repro.models``, which does not
import in this process (ROADMAP queue 3, item a), so a session fixture
runs the ``netes`` part of ``tests/_torch_lm_ref.py`` once in a
subprocess: for gemma3-4b-smoke, moonshot-v1-16b-a3b-smoke (a dense
layer, then an MoE layer of 4 experts, top-2) and whisper-tiny-smoke (the
encoder-decoder, each agent's sequence beside its 64 frames) at N = 4
agents, one 64-token sequence each, the reference's own draws of 3 steps
(the batches, ε of every agent and leaf, per stacked slice as its noise
contract folds it, β and the channel's dropout masks), its ``loss_fn``,
and its parameters after 1 and 3 steps on fully connected (dense), on
Erdős–Rényi p = 0.5 (sparse) and through channel (a)
(``quantize(bits=8)|dropout(p=0.1,seed=0)``, sparse: the wire form). The
broadcast draws are fixed to (no, yes, no), so that step 1 holds the
mixing alone and step 2 the broadcast. The port starts from the same
parameters (``convert.lm_population_from_reference``) and is handed the
same draws through ``StepDraws`` (its ε seam fills each slab from the
reference's ε, converted to the port's layout); on the CPU every kernel
wrapper runs its plain version.

Tolerances. ``loss_fn``: rtol = atol = 2e-5, as ``tests/test_torch_lm.py``
(float32 on both sides, other summation orders, ≈ 1e-6). Rewards decide
the update through their ranks only, so every step asserts that the
smallest gap between two of its 2N rewards is above ``MIN_MARGIN`` = 2e-5,
40× the two packages' difference in a loss here (≤ 4.8e-7, one float32
ulp at 6.3), before the ranks are trusted to agree. Parameters: atol = ``PARAM_ATOL`` = 2e-5 with rtol
= 2e-5: Eq. 3 scales the neighbor sum by α/(Nσ²) = 6.25, so a float32
rounding of ≈ 1e-7 in a sum of terms of ≈ 0.1 becomes ≈ 1e-6 in θ, and
three free-running steps carry it on; a wrong weight, sign or
normalization moves θ by ≥ 1e-3. Through the channel each step starts
from the reference's parameters before it (after 0, 1 and 2 steps): q8
rounds θ/scale to integers, so a 1e-7 difference in θ flips a code on the
rare element near a half-integer and moves that element by scale·6.25 ≈
1e-3, a difference of inputs and not of the step; from equal inputs the
codes are equal. The broadcast's message, θ_b ± σε_b, is rounded once by
the reference's compiled FMA and twice by the port, so there too a code
may differ by one: only at an element whose θ_b ± σε_b, in units of the
message's scale, lies within ``TIE`` = 1e-4 of a half-integer (one
rounding of it moves it ≤ 1.5e-5 there), and then every agent's element
differs by exactly that one code. Every other element is held to the
tolerance above.
"""
import dataclasses
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

from _torch_lm_ref import (NETES_ARCHS, NETES_BCAST, NETES_CFG,
                           NETES_CHANNEL, NETES_MODES, NETES_N, NETES_SEQ,
                           NETES_STEPS, XENT_CHUNK)
from repro.core import topology_repr as ref_topology_repr
from repro.core import wire_format as ref_wire_format
from repro_torch import convert
from repro_torch.comm.channel import compile_channel
from repro_torch.configs import get_config
from repro_torch.core import topology_repr, wire_format
from repro_torch.core.netes import NetESConfig
from repro_torch.core.topology import TopologySpec
from repro_torch.core.tree import flatten, leaf_paths, tree_map
from repro_torch.distributed import netes_dist
from repro_torch.kernels import _checks
from repro_torch.kernels import netes_fused_mixing as nfm
from repro_torch.kernels import netes_mixing as nm
from repro_torch.kernels import netes_sparse_mixing as nsm
from repro_torch.models import transformer
from repro_torch.obs import compile_probes
from repro_torch.train.loop import TrainConfig, train_lm_netes

TESTS = pathlib.Path(__file__).resolve().parent
SRC = TESTS.parent / "src"
TOL = dict(rtol=2e-5, atol=2e-5)
PARAM_ATOL = 2e-5
MIN_MARGIN = 2e-5
TIE = 1e-4
NCFG = NetESConfig(**NETES_CFG)
CASES = [pytest.param(arch, mode, id=f"{arch.split('-')[0]}-{mode}")
         for arch in NETES_ARCHS for mode in NETES_MODES]
METRICS = ("reward_mean", "reward_max", "reward_std", "loss_mean",
           "broadcast")


@pytest.fixture(scope="session")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("netes_ref") / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(SRC))
    res = subprocess.run([sys.executable, str(TESTS / "_torch_lm_ref.py"),
                          str(path), "netes"], env=env, capture_output=True,
                         text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-4000:]
    with np.load(path) as z:      # read on demand: the dump is ≈ 400 MB
        yield z


def sub(ref, prefix):
    """The leaves under ``prefix``, keyed below it."""
    return {k[len(prefix) + 1:]: ref[k] for k in ref.files
            if k.startswith(prefix + "/")}


def population(ref, arch, prefix):
    """A dumped population (agent axis leading) in the port's layout."""
    return convert.lm_population_from_reference(sub(ref, f"{arch}/{prefix}"),
                                                get_config(arch),
                                                device="cpu")


def initial_population(ref, arch):
    """Every agent starts from the dumped θ⁽⁰⁾ (the reference's
    ``same_init``)."""
    flat = {k: np.broadcast_to(a, (NETES_N,) + a.shape)
            for k, a in sub(ref, f"{arch}/params").items()}
    return convert.lm_population_from_reference(flat, get_config(arch),
                                                device="cpu")


class RefNoise:
    """The ε seam filled from the reference's ε of one step: each agent's
    tree, converted to the port's layout and flattened in the step's leaf
    order."""

    def __init__(self, ref, arch, t):
        cfg = get_config(arch)
        self.eps = [[leaf.reshape(-1) for leaf in flatten(
            convert.lm_params_from_reference(sub(ref, f"{arch}/eps{t}/{i}"),
                                             cfg, device="cpu"))]
                    for i in range(NETES_N)]

    def __call__(self, out, agent, leaf, slab, start):
        out.copy_(self.eps[agent][leaf][start:start + out.numel()])


def batch_of(ref, arch, t):
    """Step t's batch: tokens, and for whisper the reference's frames."""
    tokens = torch.as_tensor(ref[f"{arch}/tokens{t}"])
    batch = {"tokens": tokens, "labels": tokens}
    if f"{arch}/frames{t}" in ref.files:
        batch["frames"] = torch.as_tensor(ref[f"{arch}/frames{t}"])
    return batch


def topology_of(ref, arch, mode):
    adj = ref[f"{arch}/{mode}/adj"]
    kind = NETES_MODES[mode][1]
    if kind == "dense":
        return convert.topology_from_reference("dense", NETES_N,
                                               adj.sum(1), adj=adj,
                                               device="cpu")
    return convert.topology_from_reference(
        "sparse", NETES_N, adj.sum(1),
        neighbor_idx=ref[f"{arch}/{mode}/neighbor_idx"],
        neighbor_mask=ref[f"{arch}/{mode}/neighbor_mask"], device="cpu")


def draws_of(ref, arch, mode, t):
    mask = (torch.as_tensor(ref[f"{arch}/{mode}/edge_mask{t}"])
            if NETES_MODES[mode][2] else None)
    return netes_dist.StepDraws(noise=RefNoise(ref, arch, t),
                                beta=torch.as_tensor(ref[f"{arch}/beta{t}"]),
                                edge_mask=mask)


def assert_population_close(got, ref, arch, prefix, ties=None):
    """``got`` within the tolerance of the dumped population; with
    ``ties`` (``broadcast_ties``), a leaf's column may instead differ by
    one broadcast code in every agent where that code is a near tie."""
    want = population(ref, arch, prefix)
    for i, (path, g, w) in enumerate(zip(
            leaf_paths(got), flatten(got),
            flatten(want), strict=True)):
        g, w = g.reshape(g.shape[0], -1), w.reshape(w.shape[0], -1)
        off = (g - w).abs() > PARAM_ATOL + 2e-5 * w.abs()
        if ties is not None and off.any():
            near, scale = ties[i]
            cols = off.any(dim=0)
            assert bool(near[cols].all()), (path, "off a near tie")
            np.testing.assert_allclose((g - w)[:, cols].abs().numpy(),
                                       float(scale), rtol=1e-3,
                                       err_msg=str(path))
            g, w = g[:, ~cols], w[:, ~cols]
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=2e-5,
                                   atol=PARAM_ATOL, err_msg=str(path))


def broadcast_ties(cfg, params, batch, draws):
    """Per leaf, the columns where the broadcast message's q8 code is a
    near tie (θ_b ± σε_b over its scale within ``TIE`` of a half-integer),
    and the scale; from the parameters before the step."""
    r_pos, r_neg = netes_dist.agent_rewards(cfg, params, batch, draws.noise,
                                            NCFG.sigma)
    best = int(torch.argmax(torch.cat([r_pos, r_neg])))
    sign = 1.0 if best < NETES_N else -1.0
    out = []
    for i, leaf in enumerate(flatten(params)):
        theta = leaf[best % NETES_N].reshape(-1)
        eps = torch.empty_like(theta)
        draws.noise(eps, best % NETES_N, i, 0, 0)
        bp = theta + (sign * NCFG.sigma) * eps
        scale = bp.abs().max() / 127
        x = bp / scale
        out.append((((x - torch.floor(x)) - 0.5).abs() < TIE, scale))
    return out


def reward_margin(cfg, params, batch, noise):
    """The smallest gap between two of the step's 2N rewards."""
    r_pos, r_neg = netes_dist.agent_rewards(cfg, params, batch, noise,
                                            NCFG.sigma)
    raw = torch.sort(torch.cat([r_pos, r_neg])).values
    return float((raw[1:] - raw[:-1]).min())


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", NETES_ARCHS)
@pytest.mark.parametrize("chunked", [False, True], ids=["whole", "chunked"])
def test_loss_fn_matches_reference(ref, arch, chunked):
    cfg = get_config(arch)
    params = convert.lm_params_from_reference(sub(ref, f"{arch}/params"), cfg,
                                              device="cpu")
    batch = {k: v[0] for k, v in batch_of(ref, arch, 0).items()}
    got = transformer.loss_fn(params, cfg, batch,
                              **({"xent_chunk": XENT_CHUNK} if chunked
                                 else {}))
    want = ref[f"{arch}/loss_chunked" if chunked else f"{arch}/loss"]
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert got.shape == () and math.isfinite(float(got))


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


@pytest.mark.parametrize("arch, mode", CASES)
def test_replica_step_matches_reference(ref, arch, mode):
    """3 steps from the reference's θ⁽⁰⁾ and draws: the metrics of each
    step and the parameters after steps 1 and 3 (through the channel,
    after each step, each from the reference's parameters before it)."""
    cfg = get_config(arch)
    chan = (compile_channel(NETES_MODES[mode][2], NETES_N)
            if NETES_MODES[mode][2] else None)
    topo = topology_of(ref, arch, mode)
    step = netes_dist.make_replica_train_step(cfg, NCFG, NETES_N,
                                              microbatch=1, topology=topo,
                                              channel=chan)
    params = initial_population(ref, arch)
    cstate = chan.init(params) if chan is not None else None
    for t in range(NETES_STEPS):
        if chan is not None and t:
            params = population(ref, arch, f"{mode}/after{t}")
        draws, batch = draws_of(ref, arch, mode, t), batch_of(ref, arch, t)
        assert reward_margin(cfg, params, batch, draws.noise) > MIN_MARGIN
        ties = (broadcast_ties(cfg, params, batch, draws)
                if chan is not None and NETES_BCAST[t] else None)
        out = step(params, None, batch, draws,
                   *([cstate] if chan is not None else []))
        params, metrics = out[0], out[1]
        want = sub(ref, f"{arch}/{mode}/metrics{t}")
        names = METRICS + (("msgs", "trigger_frac", "drop_frac")
                           if chan is not None else ())
        assert sorted(want) == sorted(names)
        for name in names:
            np.testing.assert_allclose(metrics[name].numpy(), want[name],
                                       **TOL, err_msg=name)
        assert bool(metrics["broadcast"]) == NETES_BCAST[t]
        if chan is not None:
            cstate = out[2]
        if t + 1 in ((1, 2, 3) if chan is not None else (1, 3)):
            assert_population_close(params, ref, arch, f"{mode}/after{t + 1}",
                                    ties)


def test_reference_draws_are_what_the_steps_used(ref):
    """The dump's own checks: the broadcast pattern, the batch shapes and
    the chain's statistics of the reference's tokens."""
    for arch in NETES_ARCHS:
        for t in range(NETES_STEPS):
            assert (float(ref[f"{arch}/beta{t}"]) < NCFG.p_broadcast) == \
                NETES_BCAST[t]
            tokens = ref[f"{arch}/tokens{t}"]
            assert tokens.shape == (NETES_N, 1, NETES_SEQ)
            assert tokens.dtype == np.int32
            assert 0 <= tokens.min() and tokens.max() < get_config(
                arch).vocab_size


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


def test_population_round_trip(ref):
    """The reference's population → the port's → the reference's, bit for
    bit, on the dumped parameters and on stacked layer plans."""
    for arch in NETES_ARCHS:
        flat = sub(ref, f"{arch}/fc/after1")
        back = convert.lm_population_to_reference(
            convert.lm_population_from_reference(flat, get_config(arch),
                                                 device="cpu"),
            get_config(arch))
        assert sorted(back) == sorted(flat)
        for k in flat:
            np.testing.assert_array_equal(back[k], flat[k], err_msg=k)
    for arch, layers, plan in (("gemma3-4b-smoke", 8, (0, 2, 4, 0)),
                               ("moonshot-v1-16b-a3b-smoke", 6, (1, 1, 5, 0)),
                               ("jamba-v0.1-52b-smoke", 8, (0, 2, 4, 0))):
        cfg = dataclasses.replace(get_config(arch), num_layers=layers)
        assert transformer.stack_plan(cfg) == plan
        pop = netes_dist.init_population(cfg, 3, seed=1, same_init=False,
                                         device="cpu")
        flat = convert.lm_population_to_reference(pop, cfg)
        assert flat["layers_scan/0/norm1/scale"].shape[:2] == (3, plan[2])
        back = convert.lm_population_from_reference(flat, cfg, device="cpu")
        for a, b in zip(flatten(pop), flatten(back),
                        strict=True):
            assert torch.equal(a, b)


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


def test_slab_width_leaves_the_update_unchanged_for_the_same_noise(
        ref, monkeypatch):
    """The slab width cuts the same computation differently: with the
    reference's ε (one fixed stream per leaf), one column at a time of a
    slab of 7 or a whole leaf give the same parameters within rounding."""
    arch, mode = NETES_ARCHS[0], "er"
    cfg = get_config(arch)
    outs = []
    for cols in (7, 1 << 24):
        monkeypatch.setattr(netes_dist, "SLAB_COLUMNS", cols)
        step = netes_dist.make_replica_train_step(
            cfg, NCFG, NETES_N, microbatch=1,
            topology=topology_of(ref, arch, mode))
        params = initial_population(ref, arch)
        outs.append(step(params, None, batch_of(ref, arch, 0),
                         draws_of(ref, arch, mode, 0))[0])
    for x, y in zip(*map(flatten, outs), strict=True):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=2e-5,
                                   atol=PARAM_ATOL)


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

"""``repro_torch.checkpoint`` against ``repro.checkpoint.io``: the port's
state blobs round-trip bit for bit, mismatched leaves are rejected, keys
are the reference's ``_path_key`` strings, ``latest.json`` is replaced
atomically, and the NetES leaves of a checkpoint the reference wrote load
into the port. Every comparison here is EQUAL."""
import itertools
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import io as ref_io
from repro.core import netes as ref_netes
from repro.core import topology as ref_topology
from repro.core import topology_sched as ref_sched
from repro_torch import checkpoint, convert
from repro_torch.checkpoint import io
from repro_torch.comm.channel import compile_channel
from repro_torch.core import netes
from repro_torch.core import topology_sched as sched
from repro_torch.core.topology import TopologySpec

N, D = 12, 5
SCHEDULES = [("resample_er(period=2,seed=4)", "erdos_renyi", 0.3, "sparse"),
             ("anneal_density(p_end=0.1,horizon=3)", "erdos_renyi", 0.5,
              "dense"),
             ("rotate_circulant(stride=2)", "ring", 0.0, "auto"),
             ("static", "erdos_renyi", 0.3, "sparse")]


def _blob(text, family, p, rep, advance=3):
    """A training blob as ``train_rl_netes`` saves it, some way into a
    run: every kind of leaf (tensors, generators, a host int, shifts)."""
    schedule = sched.compile_schedule(
        sched.ScheduleSpec.parse(text),
        TopologySpec(family=family, n_agents=N, p=p, seed=0), rep)
    sstate = schedule.init(device="cpu")
    for _ in range(advance):
        sstate = schedule.advance(sstate)
    state = netes.init_state(N, D, seed=3, device="cpu")
    state.generator.manual_seed(11)
    torch.randn(7, generator=state.generator)
    ch = compile_channel("event_triggered(threshold=0.1)|quantize(bits=8)|"
                         "dropout(p=0.2,seed=5)", N)
    cstate = ch.init(state.thetas)
    cstate.last_sent.normal_()
    eval_gen = torch.Generator().manual_seed(999)
    return {"netes": state, "eval_gen": eval_gen, "sched": sstate,
            "chan": cstate}


def _fresh_like(text, family, p, rep):
    return _blob(text, family, p, rep, advance=0)


def _assert_equal(a, b, path="root"):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    elif isinstance(a, torch.Generator):
        assert torch.equal(a.get_state(), b.get_state()), path
        # and it draws the same numbers from here on
        assert torch.equal(torch.rand(4, generator=a),
                           torch.rand(4, generator=b)), path
    elif a is None or isinstance(a, (int, str, tuple)):
        assert a == b, path
    else:
        for f in a.__dataclass_fields__:
            _assert_equal(getattr(a, f), getattr(b, f), f"{path}.{f}")


@pytest.mark.parametrize("text,family,p,rep", SCHEDULES)
def test_blob_round_trips_bit_for_bit(tmp_path, text, family, p, rep):
    blob = _blob(text, family, p, rep)
    checkpoint.save_pytree(tmp_path / "b.npz", blob)
    restored = checkpoint.load_pytree(tmp_path / "b.npz",
                                      _fresh_like(text, family, p, rep))
    assert restored["sched"].t == 3
    _assert_equal(restored, blob)


def test_train_state_round_trips(tmp_path):
    blob = _blob(*SCHEDULES[0])
    io.save_train_state(tmp_path, 7, blob, extra={"task": "pendulum"})
    step, restored = io.restore_train_state(tmp_path,
                                            _fresh_like(*SCHEDULES[0]))
    assert step == 7
    assert json.loads((tmp_path / "latest.json").read_text()) == {
        "step": 7, "task": "pendulum"}
    _assert_equal(restored, blob)


@pytest.mark.parametrize("what", ["dtype", "shape", "missing", "int"])
def test_mismatched_leaf_is_rejected(tmp_path, what):
    tree = {"a": torch.zeros(3), "b": {"c": torch.zeros(2, dtype=torch.int32)},
            "t": 4}
    checkpoint.save_pytree(tmp_path / "t.npz", tree)
    like = {"a": torch.zeros(3), "b": {"c": torch.zeros(2, dtype=torch.int32)},
            "t": 0}
    if what == "dtype":
        like["b"]["c"] = torch.zeros(2, dtype=torch.int64)
        err, match = ValueError, "dtype mismatch for b::c"
    elif what == "shape":
        like["a"] = torch.zeros(4)
        err, match = ValueError, "shape mismatch for a"
    elif what == "missing":
        like["d"] = torch.zeros(1)
        err, match = KeyError, "missing leaf 'd'"
    else:
        like["t"] = torch.zeros((), dtype=torch.int64)   # an int is int64
        out = checkpoint.load_pytree(tmp_path / "t.npz", like)
        assert int(out["t"]) == 4 and out["t"].dtype == torch.int64
        like["t"] = torch.zeros(())
        err, match = ValueError, "dtype mismatch for t"
    with pytest.raises(err, match=match):
        checkpoint.load_pytree(tmp_path / "t.npz", like)


def test_generator_state_size_is_checked(tmp_path):
    checkpoint.save_pytree(tmp_path / "g.npz", {"g": torch.Generator()})
    with pytest.raises(ValueError, match="shape mismatch for g"):
        checkpoint.load_pytree(tmp_path / "g.npz", {"g": torch.zeros(3)})


PARTS = ["a", "b", ":", "::", "\\", "a:", ":b", "a\\", "\\:", "0", ".t"]


class _Key:
    def __init__(self, key):
        self.key = key


def test_key_escape_is_injective_and_equals_the_reference():
    paths = [p for r in (1, 2, 3) for p in itertools.product(PARTS, repeat=r)]
    keys = [io.path_key(p) for p in paths]
    assert len(set(keys)) == len(paths)
    for p, k in zip(paths, keys):
        assert k == ref_io._path_key([_Key(part) for part in p]), p


@pytest.mark.parametrize("text,family,p,rep", SCHEDULES[:3])
def test_saved_keys_are_the_references(tmp_path, text, family, p, rep):
    """The same blob saved by both packages holds the same keys, but for
    the leaves one of them alone has: the reference's threefry ``.key``s,
    the port's generators and anneal's uniform."""
    port = _blob(text, family, p, rep)
    checkpoint.save_pytree(tmp_path / "port.npz",
                           {"netes": port["netes"], "sched": port["sched"]})
    ref_schedule = ref_sched.compile_schedule(
        ref_sched.ScheduleSpec.parse(text),
        ref_topology.TopologySpec(family=family, n_agents=N, p=p, seed=0),
        rep)
    sstate = ref_schedule.init()
    for _ in range(3):
        sstate = ref_schedule.advance(sstate)
    ref_state = ref_netes.init_state(jax.random.PRNGKey(0), N, D)
    ref_io.save_pytree(tmp_path / "ref.npz",
                       {"netes": ref_state, "sched": sstate})
    with np.load(tmp_path / "port.npz") as a, \
            np.load(tmp_path / "ref.npz") as b:
        port_keys = {k for k in a.files
                     if not k.endswith((".generator", ".u"))}
        ref_keys = {k for k in b.files if not k.endswith(".key")}
        assert port_keys == ref_keys
        for k in port_keys - {"sched::.t"}:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert "netes::.thetas" in port_keys and "sched::.topo::0" in port_keys
        if rep == "auto":        # the rotating circulant
            np.testing.assert_array_equal(a["sched::.topo::4"],
                                          b["sched::.topo::4"])


def test_latest_json_is_replaced_atomically(tmp_path, monkeypatch):
    blob = {"w": torch.arange(4.0)}
    io.save_train_state(tmp_path, 1, blob)

    def crash(src, dst):
        raise OSError("crash while renaming")

    monkeypatch.setattr(io.os, "replace", crash)
    with pytest.raises(OSError):
        io.save_train_state(tmp_path, 2, {"w": torch.arange(4.0) + 1})
    monkeypatch.undo()
    # the pointer still names step 1 in full; step 2's payload is on disk
    assert json.loads((tmp_path / "latest.json").read_text()) == {"step": 1}
    assert (tmp_path / "step_00000002.npz").exists()
    step, out = io.restore_train_state(tmp_path, {"w": torch.zeros(4)})
    assert step == 1 and torch.equal(out["w"], torch.arange(4.0))
    io.save_train_state(tmp_path, 3, blob)
    assert not (tmp_path / "latest.json.tmp").exists()
    assert os.listdir(tmp_path).count("latest.json") == 1


def test_reads_the_netes_leaves_of_a_reference_checkpoint(tmp_path):
    ref_state = ref_netes.init_state(jax.random.PRNGKey(4), N, D)
    ref_state = ref_state._replace(
        step=ref_state.step + 9,
        best_reward=jax.numpy.full((), -3.5, jax.numpy.float32))
    ref_io.save_train_state(tmp_path, 9, {"netes": ref_state,
                                          "eval_key": jax.random.PRNGKey(1)})
    state = convert.state_from_reference_npz(tmp_path / "step_00000009.npz",
                                             seed=2, device="cpu")
    np.testing.assert_array_equal(state.thetas.numpy(),
                                  np.asarray(ref_state.thetas))
    np.testing.assert_array_equal(state.best_theta.numpy(),
                                  np.asarray(ref_state.best_theta))
    assert float(state.best_reward) == -3.5 and int(state.step) == 9
    assert state.step.dtype == torch.int32
    assert torch.equal(state.generator.get_state(),
                       torch.Generator().manual_seed(2).get_state())


def _reference_ring(capacity=5, written=8):
    """A reference ``MetricsState`` some way round its ring: ``written``
    distinct columns recorded."""
    from repro.obs import probes as ref_probes
    rp = ref_probes.compile_probes("fitness|graph", capacity=capacity)
    ms = rp.init()
    buf = np.arange(rp.n_signals * capacity, dtype=np.float32).reshape(
        rp.n_signals, capacity) / 7
    return rp, ms._replace(buf=jax.numpy.asarray(buf),
                           cursor=jax.numpy.asarray(written, jax.numpy.int32))


def test_reference_probe_ring_restores_through_the_shared_keys(tmp_path):
    """A reference checkpoint holding ``"obs"`` (its ``MetricsState``, a
    NamedTuple: the path parts are ``.buf`` and ``.cursor``) loads into the
    port's ``MetricsState`` by the keys both packages use, and drains to
    the reference's series."""
    from repro_torch.obs import compile_probes
    rp, ref_ms = _reference_ring()
    ref_io.save_train_state(tmp_path, 7, {"obs": ref_ms})
    with np.load(tmp_path / "step_00000007.npz") as data:
        assert sorted(data.files) == ["obs::.buf", "obs::.cursor"]
    port_probes = compile_probes("fitness|graph", capacity=5)
    step, blob = checkpoint.restore_train_state(
        tmp_path, {"obs": port_probes.init("cpu")})
    assert step == 7
    ms = blob["obs"]
    np.testing.assert_array_equal(ms.buf.numpy(), np.asarray(ref_ms.buf))
    assert ms.cursor.dtype == torch.int32 and int(ms.cursor) == 8
    got, want = port_probes.drain(ms), rp.drain(ref_ms)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_metrics_state_from_reference_round_trips(tmp_path):
    rp, ref_ms = _reference_ring(capacity=4, written=3)
    ms = convert.metrics_state_from_reference(ref_ms.buf, ref_ms.cursor,
                                              device="cpu")
    assert ms.buf.dtype == torch.float32 and ms.cursor.dtype == torch.int32
    checkpoint.save_pytree(tmp_path / "port.npz", {"obs": ms})
    back = ref_io.load_pytree(tmp_path / "port.npz", {"obs": rp.init()})
    np.testing.assert_array_equal(np.asarray(back["obs"].buf),
                                  np.asarray(ref_ms.buf))
    assert int(back["obs"].cursor) == 3
    assert back["obs"].cursor.dtype == jax.numpy.int32

"""The dry run of the port (``launch/specs.lower_pair``,
``launch/analysis.py``, ``launch/dryrun.py``) against the JAX package's:

* (i) ``model_flops``, and ``roofline_terms`` given the reference's TPU
  v5e constants, equal ``repro.launch.analysis``'s;
* (iii) the dot FLOPs of four smoke pairs on a mesh of one —
  mistral-nemo-12b-smoke's replica train step, prefill and decode, and
  llama4-scout-17b-a16e-smoke's consensus step — equal the reference's
  ``hlo_parse.hlo_costs`` of its compiled step within 1e-6 relative (the
  ``dryrun`` part of ``tests/_torch_lm_ref.py``, in a subprocess);
* (iv) every pair of ``shape_pairs()``'s smoke analogue traces on a fake
  2 × 2 mesh, with per-device argument bytes equal to the bytes of the
  local shards its DTensors hold (``tests/_torch_dryrun_ranks.py``, two
  subprocesses);
* the CLI writes a pair's JSON with the reference's keys and exits 0.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.configs import get_config as ref_get_config
from repro.launch import analysis as ref_analysis
from repro_torch.configs import (ASSIGNED_ARCHS, INPUT_SHAPES, get_config,
                                 shape_pairs)
from repro_torch.launch import analysis, specs
from repro_torch.launch.mesh import NamedShape

REPO = Path(__file__).resolve().parent.parent
ENV = dict(os.environ, PYTHONPATH=str(REPO / "src"))
RANK_PARTS = 2
TOL = 1e-6


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_model_flops_are_the_references(arch):
    for shape in INPUT_SHAPES.values():
        assert analysis.model_flops(get_config(arch), shape,
                                    shape["kind"]) == \
            ref_analysis.model_flops(ref_get_config(arch), shape,
                                     shape["kind"])


@pytest.mark.parametrize("terms", [(3.2e15, 8.1e11, 4.4e10),
                                   (1e9, 7e12, 0.0), (0.0, 0.0, 9e11)])
def test_roofline_terms_at_the_references_constants(terms):
    mine = analysis.roofline_terms(
        *terms, peak_flops=ref_analysis.PEAK_FLOPS,
        hbm_bw=ref_analysis.HBM_BW, link_bw=ref_analysis.ICI_BW)
    assert mine == ref_analysis.roofline_terms(*terms)


def test_roofline_at_the_cards_constants():
    """The H100's: 66.9 TFLOP/s float32, 3.35 TB/s, NVLink within a node,
    50 GB/s across nodes."""
    t = analysis.roofline_terms(66.9e12, 3.35e12, 500e9,
                                intra_node_bytes=450e9)
    assert t["compute_s"] == 1.0 and t["memory_s"] == 1.0
    assert t["collective_s"] == pytest.approx(2.0)
    assert t["dominant"] == "collective"
    assert t["step_time_lower_bound_s"] == t["collective_s"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's smoke pairs and the port's 2 × 2 traces, started
    together."""
    tmp = tmp_path_factory.mktemp("dryrun")
    ref_out = tmp / "ref.json"
    procs = [subprocess.Popen(
        [sys.executable, str(REPO / "tests" / "_torch_lm_ref.py"),
         str(ref_out), "dryrun"], env=dict(ENV, JAX_PLATFORMS="cpu"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO)]
    procs += [subprocess.Popen(
        [sys.executable, str(REPO / "tests" / "_torch_dryrun_ranks.py"),
         str(i), str(RANK_PARTS)], env=ENV, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, cwd=REPO)
        for i in range(RANK_PARTS)]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (_, err) in zip(procs, outs, strict=True):
        assert p.returncode == 0, err[-3000:]
    pairs = [r for out, _ in outs[1:]
             for r in json.loads(out.strip().splitlines()[-1])]
    return json.loads(ref_out.read_text()), pairs


# the port's dot FLOPs that differ from the reference's by design, by
# (arch, shape): a replica step on a mesh of one has one agent, and XLA
# turns Eq. 3's 1 × 1 contractions into multiplies, where the port counts
# them: the mixing kernel's report (its plain version's two (1, 1) × (1,
# P) products and one (1, 1) × (1,)) and the update's row sum, an ``mv``
BY_DESIGN = {("mistral-nemo-12b-smoke", "train_smoke"):
             ("kernel:netes_mixing", "aten.mv.default")}


def _port_trace(case, shapes):
    INPUT_SHAPES.update(shapes)
    saved = specs.CONSENSUS_ARCHS
    if case["consensus"]:
        specs.CONSENSUS_ARCHS = saved + (case["arch"],)
    try:
        lowered = specs.lower_pair(case["arch"], case["shape"],
                                   NamedShape(("data", "model"), (1, 1)))
    finally:
        specs.CONSENSUS_ARCHS = saved
        for k in shapes:
            INPUT_SHAPES.pop(k)
    return lowered, lowered.trace(keep_ops=True)


@pytest.mark.parametrize("index", range(4))
def test_smoke_pair_dot_flops_equal_the_references(runs, index):
    ref, _ = runs
    case = ref["cases"][index]
    lowered, rec = _port_trace(case, ref["shapes"])
    assert lowered.pair.mode == case["mode"]
    assert lowered.pair.n_agents == case["n_agents"]
    left_out = BY_DESIGN.get((case["arch"], case["shape"]), ())
    dropped = sum(op.flops * op.mult for op in rec.ops
                  if op.name in left_out)
    assert (dropped > 0) == bool(left_out)
    got = rec.costs()["dot_flops"] - dropped
    want = case["hlo_costs"]["dot_flops"]
    assert abs(got - want) <= TOL * want, (got, want)


def test_every_smoke_pair_traces_on_a_2x2_mesh(runs):
    _, pairs = runs
    assert sorted((r["arch"], r["shape"]) for r in pairs) == sorted(
        (a + "-smoke", s) for a, s in shape_pairs())
    failed = [(r["arch"], r["shape"], r["error"]) for r in pairs
              if not r["ok"]]
    assert failed == []
    for r in pairs:
        assert r["argument_bytes"] == r["local_shard_bytes"], r
        assert r["dot_flops"] > 0
        want = {"train_4k": ("replica", "consensus"), "long_500k": ("serve",),
                "prefill_32k": ("serve",), "decode_32k": ("serve",)}
        assert r["mode"] in want[r["shape"]]
    modes = {r["arch"]: r["mode"] for r in pairs if r["shape"] == "train_4k"}
    assert modes["llama4-scout-17b-a16e-smoke"] == "consensus"
    assert modes["mistral-nemo-12b-smoke"] == "replica"


def test_cli_writes_a_pairs_report(tmp_path):
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "whisper-tiny", "--shape", "decode_32k", "--out", str(tmp_path)],
        env=ENV, capture_output=True, text=True, timeout=600, cwd=REPO)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    assert "dry-run complete: 1 ok, 0 failed" in res.stdout
    (path,) = tmp_path.glob("*.json")
    rep = json.loads(path.read_text())
    assert rep["ok"] and rep["mesh"] == "16x16" and rep["n_devices"] == 256
    for key in ("mode", "memory", "op_costs", "roofline",
                "model_flops_per_device", "useful_flops_ratio", "trace_s",
                "fits", "argument_bytes_bf16"):
        assert key in rep, key
    assert rep["op_costs"]["dot_flops"] > 0
    assert rep["memory"]["peak_bytes"] >= rep["memory"]["argument_bytes"]


def test_named_shardings_maps_every_spec_to_placements():
    """Each ``P`` of a tree (dicts, lists, a state dataclass) becomes its
    placements over the mesh's dims, as ``sharding.to_placements`` gives
    them; anything else is left as it is."""
    from types import SimpleNamespace

    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.comm.channel import ChannelState
    from repro_torch.distributed.sharding import P
    mesh = SimpleNamespace(mesh_dim_names=("data", "model"))
    tree = {"w": P(None, "model"), "layers": [P("data"), P()],
            "chan": ChannelState(seed=P(), draws=P(), last_sent=None,
                                 msgs=P("model"))}
    got = specs.named_shardings(mesh, tree)
    assert got["w"] == (Replicate(), Shard(1))
    assert got["layers"] == [(Shard(0), Replicate()),
                             (Replicate(), Replicate())]
    assert got["chan"].last_sent is None
    assert got["chan"].msgs == (Replicate(), Shard(0))

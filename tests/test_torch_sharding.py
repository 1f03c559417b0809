"""The port's placement rules (``distributed.sharding``, ``distributed.
context``, ``launch.specs``, ``launch.mesh.make_production_mesh``) against
the JAX reference's on its two production meshes, 16 × 16 ("data",
"model") and 2 × 16 × 16 ("pod", "data", "model").

``repro.launch.specs`` imports ``repro.models``, which does not import in
this process (ROADMAP queue 3, item a), so a session fixture runs the
``sharding`` part of ``tests/_torch_lm_ref.py`` once in a subprocess with
512 forced host devices (the reference's meshes are made of devices). It
dumps, for every arch of ``ASSIGNED_ARCHS``, the parameter specs of each
mode over the reference's abstract trees, the decode-cache specs at B = 1
and 128, and the activation roles of every mode and kind; and for every
pair of ``shape_pairs()`` its ``classify`` result and its ``input_specs``
(shapes, dtypes, specs). Everything is compared for equality.

The port's trees hold their layers as a list (``layers/<i>``) where the
reference stacks repeated layers (``layers_scan/<j>``, leading ``n_rep``
dim) for its scan: a port leaf is compared with the reference leaf that
``convert.lm_params_to_reference`` puts it in, that leading dim (and its
spec entry, always None) dropped; the decode cache alike (``head``,
``scan``, ``tail``). The reference's step takes a threefry ``key`` where
the port's takes ``draws`` (β; ε is a function): those two are not
compared.

Placements run on a 2 × 2 gloo mesh under ``torchrun``
(``tests/_torch_placement_ranks.py``): each rank's piece equals the slice
its spec names, through ``distribute_tensor`` and through
``maybe_constrain``, and a plain tensor comes back unchanged.
"""
import json
import os
import pathlib
import subprocess
import sys
import types

import pytest
import torch

from repro_torch import convert
from repro_torch.configs import (ASSIGNED_ARCHS, INPUT_SHAPES,
                                 LONG_CONTEXT_ARCHS, get_config,
                                 shape_pairs)
from repro_torch.core.tree import leaf_paths, tree_map
from repro_torch.distributed import sharding
from repro_torch.distributed.context import (current, maybe_constrain,
                                             sharding_context)
from repro_torch.distributed.sharding import P
from repro_torch.launch import mesh as launch_mesh
from repro_torch.launch import specs
from repro_torch.models.transformer import stack_plan

TESTS = pathlib.Path(__file__).resolve().parent
ROOT = TESTS.parent
SRC = ROOT / "src"
RANKS = TESTS / "_torch_placement_ranks.py"
MESHES = {"single": launch_mesh.make_production_mesh(),
          "multi": launch_mesh.make_production_mesh(multi_pod=True)}
MODES = ("replica", "consensus", "serve")
KINDS = ("train", "prefill", "decode")
CACHE_BATCHES = (1, 128)
CACHE_LEN = 32768


@pytest.fixture(scope="session")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("sharding_ref") / "ref.json"
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(SRC),
               XLA_FLAGS="--xla_force_host_platform_device_count=512")
    res = subprocess.run([sys.executable, str(TESTS / "_torch_lm_ref.py"),
                          str(path), "sharding"], env=env,
                         capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-4000:]
    return json.loads(path.read_text())


def as_json(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def by_path(tree, prefix=""):
    """A tree's leaves (a spec ``P`` is a leaf) keyed by their "/"-joined
    path."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(by_path(tree[k], f"{prefix}/{k}" if prefix else k))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(by_path(v, f"{prefix}/{i}" if prefix else str(i)))
        return out
    return {prefix: tree}


def param_key_map(cfg):
    """Per port leaf path, (the reference key it sits in, whether that
    leaf is stacked for the reference's scan), by ``convert``'s layout:
    the port's leaves numbered in path order, laid out as the
    reference's."""
    tree = specs.abstract_params(cfg)
    paths = leaf_paths(tree)
    numbered = tree_map(lambda _: None, tree)
    for i, path in enumerate(paths):
        node = numbered
        for k in path[:-1]:
            node = node[k]
        node[path[-1]] = torch.tensor(i)
    names = ["/".join(map(str, p)) for p in paths]
    out = {}
    for key, arr in convert.lm_params_to_reference(numbered, cfg).items():
        for i in arr.reshape(-1):
            out[names[int(i)]] = (key, arr.ndim == 1)
    assert len(out) == len(names)
    return out


def cache_key_map(cfg):
    """Per port layer index, (the reference cache's key prefix, stacked)
    (its ``init_cache``: ``head``/``scan``/``tail`` by ``stack_plan``)."""
    head, period, n_rep, _ = stack_plan(cfg)
    if n_rep == 1:
        head, period = cfg.num_layers, 0
    out = []
    for i in range(cfg.num_layers):
        if i < head:
            out.append((f"head/{i}", False))
        elif i < head + n_rep * period:
            out.append((f"scan/{(i - head) % period}", True))
        else:
            out.append((f"tail/{i - head - n_rep * period}", False))
    return out


def drop(spec_or_shape, stacked, at):
    if not stacked:
        return list(spec_or_shape)
    out = list(spec_or_shape)
    del out[at]
    return out


def ref_param_entry(keymap, path, table, at):
    key, stacked = keymap[path]
    return drop(table[key], stacked, at)


def ref_cache_entry(cfg, path, table, shapes=False):
    """The reference's entry for a port cache leaf ``layers/<i>/...``: a
    spec, or with ``shapes`` a [shape, dtype] pair."""
    if not path.startswith("layers/"):
        return table[path]
    _, i, rest = path.split("/", 2)
    prefix, stacked = cache_key_map(cfg)[int(i)]
    entry = table[f"{prefix}/{rest}"]
    if shapes:
        return [drop(entry[0], stacked, 0), entry[1]]
    return drop(entry, stacked, 0)


# ---------------------------------------------------------------------------
# the registry's shapes and the meshes
# ---------------------------------------------------------------------------

def test_registry_pairs_are_the_references():
    from repro import configs as ref_configs
    assert ASSIGNED_ARCHS == ref_configs.ASSIGNED_ARCHS
    assert INPUT_SHAPES == ref_configs.INPUT_SHAPES
    assert LONG_CONTEXT_ARCHS == ref_configs.LONG_CONTEXT_ARCHS
    assert shape_pairs() == ref_configs.shape_pairs()


def test_production_meshes_are_named_shapes():
    single, multi = MESHES["single"], MESHES["multi"]
    assert single.axis_names == ("data", "model")
    assert single.shape == {"data": 16, "model": 16}
    assert multi.axis_names == ("pod", "data", "model")
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}
    assert sharding.agent_axes(multi) == ("pod", "data")
    assert sharding.n_agents(single) == 16 and sharding.n_agents(multi) == 32


def test_process_group_mesh_names_its_axes():
    mesh = launch_mesh.Mesh(group=None, rank=0, world_size=3,
                            device=torch.device("cpu"))
    assert mesh.axis_names == ("data", "model")
    assert mesh.shape == {"data": 3, "model": 1}
    assert sharding.n_agents(mesh) == 3


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_param_pspecs_match_reference(ref, arch, mode, mesh):
    cfg = get_config(arch)
    m = MESHES[mesh]
    tree = specs.abstract_params(cfg)
    if mode == "replica":
        tree = specs.stack_abstract(tree, sharding.n_agents(m))
    got = by_path(sharding.param_pspecs(cfg, tree, mode, m))
    keymap = param_key_map(cfg)
    want = ref[mesh]["params"][arch][mode]
    # the reference's scan dim follows the agent axis in replica mode
    at = 1 if mode == "replica" else 0
    for path, spec in got.items():
        assert isinstance(spec, P)
        assert as_json(spec) == ref_param_entry(keymap, path, want, at), path
    assert {k for k, _ in keymap.values()} == set(want)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("batch", CACHE_BATCHES)
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_cache_pspecs_match_reference(ref, arch, batch, mesh):
    cfg = get_config(arch)
    cache = specs.abstract_cache(cfg, batch, CACHE_LEN)
    got = by_path(sharding.cache_pspecs(cfg, cache, MESHES[mesh], batch))
    want = ref[mesh]["cache"][arch][str(batch)]
    for path, spec in got.items():
        assert as_json(spec) == ref_cache_entry(cfg, path, want), path


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_activation_roles_match_reference(ref, arch, mesh):
    cfg = get_config(arch)
    for mode in MODES:
        for kind in KINDS:
            got = sharding.activation_roles(cfg, mode, MESHES[mesh], kind)
            assert {r: as_json(s) for r, s in got.items()} == \
                ref[mesh]["roles"][arch][mode][kind], (mode, kind)


PAIRS = [pytest.param(a, s, id=f"{a}-{s}") for a, s in shape_pairs()]


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch, shape", PAIRS)
def test_classify_and_input_specs_match_reference(ref, arch, shape, mesh):
    m = MESHES[mesh]
    pair = specs.classify(arch, shape, m)
    assert [pair.mode, pair.kind, pair.n_agents] == \
        ref[mesh]["classify"][f"{arch} {shape}"]
    info = specs.input_specs(arch, shape, m)
    assert info["pair"] == pair
    want = ref[mesh]["inputs"][f"{arch} {shape}"]
    cfg = pair.cfg
    keymap = param_key_map(cfg)
    at = 1 if pair.mode == "replica" else 0
    args = {k: v for k, v in info["args"].items() if k != "draws"}
    assert set(args) == {k.split("/")[0] for k in want["args"]} - {"key"}
    for name, tree in args.items():
        for path, leaf in by_path(tree, name).items():
            assert leaf.device.type == "meta", path
            got = [list(leaf.shape), str(leaf.dtype).replace("torch.", "")]
            if name == "params":
                sub = path[len("params/"):]
                key, stacked = keymap[sub]
                shape_, dtype = want["args"]["params/" + key]
                expect = [drop(shape_, stacked, at), dtype]
            elif name == "cache":
                table = {k[len("cache/"):]: v for k, v in
                         want["args"].items() if k.startswith("cache/")}
                expect = ref_cache_entry(cfg, path[len("cache/"):], table,
                                         shapes=True)
            else:
                expect = want["args"][path]
            assert got == expect, path
    for name, tree in info["specs"].items():
        if name == "draws":
            assert tree == P()
            continue
        for path, spec in by_path(tree, name).items():
            if name == "params":
                key, stacked = keymap[path[len("params/"):]]
                expect = drop(want["specs"]["params/" + key], stacked, at)
            elif name == "cache":
                table = {k[len("cache/"):]: v for k, v in
                         want["specs"].items() if k.startswith("cache/")}
                expect = ref_cache_entry(cfg, path[len("cache/"):], table)
            else:
                expect = want["specs"][path]
            assert as_json(spec) == expect, path


# ---------------------------------------------------------------------------
# the port's own contract
# ---------------------------------------------------------------------------

def test_partition_spec_normalizes_one_axis_tuples():
    assert P(("data",), None) == P("data", None) == ("data", None)
    assert P(("pod", "data")) == (("pod", "data"),)
    assert repr(P("data", None)) == "P('data', None)"


def test_guard_divisibility_replicates_undivided_dims():
    m = MESHES["single"]
    assert sharding.guard_divisibility(P("model", None), (51865, 384), m) \
        == P(None, None)
    assert sharding.guard_divisibility(P(("data", "model"), None),
                                       (512, 8), m) == P(("data", "model"),
                                                         None)


def _fake_mesh(*names):
    return types.SimpleNamespace(mesh_dim_names=names)


def test_to_placements_maps_axes_to_mesh_dims():
    from torch.distributed.tensor import Replicate, Shard
    mesh = _fake_mesh("data", "model")
    assert sharding.to_placements(P(), mesh) == (Replicate(), Replicate())
    assert sharding.to_placements(P(None, "model"), mesh) == (Replicate(),
                                                             Shard(1))
    assert sharding.to_placements(P("model", None, "data"), mesh) == (
        Shard(2), Shard(0))
    assert sharding.to_placements(P(None, ("data", "model")), mesh) == (
        Shard(1), Shard(1))
    with pytest.raises(ValueError, match="order"):
        sharding.to_placements(P(("model", "data")), mesh)
    with pytest.raises(ValueError, match="not in the mesh"):
        sharding.to_placements(P("pod"), mesh)
    with pytest.raises(ValueError, match="one axis"):
        sharding.to_placements(P("data", "data"), mesh)


def test_maybe_constrain_is_the_identity_on_plain_tensors():
    x = torch.ones(2, 3)
    assert current() is None
    assert maybe_constrain(x, "residual") is x
    with sharding_context(_fake_mesh("data", "model"),
                          {"residual": P(None, "model")}):
        assert current()["roles"] == {"residual": P(None, "model")}
        assert maybe_constrain(x, "residual") is x
        assert maybe_constrain(x, "kv_full") is x
    assert current() is None


def test_consensus_pair_builds_the_consensus_step():
    """The card's entry: a world of one classifies scout's train_4k as
    consensus with P = 256, and ``build_step`` returns the consensus step
    in the reference's argument order, with the schedule and the
    channel."""
    from repro_torch.comm.channel import ChannelSpec
    from repro_torch.core.topology import TopologySpec
    from repro_torch.core.topology_sched import ScheduleSpec
    one = launch_mesh.Mesh(group=None, rank=0, world_size=1,
                           device=torch.device("cpu"))
    pair = specs.classify("llama4-scout-17b-a16e", "train_4k", one,
                          topo_spec=TopologySpec("erdos_renyi", 8, 0.5))
    assert (pair.mode, pair.kind, pair.n_agents) == ("consensus", "train",
                                                     256)
    assert pair.topo.n_agents == 256
    with pytest.raises(ValueError, match="schedule"):
        specs.classify("jamba-v0.1-52b", "train_4k", one,
                       sched_spec=ScheduleSpec.parse("resample_er"))
    small = specs.PairSpec(
        arch="jamba-v0.1-52b-smoke", shape_name="train_4k", mode="consensus",
        kind="train", cfg=get_config("jamba-v0.1-52b-smoke"), n_agents=4,
        topo=TopologySpec("erdos_renyi", 4, 0.5),
        sched=ScheduleSpec.parse("resample_er(period=2)"),
        chan=ChannelSpec.parse("quantize(bits=8)|dropout(p=0.1)"))
    step, order = specs.build_step(small, one, device="cpu")
    assert order == ("params", "adj", "batch", "draws", "sched", "chan")
    assert step.__qualname__.startswith("make_consensus_train_step")
    info = specs.input_specs("jamba-v0.1-52b", "train_4k", MESHES["single"],
                             topo_spec=small.topo, sched_spec=small.sched,
                             chan_spec=small.chan)
    assert set(info["args"]) == set(order)
    assert info["args"]["chan"].last_sent is None
    assert info["args"]["sched"].topo.adj.device.type == "meta"
    assert info["args"]["batch"]["tokens"].shape == (16, 16, 4096)


def test_placements_on_a_2x2_gloo_mesh(tmp_path):
    env = dict(os.environ, PYTHONPATH=f"{SRC}{os.pathsep}{TESTS}",
               OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", str(RANKS), "--out", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert res.returncode == 0, (res.stdout[-2000:], res.stderr[-6000:])
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(4)]
    coords = {tuple(r["coords"].values()) for r in ranks}
    assert coords == {(0, 0), (0, 1), (1, 0), (1, 1)}
    for r in ranks:
        for name, case in r["cases"].items():
            assert all(v for k, v in case.items() if k != "placements"), (
                r["rank"], name, case)
    from torch.distributed.tensor import Shard
    assert ranks[0]["cases"]["joint"]["placements"] == [str(Shard(1))] * 2

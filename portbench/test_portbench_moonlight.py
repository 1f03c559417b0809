"""``moonlight.consensus.er``'s path at a tiny size on the CPU (the
kernels' plain versions): the program agrees with ``moonlight_ref``
within the cell's limits, the control (the reference in TF32 in the
program's place) and every planted fault come out as not correct; the
benchmark's statement of the leaves is the port's parameter tree; the
reference imports nothing of the program and a run loads no JAX; the
counts and the readers."""
import contextlib
import json
import os
import subprocess
import sys

import pytest
import torch

from portbench import faults, harness, roofline_moonlight
from portbench.reference import moonlight_ref
from portbench.runners import consensus_moonlight as cm

BENCH = harness.load_benchmark()
CELL = "moonlight.consensus.er"
SEED = 2 ** 33 + 4321          # a seed past 32 signed bits


def tiny():
    """The smoke's widths (the port's ``moonlight-16b-a3b-smoke``: the
    published per-head widths at 2 heads, a latent of 64, experts of 32),
    P = 4 members of 128 tokens."""
    _, _, config, traffic, limits = harness.find_cell(BENCH, CELL)
    config = dict(config, port_arch="moonlight-16b-a3b-smoke",
                  hidden_size=128, num_attention_heads=2,
                  num_key_value_heads=2, kv_lora_rank=64,
                  intermediate_size=256, moe_intermediate_size=32,
                  n_routed_experts=8, num_experts_per_tok=3, vocab_size=512,
                  num_hidden_layers=3, moe_group_size=64)
    return config, dict(traffic, population=4, seq_len=128), limits


def program_numbers(config, traffic, fault=None):
    with (faults.FAULTS["consensus_moonlight"][fault]() if fault
          else contextlib.nullcontext()):
        run = cm.Run(config, traffic, SEED, "cpu")
        window = run.window(0.0, spans=False)
        outputs = run.release()
    assert window["attempted"] >= 1 and window["failed"] == 0
    return cm.compare(outputs, config, traffic, SEED, "cpu")


def test_program_agrees_with_reference():
    config, traffic, limits = tiny()
    numbers = program_numbers(config, traffic)
    correct, failed = harness.judge(numbers, limits)
    assert correct, (failed, numbers)


@pytest.mark.parametrize("seed", [1, 2])
def test_control_is_not_correct(seed):
    config, traffic, limits = tiny()
    outputs = cm.control_outputs(config, traffic, seed, "cpu")
    numbers = cm.compare(outputs, config, traffic, seed, "cpu")
    correct, _ = harness.judge(numbers, limits)
    assert not correct, numbers


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered",
                                   "swapped", "shifted", "unbiased"])
def test_planted_fault_is_not_correct(fault):
    config, traffic, limits = tiny()
    numbers = program_numbers(config, traffic, fault)
    correct, _ = harness.judge(numbers, limits)
    assert not correct, (fault, numbers)


def test_steering_by_its_own_losses_changes_nothing():
    """``follow`` stepped with the coefficients of its own member losses
    is ``follow`` unsteered; steered by other losses, it steps another θ
    but computes its losses itself."""
    config, traffic, _ = tiny()
    own = cm.follow(config, traffic, SEED, "cpu", "f64")
    same = cm.follow(config, traffic, SEED, "cpu", "f64",
                     steer=own["member_losses"])
    assert numbers(same) == numbers(own)
    assert same_routes(same, own)
    reversed_ranks = [[-x for x in step] for step in own["member_losses"]]
    other = cm.follow(config, traffic, SEED, "cpu", "f64",
                      steer=reversed_ranks)
    assert other["member_losses"][0] == own["member_losses"][0]
    assert other["update_norms"] != own["update_norms"]


def numbers(out):
    return {k: v for k, v in out.items() if k != "member_routes"}


def same_routes(a, b):
    flat = [(x, y) for sa, sb in zip(a["member_routes"], b["member_routes"],
                                     strict=True)
            for la, lb in zip(sa, sb, strict=True)
            for x, y in zip(la, lb, strict=True)]
    return all(torch.equal(x, y) for x, y in flat)


def test_routing_by_its_own_choices_changes_nothing():
    """``follow`` routed by the choices it made itself is ``follow``
    routed by its own top-k, with no slack; one choice moved to an expert
    it left out reads that expert's shortfall, and a layer's choices that
    repeat an expert read malformed and are routed by its own."""
    config, traffic, _ = tiny()
    own = cm.follow(config, traffic, SEED, "cpu", "f64")
    assert own["route_slack"] == 0.0
    routes = own["member_routes"]
    assert len(routes) == 3 and len(routes[0]) == 2 * traffic["population"]
    assert len(routes[0][0]) == cm.moe_layers(config)
    same = cm.follow(config, traffic, SEED, "cpu", "f64", routes=routes)
    assert numbers(same) == numbers(own) and same_routes(same, own)

    k, e = config["num_experts_per_tok"], config["n_routed_experts"]
    moved = [[list(layers) for layers in step] for step in routes]
    ids = moved[0][0][0].clone()
    ids[0, k - 1] = next(x for x in range(e) if x not in ids[0].tolist())
    moved[0][0][0] = ids
    other = cm.follow(config, traffic, SEED, "cpu", "f64", routes=moved)
    assert 0 < other["route_slack"] < moonlight_ref.Routes.MALFORMED
    assert other["member_losses"][0][0] != own["member_losses"][0][0]
    assert torch.equal(other["member_routes"][0][0][0], ids)

    ids = ids.clone()
    ids[0, 1] = ids[0, 0]
    moved[0][0][0] = ids
    bad = cm.follow(config, traffic, SEED, "cpu", "f64", routes=moved)
    assert bad["route_slack"] == moonlight_ref.Routes.MALFORMED
    assert bad["member_losses"] == own["member_losses"]


@pytest.mark.parametrize("case", ["own", "moved", "repeated", "shape",
                                  "missing"])
def test_routes_hold_choices_to_the_reference_scores(case):
    sel = torch.tensor([[0.9, 0.1, 0.5, 0.7],
                        [0.2, 0.8, 0.6, 0.3]], dtype=torch.float64)
    ids = {"own": [[0, 3], [1, 2]], "moved": [[0, 3], [1, 3]],
           "repeated": [[0, 0], [1, 2]], "shape": [[0, 3, 2], [1, 2, 0]],
           "missing": None}[case]
    way = moonlight_ref.Routes([] if ids is None else [torch.tensor(ids)])
    got = way.route(sel, 2)
    want = {"own": 0.0, "moved": 0.6 - 0.3}.get(
        case, moonlight_ref.Routes.MALFORMED)
    assert way.slack == pytest.approx(want, abs=1e-15)
    routed = ids if case in ("own", "moved") else [[0, 3], [1, 2]]
    assert got.tolist() == routed
    assert way.taken[0].dtype == torch.int16


def test_the_stack_layout_is_the_ports():
    """The leaves (names, shapes, the order the noise seam numbers them)
    are the port's parameter tree, at the tiny size and at the
    configuration's own (meta tensors)."""
    from repro_torch.core.tree import flatten, leaf_paths
    from repro_torch.models import transformer
    for config in (tiny()[0], harness.find_cell(BENCH, CELL)[2]):
        cfg = cm.port_config(config)
        port = transformer.init_params(cfg, device="meta")
        mine = cm.abstract_tree(config)
        assert cm.leaf_paths(mine) == leaf_paths(port)
        assert [tuple(t.shape) for t in flatten(mine)] == \
            [tuple(t.shape) for t in flatten(port)]


def test_the_configuration_is_the_published_shape():
    config = harness.find_cell(BENCH, CELL)[2]
    cfg = cm.port_config(config)
    assert cfg.count_params() == 5_432_844_800
    assert (config["hidden_size"], config["kv_lora_rank"],
            config["qk_nope_head_dim"], config["qk_rope_head_dim"],
            config["v_head_dim"], config["intermediate_size"],
            config["moe_intermediate_size"], config["n_routed_experts"],
            config["num_experts_per_tok"], config["n_shared_experts"],
            config["vocab_size"], config["tie_word_embeddings"]) == (
        2048, 512, 128, 64, 128, 11264, 1408, 64, 6, 2, 163840, False)
    entry = next(c for c in BENCH["configs"]
                 if c["name"] == "moonlight-16b-a3b.consensus")
    assert entry["reduced"] == ["num_hidden_layers"]
    assert config["reduced_from"] == {"num_hidden_layers": 27}
    with pytest.raises(ValueError, match="settings"):
        cm.port_config(dict(config, kv_lora_rank=256))


def test_counts_follow_the_widths():
    config = harness.find_cell(BENCH, CELL)[2]
    flops = roofline_moonlight.loss_dot_flops(config, 4096)
    assert abs(flops / 9.647e12 - 1) < 1e-3
    assert roofline_moonlight.step_flops(config, 8, 4096) == 16 * flops
    f, _ = roofline_moonlight.flash_mla(config, 4096)
    assert abs(f / 8.59e10 - 1) < 1e-3
    assert roofline_moonlight.calls_per_step(config, 8) == {
        "flash_mla": 144, "router_sigmoid": 128}


def test_readers_return_nothing_without_data():
    ctx = {"window": {"metrics": {"consensus_step_ms": 1000.0}},
           "profile": {"by_name": {}, "busy_s": 0.0, "window_s": 1.0,
                       "kernels": 0, "iters": 1,
                       "phases": {"ranges": {}, "unattributed_idle_s": 0.0}},
           "counts": {"step_flops": 1e12}}
    for name in ("mla_ms.consensus", "shared_experts_ms.consensus",
                 "flash_mla_roofline.consensus",
                 "router_sigmoid_roofline.consensus",
                 "moe_dropped.consensus"):
        assert harness.load_module("metrics", name).read(ctx) is None, name


REFERENCE = """
import json, sys
import portbench.reference.moonlight_ref
print(json.dumps(sorted({n.split('.')[0] for n in sys.modules})))
"""

RUN = """
import json
from portbench import harness
from portbench.test_portbench_moonlight import tiny
from portbench.runners import consensus_moonlight as cm
config, traffic, _ = tiny()
run = cm.Run(config, traffic, 7, "cpu")
run.window(0.0, spans=False)
cm.compare(run.release(), config, traffic, 7, "cpu")
print(json.dumps(harness.forbidden_loaded()))
"""


def _python(code):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(harness.REPO), str(harness.REPO / "src")])
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True, timeout=600,
                         cwd=harness.REPO)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_reference_imports_nothing_of_the_program():
    tops = set(_python(REFERENCE))
    assert not tops & {"jax", "jaxlib", "flax", "repro", "repro_torch"}


def test_a_run_loads_no_jax_and_not_the_jax_package():
    assert _python(RUN) == []


def test_drops_are_read_from_a_traced_step():
    """A step under a profiler counts the dispatch's dropped pairs (the
    counters of ``obs.regions``), as ``Run.traced`` reads them on the
    card; an untraced window counts none."""
    from repro_torch.obs import regions
    config, traffic, _ = tiny()
    run = cm.Run(config, traffic, SEED, "cpu")
    regions.reset_counters()
    run.window(0.0, spans=False)
    assert "moe_routed" not in run.counts() and regions.counters() == {}
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        run._one()
    run.counters = regions.counters()
    regions.reset_counters()
    counts = run.counts()
    moe_layers = config["num_hidden_layers"] - config["first_k_dense_replace"]
    assert counts["moe_routed"] == (2 * traffic["population"] * moe_layers
                                    * traffic["seq_len"]
                                    * config["num_experts_per_tok"])
    assert 0 <= counts["moe_dropped"] < counts["moe_routed"]
    ctx = {"counts": counts}
    share = harness.load_module("metrics", "moe_dropped.consensus").read(ctx)
    assert share == pytest.approx(100 * counts["moe_dropped"]
                                  / counts["moe_routed"])
    assert torch.is_tensor(run.params["lm_head"])

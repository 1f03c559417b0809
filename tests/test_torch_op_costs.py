"""The op recorder (``launch/op_costs.py``, the port's counterpart of
``repro.launch.hlo_parse``) and the kernels' cost reports.

* every matmul kind counts 2 · out elements · contracted size;
* on a fake 2 × 2 mesh a sharded matmul counts per device what its layout
  leaves each device of the world-of-one count, and the redistribution's
  collectives by kind; a 4-rank halo plan's recorded permute bytes equal
  the plan's own ``collective_bytes`` (``tests/_torch_op_costs_ranks.py``,
  in a process of its own);
* each kernel wrapper reports the dot FLOPs that the recorder counts for
  its plain version on the same operands, and the bytes of its operands
  and results; its shape-only path is taken on fake and meta tensors and
  never on real ones;
* folding (``repeat_map``, ``passes``, the layers by the reference's
  stacking) counts what the full trace counts;
* the consensus step traced on fake tensors counts the dot FLOPs of the
  same step run for real (on the CPU, through the kernels' plain
  versions): the CPU side of ``chip_smoke.py``'s ``tooling`` check.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import get_config
from repro_torch.core.netes import NetESConfig
from repro_torch.core.topology import TopologySpec
from repro_torch.data import make_batch
from repro_torch.distributed import netes_dist
from repro_torch.kernels import _checks, ref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import mamba_scan as ms
from repro_torch.kernels import moe_router as mr
from repro_torch.kernels import netes_fused_mixing as nfm
from repro_torch.kernels import netes_mixing as nm
from repro_torch.kernels import netes_sparse_mixing as nsm
from repro_torch.kernels import rwkv6_wkv as rw
from repro_torch.launch import op_costs, specs
from repro_torch.launch.mesh import NamedShape
from repro_torch.launch.op_costs import OpCosts
from repro_torch.models import transformer

REPO = Path(__file__).resolve().parent.parent


def _flops(fn, *args):
    with OpCosts() as rec:
        fn(*args)
    return rec.costs()["dot_flops"]


@pytest.mark.parametrize("case", ["mm", "bmm", "addmm", "baddbmm", "mv",
                                  "dot", "matmul", "einsum", "linear"])
def test_every_matmul_kind_counts_its_products(case):
    g = torch.Generator().manual_seed(0)
    a = torch.randn(6, 5, generator=g)
    b = torch.randn(5, 4, generator=g)
    a3 = torch.randn(3, 6, 5, generator=g)
    b3 = torch.randn(3, 5, 4, generator=g)
    fn, args, want = {
        "mm": (torch.mm, (a, b), 2 * 6 * 4 * 5),
        "bmm": (torch.bmm, (a3, b3), 2 * 3 * 6 * 4 * 5),
        "addmm": (torch.addmm, (torch.zeros(6, 4), a, b), 2 * 6 * 4 * 5),
        "baddbmm": (torch.baddbmm, (torch.zeros(3, 6, 4), a3, b3),
                    2 * 3 * 6 * 4 * 5),
        "mv": (torch.mv, (a, b[:, 0].contiguous()), 2 * 6 * 5),
        "dot": (torch.dot, (a[0], a[1]), 2 * 5),
        "matmul": (torch.matmul, (a3, b), 2 * 3 * 6 * 4 * 5),
        "einsum": (lambda x, y: torch.einsum("bsd,dk->bsk", x, y), (a3, b),
                   2 * 3 * 6 * 4 * 5),
        "linear": (F.linear, (a3, b.t()), 2 * 3 * 6 * 4 * 5),
    }[case]
    assert _flops(fn, *args) == want


def test_touch_bytes_and_memory_tally():
    """Every non-view result counts twice its bytes; the live tally rises
    by what a result allocates and falls when it dies; an in-place result
    allocates nothing."""
    x = torch.zeros(1000)
    with OpCosts() as rec:
        y = x + 1.0                    # 4000 bytes
        y.mul_(2.0)                    # in place: touches, allocates nothing
        z = y.view(10, 100)            # a view: neither
        del y, z
        w = torch.ones(500)            # 2000 bytes, after y died
    costs, mem = rec.costs(), rec.memory()
    assert costs["touch_bytes"] == 2 * (4000 + 4000 + 2000)
    assert mem["temp_peak_bytes"] == 4000
    assert mem["output_bytes"] == 2000
    del w


def test_peak_is_split_by_the_op_that_made_each_storage():
    """``peak_by_op``: the storages alive at the peak, by their op; the
    split sums to the peak."""
    x = torch.zeros(1000)
    with OpCosts() as rec:
        a = x + 1.0                    # 4000 bytes
        b = torch.exp(x)               # 4000 bytes: the peak, 8000
        del a, b
        c = torch.ones(1500)           # 6000 bytes, below the peak
    assert rec.peak_by_op == {"aten.add.Tensor": 4000,
                              "aten.exp.default": 4000}
    assert sum(rec.peak_by_op.values()) == rec.memory()["temp_peak_bytes"]
    del c


@pytest.fixture(scope="module")
def ranks():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run(
        [sys.executable, str(REPO / "tests" / "_torch_op_costs_ranks.py")],
        env=env, capture_output=True, text=True, timeout=300, cwd=REPO)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("layout,share,kind", [
    ("rows_over_data", 2, "all-gather"),
    ("rows_over_both", 4, "all-gather"),
    ("k_over_model", 2, "all-reduce")])
def test_a_sharded_matmul_counts_per_device(ranks, layout, share, kind):
    """(64, 32) @ (32, 16): the rows split over "data" leave each device
    half of the world-of-one FLOPs, over both axes a quarter; K split
    over "model" half, the result Partial, summed by one all-reduce of the
    (64, 16) float32 result (bytes × 2)."""
    mm = ranks["matmul"]
    assert mm["world_of_one"] == 2 * 64 * 16 * 32
    assert mm[layout]["dot_flops"] == mm["world_of_one"] / share
    assert mm[layout]["kinds"][kind] >= 1
    if kind == "all-reduce":
        assert mm[layout]["all-reduce_bytes"] == 2 * 64 * 16 * 4


def test_halo_plan_bytes_equal_the_plans_own_figure(ranks):
    """The halo rounds go through ``batch_isend_irecv``: the dispatcher
    sees them as ``c10d.send`` and ``c10d.recv_``, and a round counts once,
    at the receiver, as a collective-permute."""
    assert len(ranks["halo"]) == 4
    for shard in ranks["halo"]:
        assert shard["mode"] == "halo" and shard["rounds"] >= 1
        assert shard["recorded"] == shard["plan"] > 0


# ---------------------------------------------------------------------------
# the kernels' reports against their plain versions
# ---------------------------------------------------------------------------

def _kernel_cases():
    g = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.randn(*shape, generator=g)

    n, k, p = 6, 3, 10
    idx = torch.randint(0, n, (n, k), generator=g, dtype=torch.int32)
    mask = (torch.rand(n, k, generator=g) < 0.7).float()
    codes = torch.randint(-127, 128, (n, p), generator=g, dtype=torch.int8)
    scale = torch.rand(n, 1, generator=g)
    adj = (torch.rand(n, n, generator=g) < 0.5).float()
    decay = torch.rand(2, 5, 4, 3, generator=g)
    return {
        "flash_attention": (
            lambda *a: fa.flash_attention(*a, causal=True),
            lambda *a: ref.flash_attention_ref(*a, causal=True),
            (r(2, 7, 4, 8), r(2, 7, 2, 8), r(2, 7, 2, 8))),
        "netes_mixing": (
            lambda *a: nm.netes_mixing(*a, sigma=0.1),
            lambda *a: ref.netes_mixing_ref(*a, sigma=0.1),
            (adj, r(n), r(n), r(n, p), r(n, p))),
        "netes_mixing_rs": (nm.netes_mixing_rs, ref.netes_mixing_rs_ref,
                            (adj[:4], r(n), r(n, p), r(4, p))),
        "netes_sparse_mixing": (
            lambda *a: nsm.netes_sparse_mixing(*a, sigma=0.1),
            lambda *a: ref.sparse_mixing_ref(*a, sigma=0.1),
            (idx, mask, r(n), r(n), r(n, p), r(n, p))),
        "netes_sparse_mixing_rs": (nsm.netes_sparse_mixing_rs,
                                   ref.sparse_mixing_rs_ref,
                                   (idx, mask, r(n), r(n, p), r(n, p))),
        "fused_neighbor_sum": (nfm.fused_neighbor_sum,
                               ref.fused_neighbor_sum_ref,
                               (idx, mask, r(n), codes, scale)),
        "fused_neighbor_sum_rs": (nfm.fused_neighbor_sum_rs,
                                  ref.fused_neighbor_sum_rs_ref,
                                  (idx, mask, r(n), codes, scale, r(n, p))),
        "fused_broadcast_select": (nfm.fused_broadcast_select,
                                   ref.broadcast_select_ref,
                                   (codes[0], scale[0], torch.tensor(True),
                                    r(n, p))),
        "moe_topk": (lambda x: mr.moe_topk(x, 2),
                     lambda x: ref.moe_topk_ref(x, 2), (r(9, 8),)),
        "mamba_scan": (ms.mamba_scan, ref.mamba_scan_ref,
                       (decay, r(2, 5, 4, 3), r(2, 4, 3))),
        "rwkv6_wkv": (rw.rwkv6_wkv, ref.rwkv6_wkv_ref,
                      (r(2, 5, 3, 4), r(2, 5, 3, 4), r(2, 5, 3, 4),
                       torch.rand(2, 5, 3, 4, generator=g), r(3, 4),
                       r(2, 3, 4, 4))),
    }


KERNELS = sorted(_kernel_cases())


def _fake(mode, args):
    return tuple(mode.from_tensor(a) if isinstance(a, torch.Tensor) else a
                 for a in args)


@pytest.mark.parametrize("name", KERNELS)
def test_kernel_reports_its_plain_versions_dot_flops(name):
    """The wrapper on fake tensors (its shape-only path) reports the dot
    FLOPs that the recorder counts for the plain version on the real
    operands, and the bytes of its operands and results."""
    wrapper, plain, args = _kernel_cases()[name]
    with OpCosts() as rec_plain:
        want = plain(*args)
    mode = FakeTensorMode()
    fake_args = _fake(mode, args)
    with mode, OpCosts() as rec:
        got = wrapper(*fake_args)
    assert rec.kernels == {name: 1.0}
    assert rec.costs()["kernel_flops"] == rec_plain.costs()["dot_flops"]
    outs = got if isinstance(got, tuple) else (got,)
    wants = want if isinstance(want, tuple) else (want,)
    assert [tuple(o.shape) for o in outs] == [tuple(w.shape) for w in wants]
    moved = sum(t.numel() * t.element_size()
                for t in (*args, *outs) if isinstance(t, torch.Tensor))
    assert rec.costs()["kernel_bytes"] == moved


@pytest.mark.parametrize("name", KERNELS)
def test_shape_only_path_is_for_fake_and_meta_tensors_only(name):
    """Meta operands: empty meta results of the plain version's shapes,
    the costs reported. Real CPU operands: the plain version's values and
    no report (a real CUDA tensor reaches the kernel, as the chip run
    shows: ``chip_smoke.py`` counts its launches)."""
    wrapper, plain, args = _kernel_cases()[name]
    meta = tuple(a.to("meta") if isinstance(a, torch.Tensor) else a
                 for a in args)
    assert _checks.shape_only(meta)
    assert not _checks.shape_only(args)
    with OpCosts() as rec:
        got = wrapper(*meta)
    assert rec.kernels == {name: 1.0}
    outs = got if isinstance(got, tuple) else (got,)
    wants = plain(*args)
    wants = wants if isinstance(wants, tuple) else (wants,)
    assert all(o.device.type == "meta" for o in outs)
    assert [tuple(o.shape) for o in outs] == [tuple(w.shape) for w in wants]
    with OpCosts() as rec:
        real = wrapper(*args)
    assert rec.kernels == {}
    real = real if isinstance(real, tuple) else (real,)
    for r_, w in zip(real, wants, strict=True):
        assert torch.equal(r_, w)


# ---------------------------------------------------------------------------
# folding, and the consensus step fake against real
# ---------------------------------------------------------------------------

def test_repeat_map_and_passes_fold_only_under_a_folding_recorder():
    calls = []
    assert op_costs.repeat_map(lambda i: calls.append(i) or i, 3) == [0, 1, 2]
    assert list(op_costs.passes(3)) == [0, 1, 2]
    x = torch.ones(4, 4)
    with OpCosts(fold=True) as rec:
        out = op_costs.repeat_map(lambda i: x @ x, 5)
        for _ in op_costs.passes(3):
            x @ x
    assert len(out) == 5 and out[0] is out[4]
    assert rec.costs()["dot_flops"] == (5 + 3) * 2 * 4 * 4 * 4


def _consensus(arch, n_pop=2, seq=64, layers=None):
    cfg = get_config(arch)
    pair = specs.classify(arch, "train_4k", NamedShape(("data", "model"),
                                                       (1, 1)),
                          topo_spec=TopologySpec(family="erdos_renyi",
                                                 n_agents=n_pop, p=0.5))
    pair = dataclasses.replace(
        pair, mode="consensus", n_agents=n_pop,
        topo=dataclasses.replace(pair.topo, n_agents=n_pop),
        cfg=cfg if layers is None else dataclasses.replace(
            cfg, num_layers=layers))
    shape = dict(seq_len=seq, global_batch=n_pop, kind="train")
    ncfg = NetESConfig(alpha=1e-6, sigma=1e-3, p_broadcast=0.5)
    return specs.lower(pair, NamedShape(("data", "model"), (1, 1)),
                       shape=shape, ncfg=ncfg, device="cpu")


def _step_pair(lowered, n_pop=2, seq=64):
    cfg = lowered.pair.cfg
    params = transformer.init_params(cfg, seed=0, device="cpu")
    batch = make_batch(cfg, dict(global_batch=n_pop, seq_len=seq),
                       torch.Generator().manual_seed(1))
    batch = {k: v.reshape((n_pop, 1) + v.shape[1:]) for k, v in
             batch.items()}
    draws = netes_dist.StepDraws(noise=netes_dist.NoiseStream(11, 0),
                                 beta=torch.full((), 1.0))
    return params, batch, draws


@pytest.mark.parametrize("arch", ["llama4-scout-17b-a16e-smoke",
                                  "jamba-v0.1-52b-smoke"])
def test_folded_trace_counts_the_full_trace(arch):
    """The members folded (one traced, counted P times) and the layers
    folded by the reference's stacking (8 layers: a period repeated ≥ 4
    times) count the FLOPs, bytes and kernel reports of the full trace."""
    lowered = _consensus(arch, layers=8)
    assert transformer.stack_plan(lowered.pair.cfg)[2] >= 4
    folded, full = lowered.trace(fold=True), lowered.trace(fold=False)
    for key in ("dot_flops", "dot_bytes", "kernel_flops", "kernel_bytes",
                "touch_bytes"):
        assert folded.costs()[key] == full.costs()[key], key
    assert folded.kernels == full.kernels


@pytest.mark.parametrize("arch", ["llama4-scout-17b-a16e-smoke",
                                  "jamba-v0.1-52b-smoke"])
def test_consensus_trace_counts_the_real_steps_flops(arch):
    """``lower(...).trace()`` on fake tensors (the kernels' shape-only
    paths report) against the same step run on real CPU tensors (the
    kernels' plain versions run and are recorded): the dot FLOPs are
    equal, and so is the live-storage peak of the two runs."""
    lowered = _consensus(arch)
    fake = lowered.trace(fold=True)
    params, batch, draws = _step_pair(lowered)
    with OpCosts() as real:
        lowered.fn(params, None, batch, draws)
    assert fake.kernels and not real.kernels
    assert fake.costs()["dot_flops"] == real.costs()["dot_flops"]
    assert fake.costs()["kernel_flops"] > 0
    assert np.isfinite(float(params["embed"].sum()))


@pytest.mark.parametrize("arch", ["rwkv6-7b-smoke", "jamba-v0.1-52b-smoke"])
def test_folded_chunk_loops_count_the_full_trace(arch):
    """The plain forward's chunk loops (rwkv's chunked WKV, mamba's
    chunked scan) fold to one chunk under a folding recorder and count
    what the full trace counts, on a prefill pair long enough for 4
    chunks."""
    shape = dict(seq_len=4096, global_batch=1, kind="prefill")
    pair = specs.classify(arch, "prefill_32k",
                          NamedShape(("data", "model"), (1, 1)))
    lowered = specs.lower(pair, NamedShape(("data", "model"), (1, 1)),
                          shape=shape)
    folded, full = lowered.trace(fold=True), lowered.trace(fold=False)
    for key in ("dot_flops", "dot_bytes", "touch_bytes"):
        assert folded.costs()[key] == full.costs()[key], key

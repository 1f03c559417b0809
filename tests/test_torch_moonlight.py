"""moonlight-16b-a3b (a port-only architecture: latent attention, sigmoid
routing with a fixed bias and shared experts, an untied unembedding)
against its plain reference ``portbench/reference/moonlight_ref.py``, on
seeded random weights at the ``-smoke`` size, on the CPU; and the two new
kernel instances against their plain versions on the card (marked
``card``; they skip without one). This file imports no JAX, so on a
machine with the card it runs without this directory's conftest:

    PYTHONPATH=src python -m pytest -q --noconftest -m card \\
        tests/test_torch_moonlight.py

Tolerances, with their reasons:

* float64 through the port against the float64 reference: rtol = atol =
  1e-6. The port's float64 path rounds two things to float32 where the
  reference does not: RoPE's angles and rotation (``layers.apply_rope``)
  and RMSNorm's mean square (``layers.rmsnorm``). At 128 positions and
  these widths that moves the outputs by ≤ 2e-7 (measured); a missing
  mask, scale, RoPE term or norm moves them by ≥ 1e-2.
* float32 through the port (the kernel path's plain versions) against the
  float64 reference: rtol = atol = 2e-5, float32's rounding over the
  block's sums (≈ 2e-6 measured), as ``test_torch_lm.py``'s.
* The router: ids EQUAL, gates within 1e-6. Ids can differ only where two
  biased scores of a token lie within float32's rounding of each other,
  so each input's smallest gap between its k-th and (k+1)-th biased score
  is asserted to be above 1e-6 (as slice 6b's router tests do); gates are
  scores ≤ 1 over a sum of k of them, ≈ 1e-7 apart.
* The MoE layers route as the reference only away from near-ties: the
  model tests assert the same gap of every routed token.
* The consensus steps: the cell's own limits (``limits/
  moonlight.consensus.er.json``), at the smoke size.
"""
import dataclasses

import pytest
import torch

from portbench import harness
from portbench.reference import moonlight_ref
from portbench.runners import consensus_moonlight as cm
from repro_torch.configs import get_config
from repro_torch.core.tree import tree_map
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import moe_router as mr
from repro_torch.kernels import ref
from repro_torch.models import mla, moe, transformer

SMOKE = "moonlight-16b-a3b-smoke"
F64 = dict(rtol=1e-6, atol=1e-6)
F32 = dict(rtol=2e-5, atol=2e-5)
MIN_GAP = 1e-6
S = 128


def ref_config(cfg) -> dict:
    """The reference's configuration (the catalog's keys) of a port
    config."""
    return {"hidden_size": cfg.d_model, "num_attention_heads": cfg.num_heads,
            "kv_lora_rank": cfg.kv_lora_rank,
            "qk_nope_head_dim": cfg.qk_nope_head_dim,
            "qk_rope_head_dim": cfg.qk_rope_head_dim,
            "v_head_dim": cfg.v_head_dim, "rope_theta": cfg.rope_theta,
            "rms_norm_eps": cfg.norm_eps, "intermediate_size": cfg.d_ff,
            "moe_intermediate_size": cfg.moe_d_ff,
            "n_routed_experts": cfg.num_experts,
            "num_experts_per_tok": cfg.experts_per_token,
            "n_shared_experts": cfg.n_shared_experts,
            "routed_scaling_factor": cfg.routed_scaling_factor,
            "first_k_dense_replace": cfg.first_dense_layers,
            "num_hidden_layers": cfg.num_layers,
            "vocab_size": cfg.vocab_size,
            "moe_group_size": cfg.moe_group_size,
            "moe_capacity_factor": cfg.moe_capacity_factor,
            "assumed": {"e_score_correction_bias": {
                "seed": cfg.router_bias_seed, "std": cfg.router_bias_std}}}


def getter(tree):
    def get(path):
        node = tree
        for k in path:
            node = node[k]
        return node
    return get


@pytest.fixture(scope="module")
def model():
    cfg = get_config(SMOKE)
    params = transformer.init_params(cfg, seed=3, device="cpu")
    # weights of a usual spread for the whole stack: the inits' draws
    # with every weight's own scale, the norms ones
    return cfg, params, tree_map(lambda t: t.double(), params)


def inputs(cfg, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(1, S, cfg.d_model, generator=g, dtype=torch.float64)
    return x, torch.arange(S)


# --------------------------------------------------------------------------
# the latent-attention mixer
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kernel", [True, False], ids=["flash", "blockwise"])
def test_mla_block_matches_reference(model, kernel):
    cfg, p32, p64 = model
    spec = mla.mla_spec(cfg)
    x, pos = inputs(cfg)
    rc = ref_config(cfg)
    want = moonlight_ref.mla(getter(p64["layers"][0]["mla"]), (), x[0], rc,
                             "f64")
    if not kernel:      # the flash wrapper takes float32 only
        got64 = mla.mla_block(p64["layers"][0]["mla"], spec, x, pos,
                              kernel=False)[0]
        torch.testing.assert_close(got64, want, **F64)
    got32 = mla.mla_block(p32["layers"][0]["mla"], spec, x.float(), pos,
                          kernel=kernel)[0]
    torch.testing.assert_close(got32.double(), want, **F32)


def test_flash_plain_version_takes_two_widths():
    """The wrapper's plain path at q/k 192, v 128 against attention
    written out, and its shape checks."""
    g = torch.Generator().manual_seed(1)
    q = torch.randn(2, 40, 4, 192, generator=g)
    k = torch.randn(2, 40, 2, 192, generator=g)
    v = torch.randn(2, 40, 2, 128, generator=g)
    out = fa.flash_attention(q, k, v, causal=True)
    assert out.shape == (2, 40, 4, 128)
    kk = k.repeat_interleave(2, dim=2).double()
    vv = v.repeat_interleave(2, dim=2).double()
    sc = torch.einsum("bqhd,bkhd->bhqk", q.double(), kk) / 192 ** 0.5
    sc = sc.masked_fill(~torch.ones(40, 40, dtype=torch.bool).tril(),
                        float("-inf"))
    want = torch.einsum("bhqk,bkhd->bqhd", sc.softmax(-1), vv)
    torch.testing.assert_close(out.double(), want, **F32)
    assert fa.flops(2, 40, 40, 4, 192, 128) == 2.0 * 2 * 4 * 40 * 40 * 320
    with pytest.raises(ValueError, match="shapes"):
        fa.flash_attention(q, k, v[:, :, :1])


# --------------------------------------------------------------------------
# the sigmoid router and the MoE layer
# --------------------------------------------------------------------------

def _biased_gap(logits, bias, k):
    sel = torch.sigmoid(logits.double()) + bias.double()
    top = torch.sort(sel, dim=-1, descending=True).values
    return float((top[:, k - 1] - top[:, k]).min())


@pytest.mark.parametrize("t,e,k", [(300, 64, 6), (100, 8, 3)])
def test_sigmoid_router_matches_the_published_rule(t, e, k):
    g = torch.Generator().manual_seed(t)
    logits = torch.randn(t, e, generator=g)
    bias = moe.router_bias(0, 0.01, e, "cpu")
    assert _biased_gap(logits, bias, k) > MIN_GAP
    gates, ids = mr.moe_topk_sigmoid(logits, bias, k, 2.446)
    s = torch.sigmoid(logits.double())
    want_ids = torch.topk(s + bias.double(), k, dim=-1).indices
    assert torch.equal(ids.long(), want_ids)
    vals = s.gather(1, want_ids)
    want = vals / (vals.sum(-1, keepdim=True) + 1e-20) * 2.446
    torch.testing.assert_close(gates.double(), want, rtol=0, atol=1e-6)
    # the bias decides at least one token's experts
    plain = torch.topk(s, k, dim=-1).indices
    assert not torch.equal(plain.sort(-1).values, want_ids.sort(-1).values)
    assert bias.abs().min() > 0


def test_sigmoid_router_ties_go_to_the_lower_index():
    logits = torch.zeros(2, 8)
    gates, ids = ref.moe_topk_sigmoid_ref(logits, torch.zeros(8), 3, 1.0)
    assert ids.tolist() == [[0, 1, 2], [0, 1, 2]]
    torch.testing.assert_close(gates, torch.full((2, 3), 1 / 3))


def test_moe_layer_matches_reference(model):
    """The routed experts (capacity dispatch) plus the shared experts, in
    float64 through the plain router, against the reference."""
    cfg, _, p64 = model
    layer = p64["layers"][1]
    x, _ = inputs(cfg, seed=2)
    logits = x[0] @ layer["moe"]["router"]
    bias = moe.router_bias(0, 0.01, cfg.num_experts, "cpu")
    assert _biased_gap(logits, bias, cfg.experts_per_token) > MIN_GAP
    got = transformer._ffn(layer, cfg, cfg.layer_specs()[1], x,
                           kernel=False)[0]
    rc = ref_config(cfg)
    get = getter(layer)
    want = (moonlight_ref.moe(get, ("moe",), x[0], rc, "f64")
            + moonlight_ref._swiglu_at(get, ("shared",), x[0], "f64"))
    torch.testing.assert_close(got, want, **F64)


def test_drops_are_counted_only_under_a_profiler(model):
    from repro_torch.obs import regions
    cfg, p32, _ = model
    x, _ = inputs(cfg, seed=4)
    spec = dataclasses.replace(transformer.moe_spec(cfg),
                               capacity_factor=0.5)
    assert spec.count_drops
    regions.reset_counters()
    moe.moe_block(p32["layers"][1]["moe"], spec, x.float())
    assert regions.counters() == {}
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        moe.moe_block(p32["layers"][1]["moe"], spec, x.float())
    got = regions.counters()
    regions.reset_counters()
    cap = moe.group_capacity(spec, spec.group_size)
    routed = S * spec.experts_per_token
    assert got["moe.routed"] == routed
    assert got["moe.dropped"] >= routed - spec.num_experts * cap * (
        S // spec.group_size)


def test_untimed_drop_count_runs_no_ops(model):
    """Without a profiler, counting drops adds no operation to the MoE
    layer: the ops dispatched are those of a spec that counts nothing."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.names = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.names.append(str(func))
            return func(*args, **(kwargs or {}))

    cfg, p32, _ = model
    x, _ = inputs(cfg, seed=4)
    spec = dataclasses.replace(transformer.moe_spec(cfg),
                               capacity_factor=0.5)
    seen = {}
    for count in (True, False):
        with Ops() as ops:
            moe.moe_block(p32["layers"][1]["moe"],
                          dataclasses.replace(spec, count_drops=count),
                          x.float())
        seen[count] = ops.names
    assert seen[True] == seen[False] and seen[True]


def test_renamed_config_builds_the_same_model(model):
    """A port-only arch's settings live on its config: renamed through
    ``dataclasses.replace``, it builds and scores the same model."""
    cfg, p32, _ = model
    other = dataclasses.replace(cfg, name="renamed")
    params = transformer.init_params(other, seed=3, device="cpu")
    assert tree_map(lambda a: a.shape, params) == \
        tree_map(lambda a: a.shape, p32)
    tok = torch.randint(0, cfg.vocab_size, (1, S),
                        generator=torch.Generator().manual_seed(5))
    batch = {"tokens": tok, "labels": tok}
    torch.testing.assert_close(transformer.forward(params, other, batch),
                               transformer.forward(p32, cfg, batch),
                               rtol=0, atol=0)


# --------------------------------------------------------------------------
# the whole loss, and what the port does not serve
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_loss_matches_reference(model, dtype):
    cfg, p32, p64 = model
    params = p64 if dtype == "f64" else p32
    tok = torch.randint(0, cfg.vocab_size, (1, S),
                        generator=torch.Generator().manual_seed(5))
    got = transformer.loss_fn(params, cfg, {"tokens": tok, "labels": tok})
    want = moonlight_ref.loss(getter(p64), tok[0], ref_config(cfg), "f64")
    torch.testing.assert_close(got.double(), want,
                               **(F64 if dtype == "f64" else F32))
    if dtype == "f64":
        logits = transformer.forward(p64, cfg, {"tokens": tok})
        assert logits.shape == (1, S, cfg.vocab_size)


def test_untied_unembedding_and_serving_raise(model):
    cfg, p32, _ = model
    assert not cfg.tie_embeddings
    assert p32["lm_head"].shape == (cfg.d_model, cfg.vocab_size)
    for fn in (lambda: transformer.init_cache(cfg, 1, 8, torch.float32,
                                              device="cpu"),
               lambda: transformer.prefill(p32, cfg, {"tokens": torch.zeros(
                   1, 4, dtype=torch.long)}, {}),
               lambda: transformer.decode_step(
                   p32, cfg, torch.zeros(1, 1, dtype=torch.long), {},
                   torch.zeros(1, dtype=torch.long))):
        with pytest.raises(NotImplementedError, match="latent"):
            fn()


def test_published_shape():
    cfg = get_config("moonlight-16b-a3b")
    assert cfg.count_params() == 15_960_106_496
    assert dataclasses.replace(cfg, num_layers=9).count_params() == \
        5_432_844_800
    assert [(s.mixer, s.ffn) for s in cfg.layer_specs()[:2]] == [
        ("mla", "swiglu"), ("mla", "moe")]
    assert (cfg.qk_head_dim, cfg.v_head_dim, cfg.kv_lora_rank,
            cfg.moe_d_ff, cfg.n_shared_experts) == (192, 128, 512, 1408, 2)
    assert get_config("moonshot-v1-16b-a3b").num_layers == 48


# --------------------------------------------------------------------------
# three consensus steps against the reference's, one case per broadcast
# outcome of the checked steps
# --------------------------------------------------------------------------

def tiny():
    bench = harness.load_benchmark()
    _, _, config, traffic, limits = harness.find_cell(
        bench, "moonlight.consensus.er")
    cfg = get_config(SMOKE)
    rc = ref_config(cfg)
    config = dict(config, port_arch=SMOKE,
                  **{k: v for k, v in rc.items() if k in config
                     and k != "assumed"},
                  num_key_value_heads=cfg.num_kv_heads)
    return config, dict(traffic, population=4, seq_len=S), limits


@pytest.mark.parametrize("pattern", [[False, True, False],
                                     [True, False, True]],
                         ids=["update-broadcast-update",
                              "broadcast-update-broadcast"])
def test_consensus_steps_follow_the_reference(pattern):
    config, traffic, limits = tiny()
    traffic = dict(traffic, check_broadcast=pattern)
    seed = 2 ** 33 + 99
    run = cm.Run(config, traffic, seed, "cpu")
    outputs = run.release()
    numbers = cm.compare(outputs, config, traffic, seed, "cpu")
    correct, failed = harness.judge(numbers, limits)
    assert correct, (failed, numbers)


# --------------------------------------------------------------------------
# the kernels, on the card
# --------------------------------------------------------------------------

@pytest.fixture
def card():
    """Skips the test where no CUDA card is visible; decided when the
    test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.card
def test_flash_192_128_on_the_card(card):
    """The instance against its plain version at moonlight's shape: 1 ×
    4096, 16 heads, causal, float32 (atol 2e-5 as ``F32``: both sum in
    float32 in other orders)."""
    g = torch.Generator(device=card).manual_seed(7)
    q = torch.randn(1, 4096, 16, 192, device=card, generator=g)
    k = torch.randn(1, 4096, 16, 192, device=card, generator=g)
    v = torch.randn(1, 4096, 16, 128, device=card, generator=g)
    got = fa.flash_attention(q, k, v, causal=True)
    want = ref.flash_attention_ref(q, k, v, causal=True)
    torch.testing.assert_close(got, want, **F32)
    pl, resident = fa.launch_plan(1, 4096, 16, 16, 192, 128)
    assert pl.rows == 128 and resident >= 1


@pytest.mark.card
def test_router_sigmoid_on_the_card(card):
    """The (64, 6) instance and the generic one against the plain version
    on the card: ids EQUAL (above the asserted gap), gates within 1e-6."""
    g = torch.Generator(device=card).manual_seed(8)
    for t, e, k in ((4096, 64, 6), (1000, 8, 3)):
        logits = torch.randn(t, e, device=card, generator=g)
        bias = moe.router_bias(0, 0.01, e, card)
        assert _biased_gap(logits, bias, k) > MIN_GAP
        gates, ids = mr.moe_topk_sigmoid(logits, bias, k, 2.446)
        w_gates, w_ids = ref.moe_topk_sigmoid_ref(logits, bias, k, 2.446)
        assert torch.equal(ids, w_ids)
        torch.testing.assert_close(gates, w_gates, rtol=0, atol=1e-6)
        info = mr.launch_info(t, e, k, card.index or 0, sigmoid=True)
        assert info["local_bytes"] == 0

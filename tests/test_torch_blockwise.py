"""The port's ``blockwise_attention`` (the full forward's attention,
``attention_block``), standard ES's ``es_step`` and ``train.loop.
build_adjacency`` against the JAX reference.

``repro.models`` does not import in this process (ROADMAP queue 3, item
a), so a session fixture runs the ``blockwise`` part of
``tests/_torch_lm_ref.py`` once in a subprocess and loads the npz it
writes: the reference's ``blockwise_attention`` at query blocks of 40 and
key blocks of 48 over its patterns (full causal, sliding, chunked,
non-causal self attention, cross attention with Sq ≠ Sk; G = 1 and 2;
head_dim 32 and 64), its ``attention_block`` over 1100 positions (three
query blocks of 512 and two key blocks of 1024, both padded), its
non-causal attention over 1500 keys (548 padded keys), and three
``es_step``s on the sphere landscape with the ε each drew.

Tolerances. Against the reference, float32: rtol = atol = 1e-5. Both
sides run the same online softmax over the same blocks and sum in other
orders, which moves the outputs by ≈ 5e-7; a wrong mask, block offset or
rescale moves them by ≥ 1e-2. Against ``kernels.ref.flash_attention_ref``
(naive softmax attention) in float64: 1e-12 absolute, where the two
forms differ by float64 rounding (≈ 1e-15). ``es_step``: rtol = atol =
1e-6 on θ and the rewards, where the sums over 16 agents of 12 columns
round ≈ 1e-7 apart.

The reference's ``blockwise_attention`` masks padded keys only under the
causal and chunked masks (ROADMAP, the reference's fault i): the patterns
above keep its non-causal Sk at multiples of the key block, and
``test_reference_counts_padded_keys_the_port_does_not`` shows the gap
where they are not.
"""
import math
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_lm_ref import (B, BW_BLOCK_D, BW_BLOCK_KINDS, BW_BLOCK_SEQ,
                           BW_FAULT_SEQ, BW_G, BW_HEAD_DIMS, BW_HKV,
                           BW_K_BLOCK, BW_PATTERNS, BW_Q_BLOCK, ES_D, ES_N,
                           ES_STEPS)
from repro.core.topology import TopologySpec as RefTopologySpec
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core import netes
from repro_torch.core.topology import TopologySpec
from repro_torch.envs import make_landscape_reward_fn
from repro_torch.kernels import ref
from repro_torch.launch import op_costs
from repro_torch.models import attention, transformer
from repro_torch.train import loop

TESTS = pathlib.Path(__file__).resolve().parent
SRC = TESTS.parent / "src"
TOL = dict(rtol=1e-5, atol=1e-5)
TOL_F64 = 1e-12
TOL_ES = dict(rtol=1e-6, atol=1e-6)
CASES = [pytest.param(pat, g, hd, id=f"{pat[0]}-g{g}-hd{hd}")
         for pat in BW_PATTERNS for g in BW_G for hd in BW_HEAD_DIMS]


@pytest.fixture(scope="session")
def bw(tmp_path_factory):
    path = tmp_path_factory.mktemp("blockwise_ref") / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(SRC))
    res = subprocess.run([sys.executable, str(TESTS / "_torch_lm_ref.py"),
                          str(path), "blockwise"], env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def t(a):
    return torch.as_tensor(np.asarray(a))


def _spec(pattern, g, hd):
    _, kind, window = pattern[:3]
    return attention.AttnSpec(num_heads=BW_HKV * g, num_kv_heads=BW_HKV,
                              head_dim=hd, kind=kind, window=window)


def _naive(spec, q, k, v, causal):
    """``flash_attention_ref`` with the pattern's masks."""
    return ref.flash_attention_ref(
        q, k, v, causal=causal, scale=spec.scale,
        window=spec.window if spec.kind == "sliding" else 0,
        chunk=spec.window if spec.kind == "chunked" else 0)


@pytest.mark.parametrize("pattern,g,hd", CASES)
def test_blockwise_matches_reference(bw, pattern, g, hd):
    label, _, _, causal, sq, sk = pattern
    p = f"bw_{label}_g{g}_hd{hd}"
    got = attention.blockwise_attention(
        _spec(pattern, g, hd), t(bw[f"{p}/q"]), t(bw[f"{p}/k"]),
        t(bw[f"{p}/v"]), torch.arange(sq), torch.arange(sk), causal=causal,
        q_block=BW_Q_BLOCK, k_block=BW_K_BLOCK)
    assert got.dtype == torch.float32 and got.shape == (B, sq, BW_HKV * g,
                                                        hd)
    np.testing.assert_allclose(got.numpy(), bw[f"{p}/out"], **TOL)


@pytest.mark.parametrize("pattern,g,hd", CASES)
def test_blockwise_equals_naive_attention_in_float64(bw, pattern, g, hd):
    """Accumulated in float64 for float64 operands: the full forward's
    float64 yardstick."""
    label, _, _, causal, sq, sk = pattern
    p = f"bw_{label}_g{g}_hd{hd}"
    spec = _spec(pattern, g, hd)
    q, k, v = (t(bw[f"{p}/{n}"]).double() for n in "qkv")
    got = attention.blockwise_attention(
        spec, q, k, v, torch.arange(sq), torch.arange(sk), causal=causal,
        q_block=BW_Q_BLOCK, k_block=BW_K_BLOCK)
    assert got.dtype == torch.float64
    err = (got - _naive(spec, q, k, v, causal)).abs().max().item()
    assert err <= TOL_F64, err


def test_reference_counts_padded_keys_the_port_does_not(bw):
    """Non-causal attention over 1500 keys in key blocks of 1024: the
    reference's 548 padded zero keys take softmax mass (its fault i), the
    port's take none, as in the flash kernel and its plain version."""
    q, k, v = (t(bw[f"fault_i/{n}"]).double() for n in "qkv")
    spec = attention.AttnSpec(num_heads=2, num_kv_heads=2, head_dim=32)
    pos = torch.arange(BW_FAULT_SEQ)
    naive = _naive(spec, q, k, v, causal=False)
    port = attention.blockwise_attention(spec, q, k, v, pos, pos,
                                         causal=False)
    assert (port - naive).abs().max().item() <= TOL_F64
    gap = (t(bw["fault_i/out"]).double() - naive).abs().max().item()
    assert gap > 0.1, gap


@pytest.mark.parametrize("kind,window", BW_BLOCK_KINDS,
                         ids=[k for k, _ in BW_BLOCK_KINDS])
def test_attention_block_matches_reference(bw, kind, window):
    """The full forward's attention block over 1100 positions: three query
    blocks and two key blocks of the defaults, both padded."""
    spec = attention.AttnSpec(num_heads=4, num_kv_heads=2, head_dim=32,
                              kind=kind, window=window)
    params = convert._nest(bw, f"block_{kind}/params", None,
                           torch.device("cpu"))
    got = attention.attention_block(params, spec, t(bw[f"block_{kind}/x"]),
                                    torch.arange(BW_BLOCK_SEQ))
    assert got.shape == (1, BW_BLOCK_SEQ, BW_BLOCK_D)
    np.testing.assert_allclose(got.detach().numpy(), bw[f"block_{kind}/out"],
                               **TOL)


def test_forward_makes_no_whole_score_tensor():
    """``transformer.forward`` over S = 2048 > k_block positions: no op
    makes a tensor with two dims of S (the naive (Sq, Sk) scores), and no
    result holds more elements than one key block's scores, (H, S, 1024)."""
    cfg = get_config("mistral-nemo-12b-smoke")
    s = 2048
    params = transformer.init_params(cfg, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (1, s),
                           generator=torch.Generator().manual_seed(0))
    with torch.no_grad(), op_costs.OpCosts() as rec:
        logits = transformer.forward(params, cfg, {"tokens": tokens})
    assert logits.shape == (1, s, cfg.vocab_size)
    shapes = [o[0] for r in rec.ops for o in r.outputs or ()]
    assert shapes and not [sh for sh in shapes if list(sh).count(s) >= 2]
    block_scores = cfg.num_heads * s * 1024
    assert max(math.prod(sh) for sh in shapes) <= max(
        block_scores, s * cfg.vocab_size)


def test_kv_loop_folds_for_the_recorder():
    """Under a folding recorder the KV loop runs one pass counted nk
    times: the same dot FLOPs as the unfolded loop."""
    spec = attention.AttnSpec(num_heads=4, num_kv_heads=2, head_dim=32)
    gen = torch.Generator().manual_seed(1)
    q = torch.randn(1, 200, 4, 32, generator=gen)
    k, v = torch.randn(1, 200, 2, 32, generator=gen), torch.randn(
        1, 200, 2, 32, generator=gen)
    pos = torch.arange(200)
    flops = {}
    for fold in (False, True):
        with op_costs.OpCosts(fold=fold) as rec:
            attention.blockwise_attention(spec, q, k, v, pos, pos,
                                          q_block=64, k_block=48)
        flops[fold] = rec.costs()["dot_flops"]
    # 5 key blocks of 48 over 4 query blocks of 64: two products each
    assert flops[True] == flops[False] == 2 * 2 * 4 * 256 * 240 * 32


def test_es_step_matches_reference(bw):
    """Three steps on the sphere from the reference's θ⁽⁰⁾, each given the
    ε the reference drew."""
    reward_fn = make_landscape_reward_fn("sphere")
    cfg = netes.NetESConfig(alpha=0.05, sigma=0.1)
    theta = t(bw["es/theta0"])
    for step in range(ES_STEPS):
        theta, m = netes.es_step(theta, reward_fn, cfg, ES_N,
                                 eps=t(bw[f"es/eps{step}"]))
        np.testing.assert_allclose(theta.numpy(), bw[f"es/theta{step + 1}"],
                                   **TOL_ES)
        for name in ("reward_mean", "reward_max"):
            np.testing.assert_allclose(m[name].numpy(),
                                       bw[f"es/{name}{step}"], **TOL_ES)


@pytest.mark.parametrize("antithetic", [True, False])
def test_es_step_draws_eps_from_its_generator(antithetic):
    """ε comes first from the generator: the same step as with that draw
    injected."""
    reward_fn = make_landscape_reward_fn("rastrigin")
    cfg = netes.NetESConfig(antithetic=antithetic)
    theta = torch.linspace(-1, 1, ES_D)
    got, m = netes.es_step(theta, reward_fn, cfg, ES_N,
                           generator=torch.Generator().manual_seed(3))
    eps = torch.randn(ES_N, ES_D, generator=torch.Generator().manual_seed(3))
    want, m_want = netes.es_step(theta, reward_fn, cfg, ES_N, eps=eps)
    assert torch.equal(got, want) and not torch.equal(got, theta)
    assert all(torch.equal(m[k], m_want[k]) for k in m_want)
    with pytest.raises(ValueError, match="generator or eps"):
        netes.es_step(theta, reward_fn, cfg, ES_N)


def test_build_adjacency_is_the_reference_graph_on_the_device():
    tc = loop.TrainConfig(topology=TopologySpec(
        family="erdos_renyi", n_agents=24, p=0.3, seed=4))
    adj = loop.build_adjacency(tc, device="cpu")
    want = RefTopologySpec(family="erdos_renyi", n_agents=24, p=0.3,
                           seed=4).build()
    assert adj.dtype == torch.float32 and adj.shape == (24, 24)
    np.testing.assert_array_equal(adj.numpy(), np.asarray(want))
    if not torch.cuda.is_available():    # the default device is the card
        with pytest.raises(RuntimeError, match="cuda"):
            loop.build_adjacency(tc)

"""θ-mixing by hop chains and gathers (``repro_torch.distributed.
permute_mixing``), one agent a rank: every backend over 4 gloo ranks
spawned on the CPU (``tests/_torch_shard_ranks.py --permute`` under
torchrun) against the port's ``circulant_mixing_ref`` (or the dense row
product it stands for), and against the reference's backends run over 4
forced host devices in a subprocess (``repro.distributed.permute_mixing``,
as ``tests/test_permute_mixing.py`` runs them)."""
import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_shard_cases as cases
from repro.distributed.permute_mixing import \
    circulant_mixing_ref as ref_circulant_mixing_ref
from repro_torch.comm.channel import compile_channel
from repro_torch.core.topology_repr import signed_offsets
from repro_torch.distributed import permute_mixing

ROOT = pathlib.Path(__file__).resolve().parent.parent
SRC = ROOT / "src"
RANKS = pathlib.Path(__file__).resolve().parent / "_torch_shard_ranks.py"
WORLD = 4
# float32 sums of ≤ 4 terms in another order, and one q8 level where a
# code sits on a rounding boundary: |Δ| ≤ 1e-5 (the payloads are O(1))
TOL = dict(rtol=1e-5, atol=1e-5)

_REFERENCE_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ.setdefault("JAX_PLATFORMS", "cpu")
import numpy as np
import jax.numpy as jnp
from repro.comm import channel as cc
from repro.core import topology_repr
from repro.distributed import permute_mixing as pm
from repro.distributed.fleet_shard import build_mesh

data = dict(np.load(sys.argv[1]))
mesh = build_mesh(4)
w, th = jnp.asarray(data["weights"]), jnp.asarray(data["thetas"])
out = {}
for name in data["names"]:
    kind, arg, chan, t = eval(str(data["spec_" + name]))
    ch = None if chan is None else cc.compile_channel(chan, 4)
    if "adj_" + name in data:
        rep = "dense" if kind == "topology_dense" else "sparse"
        topo = topology_repr.from_dense(data["adj_" + name], rep)
    elif kind == "topology_circulant":
        topo = topology_repr.from_dense(
            np.asarray(data["circ_" + name]), "circulant")
    if kind == "permute":
        f = pm.make_permute_mixing(mesh, "agents", arg, channel=ch)
    elif kind == "allgather":
        f = pm.make_allgather_mixing(mesh, "agents", channel=ch)
    elif kind == "sparse":
        f = pm.make_sparse_gather_mixing(mesh, "agents", topo, channel=ch)
    elif kind.startswith("topology"):
        f = pm.make_topology_mixing(mesh, "agents", topo, channel=ch)
    else:
        g = pm.make_rotating_permute_mixing(mesh, "agents", arg, stride=1,
                                            channel=ch)
        out[name] = np.asarray(g(w, th, jnp.int32(t)))
        continue
    out[name] = np.asarray(f(w, th))
np.savez(sys.argv[2], **out)
print("REFERENCE_PERMUTE_OK")
"""


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    """Each backend's (N, D) output: the port's over 4 gloo ranks (rank r
    its row r), and the reference's over 4 forced host devices."""
    root = tmp_path_factory.mktemp("permute")
    env = dict(os.environ, PYTHONPATH=f"{SRC}{os.pathsep}{RANKS.parent}",
               OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(WORLD), str(RANKS), "--out",
         str(root / "ranks"), "--permute", "--no-cases"],
        env=env, capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-6000:]
    ranks = [torch.load(root / "ranks" / f"rank{r}.pt")["permute"]
             for r in range(WORLD)]
    port = {name: torch.cat([r[name] for r in ranks]).numpy()
            for name in cases.PERMUTE_CASES}

    weights, thetas = cases.permute_inputs(WORLD)
    data = {"weights": weights.numpy(), "thetas": thetas.numpy(),
            "names": np.array(sorted(cases.PERMUTE_CASES))}
    for name, spec in cases.PERMUTE_CASES.items():
        data["spec_" + name] = np.array(repr(spec))
        topo = cases.permute_topology(spec[0], spec[1], WORLD)
        if topo is not None and topo.kind != "circulant":
            data["adj_" + name] = topo.to_dense().numpy()
        elif topo is not None:
            data["circ_" + name] = topo.to_dense().numpy()
    np.savez(root / "inputs.npz", **data)
    renv = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    renv["PYTHONPATH"] = str(SRC)
    res = subprocess.run(
        [sys.executable, "-c", _REFERENCE_SCRIPT, str(root / "inputs.npz"),
         str(root / "reference.npz")],
        env=renv, capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert "REFERENCE_PERMUTE_OK" in res.stdout, res.stderr[-6000:]
    with np.load(root / "reference.npz") as ref:
        reference = {k: ref[k] for k in ref}
    return port, reference


def _expected(name):
    """The port's oracle on the whole arrays: ``circulant_mixing_ref`` for
    the chains, the row product of the weights for the gathers (the
    neighbor-listed entries only, for the sparse ones)."""
    kind, arg, chan, t = cases.PERMUTE_CASES[name]
    weights, thetas = cases.permute_inputs(WORLD)
    if chan is not None:
        thetas = compile_channel(chan, WORLD).codec(thetas, batched=True)
    if kind in ("permute", "topology_circulant"):
        return permute_mixing.circulant_mixing_ref(weights, thetas, arg)
    if kind == "rotating":
        m = max(1, (WORLD - 1) // 2)
        offs = [(d - 1 + t * 1) % m + 1 for d in arg]
        return permute_mixing.circulant_mixing_ref(weights, thetas, offs)
    if kind in ("sparse", "topology_sparse"):
        topo = cases.permute_topology(kind, arg, WORLD)
        keep = (topo.to_dense() != 0).to(weights.dtype)
        return (weights * keep) @ thetas
    return weights @ thetas


@pytest.mark.parametrize("name", sorted(cases.PERMUTE_CASES))
def test_backend_matches_the_oracle(outputs, name):
    port, _ = outputs
    np.testing.assert_allclose(port[name], _expected(name).numpy(), **TOL)


@pytest.mark.parametrize("name", sorted(cases.PERMUTE_CASES))
def test_backend_matches_the_reference_backend(outputs, name):
    port, reference = outputs
    np.testing.assert_allclose(port[name], reference[name], **TOL)


@pytest.mark.parametrize("n,seed", [(8, 0), (16, 3)])
def test_circulant_ref_matches_the_reference_oracle(n, seed):
    rng = np.random.default_rng(seed)
    offsets = [1, 3]
    w = rng.normal(size=(n, n)).astype(np.float32)
    th = rng.normal(size=(n, 5)).astype(np.float32)
    got = permute_mixing.circulant_mixing_ref(torch.as_tensor(w),
                                              torch.as_tensor(th), offsets)
    want = ref_circulant_mixing_ref(jnp.asarray(w), jnp.asarray(th),
                                    offsets)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_signed_offsets_as_the_reference():
    assert signed_offsets([1, 3], 8) == [1, 3, 5, 7]
    assert signed_offsets([4], 8) == [4]


def test_stateful_channels_are_refused_at_the_collective_layer():
    ch = compile_channel("quantize(bits=8)|dropout(p=0.1,seed=0)", 4)
    with pytest.raises(ValueError, match="stateless"):
        permute_mixing._wire_codec(ch)
    assert permute_mixing._wire_codec(None)(torch.ones(1)) is not None

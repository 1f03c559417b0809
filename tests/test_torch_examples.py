"""The port's example scripts (``examples/*_torch.py``), each ``main(argv)``
run on the CPU at a tiny size: they finish, and what they return has the
shape and the finite values their output promises. Without a GPU their
default device, the card, raises."""
import importlib.util
import math
import pathlib

import numpy as np
import pytest
import torch

EXAMPLES = pathlib.Path(__file__).resolve().parent.parent / "examples"


def example(name):
    spec = importlib.util.spec_from_file_location(name,
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch", ["gemma3-4b-smoke", "whisper-tiny-smoke",
                                  "llava-next-mistral-7b-smoke"])
def test_serve_batch_serves_every_frontend_on_cpu(arch, capsys):
    out = example("serve_batch_torch").main(
        ["--arch", arch, "--batch", "2", "--new-tokens", "3",
         "--device", "cpu"])
    assert out.shape == (2, 3) and out.dtype == np.int32
    assert f"{arch}: generated (2, 3)" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["whisper-tiny-smoke",
                                  "llava-next-mistral-7b-smoke"])
def test_lm_netes_train_runs_on_cpu(arch, capsys):
    hist = example("lm_netes_train_torch").main(
        ["--arch", arch, "--iters", "2", "--agents", "4", "--seq-len", "24",
         "--device", "cpu"])
    assert len(hist["loss_mean"]) == 2
    assert all(math.isfinite(x) for x in hist["loss_mean"])
    assert f"{arch} via NetES/erdos_renyi: loss" in capsys.readouterr().out


def test_rl_netes_runs_er_fc_and_the_lossy_wire_on_cpu(tmp_path, capsys):
    trace = tmp_path / "run.jsonl"
    results = example("rl_netes_torch").main(
        ["--task", "landscape:sphere", "--agents", "8", "--iters", "4",
         "--trace", str(trace), "--checkpoint-dir", str(tmp_path / "ck"),
         "--device", "cpu"])
    assert sorted(results) == ["erdos_renyi", "erdos_renyi+q8drop",
                               "fully_connected"]
    assert all(math.isfinite(h["max_eval"]) for h in results.values())
    assert "probes" in results["erdos_renyi"]
    assert results["erdos_renyi+q8drop"]["realized_msgs"] > 0
    out = capsys.readouterr().out
    assert "consensus_dist" in out and "span" in out
    assert (tmp_path / "ck" / "latest.json").exists()


def test_rl_netes_search_trains_on_the_winner_on_cpu(tmp_path, capsys):
    results = example("rl_netes_torch").main(
        ["--task", "landscape:sphere", "--agents", "8", "--iters", "2",
         "--search", "--checkpoint-dir", str(tmp_path / "ck"),
         "--device", "cpu"])
    (name, hist), = results.items()
    assert "search winner: " + name in capsys.readouterr().out
    assert math.isfinite(hist["max_eval"])


@pytest.mark.parametrize("name,argv", [
    ("serve_batch_torch", ["--arch", "whisper-tiny-smoke"]),
    ("lm_netes_train_torch", ["--iters", "1"]),
    ("rl_netes_torch", ["--iters", "1"])])
def test_examples_default_to_the_card(name, argv, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU; the check is for GPU-less hosts")
    with pytest.raises(RuntimeError, match="cuda"):
        example(name).main(argv + (["--checkpoint-dir", str(tmp_path)]
                                   if name == "rl_netes_torch" else []))

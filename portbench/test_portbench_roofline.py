"""The benchmark's own counts, held beside the port's dry-run count
(``launch/op_costs``) of the same loss: they differ by the empty expert
slots of the capacity dispatch alone, which the port computes and the
benchmark's count (top-k a token) leaves out."""
import pytest
import torch

from portbench import harness, roofline
from portbench.runners import consensus_lm
from portbench.test_portbench_cells import tiny_lm


def test_jamba_loss_count_beside_op_costs():
    from repro_torch.launch import op_costs
    from repro_torch.models import transformer
    config, _, _ = tiny_lm()
    cfg = consensus_lm.port_config(config)
    params = transformer.init_params(cfg, device="cpu")
    s = 256
    tok = torch.randint(0, config["vocab_size"], (1, s), dtype=torch.int32)
    with op_costs.OpCosts(keep_ops=False) as rec:
        transformer.loss_fn(params, cfg, {"tokens": tok, "labels": tok})
    slots = roofline.moe_capacity_slots(config, s)
    empty = slots - config["num_experts_per_tok"] * s
    assert empty > 0
    moe_layers = sum(
        i % config["expert_layer_period"] == config["expert_layer_offset"]
        for i in range(config["num_hidden_layers"]))
    extra = moe_layers * empty * 2 * 3 * config["hidden_size"] \
        * config["intermediate_size"]
    assert rec.costs()["dot_flops"] == roofline.lm_loss_dot_flops(
        config, s) + extra


def test_jamba_step_count_at_the_cell():
    _, _, config, traffic, _ = harness.find_cell(harness.load_benchmark(),
                                                 "jamba.consensus.er")
    step = roofline.consensus_step_flops(config, traffic["population"],
                                         traffic["seq_len"])
    # the dry run's count of the same step (launch/op_costs) less the
    # empty expert slots
    empty = (roofline.moe_capacity_slots(config, traffic["seq_len"])
             - 2 * traffic["seq_len"])
    extra = 2 * traffic["population"] * empty * 2 * 3 * 4096 * 14336
    assert step + extra == 143_597_936_574_464


@pytest.mark.parametrize("n,d", [(16, 4481), (16384, 4481)])
def test_eq3_counts(n, d):
    flops, nbytes = roofline.eq3_dense(n, d)
    assert flops == 2 * n * n * d
    assert nbytes == 4 * (n * n + 3 * n * d)
    # a complete graph's edge count gives the dense flops
    assert roofline.eq3_sparse(n * n, n, d)[0] == flops
    t, bound = roofline.roofline_time(flops, nbytes)
    assert bound == ("flops" if n > 100 else "bytes") and t > 0


def test_rollout_count():
    assert roofline.mlp_flops_per_step([3, 64, 64, 1]) == 2 * (192 + 4096
                                                              + 64)
    assert roofline.rollout_flops(2, 200, [3, 64, 64, 1]) == \
        2 * 200 * 2 * 4352

"""NetES consensus training of Moonlight-16B-A3B (latent attention,
sigmoid-routed experts with shared experts, an untied unembedding), one
shared θ and P members evaluated one after another, driven through the
step that ``launch.specs.build_step`` returns for ``classify``'s pair.

Everything but the model is ``consensus_lm``'s: θ⁽⁰⁾ (``init_leaf``),
the token batches, the members' adjacency, the checked first steps' ε
(``Noise``) and β, the window and the traced step. This file states the
model: its leaves (``abstract_tree``), the port's config of the file
(``port_config``) and the reference's steps (``follow``, through
``reference/moonlight_ref.py``). A traced step also reads the MoE
dispatch's dropped (token, choice) pairs from the program's counters.

The comparison differs from ``consensus_lm``'s in three ways. In
float32 a token whose 6th and 7th biased router scores lie within its
rounding goes to another expert than in float64, and with experts full
the dispatch's drops move with it: routed by its own choices, the float64
reference's member losses differed from the program's by up to 3.4e-4
relative on sound seeds, as much as a fault, and such a jump can reorder
two close members, which moves the update by a few percent and puts
every later step on another θ. So the float64 reference routes each
member's loss by the program's own expert choices, recorded at
``moe.moe_block``'s router (``follow``'s ``routes``), and
``route_slack`` holds those choices to its own scores: the most by which
a chosen expert's biased score falls short of one left out. And, as the
pendulum cells' reference adopts the program's ranks, it steps θ with
the coefficients and the best member of the program's own member losses,
recorded at the step's ``member_rewards`` seam (``follow``'s ``steer``),
while it computes every loss itself. So that a wrong loss cannot steer
the reference unseen, every member's loss is held by itself:
``member_gap_max`` is the largest relative gap of any of the 2P members
at any step; ``member_gap`` reads, a step, the lower quartile of the
members' gaps, averaged over the steps.

Besides ``consensus_lm``'s faults, three that a mean over members or the
steered update hides: two members' losses swapped (each evaluated with
the other's noise, updated with its own), one member's loss moved by
5e-4 of itself, and the router choosing without its bias.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import statistics

import torch

from portbench import faults, harness, roofline_moonlight
from portbench.reference import moonlight_ref
from portbench.runners import consensus_lm
from portbench.runners.consensus_lm import (Noise, at, init_leaf, leaf_paths,
                                            leaf_norms_of_diff,
                                            member_adjacency, ncfg_dict,
                                            tokens)


def lm_swapped():
    """Members 0 and 1 evaluated with each other's noise: their rewards
    swapped, both signs, the update taking each member's own ε."""
    from repro_torch.distributed import netes_dist

    def make(real):
        def rewards(*a, **kw):
            r_pos, r_neg = real(*a, **kw)
            return r_pos[[1, 0, *range(2, len(r_pos))]], \
                r_neg[[1, 0, *range(2, len(r_neg))]]
        return rewards
    return faults._patched(netes_dist, "member_rewards", make)


def lm_shifted():
    """Member 0's +σ loss raised by 5e-4 of itself: under the mean over
    the 2P members' limit, over the gap between close members."""
    from repro_torch.distributed import netes_dist

    def make(real):
        def rewards(*a, **kw):
            r_pos, r_neg = real(*a, **kw)
            r_pos = r_pos.clone()
            r_pos[0] = r_pos[0] * (1 + 5e-4)
            return r_pos, r_neg
        return rewards
    return faults._patched(netes_dist, "member_rewards", make)


def lm_unbiased():
    """The router choosing by sigmoid(l) alone, its
    ``e_score_correction_bias`` left out."""
    from repro_torch.models import moe

    def make(real):
        def bias(seed, std, num_experts, device):
            return torch.zeros_like(real(seed, std, num_experts, device))
        return bias
    return faults._patched(moe, "router_bias", make)


# the consensus step's planted faults, two of one member and the router's
faults.FAULTS.setdefault("consensus_moonlight", {
    **faults.FAULTS["consensus_lm"], "swapped": lm_swapped,
    "shifted": lm_shifted, "unbiased": lm_unbiased})


def port_config(config):
    """The port's ModelConfig for the configuration file, every size as
    the file states it; raises where the port's settings or layer layout
    differ from the file's."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(
        get_config(config["port_arch"]),
        num_layers=config["num_hidden_layers"],
        d_model=config["hidden_size"],
        num_heads=config["num_attention_heads"],
        num_kv_heads=config["num_key_value_heads"],
        d_ff=config["intermediate_size"], vocab_size=config["vocab_size"],
        num_experts=config["n_routed_experts"],
        experts_per_token=config["num_experts_per_tok"],
        first_dense_layers=config["first_k_dense_replace"],
        moe_every=config["moe_layer_freq"],
        rope_theta=float(config["rope_theta"]),
        tie_embeddings=config["tie_word_embeddings"],
        moe_group_size=config["moe_group_size"],
        moe_capacity_factor=config["moe_capacity_factor"])
    bias = config["assumed"]["e_score_correction_bias"]
    want = dict(kv_lora_rank=config["kv_lora_rank"],
                qk_nope_head_dim=config["qk_nope_head_dim"],
                qk_rope_head_dim=config["qk_rope_head_dim"],
                v_head_dim=config["v_head_dim"],
                moe_d_ff=config["moe_intermediate_size"],
                n_shared_experts=config["n_shared_experts"],
                scoring=config["scoring_func"],
                routed_scaling_factor=config["routed_scaling_factor"],
                router_bias_seed=bias["seed"], router_bias_std=bias["std"],
                norm_eps=config["rms_norm_eps"])
    have = {k: getattr(cfg, k, None) for k in want}
    if have != want:
        raise ValueError(f"the port's settings {have} are not the "
                         f"configuration's {want}")
    if config["q_lora_rank"] is not None or config["n_group"] != 1 \
            or config["topk_group"] != 1 or not config["norm_topk_prob"]:
        raise ValueError("the port routes with one group, normalised, and "
                         "has no query low-rank path")
    layout = [(ls.mixer, ls.ffn) for ls in cfg.layer_specs()]
    dense = config["first_k_dense_replace"]
    if layout != [("mla", "swiglu" if i < dense else "moe")
                  for i in range(config["num_hidden_layers"])]:
        raise ValueError(f"the port lays the layers out as {layout}")
    return cfg


def abstract_tree(config):
    """The leaves' names and shapes of the stack the configuration
    states (meta tensors, nothing drawn)."""
    d, v = config["hidden_size"], config["vocab_size"]
    h, r = config["num_attention_heads"], config["kv_lora_rank"]
    nope, rope, dv = (config["qk_nope_head_dim"], config["qk_rope_head_dim"],
                      config["v_head_dim"])
    e, fe = config["n_routed_experts"], config["moe_intermediate_size"]
    fs = config["n_shared_experts"] * fe

    def meta(*shape):
        return torch.empty(shape, device="meta")

    def swiglu(f):
        return {"w_gate": meta(d, f), "w_up": meta(d, f),
                "w_down": meta(f, d)}
    layers = []
    for i in range(config["num_hidden_layers"]):
        layer = {"norm1": {"scale": meta(d)}, "norm2": {"scale": meta(d)},
                 "mla": {"wq": meta(d, h * (nope + rope)),
                         "wkv_a": meta(d, r + rope),
                         "kv_norm": {"scale": meta(r)},
                         "wkv_b": meta(r, h * (nope + dv)),
                         "wo": meta(h * dv, d)}}
        if i < config["first_k_dense_replace"]:
            layer["ffn"] = swiglu(config["intermediate_size"])
        else:
            layer["moe"] = {"router": meta(d, e), "w_gate": meta(e, d, fe),
                            "w_up": meta(e, d, fe), "w_down": meta(e, fe, d)}
            layer["shared"] = swiglu(fs)
        layers.append(layer)
    return {"embed": meta(v, d), "lm_head": meta(d, v),
            "final_norm": {"scale": meta(d)}, "layers": layers}


class Run(consensus_lm.Run):
    def __init__(self, config, traffic, seed: int, device):
        from repro_torch.core.netes import NetESConfig
        from repro_torch.launch import specs
        from repro_torch.launch.mesh import NamedShape

        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.ncfg = NetESConfig(**ncfg_dict(config))
        one = NamedShape(("data", "model"), (1, 1))
        pair = specs.classify(config["port_arch"], traffic["shape"], one)
        if pair.mode != "consensus":
            raise ValueError(f"classify gave mode {pair.mode!r}")
        self.p = traffic["population"]
        pair = dataclasses.replace(pair, n_agents=self.p,
                                   cfg=port_config(config))
        self.step_fn, order = specs.build_step(pair, one, self.ncfg,
                                               device=self.device)
        if order != ("params", "adj", "batch", "draws"):
            raise ValueError(f"the step takes {order}")
        shapes = abstract_tree(config)
        self.paths = leaf_paths(shapes)
        self.shapes = [tuple(at(shapes, q).shape) for q in self.paths]
        self.sizes = [math.prod(s) for s in self.shapes]
        self.params = self._theta0_tree(shapes)
        self.adj = member_adjacency(traffic, self.device)
        self.t = 0
        self.counters = {}
        self.outputs = self._checked_steps()

    def _checked_steps(self) -> dict:
        with _recording_members() as seen, _recording_routes() as ids:
            out = super()._checked_steps()
        out["member_losses"] = [(-r).double().tolist() for r in seen]
        out["member_routes"] = _by_member(ids, len(seen), 2 * self.p,
                                          moe_layers(self.config))
        return out

    def traced(self) -> dict:
        from repro_torch.obs import regions
        regions.reset_counters()
        out = super().traced()
        self.counters = regions.counters()
        regions.reset_counters()
        return out

    def counts(self) -> dict:
        c, p, s = self.config, self.p, self.traffic["seq_len"]
        calls = roofline_moonlight.calls_per_step(c, p)
        out = {"step_flops": roofline_moonlight.step_flops(c, p, s),
               "flash_mla_flops": calls["flash_mla"]
               * roofline_moonlight.flash_mla(c, s)[0],
               "router_sigmoid_bytes": calls["router_sigmoid"]
               * roofline_moonlight.router_sigmoid(c, s)[1]}
        if "moe.routed" in self.counters:
            out["moe_dropped"] = self.counters.get("moe.dropped", 0.0)
            out["moe_routed"] = self.counters["moe.routed"]
        return out


@contextlib.contextmanager
def _recording_members():
    """While open, each call of the consensus step's ``member_rewards``
    (the one the step looks up, a planted fault's included) appends its
    2P rewards, [R⁺ of each member, R⁻ of each member], to the list it
    yields."""
    from repro_torch.distributed import netes_dist
    seen, real = [], netes_dist.member_rewards

    def recording(*a, **kw):
        r_pos, r_neg = real(*a, **kw)
        seen.append(torch.cat([r_pos, r_neg]).detach().clone())
        return r_pos, r_neg
    netes_dist.member_rewards = recording
    try:
        yield seen
    finally:
        netes_dist.member_rewards = real


@contextlib.contextmanager
def _recording_routes():
    """While open, each call of ``moe.moe_block`` appends the expert ids
    its router chose, (tokens, k) int16 on the CPU, to the list it
    yields."""
    from repro_torch.models import moe
    seen, real = [], moe.moe_block

    def recording(params, spec, x, topk=moe.moe_topk):
        def chosen(logits, k):
            gates, ids = topk(logits, k)
            seen.append(ids.reshape(-1, k).to("cpu", torch.int16))
            return gates, ids
        return real(params, spec, x, topk=chosen)
    moe.moe_block = recording
    try:
        yield seen
    finally:
        moe.moe_block = real


def moe_layers(config) -> int:
    return config["num_hidden_layers"] - config["first_k_dense_replace"]


def _by_member(ids, steps: int, members: int, layers: int):
    """The router calls of the checked steps, in the step's order (each
    member's θ + σε, then its θ − σε, each through the MoE layers in
    turn), as [step][2m (+σ) or 2m + 1 (−σ)][layer]."""
    if len(ids) != steps * members * layers:
        raise ValueError(f"{len(ids)} router calls in {steps} steps of "
                         f"{members} losses through {layers} MoE layers")
    it = iter(ids)
    return [[[next(it) for _ in range(layers)] for _ in range(members)]
            for _ in range(steps)]


# --------------------------------------------------------------------------
# the reference's steps, and the control (the reference in TF32)
# --------------------------------------------------------------------------

def follow(config, traffic, seed: int, device, precision: str,
           steer=None, routes=None) -> dict:
    """The checked steps computed by ``moonlight_ref`` from the same
    inputs, in ``precision``, with θ kept a leaf at a time in that dtype.
    Returns what the program's checked steps return, and ``route_slack``.
    With ``steer`` (a program's ``member_losses``), each step's update
    takes its coefficients and best member from those losses, not its
    own; with ``routes`` (a program's ``member_routes``), each loss is
    routed by the program's expert choices (``moonlight_ref.Routes``),
    ``route_slack`` the most any falls short of the reference's own."""
    dt = torch.float64 if precision == "f64" else torch.float32
    meta = abstract_tree(config)
    paths = leaf_paths(meta)
    shapes = [tuple(at(meta, q).shape) for q in paths]
    sizes = [math.prod(s) for s in shapes]
    index = {q: i for i, q in enumerate(paths)}
    theta = [init_leaf(q, shapes[i], seed, i, device).to(dt)
             for i, q in enumerate(paths)]
    p, seq = traffic["population"], traffic["seq_len"]
    cfg = ncfg_dict(config)
    adj = member_adjacency(traffic, device)
    betas = harness.check_betas(traffic["check_broadcast"],
                                cfg["p_broadcast"], seed, device)
    out = {"loss_mean": [], "member_losses": [], "member_routes": [],
           "route_slack": 0.0}
    for t, beta in enumerate(betas):
        noise = Noise(seed, t, sizes)
        batch = tokens(seed, t, p, seq, config["vocab_size"], device)
        losses = {1.0: [], -1.0: []}
        taken = []
        for m in range(p):
            for j, sign in enumerate((1.0, -1.0)):
                def get(path, m=m, sign=sign):
                    i = index[path]
                    e = noise.leaf(m, i, device).to(dt).view(shapes[i])
                    return theta[i] + (sign * cfg["sigma"]) * e
                way = moonlight_ref.Routes(
                    None if routes is None else routes[t][2 * m + j])
                losses[sign].append(moonlight_ref.loss(
                    get, batch[m, 0], config, precision, routes=way))
                taken.append(way.taken)
                out["route_slack"] = max(out["route_slack"], way.slack)
        out["member_routes"].append(taken)
        lp, ln = torch.stack(losses[1.0]), torch.stack(losses[-1.0])
        out["loss_mean"].append(float(torch.cat([lp, ln]).mean()))
        out["member_losses"].append(torch.cat([lp, ln]).tolist())
        if steer is not None:
            lp, ln = torch.tensor(steer[t], dtype=dt, device=device).split(p)
        coeff, best = moonlight_ref.consensus_coefficients(lp, ln, adj)
        norms = []
        for i in range(len(paths)):
            new = moonlight_ref.update_leaf(
                theta[i],
                lambda m, i=i: noise.leaf(m, i, device).to(dt).view(
                    shapes[i]),
                coeff, best, beta, cfg)
            norms += leaf_norms_of_diff(lambda _, a=new: a,
                                        lambda _, b=theta[i]: b, 1)
            theta[i] = new
        if t == 0:
            out["update_norms"] = norms
    out["change_norms"] = leaf_norms_of_diff(
        lambda i: theta[i],
        lambda i: init_leaf(paths[i], shapes[i], seed, i, device).to(dt),
        len(paths))
    return out


def compare(outputs: dict, config, traffic, seed: int, device) -> dict:
    ref = follow(config, traffic, seed, device, "f64",
                 steer=outputs["member_losses"],
                 routes=outputs["member_routes"])
    gaps = [abs(a - b) / abs(b) for a, b in
            zip(outputs["loss_mean"], ref["loss_mean"], strict=True)]
    each = [[abs(a - b) / abs(b) for a, b in zip(mp, mr, strict=True)]
            for mp, mr in zip(outputs["member_losses"],
                              ref["member_losses"], strict=True)]
    members = [statistics.quantiles(g, n=4)[0] for g in each]
    worst = [max(g) for g in each]
    return {"loss_gap": sum(gaps) / len(gaps),
            **{f"loss_gap_t{t}": g for t, g in enumerate(gaps)},
            "member_gap": sum(members) / len(members),
            **{f"member_gap_t{t}": g for t, g in enumerate(members)},
            "member_gap_max": max(worst),
            **{f"member_gap_max_t{t}": g for t, g in enumerate(worst)},
            "route_slack": ref["route_slack"],
            "update_gap": harness.norm_gaps(outputs["update_norms"],
                                            ref["update_norms"]),
            "change_gap": harness.norm_gaps(outputs["change_norms"],
                                            ref["change_norms"])}


def control_outputs(config, traffic, seed: int, device,
                    precision: str = "tf32") -> dict:
    return follow(config, traffic, seed, device, precision)

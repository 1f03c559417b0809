"""NetES consensus training of a language model (one shared θ, P members
evaluated one after another, DESIGN.md §7.4), driven through the step
that ``launch.specs.build_step`` returns for ``classify``'s pair.

Set-up makes every input from the seed: θ⁽⁰⁾ (one draw a leaf, on the
device), each step's token batch, the members' adjacency, and for the
first steps the members' ε (through the step's ``noise`` seam) and β. It
drives the one θ through those steps, which warm every shape up and are
what the reference follows; the window then steps θ on the port's own
draws (``netes_dist.draw``), one host transfer a step.
"""
from __future__ import annotations

import dataclasses
import math
import time

import torch

from portbench import harness, roofline
from portbench.reference import jamba_ref

# ε is drawn in slabs of this many columns of a leaf, one seed a slab.
NOISE_SLAB = 1 << 24


def leaf_paths(tree, prefix=()) -> list:
    """Paths of a nested dict/list's leaves, dict keys sorted, list items
    in order: the numbering of the step's ``noise`` seam."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in leaf_paths(tree[k],
                                                            prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree)
                for p in leaf_paths(v, prefix + (i,))]
    return [prefix]


def at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def init_leaf(path, shape, seed: int, index: int, device) -> torch.Tensor:
    """θ⁽⁰⁾ of one leaf, float32: weights N(0, 1/fan_in) clamped to ±2
    standard deviations (fan_in the size of the axis each product
    contracts), the embedding N(0, 0.02²), norms one, the mamba constants
    as the mamba paper initialises them (A = −(1..d_state), D = 1, a Δ
    bias giving Δ = 0.01, zero conv bias)."""
    name = path[-1]
    ones = dict(device=device, dtype=torch.float32)
    if name in ("scale", "D"):
        return torch.ones(shape, **ones)
    if name == "conv_b":
        return torch.zeros(shape, **ones)
    if name == "dt_bias":
        return torch.full(shape, math.log(math.expm1(0.01)), **ones)
    if name == "A_log":
        return torch.log(torch.arange(1, shape[1] + 1, **ones)).expand(
            shape).contiguous()
    raw = torch.randn(shape, generator=harness.generator(device, seed, 11,
                                                         index), **ones)
    if name == "embed":
        return raw.mul_(0.02)
    fan_in = {"conv_w": 4 * shape[0]}.get(name, shape[-2])
    return raw.clamp_(-2.0, 2.0).mul_(1.0 / math.sqrt(fan_in))


class Noise:
    """The members' ε of one checked step: leaf l's flattened ε is cut in
    slabs of ``NOISE_SLAB``, slab s drawn whole from its own seed; a call
    fills any stretch of columns. Same seam as the port's ``NoiseStream``
    (``noise(out, member, leaf, slab, start)``)."""

    def __init__(self, seed: int, step: int, sizes: list):
        self.seed, self.step, self.sizes = seed, step, sizes

    def slab(self, member, leaf, s, device, dtype=torch.float32):
        n = min(NOISE_SLAB, self.sizes[leaf] - s * NOISE_SLAB)
        g = harness.generator(device, self.seed, 13, self.step, member,
                              leaf, s)
        return torch.randn(n, generator=g, device=device, dtype=dtype)

    def __call__(self, out, member, leaf, _slab, start):
        stop = start + out.numel()
        for s in range(start // NOISE_SLAB, ceil_div(stop, NOISE_SLAB)):
            lo, hi = s * NOISE_SLAB, (s + 1) * NOISE_SLAB
            a, b = max(lo, start), min(hi, stop)
            out[a - start:b - start].copy_(
                self.slab(member, leaf, s, out.device)[a - lo:b - lo])

    def leaf(self, member, leaf, device) -> torch.Tensor:
        """ε of a whole leaf, flat, float32."""
        return torch.cat([self.slab(member, leaf, s, device) for s in
                          range(ceil_div(self.sizes[leaf], NOISE_SLAB))])


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def tokens(seed: int, step: int, p: int, seq: int, vocab: int, device):
    """Step ``step``'s batch: P members × 1 sequence of ``seq`` token ids,
    uniform over the vocabulary."""
    return torch.randint(0, vocab, (p, 1, seq),
                         generator=harness.generator(device, seed, 12, step),
                         device=device, dtype=torch.int32)


def member_adjacency(traffic, device) -> torch.Tensor:
    """The members' G(P, p) with self-loops, from the traffic's
    ``topology_seed``."""
    p = traffic["population"]
    u = torch.rand(p, p, generator=harness.generator(
        device, traffic["topology_seed"], 2), device=device)
    adj = torch.triu(u < traffic["p"], diagonal=1)
    adj = (adj | adj.T).to(torch.float32)
    adj.fill_diagonal_(1.0)
    return adj


def port_config(config):
    """The port's ModelConfig for the configuration file, every size as
    the file states it; raises where the port's layer layout differs."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(
        get_config(config["port_arch"]),
        num_layers=config["num_hidden_layers"],
        d_model=config["hidden_size"],
        num_heads=config["num_attention_heads"],
        num_kv_heads=config["num_key_value_heads"],
        d_ff=config["intermediate_size"], vocab_size=config["vocab_size"],
        num_experts=config["num_experts"],
        experts_per_token=config["num_experts_per_tok"],
        mamba_d_state=config["mamba_d_state"],
        mamba_d_conv=config["mamba_d_conv"],
        mamba_expand=config["mamba_expand"],
        moe_every=config["expert_layer_period"],
        moe_offset=config["expert_layer_offset"],
        moe_group_size=config["moe_group_size"],
        moe_capacity_factor=config["moe_capacity_factor"])
    want = []
    for i in range(config["num_hidden_layers"]):
        moe = i % config["expert_layer_period"] == config["expert_layer_offset"]
        want.append(("mamba", "moe" if moe else "swiglu"))
    have = [(ls.mixer, ls.ffn) for ls in cfg.layer_specs()]
    if have != want:
        raise ValueError(f"the port lays the layers out as {have}, the "
                         f"configuration as {want}")
    if -(-cfg.d_model // 16) != config["mamba_dt_rank"]:
        raise ValueError("the port's Δ rank is not the configuration's")
    return cfg


def ncfg_dict(config) -> dict:
    return {k: config["netes"][k] for k in
            ("alpha", "sigma", "p_broadcast", "weight_decay")}


def leaf_norms_of_diff(get_a, get_b, n_leaves) -> list:
    """‖a_l − b_l‖ of every leaf, accumulated in float64 a slab at a
    time."""
    out = []
    for i in range(n_leaves):
        a, b = get_a(i).reshape(-1), get_b(i).reshape(-1)
        sq = 0.0
        for c0 in range(0, a.numel(), NOISE_SLAB):
            d = (a[c0:c0 + NOISE_SLAB].double()
                 - b[c0:c0 + NOISE_SLAB].double())
            sq += float(torch.dot(d, d))
        out.append(math.sqrt(sq))
    return out


class Run:
    def __init__(self, config, traffic, seed: int, device):
        from repro_torch.core.netes import NetESConfig
        from repro_torch.launch import specs
        from repro_torch.launch.mesh import NamedShape

        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        c = config["netes"]
        self.ncfg = NetESConfig(alpha=c["alpha"], sigma=c["sigma"],
                                p_broadcast=c["p_broadcast"],
                                weight_decay=c["weight_decay"])
        one = NamedShape(("data", "model"), (1, 1))
        pair = specs.classify(config["port_arch"], traffic["shape"], one)
        if pair.mode != "consensus":
            raise ValueError(f"classify gave mode {pair.mode!r}")
        self.p = traffic["population"]
        cfg = port_config(config)
        pair = dataclasses.replace(pair, n_agents=self.p, cfg=cfg)
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
        self.outputs = self._checked_steps()

    def _theta0_tree(self, shapes):
        def build(node, prefix):
            if isinstance(node, dict):
                return {k: build(v, prefix + (k,)) for k, v in node.items()}
            if isinstance(node, (list, tuple)):
                return type(node)(build(v, prefix + (i,))
                                  for i, v in enumerate(node))
            i = self.paths.index(prefix)
            return init_leaf(prefix, self.shapes[i], self.seed, i,
                             self.device)
        return build(shapes, ())

    def theta0(self, i):
        return init_leaf(self.paths[i], self.shapes[i], self.seed, i,
                         self.device)

    def _batch(self, t):
        tok = tokens(self.seed, t, self.p, self.traffic["seq_len"],
                     self.config["vocab_size"], self.device)
        return {"tokens": tok, "labels": tok}

    def _step(self, draws):
        self.params, metrics = self.step_fn(self.params, self.adj,
                                            self._batch(self.t), draws)
        self.t += 1
        return metrics

    def _checked_steps(self) -> dict:
        from repro_torch.distributed.netes_dist import StepDraws
        pattern = self.traffic["check_broadcast"]
        betas = harness.check_betas(pattern, self.ncfg.p_broadcast,
                                    self.seed, self.device)
        n = len(self.paths)
        out = {"loss_mean": []}
        for t, beta in enumerate(betas):
            m = self._step(StepDraws(
                noise=Noise(self.seed, t, self.sizes),
                beta=torch.tensor(beta, device=self.device)))
            out["loss_mean"].append(float(m["loss_mean"]))
            if t == 0:
                out["update_norms"] = self._diff_norms(n)
        out["change_norms"] = self._diff_norms(n)
        return out

    def _diff_norms(self, n):
        leaves = [at(self.params, q) for q in self.paths]
        return leaf_norms_of_diff(lambda i: leaves[i], self.theta0, n)

    def _one(self) -> int:
        from repro_torch.distributed import netes_dist
        from repro_torch.obs import device_get
        m = self._step(netes_dist.draw(harness.sub_seed(self.seed, 14),
                                       self.t, device=self.device))
        host = device_get(torch.stack([m["loss_mean"], m["reward_max"]]))
        return int(not bool(torch.isfinite(host).all()))

    def window(self, seconds: float, spans: bool) -> dict:
        harness.sync(self.device)
        t0 = time.perf_counter()
        steps = failed = 0
        while True:
            failed += self._one()
            steps += 1
            elapsed = time.perf_counter() - t0
            if elapsed >= seconds:
                break
        return {"metrics": {"consensus_step_ms": elapsed * 1e3 / steps},
                "attempted": steps, "failed": failed, "spans": {}}

    def traced(self) -> dict:
        from torch.profiler import ProfilerActivity, profile, record_function
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function("portbench.window"):
                self._one()
        return {"prof": prof, "iters": 1}

    def counts(self) -> dict:
        return {"step_flops": roofline.consensus_step_flops(
                    self.config, self.p, self.traffic["seq_len"])}

    def release(self) -> dict:
        out = self.outputs
        self.params = self.step_fn = self.outputs = None
        return out


# --------------------------------------------------------------------------
# the reference's steps, and the control (the reference in TF32)
# --------------------------------------------------------------------------

def follow(config, traffic, seed: int, device, precision: str) -> dict:
    """The checked steps computed by ``jamba_ref`` from the same inputs,
    in ``precision``, with θ kept a leaf at a time in that dtype. Returns
    what the program's checked steps return."""
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
    out = {"loss_mean": []}
    for t, beta in enumerate(betas):
        noise = Noise(seed, t, sizes)
        batch = tokens(seed, t, p, seq, config["vocab_size"], device)
        losses = {1.0: [], -1.0: []}
        for m in range(p):
            for sign in (1.0, -1.0):
                def get(path, m=m, sign=sign):
                    i = index[path]
                    e = noise.leaf(m, i, device).to(dt).view(shapes[i])
                    return theta[i] + (sign * cfg["sigma"]) * e
                losses[sign].append(jamba_ref.loss(get, batch[m, 0], config,
                                                   precision))
        lp, ln = torch.stack(losses[1.0]), torch.stack(losses[-1.0])
        out["loss_mean"].append(float(torch.cat([lp, ln]).mean()))
        coeff, best = jamba_ref.consensus_coefficients(lp, ln, adj)
        norms = []
        for i in range(len(paths)):
            new = jamba_ref.update_leaf(
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


def abstract_tree(config):
    """The leaves' names and shapes of the stack the configuration
    states (meta tensors, nothing drawn)."""
    d, f = config["hidden_size"], config["intermediate_size"]
    di, ds = config["mamba_expand"] * d, config["mamba_d_state"]
    r, k, v = config["mamba_dt_rank"], config["mamba_d_conv"], \
        config["vocab_size"]
    e = config["num_experts"]

    def meta(*shape):
        return torch.empty(shape, device="meta")
    layers = []
    for i in range(config["num_hidden_layers"]):
        layer = {"norm1": {"scale": meta(d)}, "norm2": {"scale": meta(d)},
                 "mamba": {"in_x": meta(d, di), "in_z": meta(d, di),
                           "conv_w": meta(k, di), "conv_b": meta(di),
                           "x_proj": meta(di, r + 2 * ds),
                           "dt_proj": meta(r, di), "dt_bias": meta(di),
                           "A_log": meta(di, ds), "D": meta(di),
                           "out_proj": meta(di, d)}}
        if i % config["expert_layer_period"] == config["expert_layer_offset"]:
            layer["moe"] = {"router": meta(d, e), "w_gate": meta(e, d, f),
                            "w_up": meta(e, d, f), "w_down": meta(e, f, d)}
        else:
            layer["ffn"] = {"w_gate": meta(d, f), "w_up": meta(d, f),
                            "w_down": meta(f, d)}
        layers.append(layer)
    return {"embed": meta(v, d), "final_norm": {"scale": meta(d)},
            "layers": layers}


def compare(outputs: dict, config, traffic, seed: int, device) -> dict:
    ref = follow(config, traffic, seed, device, "f64")
    gaps = [abs(a - b) / abs(b) for a, b in
            zip(outputs["loss_mean"], ref["loss_mean"], strict=True)]
    # the mean over the steps: float32 routes a token whose second and
    # third router probabilities are within its rounding to another
    # expert than float64 does, which moves one step's gap by ~1e-6
    return {"loss_gap": sum(gaps) / len(gaps),
            **{f"loss_gap_t{t}": g for t, g in enumerate(gaps)},
            "update_gap": harness.norm_gaps(outputs["update_norms"],
                                            ref["update_norms"]),
            "change_gap": harness.norm_gaps(outputs["change_norms"],
                                            ref["change_norms"])}


def control_outputs(config, traffic, seed: int, device,
                    precision: str = "tf32") -> dict:
    return follow(config, traffic, seed, device, precision)

"""Dry-run analysis: memory, FLOPs and collective-byte accounting for the
roofline report. The port of ``repro.launch.analysis``; its inputs are an
``op_costs.OpCosts`` recorder's totals instead of a compiled module's
(whose ``costs()`` carries the reference's ``collective_stats`` keys:
``<kind>_bytes``, ``<kind>_count`` and ``collective_bytes``).

Conventions:

* every quantity is per device: the recorder counts the local ops of one
  rank (``op_costs``), so the roofline terms divide by one card's peaks;
* collective bytes are the per-device result bytes of the collectives,
  × 2 for an all-reduce (a reduce-scatter and an all-gather);
* the card is NVIDIA's H100 SXM5 80 GB (its datasheet): 66.9 TFLOP/s in
  float32 without TF32 (the port's steps run with TF32 off), 3.35 TB/s of
  HBM3, NVLink 4 at 450 GB/s each way between the 8 cards of a node, and
  50 GB/s a card (NDR InfiniBand) for a group that spans nodes.
  ``roofline_terms`` takes each as a keyword, so the reference's TPU v5e
  constants give the reference's terms.
"""
from __future__ import annotations

from typing import Dict

PEAK_FLOPS = 66.9e12         # float32, no TF32 / card
HBM_BW = 3.35e12             # bytes/s / card
NVLINK_BW = 450e9            # bytes/s / card, each way, within a node
INTER_NODE_BW = 50e9         # bytes/s / card, across nodes
HBM_BYTES = 80e9             # device memory / card


def roofline_terms(flops: float, hbm_bytes: float, collective_bytes: float,
                   *, intra_node_bytes: float = 0.0,
                   peak_flops: float = PEAK_FLOPS, hbm_bw: float = HBM_BW,
                   link_bw: float = INTER_NODE_BW,
                   intra_bw: float = NVLINK_BW) -> Dict[str, float]:
    """All inputs per device. ``intra_node_bytes`` of the collective bytes
    move over NVLink (``intra_bw``), the rest over ``link_bw``. Returns
    the three terms in seconds and the dominant one."""
    t_compute = flops / peak_flops
    t_memory = hbm_bytes / hbm_bw
    t_collective = ((collective_bytes - intra_node_bytes) / link_bw
                    + intra_node_bytes / intra_bw)
    terms = {"compute_s": t_compute, "memory_s": t_memory,
             "collective_s": t_collective}
    dominant = max(terms, key=terms.get)
    terms["dominant"] = dominant.replace("_s", "")
    terms["step_time_lower_bound_s"] = max(t_compute, t_memory, t_collective)
    return terms


def model_flops(cfg, shape: Dict, kind: str) -> float:
    """MODEL_FLOPS = 6·N_active·D tokens (forward-only ES step ⇒ 2·N·D per
    forward; we report the conventional 6·N·D training equivalent AND the
    forward-only 2·N·D — the ratio table uses forward-only × forwards/step).
    """
    n_active = cfg.active_params_per_token()
    tokens = shape["seq_len"] * shape["global_batch"]
    if kind == "train":
        # NetES: 2 forwards (antithetic) per step, forward-only
        return 2 * 2.0 * n_active * tokens
    if kind == "prefill":
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * shape["global_batch"]


def memory_analysis_dict(argument_bytes: float, recorder) -> Dict[str, float]:
    """Per-device memory of a traced step: ``argument_bytes`` (its inputs'
    local shards), and from the recorder's live-storage tally the peak of
    what the step allocated (``temp_bytes``) and what it left alive
    (``output_bytes``, the results). ``peak_bytes`` = arguments + that
    peak: a step's results are made within it, and an in-place update
    allocates nothing for the arguments it rewrites."""
    mem = recorder.exit_memory or recorder.memory()
    return {
        "argument_bytes": float(argument_bytes),
        "output_bytes": mem["output_bytes"],
        "temp_bytes": mem["temp_peak_bytes"],
        "peak_bytes": float(argument_bytes) + mem["temp_peak_bytes"],
    }

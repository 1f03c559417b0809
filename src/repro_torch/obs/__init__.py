"""On-device telemetry (DESIGN.md §15), the port of ``repro.obs``: probe
rings on the device (``probes``), kernel-build and host-transfer counters
(``cuda_watch``), and the schema-versioned JSONL trace layer (``trace``).

CLI: ``python -m repro_torch.obs summarize|validate <trace.jsonl>``.
"""
from .cuda_watch import (Watch, count_host_transfers, count_kernel_builds,
                         device_get)
from .probes import (DEFAULT_CAPACITY, MetricsState, Probes, ProbeSpec,
                     STAGES, compile_probes)
from .trace import SCHEMA, Trace, read_trace, summarize, validate_trace

__all__ = [
    "DEFAULT_CAPACITY", "MetricsState", "Probes", "ProbeSpec", "STAGES",
    "compile_probes", "SCHEMA", "Trace", "read_trace", "summarize",
    "validate_trace", "Watch", "count_kernel_builds",
    "count_host_transfers", "device_get",
]

"""The port's copy of ``src/repro/core/profiler.py`` (framework-free, so copied
rather than imported: the port imports nothing of ``repro``). Its code
equals the original's outside the import lines and this docstring;
``tests/test_torch_core.py`` checks that, and holds the two to the same
results. The original's docstring follows.

Offline profiling (§5.3): MaxTput(G, bucket, SLO) tables.

Profile sources:
  * "analytic"  — the roofline engine model (engine_model.py), evaluated at
    each workload bucket's representative request size.
  * "xla"       — same queueing model, but per-token FLOP/byte terms replaced
    by the dry-run's compiled cost_analysis numbers for the chosen
    architecture (ties profiles to *our* engine's compiled HLO).

The profile is exactly what Mélange consumes: for every accelerator type and
every histogram bucket, the max request rate that meets the TPOT SLO.
"""
from __future__ import annotations

import dataclasses
import json
import re
from pathlib import Path
from typing import Mapping, Optional

import numpy as np

from .accelerators import Accelerator
from .engine_model import DEFAULT_ENGINE, EngineModel, EngineModelParams, ModelPerf
from .workload import Bucket


@dataclasses.dataclass
class Profile:
    """max_tput[gpu][bucket_index] in req/s (0 = infeasible under SLO)."""

    gpus: dict[str, Accelerator]
    buckets: list[Bucket]
    slo_tpot_s: float
    max_tput: dict[str, np.ndarray]
    model_name: str = ""

    def feasible(self, gpu: str, bucket_idx: int) -> bool:
        return self.max_tput[gpu][bucket_idx] > 0

    def to_json(self) -> str:
        return json.dumps({
            "model": self.model_name,
            "slo_tpot_s": self.slo_tpot_s,
            "gpus": sorted(self.gpus),
            "max_tput": {g: list(map(float, v))
                         for g, v in self.max_tput.items()},
        }, indent=1)


def profile_catalog(
    gpus: Mapping[str, Accelerator],
    buckets: list[Bucket],
    model: ModelPerf,
    slo_tpot_s: float,
    engine_params: EngineModelParams = DEFAULT_ENGINE,
    flops_per_token: Optional[float] = None,
    bytes_per_step_base: Optional[float] = None,
) -> Profile:
    """One-time offline profiling step (fast: closed-form model)."""
    em = EngineModel(model, engine_params,
                     flops_per_token=flops_per_token,
                     bytes_per_step_base=bytes_per_step_base)
    table: dict[str, np.ndarray] = {}
    for name, acc in gpus.items():
        row = np.zeros(len(buckets))
        for k, b in enumerate(buckets):
            row[k] = em.max_throughput(acc, b.rep_input, b.rep_output,
                                       slo_tpot_s)
        table[name] = row
    return Profile(dict(gpus), buckets, slo_tpot_s, table, model.name)


def profile_from_dryrun(
    gpus: Mapping[str, Accelerator],
    buckets: list[Bucket],
    cfg,
    dryrun_record: dict,
    slo_tpot_s: float,
    engine_params: EngineModelParams = DEFAULT_ENGINE,
) -> Profile:
    """XLA-derived profile: per-token decode FLOPs *and* per-step bytes from
    the compiled serve_step of the dry-run (decode cell), scaled per
    accelerator."""
    model = ModelPerf.from_config(cfg)
    return profile_catalog(
        gpus, buckets, model, slo_tpot_s, engine_params,
        flops_per_token=decode_flops_per_token_from_record(dryrun_record),
        bytes_per_step_base=decode_bytes_per_step_base_from_record(
            dryrun_record, model))


def record_devices(rec: dict) -> int:
    """Device count of the dry-run: explicit field, else the mesh shape
    (``pod_16x16`` -> 256). cost_analysis numbers are per-device modules,
    so totals must be scaled by this — no silent default."""
    if "devices" in rec:
        return int(rec["devices"])
    dims = re.findall(r"\d+", rec.get("mesh", ""))
    if dims:
        return int(np.prod([int(d) for d in dims]))
    raise ValueError(
        "dry-run record carries neither 'devices' nor a parsable 'mesh'; "
        "cannot scale per-device cost_analysis numbers")


def decode_flops_per_token_from_record(rec: dict,
                                       n_devices: Optional[int] = None) -> float:
    d = record_devices(rec) if n_devices is None else n_devices
    return rec["flops"] * d / max(1, rec["global_batch"])


def decode_bytes_per_step_base_from_record(
        rec: dict, model: ModelPerf,
        n_devices: Optional[int] = None) -> Optional[float]:
    """Batch-independent bytes per decode step (weights + constants), from
    the compiled totals minus the modeled per-sequence KV/state traffic at
    the cell's context length.  Returns None (analytic fallback) when the
    record has no byte counts (cost_analysis_error runs)."""
    total_per_dev = rec.get("bytes_tc", rec.get("bytes_accessed"))
    if total_per_dev is None:
        return None
    d = record_devices(rec) if n_devices is None else n_devices
    total = float(total_per_dev) * d
    nb = max(1, rec["global_batch"])
    per_seq = (rec.get("seq_len", 0) * model.kv_bytes_per_token
               + model.state_bytes)
    base = total - nb * per_seq
    # the step must at least stream the active weights once; never exceed
    # what the compiler measured in total
    return float(min(max(base, model.active_param_bytes), total))

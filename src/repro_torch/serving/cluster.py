"""Heterogeneous serving cluster (port of ``repro/serving/cluster.py``):
Mélange allocation -> engine instances -> App-A.2 load balancer routing.

Every instance is a ``ServingEngine`` over the one ``Transformer`` it is
given, on one device: the instances share the weights and each has its own
slot cache and ``BlockManager``. Instances are created in the order of the
sorted GPU names and routed by ``core.balancer.LoadBalancer`` over the
given ``Profile`` (seeded, straggler factor 0.5), exactly as in the
reference, so on the same profile, seed and requests the two clusters route
alike. On one card the instances take turns, so this integrates the
control plane with real engines; it does not evaluate latency SLOs per GPU
type (the reference's ``core/simulator.py`` models those).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core.balancer import InstanceRef, LoadBalancer
from repro_torch.core.profiler import Profile
from repro_torch.models import transformer as T
from repro_torch.serving.engine import EngineConfig, Request, ServingEngine


@dataclasses.dataclass
class ClusterStats:
    completed: int
    rejected: int
    per_instance: dict[int, int]
    mean_tokens: float


class ServingCluster:
    """``allocation_counts`` maps a GPU name of ``profile`` to a number of
    instances; ``model`` must live on ``device`` (CUDA by default; raises
    when CUDA is missing)."""

    def __init__(self, cfg, model: T.Transformer,
                 allocation_counts: dict[str, int], profile: Profile,
                 ecfg: Optional[EngineConfig] = None, seed: int = 0, *,
                 device="cuda"):
        self.cfg = cfg
        self.ecfg = ecfg or EngineConfig()
        self.engines: list[ServingEngine] = []
        refs = []
        iid = 0
        for gpu, n in sorted(allocation_counts.items()):
            for _ in range(int(n)):
                self.engines.append(ServingEngine(cfg, model, self.ecfg,
                                                  device=device))
                refs.append(InstanceRef(iid, gpu))
                iid += 1
        self.lb = LoadBalancer(profile, refs, seed=seed,
                               straggler_factor=0.5)
        self.routed: dict[int, int] = {}

    def submit(self, req: Request) -> int:
        ref = self.lb.route(len(req.prompt))
        self.engines[ref.inst_id].submit(req)
        self.routed[req.rid] = ref.inst_id
        return ref.inst_id

    def run(self, max_steps: int = 10_000) -> ClusterStats:
        done_total: list[Request] = []
        for _ in range(max_steps):
            busy = False
            for e in self.engines:
                if e.queue or e.n_active:
                    e.step()
                    busy = True
            if not busy:
                break
        per_inst: dict[int, int] = {}
        rejected = 0
        for i, e in enumerate(self.engines):
            for r in e.finished:
                if not r.generated:
                    rejected += 1
                    continue
                done_total.append(r)
                per_inst[i] = per_inst.get(i, 0) + 1
                self.lb.observe(len(r.prompt), len(r.generated),
                                inst_id=i, tpot=max(r.tpot, 1e-6))
        mean_toks = (np.mean([len(r.generated) for r in done_total])
                     if done_total else 0.0)
        return ClusterStats(len(done_total), rejected, per_inst,
                            float(mean_toks))

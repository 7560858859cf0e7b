"""Serving metrics: streaming TPOT/TTFT aggregation (the port's own copy of
``repro.serving.metrics``)."""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class LatencyStats:
    ttfts: list[float] = dataclasses.field(default_factory=list)
    tpots: list[float] = dataclasses.field(default_factory=list)

    def observe(self, ttft: float, tpot: float) -> None:
        self.ttfts.append(ttft)
        self.tpots.append(tpot)

    def attainment(self, slo_tpot_s: float) -> float:
        if not self.tpots:
            return 1.0
        return float(np.mean(np.asarray(self.tpots) <= slo_tpot_s + 1e-9))

    def percentile(self, metric: str, q: float) -> float:
        arr = getattr(self, metric)
        return float(np.percentile(arr, q)) if arr else 0.0

    def summary(self, slo_tpot_s: float) -> dict:
        return {
            "n": len(self.tpots),
            "tpot_p50": self.percentile("tpots", 50),
            "tpot_p99": self.percentile("tpots", 99),
            "ttft_p50": self.percentile("ttfts", 50),
            "ttft_p99": self.percentile("ttfts", 99),
            "slo_attainment": self.attainment(slo_tpot_s),
        }

"""End-to-end serving driver on the PyTorch port alone: allocate a
heterogeneous pool with the port's Mélange, spin up the port's engines
(the reduced model), route live requests through the App-A.2 load
balancer, and evaluate SLO attainment with the port's discrete-event
simulator at the paper's scale. The twin of ``serve_heterogeneous.py``: the
same flags, defaults and printed lines, plus ``--device`` (CUDA by
default; without CUDA it raises unless ``--device cpu`` is asked for). It
imports nothing of JAX or of the JAX package. The reduced model's heads
are widened from 16 to 64, the smallest head dim the attention kernels
take, so the same model runs on the CPU and on the card; the printed lines
do not depend on it (greedy requests run to their token budget, and the
balancer routes by prompt length).

    PYTHONPATH=src python examples/serve_heterogeneous_torch.py
        [--arch qwen2-1.5b] [--requests 40] [--sim-requests 2000]
        [--rate 4.0] [--device cuda|cpu]
"""
import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import (Melange, ModelPerf, PAPER_GPUS, make_workload,
                              simulate)
from repro_torch.kernels.flash_attention import HEAD_DIMS
from repro_torch.models import transformer as T
from repro_torch.serving import EngineConfig, Request, ServingCluster

SLO_TPOT_S = 0.12


def reduced_config(arch: str):
    """``arch``'s reduced config, its head dim raised to the smallest one
    the attention kernels take."""
    cfg = get_config(arch).reduced()
    return dataclasses.replace(
        cfg, head_dim=min(d for d in HEAD_DIMS if d >= cfg.head_dim))


def control_plane(rate: float, model: ModelPerf, gpus=PAPER_GPUS,
                  profile=None):
    """Mélange on arena traffic at ``rate`` req/s (10% over-provisioned,
    a 1.5 s solver budget): (the ``Melange``, its allocation).
    ``profile``: a precomputed MaxTput profile of ``gpus`` (else the
    analytic one)."""
    mel = Melange(gpus, model, SLO_TPOT_S, profile=profile)
    alloc = mel.allocate(make_workload("arena", rate), over_provision=0.1,
                         time_budget_s=1.5)
    return mel, alloc


def example_requests(vocab_size: int, n: int) -> list[Request]:
    """``n`` requests drawn from ``default_rng(0)`` as the JAX example draws
    them: prompts of 4-23 tokens, 4-15 new tokens each."""
    rng = np.random.default_rng(0)
    out = []
    for rid in range(n):
        prompt = list(map(int, rng.integers(1, vocab_size,
                                            size=int(rng.integers(4, 24)))))
        out.append(Request(rid=rid, prompt=prompt,
                           max_new_tokens=int(rng.integers(4, 16))))
    return out


def data_plane(cfg, model: T.Transformer, counts: dict, profile,
               requests, ecfg: EngineConfig, device):
    """``requests`` through a ``ServingCluster`` of ``counts`` instances
    over ``model`` (the engine refuses vision and codebook configs):
    (the cluster, its stats)."""
    cluster = ServingCluster(cfg, model, counts, profile, ecfg,
                             device=device)
    for req in requests:
        cluster.submit(req)
    return cluster, cluster.run()


def slo_evaluation(counts: dict, profile, model: ModelPerf, rate: float,
                   n_requests: int):
    """The simulator's run of ``counts`` on arena traffic at ``rate``
    (seed 3): a ``SimResult``."""
    return simulate(counts, profile, model, "arena", rate=rate,
                    n_requests=n_requests, seed=3)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--requests", type=int, default=40)
    ap.add_argument("--sim-requests", type=int, default=2000)
    ap.add_argument("--rate", type=float, default=4.0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (raises without it) or cpu")
    args = ap.parse_args(argv)
    dev = T.resolve_device(args.device)

    # ---- control plane: Mélange allocation --------------------------------
    model = ModelPerf.llama2_7b()
    mel, alloc = control_plane(args.rate, model)
    print(f"[alloc] {alloc.counts} -> ${alloc.cost_per_hour:.2f}/h")

    # ---- data plane: the port's engines (reduced model) -------------------
    cfg = reduced_config(args.arch)
    net = T.Transformer(cfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(0))
    _, stats = data_plane(cfg, net, alloc.counts, mel.profile,
                          example_requests(cfg.vocab_size, args.requests),
                          EngineConfig(max_batch=4, max_seq=96), dev)
    print(f"[serve] completed={stats.completed} rejected={stats.rejected} "
          f"mean_generated={stats.mean_tokens:.1f} tok")
    print(f"[serve] per-instance request counts: {stats.per_instance}")

    # ---- SLO evaluation at target-hardware timings (simulator) -------------
    res = slo_evaluation(alloc.counts, mel.profile, model, args.rate,
                         args.sim_requests)
    pct = res.tpot_percentiles((50, 90, 99, 99.5))
    print(f"[slo]   attainment={res.slo_attainment*100:.2f}% "
          f"(TPOT p50={pct[50]*1e3:.1f}ms p99={pct[99]*1e3:.1f}ms "
          f"p99.5={pct[99.5]*1e3:.1f}ms; SLO=120ms) "
          f"cost=${res.cost:.2f} for {res.duration_s:.0f}s")


if __name__ == "__main__":
    main()

"""The port's copy of ``src/repro/core/engine_model.py`` (framework-free, so copied
rather than imported: the port imports nothing of ``repro``). Its code
equals the original's outside the import lines and this docstring;
``tests/test_torch_core.py`` checks that, and holds the two to the same
results. The original's docstring follows.

Analytical serving-engine performance model (roofline-based).

The paper measures ``MaxTput(G, request_size, SLO)`` by saturating vLLM on
real GPUs.  This container has no accelerators, so we model the engine from
first principles — the same three regimes the paper's analysis identifies:

  * decode step time  = max(weights+KV bytes / HBM_bw, 2·P_active·b / peak)
                        + fixed per-step overhead,
  * prefill           = compute-bound: (2·P_active + attn) FLOPs per token,
    interleaved with decode (chunked-prefill time sharing),
  * concurrency cap   = (HBM − weights − activation reserve) / KV-per-request.

``MaxTput`` is then the largest request rate whose steady-state TPOT meets
the SLO — which reproduces every qualitative effect in §4: cheap accelerators
win small requests at loose SLOs (capacity- and $-driven), expensive ones win
large requests (memory capacity) and tight SLOs (latency floor = P/W).

A second profile source (`from_cost_analysis`) replaces the analytic
per-token FLOP/byte terms with the XLA-compiled numbers from the dry-run,
tying profiles to *our* engine rather than a hand model.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

from .accelerators import Accelerator


@dataclasses.dataclass(frozen=True)
class ModelPerf:
    """Model terms the engine model needs."""

    name: str
    param_bytes: float           # total weight bytes (as served)
    active_param_bytes: float    # per-token touched weight bytes (MoE-aware)
    kv_bytes_per_token: float    # KV-cache (or recurrent-state amortized) bytes
    n_layers: int
    d_model: int
    state_bytes: float = 0.0     # constant per-sequence state (SSM archs)

    @classmethod
    def llama2_7b(cls) -> "ModelPerf":
        p = 6.74e9 * 2
        kv = 2 * 32 * 32 * 128 * 2          # 2·L·kv_heads·head_dim·bytes
        return cls("llama2-7b", p, p, kv, 32, 4096)

    @classmethod
    def llama2_70b(cls) -> "ModelPerf":
        p = 70e9 * 2
        kv = 2 * 80 * 8 * 128 * 2           # GQA kv=8
        return cls("llama2-70b", p, p, kv, 80, 8192)

    @classmethod
    def from_config(cls, cfg) -> "ModelPerf":
        """Derive from one of the assigned architecture configs."""
        from repro_torch.models.transformer import count_params
        bpe = 2 if cfg.param_dtype == "bfloat16" else 4
        p = count_params(cfg) * bpe
        pa = count_params(cfg, active_only=True) * bpe
        kv = 0.0
        state = 0.0
        for spec in cfg.layer_specs():
            if spec.kind == "attn" and spec.attn_type != "cross":
                if spec.attn_type == "local" and cfg.sliding_window:
                    continue  # bounded window: amortized into state_bytes
                kv += 2 * cfg.n_kv_heads * cfg.head_dim * 2
            elif spec.kind == "mamba":
                state += (cfg.d_inner * cfg.mamba_d_state * 4
                          + cfg.d_inner * (cfg.mamba_conv - 1) * 2)
            elif spec.kind == "rwkv":
                state += (cfg.rwkv_heads * cfg.rwkv_head_dim ** 2 * 4
                          + 2 * cfg.d_model * 2)
        for spec in cfg.layer_specs():
            if spec.kind == "attn" and spec.attn_type == "local" and cfg.sliding_window:
                state += 2 * cfg.n_kv_heads * cfg.head_dim * 2 * cfg.sliding_window
        return cls(cfg.name, p, pa, kv, cfg.n_layers, cfg.d_model,
                   state_bytes=state)


@dataclasses.dataclass(frozen=True)
class EngineModelParams:
    """Calibration constants (single global set — not per-GPU-tuned)."""

    mfu: float = 0.5                 # achievable fraction of peak FLOPs
    bw_util: float = 0.8             # achievable fraction of HBM bandwidth
    step_overhead_s: float = 0.004   # scheduler+sampling+launch per step
    per_seq_overhead_s: float = 30e-6  # §4.2's per-request latency overhead
    activation_reserve: float = 0.08  # fraction of HBM reserved
    kv_avg_occupancy: float = 0.5    # avg decoded fraction (i + o/2)
    tp_collective_latency_s: float = 4e-6  # launch+sync floor per all-reduce


DEFAULT_ENGINE = EngineModelParams()


class EngineModel:
    def __init__(self, model: ModelPerf,
                 params: EngineModelParams = DEFAULT_ENGINE,
                 flops_per_token: Optional[float] = None,
                 bytes_per_step_base: Optional[float] = None):
        self.m = model
        self.p = params
        # overridable by XLA-derived profiles; explicit 0.0 is a valid
        # override (e.g. a weights-resident ablation), so test against None
        self._flops_per_token = (flops_per_token if flops_per_token is not None
                                 else 2.0 * model.active_param_bytes / 2)
        self._bytes_base = (bytes_per_step_base if bytes_per_step_base is not None
                            else model.param_bytes)

    # -- capacity ----------------------------------------------------------
    def fits(self, acc: Accelerator, max_tokens: int) -> bool:
        if acc.max_request_tokens and max_tokens > acc.max_request_tokens:
            return False
        need = (self.m.param_bytes + self.m.state_bytes
                + max_tokens * self.m.kv_bytes_per_token)
        return need <= acc.mem_bytes * (1 - self.p.activation_reserve)

    def max_batch(self, acc: Accelerator, i: int, o: int) -> int:  # unit: i: tok, o: tok
        avail = acc.mem_bytes * (1 - self.p.activation_reserve) - self.m.param_bytes
        if avail <= 0:
            return 0
        # Even a cache-free architecture holds one token's activations per
        # co-resident sequence (residual stream through every layer), so the
        # per-request footprint has a physical floor — this replaces the old
        # arbitrary 4096 cap for state-free models.
        act_floor = 2.0 * self.m.d_model * self.m.n_layers * 2
        per_req = (self.m.state_bytes
                   + (i + self.p.kv_avg_occupancy * o) * self.m.kv_bytes_per_token)
        per_req = max(per_req, act_floor)
        return max(0, int(avail / per_req))

    # -- timing ------------------------------------------------------------
    def _tp_comm_bytes_per_token(self, acc: Accelerator) -> float:
        """Per-chip all-reduce traffic per token under tp-way tensor
        parallelism: two ring all-reduces per layer (post-attention and
        post-MLP), each moving 2·(tp-1)/tp of a d_model activation row."""
        if acc.tp <= 1:
            return 0.0
        ring = 2.0 * (acc.tp - 1) / acc.tp
        return 2.0 * self.m.n_layers * ring * self.m.d_model * 2

    def _tp_step_latency(self, acc: Accelerator) -> float:
        """Non-overlappable collective launch/sync floor per engine step."""
        if acc.tp <= 1:
            return 0.0
        return (2.0 * self.m.n_layers * self.p.tp_collective_latency_s
                * math.log2(acc.tp))

    def decode_step_time(self, acc: Accelerator, b: int, ctx: float) -> float:  # unit: b: 1, ctx: tok, return: s
        """One engine step decoding b tokens at average context ctx."""
        # b plays two dimensional roles: count of co-resident sequences
        # (KV reads, per-seq overhead) and tokens decoded this step (FLOP
        # and collective traffic) — one new token per sequence per step
        new_toks = float(b)  # unit: tok
        kv_read = b * ctx * self.m.kv_bytes_per_token + b * self.m.state_bytes
        mem_t = (self._bytes_base + kv_read) / (acc.eff_bw * self.p.bw_util)
        flop_t = self._flops_per_token * new_toks / (acc.eff_flops * self.p.mfu)
        comm_t = 0.0
        if acc.tp > 1:
            link = max(acc.link_gbs, 1e-3) * 1e9
            comm_t = (new_toks * self._tp_comm_bytes_per_token(acc) / link
                      + self._tp_step_latency(acc))
        return (max(mem_t, flop_t) + comm_t + self.p.step_overhead_s
                + b * self.p.per_seq_overhead_s)

    def prefill_rate(self, acc: Accelerator, i: int) -> float:  # unit: i: tok
        """Prefill tokens/s (compute-bound, incl. quadratic attention)."""
        attn = 2.0 * self.m.n_layers * self.m.d_model * i   # per-token avg
        fpt = self._flops_per_token + attn
        t_per_tok = fpt / (acc.eff_flops * self.p.mfu)
        if acc.tp > 1:       # bandwidth term only: latency amortizes over
            link = max(acc.link_gbs, 1e-3) * 1e9    # thousands of tokens
            t_per_tok += self._tp_comm_bytes_per_token(acc) / link
        return 1.0 / t_per_tok

    def rate_and_tpot(self, acc: Accelerator, b: int, i: int, o: int):  # unit: b: 1, i: tok, o: tok, return: (req/s, s)
        """(throughput req/s, avg TPOT) at steady concurrency b.

        Throughput is utilization-bounded: each request consumes
        i/R_pf (prefill, serialized) + o·t_step(b)/b of accelerator time.
        TPOT charges prefill *interference to other requests only* —
        at b=1 a request's own prefill is TTFT, not TPOT (non-chunked
        engines stall victims during prefill; per-victim-token stall is
        the prefill time fraction φ spread over (b-1)/b of requests)."""
        ctx = i + self.p.kv_avg_occupancy * o
        t_d = self.decode_step_time(acc, b, ctx)
        r_pf = self.prefill_rate(acc, i)
        # each of the b co-resident sequences decodes one token per step
        toks_per_step = float(b)  # unit: tok
        r = 1.0 / (i / r_pf + o * t_d / toks_per_step)
        phi = min(0.95, r * i / r_pf)
        tpot = t_d / max(0.05, 1.0 - phi * (b - 1) / b)
        return r, tpot

    def tpot(self, acc: Accelerator, b: int, i: int, o: int) -> float:  # unit: i: tok, o: tok
        return self.rate_and_tpot(acc, b, i, o)[1]

    def ttft(self, acc: Accelerator, b: int, i: int, o: int) -> float:  # unit: i: tok, o: tok
        return i / self.prefill_rate(acc, i) + self.decode_step_time(
            acc, b, i + self.p.kv_avg_occupancy * o)

    # -- MaxTput (§5.3) -----------------------------------------------------
    def max_throughput(self, acc: Accelerator, i: int, o: int,  # unit: i: tok, o: tok
                       slo_tpot_s: float) -> float:
        """Max request rate (req/s) for (i, o) requests under the TPOT SLO.

        TPOT(b) is monotone -> binary search the largest feasible
        concurrency; the rate at that concurrency is the MaxTput."""
        if not self.fits(acc, i + o):
            return 0.0
        b_hi = self.max_batch(acc, i, o)
        if b_hi < 1:
            return 0.0
        if self.tpot(acc, 1, i, o) > slo_tpot_s:
            return 0.0
        lo, hi = 1, b_hi
        while lo < hi:
            mid = (lo + hi + 1) // 2
            if self.tpot(acc, mid, i, o) <= slo_tpot_s:
                lo = mid
            else:
                hi = mid - 1
        r, _ = self.rate_and_tpot(acc, lo, i, o)
        return r

    def tokens_per_dollar(self, acc: Accelerator, i: int, o: int,  # unit: i: tok, o: tok
                          slo_tpot_s: float) -> float:
        """The paper's T/$ metric: (input+output tokens)/hour / $/hour."""
        r = self.max_throughput(acc, i, o, slo_tpot_s)
        return r * (i + o) * 3600.0 / acc.price_hr

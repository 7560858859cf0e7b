#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each of which raises on failure (nothing is caught):
  1. build   — compiles src/repro_torch/kernels/csrc/*.cu for sm_90a.
  2. kernels — each CUDA kernel against its plain PyTorch version on the
               card: the tests/test_kernels.py shape sweep in fp32 and bf16,
               window/softcap and ragged cases, and the serving path's
               shapes (qwen2-1.5b: H=12, KVH=2, Dh=128, bf16; prefill
               Sq=Skv=1024; decode B=8, S=2048). Times with CUDA events.
  3. serving — qwen2-1.5b at full width and depth (28 layers, bf16, seeded
               random weights) behind ServingEngine(max_batch=8,
               max_seq=2048): 8 requests, 32 new tokens each. The launch
               counters must show every prefill and decode step going
               through the kernels.
  4. path    — one prompt through prefill and 8 teacher-forced decode steps,
               once through the kernels and once with impl="plain".
  5. trace   — torch.profiler over 5 serving-shaped decode steps (B=8):
               step wall time, device busy time and the top kernels.

Prints the card's name and power limit, a {"kernels": [...]} line, and as
its last line {"ok": true, "device": {...}}. Without CUDA, or without the
repository beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# NVIDIA H100 SXM published peaks (dense): bf16 tensor-core rate, HBM rate
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
TOL = {"float32": 2e-5, "bfloat16": 2e-2}   # tests/test_kernels.py::_tol
# Logits of the kernel path vs the plain path, bf16, full-width qwen2 with
# random weights (logit std ~0.78): both paths attend in fp32 and round to
# bf16, so they differ only where a rounding flips and the flip propagates
# through 28 layers; 0.1 is ~13 bf16 ulps at |logit| in [1, 2).
PATH_TOL = 0.1
N_REQUESTS, NEW_TOKENS = 8, 32


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import transformer as T
    from repro_torch.serving import (EngineConfig, LatencyStats, Request,
                                     ServingEngine)

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"card: {smi()}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    # -- 1. build ---------------------------------------------------------
    _, build_s, log = _build.timed_load()
    print(f"build: {build_s:.3f} s -> {_build.library_path()}")
    for line in log.splitlines():
        if any(w in line for w in ("Compiling entry", "Used", "spill")) \
                or line.startswith("=="):
            print(f"  {line.strip()}")

    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def err(a, b) -> float:
        return float((a.float() - b.float()).abs().max())

    def time_ms(fn, args_sets, iters=30):
        """Mean ms per call over ``iters`` calls, rotating through input
        sets (so a call does not find the previous call's inputs in L2)."""
        for i in range(3):
            fn(*args_sets[i % len(args_sets)])
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for i in range(iters):
            fn(*args_sets[i % len(args_sets)])
        t1.record()
        torch.cuda.synchronize()
        return t0.elapsed_time(t1) / iters

    # -- 2. kernels vs plain ----------------------------------------------
    sweep = {"flash_attention": {}, "decode_attention": {}}

    def check(name, dtype, got, want, case):
        e = err(got, want)
        tol = TOL[str(dtype).split(".")[-1]]
        if not e < tol:
            raise AssertionError(f"{name} {case} {dtype}: max abs err {e} "
                                 f">= {tol}")
        key = str(dtype).split(".")[-1]
        sweep[name][key] = max(sweep[name].get(key, 0.0), e)

    flash_cases = [  # B, Sq, Skv, H, KVH, Dh, causal, window, softcap
        (1, 128, 128, 4, 4, 64, True, None, None),     # tests/test_kernels
        (2, 256, 256, 8, 2, 64, True, None, None),
        (1, 256, 256, 4, 1, 128, True, None, None),
        (2, 128, 128, 12, 2, 64, True, None, None),
        (1, 256, 256, 4, 2, 64, True, 64, None),
        (1, 256, 256, 4, 2, 64, True, None, 30.0),
        (1, 256, 256, 4, 2, 64, True, 128, 50.0),
        (1, 200, 200, 12, 2, 128, True, None, None),   # ragged edges
        (2, 100, 160, 4, 2, 128, True, 48, 50.0),
        (1, 96, 136, 4, 2, 64, False, None, None),
        (1, 8, 8, 12, 2, 128, True, None, None),       # smallest padded
        (1, 1024, 1024, 12, 2, 128, True, None, None),  # serving path
    ]
    n_flash = 0
    for dtype in (torch.float32, torch.bfloat16):
        for B, Sq, Skv, H, KVH, Dh, causal, window, cap in flash_cases:
            q = rnd((B, Sq, H, Dh), dtype)
            k, v = rnd((B, Skv, KVH, Dh), dtype), rnd((B, Skv, KVH, Dh), dtype)
            kw = dict(causal=causal, window=window, softcap=cap)
            check("flash_attention", dtype,
                  ops.flash_attention(q, k, v, impl="cuda", **kw),
                  ops.flash_attention(q, k, v, impl="plain", **kw),
                  (B, Sq, Skv, H, KVH, Dh, causal, window, cap))
            n_flash += 1

    decode_cases = [  # B, S, H, KVH, Dh, window, softcap
        (2, 512, 8, 2, 64, None, None),                 # tests/test_kernels
        (1, 256, 4, 4, 128, None, 30.0),
        (2, 512, 4, 2, 64, 128, None),
        (3, 256, 16, 2, 64, None, None),
        (8, 2048, 12, 2, 128, 256, 50.0),
        (8, 2048, 12, 2, 128, None, None),              # serving path
    ]
    n_decode = 0
    lrng = np.random.default_rng(1)
    for dtype in (torch.float32, torch.bfloat16):
        for B, S, H, KVH, Dh, window, cap in decode_cases:
            q = rnd((B, H, Dh), dtype)
            kc, vc = rnd((B, S, KVH, Dh), dtype), rnd((B, S, KVH, Dh), dtype)
            lens = lrng.integers(1, S + 1, size=B)
            lens[0], lens[-1] = 1, S                     # both extremes
            lens = torch.from_numpy(lens).to(dev)
            kw = dict(window=window, softcap=cap)
            check("decode_attention", dtype,
                  ops.decode_attention(q, kc, vc, lens, impl="cuda", **kw),
                  ops.decode_attention(q, kc, vc, lens, impl="plain", **kw),
                  (B, S, H, KVH, Dh, window, cap))
            n_decode += 1
    print(f"kernels: {n_flash} flash and {n_decode} decode cases within "
          f"tolerance; max abs err {json.dumps(sweep)}")

    # timing at the serving path's shapes (bf16)
    bf16 = torch.bfloat16
    H, KVH, Dh, G = 12, 2, 128, 6
    S_pf = 1024
    pf_sets = [(rnd((1, S_pf, H, Dh), bf16), rnd((1, S_pf, KVH, Dh), bf16),
                rnd((1, S_pf, KVH, Dh), bf16)) for _ in range(8)]
    q, k, v = pf_sets[0]
    o_kernel = ops.flash_attention(q, k, v, impl="cuda")
    flash_err = err(o_kernel, ops.flash_attention(q, k, v, impl="plain"))
    lib_sets = [(a.transpose(1, 2).contiguous(),
                 b.repeat_interleave(G, dim=2).transpose(1, 2).contiguous(),
                 c.repeat_interleave(G, dim=2).transpose(1, 2).contiguous())
                for a, b, c in pf_sets]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_err = err(sdpa(*lib_sets[0], is_causal=True).transpose(1, 2),
                  o_kernel)
    pairs = S_pf * (S_pf + 1) // 2
    pf_flops = 4 * H * Dh * pairs
    pf_bytes = 2 * (2 * S_pf * H * Dh + 2 * S_pf * KVH * Dh)
    pf_bound = {"operations": pf_flops / PEAK_BF16_FLOPS * 1e3,
                "bytes": pf_bytes / PEAK_BYTES * 1e3}
    flash_row = {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:92",
        "tpu_kernel": "src/repro/kernels/flash_attention.py:92",
        "shape": "B=1 Sq=Skv=1024 H=12 KVH=2 Dh=128 bf16 causal",
        "max_abs_err": flash_err, "tol": TOL["bfloat16"],
        "ms": time_ms(lambda a, b, c: ops.flash_attention(
            a, b, c, impl="cuda"), pf_sets),
        "plain_ms": time_ms(lambda a, b, c: ops.flash_attention(
            a, b, c, impl="plain"), pf_sets, iters=10),
        "library_ms": time_ms(lambda a, b, c: sdpa(a, b, c, is_causal=True),
                              lib_sets),
        "library_max_abs_err": lib_err,
        "bound_ms": max(pf_bound.values()),
        "bound_by": max(pf_bound, key=pf_bound.get),
        "flops": pf_flops, "bytes": pf_bytes,
    }

    B_d, S_d = 8, 2048
    d_lens = torch.from_numpy(
        np.random.default_rng(0).integers(64, 2048, size=B_d)).to(dev)
    d_sets = [(rnd((B_d, H, Dh), bf16), rnd((B_d, S_d, KVH, Dh), bf16),
               rnd((B_d, S_d, KVH, Dh), bf16), d_lens) for _ in range(8)]
    q, kc, vc, lens = d_sets[0]
    o_kernel = ops.decode_attention(q, kc, vc, lens, impl="cuda")
    decode_err = err(o_kernel, ops.decode_attention(q, kc, vc, lens,
                                                    impl="plain"))
    pos = torch.arange(S_d, device=dev)

    def lib_args(a, b, c, ln):
        return (a[:, :, None], b.repeat_interleave(G, dim=2).transpose(1, 2)
                .contiguous(), c.repeat_interleave(G, dim=2).transpose(1, 2)
                .contiguous(), (pos[None] < ln[:, None])[:, None, None])

    dlib_sets = [lib_args(*s) for s in d_sets]
    lib_err = err(sdpa(dlib_sets[0][0], dlib_sets[0][1], dlib_sets[0][2],
                       attn_mask=dlib_sets[0][3])[:, :, 0], o_kernel)
    live = int(d_lens.sum())
    d_bytes = 2 * live * KVH * Dh * 2 + 2 * B_d * H * Dh * 2 + 4 * B_d
    d_flops = 4 * live * H * Dh
    d_bound = {"bytes": d_bytes / PEAK_BYTES * 1e3,
               "operations": d_flops / PEAK_BF16_FLOPS * 1e3}
    decode_row = {
        "name": "decode_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:76",
        "tpu_kernel": "src/repro/kernels/decode_attention.py:76",
        "shape": f"B=8 S=2048 H=12 KVH=2 Dh=128 bf16 lengths "
                 f"{d_lens.tolist()}",
        "max_abs_err": decode_err, "tol": TOL["bfloat16"],
        "ms": time_ms(lambda a, b, c, ln: ops.decode_attention(
            a, b, c, ln, impl="cuda"), d_sets),
        "plain_ms": time_ms(lambda a, b, c, ln: ops.decode_attention(
            a, b, c, ln, impl="plain"), d_sets),
        "library_ms": time_ms(lambda a, b, c, m: sdpa(a, b, c, attn_mask=m),
                              dlib_sets),
        "library_max_abs_err": lib_err,
        "bound_ms": max(d_bound.values()),
        "bound_by": max(d_bound, key=d_bound.get),
        "flops": d_flops, "bytes": d_bytes, "blocks": B_d * KVH,
    }
    for row in (flash_row, decode_row):
        row["kernel_ms"] = row["ms"]
        if not row["max_abs_err"] < row["tol"]:
            raise AssertionError(f"{row['name']} at the serving shape: "
                                 f"{row['max_abs_err']} >= {row['tol']}")
    del pf_sets, lib_sets, d_sets, dlib_sets

    # -- 3. serving: qwen2-1.5b at full width ------------------------------
    cfg = get_config("qwen2-1.5b")
    t0 = time.perf_counter()
    model = T.Transformer(cfg, device="cuda",
                          generator=torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model: {cfg.name} {cfg.n_layers} layers d_model {cfg.d_model} "
          f"{n_params} params {cfg.param_dtype}, init "
          f"{time.perf_counter() - t0:.3f} s")
    eng = ServingEngine(cfg, model, EngineConfig(max_batch=8, max_seq=2048))
    eng.submit(Request(rid=-1, prompt=list(range(1, 65)), max_new_tokens=2))
    eng.run()                                    # warm-up: cuBLAS, allocator
    eng.finished.clear()
    eng.prefills = eng.decodes = 0
    rng = np.random.default_rng(0)
    prompt_lens = rng.integers(64, 1025, size=N_REQUESTS)
    prompts = [list(map(int, rng.integers(0, cfg.vocab_size, size=L)))
               for L in prompt_lens]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.launches = 0
    da.launches = 0
    t0 = time.perf_counter()
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=NEW_TOKENS))
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    flash_launches, decode_launches = fa.launches, da.launches
    if len(done) != N_REQUESTS or any(len(r.generated) != NEW_TOKENS
                                      for r in done):
        raise AssertionError(f"serving: {len(done)} finished, tokens "
                             f"{[len(r.generated) for r in done]}")
    if eng.prefills != N_REQUESTS:
        raise AssertionError(f"serving: {eng.prefills} prefills")
    if flash_launches != cfg.n_layers * eng.prefills or \
            decode_launches != cfg.n_layers * eng.decodes:
        raise AssertionError(
            f"launch counts: flash {flash_launches} for {eng.prefills} "
            f"prefills, decode {decode_launches} for {eng.decodes} steps")
    for r in done:
        if not all(0 <= t < cfg.vocab_size for t in r.generated):
            raise AssertionError(f"request {r.rid}: token out of range")
    stats = LatencyStats()
    for r in done:
        stats.observe(r.ttft, r.tpot)
    serving = {
        "requests": len(done), "new_tokens": NEW_TOKENS,
        "prompt_lens": prompt_lens.tolist(),
        "prefills": eng.prefills, "decode_steps": eng.decodes,
        "flash_launches": flash_launches, "decode_launches": decode_launches,
        "wall_s": wall,
        "output_tok_per_s": N_REQUESTS * NEW_TOKENS / wall,
        "ttft_p50_s": stats.percentile("ttfts", 50),
        "ttft_p99_s": stats.percentile("ttfts", 99),
        "tpot_p50_s": stats.percentile("tpots", 50),
        "tpot_p99_s": stats.percentile("tpots", 99),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    print(f"serving: {json.dumps(serving)}")
    flash_row["launches"] = flash_launches
    decode_row["launches"] = decode_launches

    # -- 4. kernel path vs plain path -------------------------------------
    P, steps = 1000, 8
    prng = np.random.default_rng(2)
    prompt = torch.from_numpy(prng.integers(0, cfg.vocab_size, size=(1, P)))
    forced = torch.from_numpy(prng.integers(0, cfg.vocab_size,
                                            size=(steps, 1)))
    outs, times = {}, {}
    for impl in ("cuda", "plain"):
        cache = T.init_cache(cfg, 1, 2048)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        logits, pf = model.prefill(prompt.to(dev), impl=impl)
        T.cache_insert(cfg, cache, pf, 0, P)
        ev[1].record()
        rows = [logits[0, P - 1]]
        lengths = torch.tensor([P], device=dev)
        for t in range(steps):
            step_logits, cache = model.decode_step(
                cache, forced[t].to(dev), lengths, impl=impl)
            rows.append(step_logits[0])
            lengths = lengths + 1
        ev[2].record()
        torch.cuda.synchronize()
        outs[impl] = torch.stack(rows).float()
        times[impl] = {"prefill_ms": ev[0].elapsed_time(ev[1]),
                       "decode_step_ms": ev[1].elapsed_time(ev[2]) / steps}
        del cache, pf, logits
    path_err = err(outs["cuda"], outs["plain"])
    if not bool(torch.isfinite(outs["cuda"]).all()):
        raise AssertionError("kernel path logits are not finite")
    if not path_err < PATH_TOL:
        raise AssertionError(f"kernel path vs plain path logits: {path_err} "
                             f">= {PATH_TOL}")
    path = {"prompt": P, "decode_steps": steps, "max_abs_err": path_err,
            "tol": PATH_TOL,
            "argmax_agree": int((outs["cuda"].argmax(-1)
                                 == outs["plain"].argmax(-1)).sum()),
            "logit_std": float(outs["plain"].std()), "times": times}
    print(f"path: {json.dumps(path)}")

    # -- 5. where a serving decode step's time goes (torch.profiler) -------
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    cache = T.init_cache(cfg, B_d, S_d)
    toks = torch.zeros(B_d, dtype=torch.int64, device=dev)
    for _ in range(3):
        model.decode_step(cache, toks, d_lens)
    torch.cuda.synchronize()
    n_steps = 5
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            model.decode_step(cache, toks, d_lens)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / n_steps
    dev_events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and e.self_device_time_total > 0]
    kernels = sorted(((e.key, e.self_device_time_total / 1e3 / n_steps)
                      for e in dev_events), key=lambda kv: -kv[1])
    busy_ms = sum(ms for _, ms in kernels)
    trace = {"batch": B_d, "lengths": d_lens.tolist(),
             "step_wall_ms": step_ms, "traced": True,
             "kernels_per_step": sum(e.count for e in dev_events) / n_steps,
             "device_busy_ms": busy_ms if kernels else "not measured",
             "device_idle_share": 1 - busy_ms / step_ms if kernels
             else "not measured",
             "top_kernels_ms": [[k[:60], ms] for k, ms in kernels[:8]]}
    print(f"trace: {json.dumps(trace)}")
    del cache

    print(json.dumps({"kernels": [flash_row, decode_row]}))
    print(smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

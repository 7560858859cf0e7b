#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each of which raises on failure (nothing is caught):
  1. build   — compiles src/repro_torch/kernels/csrc/*.cu for sm_90a and
               counts the tensor-core instructions in the library's SASS
               (cuobjdump): the bf16 prefill kernels must have them.
  2. kernels — each CUDA kernel against its plain PyTorch version on the
               card. Attention: the tests/test_kernels.py shape sweep in
               fp32 and bf16, window/softcap and ragged cases, and both
               served attention models' shapes (qwen2-1.5b: H=12, KVH=2,
               Dh=128; granite-moe: H=16, KVH=8, Dh=64; bf16, prefill
               Sq=Skv=1024, decode B=8, S=2048). MoE gating: the
               tests/test_kernels.py shapes, granite's decode and prefill
               and jamba's shapes, and an exp-underflow case; ids exactly
               equal. WKV6 and Mamba scans: the tests/test_kernels.py
               shapes, full-width prefill (rwkv6-1.6b: H=32, K=64; jamba:
               Din=16384, N=16; T=1024) and the decode batch (B=8, T=1,
               also against the single-step versions and with the state
               written in place), fp32 and bf16, against the sequential
               oracles; rwkv6 also at the chunk edges T = c - 1, c, c + 1 of
               every chunk size, T = 881, B = 8 at T = 200 and decays down to
               ~e^-20; ssm also at N = 8 and 16 with Din = 16608 (not whole
               blocks), T = 1023. A chunk sweep times rwkv6's chunk
               sizes. The attention sweeps also
               hold the split-KV decode at its edges (G = 16, lengths 0
               and 1, a window under one split, int64 and int32 lengths)
               and the prefill at Sq = Skv = 64 k + 1 with a window under
               one tile. Times with CUDA events and torch.profiler.
  3. serving — qwen2-1.5b, granite-moe-1b-a400m and rwkv6-1.6b at full
               width and depth, then jamba-1.5-large at full width on the
               first 4 layers of its period (bf16, seeded random weights)
               behind ServingEngine(max_batch=8, max_seq=2048): 8 requests,
               32 new tokens each. The launch counters, zeroed just before
               each run, must show every prefill and decode step of every
               layer going through its kernels, per layer kind.
  4. path    — one prompt through prefill and 8 teacher-forced decode steps,
               once through the kernels and once with impl="plain": qwen2
               in bf16; granite in fp32 (gated, with no differing expert
               choice) and in bf16 (reported); rwkv6 in fp32 (gated, argmax
               equal) and in bf16 (reported); jamba in fp32 on layers 0-1
               (Mamba + dense, Mamba + MoE) and on layers 2-3 (Mamba +
               dense, attention + MoE), each gated with no differing expert
               choice, and in bf16 on the 4 (reported).
  5. trace   — torch.profiler over 5 serving-shaped decode steps (B=8) of
               each model: step wall time, device busy time, top kernels.

Prints the card's name and power limit, a {"kernels": [...]} line, and as
its last line {"ok": true, "device": {...}}. Without CUDA, or without the
repository beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# NVIDIA H100 SXM published peaks (dense): bf16 tensor-core rate, fp32 rate
# outside the tensor cores, HBM rate
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
TOL = {"float32": 2e-5, "bfloat16": 2e-2}   # tests/test_kernels.py::_tol
GATING_TOL = 1e-6           # tests/test_kernels.py::test_moe_gating_kernel
# Logits of the kernel path vs the plain path, bf16, full-width qwen2 with
# random weights (logit std ~0.78): both paths attend in fp32 and round to
# bf16, so they differ only where a rounding flips and the flip propagates
# through 28 layers; 0.1 is ~13 bf16 ulps at |logit| in [1, 2).
PATH_TOL = 0.1
# The same for granite-moe in fp32, where a route is gated, not rounded:
# both paths run the same cuBLAS fp32 products and differ only in the order
# the attention kernels sum in (<= 5e-7 per call at O(1) inputs, PERF.md)
# and in the gating weights (<= 1e-7). With every expert choice equal, that
# is ~1e-6 per layer, a few 1e-5 after 24 residual layers; 1e-3 leaves
# room for growth with depth and is still far below what one flipped route
# moves (a whole expert's output, weighted ~1/8, at O(1) hidden values).
# rwkv6 and jamba in fp32 are held to the same 1e-3: their plain paths run
# the chunked scans, which differ from the kernels' sequential sums by
# ~1e-6 relative per layer (the case sweep above).
PATH_TOL_FP32 = 1e-3
# The scans vs their sequential oracles: tests/test_kernels.py's 1e-4 for
# fp32 outputs and states. With bf16 inputs both sides read the same bf16
# values and compute in fp32, so the fp32 results differ by summation order
# only (~1e-6); the bf16 outputs may then round a value's last bit apart,
# one bf16 ulp, <= 2^-7 of its magnitude: outputs must lie within
# SCAN_TOL + 2^-7 |oracle| elementwise, states (fp32) within SCAN_TOL.
SCAN_TOL = 1e-4
BF16_ULP = 2.0 ** -7
N_REQUESTS, NEW_TOKENS = 8, 32
B_D, S_D = 8, 2048          # serving decode batch and cache length


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def underflow_logits() -> np.ndarray:
    """Rows whose logits sit > 104 apart, so fewer than k = 8 experts keep
    a non-zero fp32 probability (ROADMAP C-ref-2)."""
    lg = np.full((3, 16), -120.0, np.float32)
    lg[0] = -110.0 * np.arange(16)                    # one survivor
    lg[1, [3, 8, 13]] = 0.0                           # three, tied
    lg[2, 9], lg[2, 2] = 1.0, 0.5                     # two
    return lg


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gating as mg
    from repro_torch.kernels import rwkv6_scan as rk
    from repro_torch.kernels import ssm_scan as ss
    from repro_torch.models import transformer as T
    from repro_torch.serving import (EngineConfig, LatencyStats, Request,
                                     ServingEngine)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"card: {smi()}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    kernel_mods = {"flash_attention": fa, "decode_attention": da,
                   "moe_gating": mg, "rwkv6_scan": rk, "ssm_scan": ss}

    # -- 1. build ---------------------------------------------------------
    _, build_s, log = _build.timed_load()
    print(f"build: {build_s:.3f} s -> {_build.library_path()}")
    for line in log.splitlines():
        if any(w in line for w in ("Compiling entry", "Used", "spill")) \
                or line.startswith("=="):
            print(f"  {line.strip()}")

    # tensor-core instructions per kernel in the built library's SASS
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass_mma = {}
    if Path(cuobjdump).exists():
        sass = subprocess.run([cuobjdump, "-sass", str(_build.library_path())],
                              capture_output=True, text=True,
                              check=True).stdout
        fn = None
        for line in sass.splitlines():
            if "Function :" in line:
                fn = line.split("Function :")[1].strip()
            elif fn and "*/" in line and "MMA" in line:
                op = line.split("*/", 1)[1].split()[0]
                if op.rstrip(";").split(".")[0] in ("HMMA", "HGMMA"):
                    ops_fn = sass_mma.setdefault(fn, {})
                    ops_fn[op] = ops_fn.get(op, 0) + 1
        tc = {f: o for f, o in sass_mma.items() if "flash_tc_kernel" in f}
        if len(tc) != len(fa.HEAD_DIMS):
            raise AssertionError(f"bf16 flash kernels without tensor-core "
                                 f"instructions in their SASS: {sass_mma}")
        print(f"sass: tensor-core instructions {json.dumps(sass_mma)}")
    else:
        print("sass: not measured (no cuobjdump)")

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

    def device_ms(fn, args_sets, iters=30):
        """Device time per call: the self time of every CUDA kernel the
        calls launch, under torch.profiler. Where the host takes longer to
        issue a call than the device to run it, time_ms measures the host
        and this the device."""
        for i in range(3):
            fn(*args_sets[i % len(args_sets)])
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i in range(iters):
                fn(*args_sets[i % len(args_sets)])
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA)
        if not total > 0:
            raise AssertionError("torch.profiler saw no device time")
        return total / 1e3 / iters

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
        (1, 193, 193, 12, 2, 128, True, None, None),   # 64 k + 1: one row
        (2, 129, 129, 4, 2, 64, True, 24, 30.0),       # window < one tile
        (1, 257, 257, 8, 2, 128, True, 40, 50.0),
        (1, 1024, 1024, 12, 2, 128, True, None, None),  # qwen2 serving
        (1, 1024, 1024, 16, 8, 64, True, None, None),   # granite serving
        (1, 1000, 1000, 16, 8, 64, True, None, None),   # granite path
        (1, 1024, 1024, 64, 8, 128, True, None, None),  # jamba serving
        (1, 1000, 1000, 64, 8, 128, True, None, None),  # jamba path
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

    decode_cases = [  # B, S, H, KVH, Dh, window, softcap, lengths
        (2, 512, 8, 2, 64, None, None, None),           # tests/test_kernels
        (1, 256, 4, 4, 128, None, 30.0, None),
        (2, 512, 4, 2, 64, 128, None, None),
        (3, 256, 16, 2, 64, None, None, None),
        (8, 2048, 12, 2, 128, 256, 50.0, None),
        (8, 2048, 12, 2, 128, None, None, None),        # qwen2 serving
        (8, 2048, 16, 8, 64, None, None, None),         # granite serving
        (8, 2048, 64, 8, 128, None, None, None),        # jamba serving
        (4, 2048, 32, 2, 128, None, None, None),        # G = 16 (MAX_GROUP)
        (4, 2048, 32, 2, 64, 40, 30.0, None),
        (8, 2048, 12, 2, 128, None, None, [1] * 8),     # one split not empty
        (4, 2048, 12, 2, 128, None, None, [2048, 0, 700, 1]),   # a zero row
        (8, 2048, 12, 2, 128, 50, 30.0, None),          # window < one split
        (3, 300, 12, 2, 128, 64, None, [300, 0, 129]),  # ragged last tile
    ]
    n_decode = 0
    lrng = np.random.default_rng(1)
    for dtype in (torch.float32, torch.bfloat16):
        for B, S, H, KVH, Dh, window, cap, lens in decode_cases:
            q = rnd((B, H, Dh), dtype)
            kc, vc = rnd((B, S, KVH, Dh), dtype), rnd((B, S, KVH, Dh), dtype)
            if lens is None:
                lens = lrng.integers(1, S + 1, size=B)
                lens[0], lens[-1] = 1, S                 # both extremes
            kw = dict(window=window, softcap=cap)
            # lengths as the engine hands them over (int64) and as int32
            for ldt in (torch.int64, torch.int32):
                ln = torch.tensor(lens, dtype=ldt, device=dev)
                got = ops.decode_attention(q, kc, vc, ln, impl="cuda", **kw)
                check("decode_attention", dtype, got,
                      ops.decode_attention(q, kc, vc, ln, impl="plain", **kw),
                      (B, S, H, KVH, Dh, window, cap, str(ldt)))
                if bool((got[ln == 0] != 0).any()):
                    raise AssertionError(f"decode_attention {B, S, H} "
                                         "lengths 0: output not zero")
                n_decode += 1

    gating_cases = [  # T, E, k
        (100, 32, 4), (64, 8, 3), (257, 384, 8),        # tests/test_kernels
        (8, 32, 8), (1024, 32, 8),                      # granite serving
        (256, 16, 2),                                   # jamba
    ]
    gating_err = 0.0
    for case in gating_cases + ["underflow"]:
        if case == "underflow":
            lg, k = underflow_logits(), 8
        else:
            Tg, Eg, k = case
            lg = (np.random.default_rng(Tg).standard_normal((Tg, Eg))
                  * 2).astype(np.float32)
        lg = torch.from_numpy(lg).to(dev)
        w, ids, _ = ops.moe_gating(lg, k, impl="cuda")
        w_ref, ids_ref, _ = ops.moe_gating(lg, k, impl="plain")
        if not torch.equal(ids, ids_ref):
            raise AssertionError(f"moe_gating {case}: ids differ from the "
                                 "plain version")
        if any(len(set(row)) != k for row in ids.tolist()):
            raise AssertionError(f"moe_gating {case}: repeated ids")
        e = err(w, w_ref)
        if not e < GATING_TOL:
            raise AssertionError(f"moe_gating {case}: weights max abs err "
                                 f"{e} >= {GATING_TOL}")
        gating_err = max(gating_err, e)
    sweep["moe_gating"] = {"float32": gating_err}

    def rwkv_inputs(B, Tn, H, K, dtype, strong_decay=False):
        """tests/test_kernels.py::test_rwkv6_kernel's distributions; r/k/v
        in ``dtype``, w/u/state fp32 as the model passes them.
        ``strong_decay``: w = exp(-exp(N(0, 1) + 2)), down to ~e^-20."""
        r, k, v = (rnd((B, Tn, H, K), torch.float32) * 0.5 for _ in range(3))
        z = rnd((B, Tn, H, K), torch.float32)
        w = torch.exp(-torch.exp(z + 2 if strong_decay else z * 0.5 - 1))
        return (r.to(dtype), k.to(dtype), v.to(dtype), w,
                rnd((H, K), torch.float32) * 0.3,
                rnd((B, H, K, K), torch.float32) * 0.1)

    def ssm_inputs(B, Tn, Din, N, dtype):
        """tests/test_kernels.py::test_ssm_kernel's distributions with a
        non-zero state; x/Bm/Cm in ``dtype``, dt/A/D/h0 fp32."""
        f32 = torch.float32
        x = rnd((B, Tn, Din), dtype)
        dt = torch.nn.functional.softplus(rnd((B, Tn, Din), f32)) * 0.1
        A = -torch.exp(rnd((Din, N), f32) * 0.3)
        return (x, dt, A, rnd((B, Tn, N), dtype), rnd((B, Tn, N), dtype),
                rnd((Din,), f32), rnd((B, Din, N), f32) * 0.1)

    scan_errs = {}

    def scan_check(name, dtype, got, want, case, against):
        """Outputs within SCAN_TOL (+ one bf16 ulp), states within
        SCAN_TOL; records the max abs errors."""
        (out, st), (out_r, st_r) = got, want
        diff = (out.float() - out_r.float()).abs()
        lim = SCAN_TOL + (BF16_ULP * out_r.float().abs()
                          if dtype == torch.bfloat16 else 0.0)
        e_out, e_st = float(diff.max()), err(st, st_r)
        if not bool((diff < lim).all()) or not e_st < SCAN_TOL:
            raise AssertionError(
                f"{name} {case} {dtype} vs {against}: max abs err out "
                f"{e_out}, state {e_st}")
        key = str(dtype).split(".")[-1]
        scan_errs[(name, case, key)] = max(e_out, e_st)
        sweep.setdefault(name, {})
        sweep[name][key] = max(sweep[name].get(key, 0.0), e_out, e_st)

    RWKV_PF, RWKV_DEC = (1, 1024, 32, 64), (B_D, 1, 32, 64)
    SSM_PF, SSM_DEC = (1, 1024, 16384, 16), (B_D, 1, 16384, 16)
    # rwkv6: (B, T, H, K, chunk or None for the plan, strong decay); the
    # chunk edges T = c - 1, c, c + 1 of every chunk size, a served prompt
    # length, a batch, and decays down to ~e^-20
    rwkv_cases = [(2, 64, 2, 16, None, False), (1, 96, 4, 32, None, False),
                  (2, 80, 2, 16, None, False), (*RWKV_PF, None, False),
                  (*RWKV_DEC, None, False)]
    rwkv_cases += [(1, T_, 32, 64, c, False) for c in rk.CHUNKS
                   for T_ in (c - 1, c, c + 1)]
    rwkv_cases += [(1, 881, 32, 64, None, False), (B_D, 200, 32, 64, None,
                                                   False),
                   (1, 300, 32, 64, None, True)]
    # ssm: (B, T, Din, N); N = 8 and 16 at a Din that is not a whole
    # number of blocks (16384 + 64 * 3 + 32) and T = 1023
    ssm_cases = [(2, 32, 64, 8), (1, 64, 128, 16), (2, 50, 32, 8),
                 SSM_PF, SSM_DEC, (1, 1023, 16608, 16), (1, 1023, 16608, 8)]
    for dtype in (torch.float32, torch.bfloat16):
        for B_, T_, H_, K_, c, strong in rwkv_cases:
            args = rwkv_inputs(B_, T_, H_, K_, dtype, strong_decay=strong)
            case = (B_, T_, H_, K_) + ((f"chunk {c}",) if c else ()) \
                + (("strong decay",) if strong else ())
            got = rk.rwkv6_scan(*args, chunk=c)
            scan_check("rwkv6_scan", dtype, got,
                       ops.rwkv6_scan(*args, impl="naive"), case,
                       "rwkv6_sequential")
            if T_ == 1:
                scan_check("rwkv6_scan", dtype, got,
                           ops.rwkv6_scan(*args, impl="plain"), case,
                           "rwkv6_single_step")
                # decode's in-place state: state_out is the state itself
                st = args[-1].clone()
                scan_check("rwkv6_scan", dtype,
                           ops.rwkv6_scan(*args[:-1], st, state_out=st),
                           got, case + ("in place",), "out-of-place kernel")
        for case in ssm_cases:
            args = ssm_inputs(*case, dtype)
            got = ops.ssm_scan(*args, impl="cuda")
            scan_check("ssm_scan", dtype, got,
                       ops.ssm_scan(*args, impl="naive"), case,
                       "ssm_sequential")
            if case[1] == 1:
                scan_check("ssm_scan", dtype, got,
                           ops.ssm_scan(*args, impl="plain"), case,
                           "ssm_single_step")
                h = args[-1].clone()
                scan_check("ssm_scan", dtype,
                           ops.ssm_scan(*args[:-1], h, state_out=h), got,
                           case + ("in place",), "out-of-place kernel")
        # Bm / Cm as strided views of one projection, as mamba_forward
        # passes them (dt_rank 512 columns before them)
        x, dt, A, Bm, Cm, D, h0 = ssm_inputs(2, 40, 256, 16, dtype)
        proj = torch.cat([rnd((2, 40, 512), dtype), Bm, Cm], dim=-1)
        _, Bv, Cv = proj.split([512, 16, 16], dim=-1)
        args = (x, dt, A, Bv, Cv, D, h0)
        scan_check("ssm_scan", dtype, ops.ssm_scan(*args, impl="cuda"),
                   ops.ssm_scan(*args, impl="naive"), "strided Bm/Cm",
                   "ssm_sequential")
    # the chunked passes with the final state written over the input state
    # (carry reads each element of s0 before it writes that of sT)
    for dtype in (torch.float32, torch.bfloat16):
        args = rwkv_inputs(1, 100, 32, 64, dtype)
        st = args[-1].clone()
        got = rk.rwkv6_scan(*args[:-1], st, state_out=st, chunk=32)
        if got[1] is not st:
            raise AssertionError("rwkv6_scan did not return state_out")
        scan_check("rwkv6_scan", dtype, got,
                   ops.rwkv6_scan(*args, impl="naive"),
                   (1, 100, 32, 64, "chunk 32", "in place"),
                   "rwkv6_sequential")
    print(f"kernels: {n_flash} flash, {n_decode} decode, "
          f"{len(gating_cases) + 1} moe_gating, {2 * len(rwkv_cases) + 2} "
          f"rwkv6_scan and {2 * len(ssm_cases) + 2} ssm_scan cases within "
          f"tolerance (ids equal); max abs err {json.dumps(sweep)}")

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
    # ms: device time per call (torch.profiler); call_ms: per call as CUDA
    # events see it back to back, the wrapper's host time included. plain_ms
    # and library_ms are CUDA-event times, as in earlier runs.
    def flash_kernel(a, b, c):
        return ops.flash_attention(a, b, c, impl="cuda")

    def sdpa_causal(a, b, c):
        return sdpa(a, b, c, is_causal=True)

    flash_row = {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:92",
        "tpu_kernel": "src/repro/kernels/flash_attention.py:92",
        "shape": "B=1 Sq=Skv=1024 H=12 KVH=2 Dh=128 bf16 causal",
        "max_abs_err": flash_err, "tol": TOL["bfloat16"],
        "ms": device_ms(flash_kernel, pf_sets),
        "call_ms": time_ms(flash_kernel, pf_sets),
        "plain_ms": time_ms(lambda a, b, c: ops.flash_attention(
            a, b, c, impl="plain"), pf_sets, iters=10),
        "library_ms": time_ms(sdpa_causal, lib_sets),
        "library_device_ms": device_ms(sdpa_causal, lib_sets),
        "library_max_abs_err": lib_err,
        "bound_ms": max(pf_bound.values()),
        "bound_by": max(pf_bound, key=pf_bound.get),
        "flops": pf_flops, "bytes": pf_bytes,
        "block_q": fa.BLOCK_Q,
        "blocks": H * -(-S_pf // fa.BLOCK_Q),
    }

    d_lens = torch.from_numpy(
        np.random.default_rng(0).integers(64, 2048, size=B_D)).to(dev)
    d_sets = [(rnd((B_D, H, Dh), bf16), rnd((B_D, S_D, KVH, Dh), bf16),
               rnd((B_D, S_D, KVH, Dh), bf16), d_lens) for _ in range(8)]
    q, kc, vc, lens = d_sets[0]
    o_kernel = ops.decode_attention(q, kc, vc, lens, impl="cuda")
    decode_err = err(o_kernel, ops.decode_attention(q, kc, vc, lens,
                                                    impl="plain"))
    pos = torch.arange(S_D, device=dev)

    def lib_args(a, b, c, ln):
        return (a[:, :, None], b.repeat_interleave(G, dim=2).transpose(1, 2)
                .contiguous(), c.repeat_interleave(G, dim=2).transpose(1, 2)
                .contiguous(), (pos[None] < ln[:, None])[:, None, None])

    dlib_sets = [lib_args(*s) for s in d_sets]
    lib_err = err(sdpa(dlib_sets[0][0], dlib_sets[0][1], dlib_sets[0][2],
                       attn_mask=dlib_sets[0][3])[:, :, 0], o_kernel)
    live = int(d_lens.sum())
    d_bytes = 2 * live * KVH * Dh * 2 + 2 * B_D * H * Dh * 2 + 4 * B_D
    d_flops = 4 * live * H * Dh
    d_bound = {"bytes": d_bytes / PEAK_BYTES * 1e3,
               "operations": d_flops / PEAK_BF16_FLOPS * 1e3}
    def decode_kernel(a, b, c, ln):
        return ops.decode_attention(a, b, c, ln, impl="cuda")

    def sdpa_masked(a, b, c, m):
        return sdpa(a, b, c, attn_mask=m)

    n_splits = da.plan_splits(B_D, KVH, S_D,
                              torch.cuda.get_device_properties(dev)
                              .multi_processor_count)
    decode_row = {
        "name": "decode_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:76",
        "tpu_kernel": "src/repro/kernels/decode_attention.py:76",
        "shape": f"B=8 S=2048 H=12 KVH=2 Dh=128 bf16 lengths "
                 f"{d_lens.tolist()} ({d_lens.dtype})",
        "max_abs_err": decode_err, "tol": TOL["bfloat16"],
        "ms": device_ms(decode_kernel, d_sets),
        "call_ms": time_ms(decode_kernel, d_sets),
        "plain_ms": time_ms(lambda a, b, c, ln: ops.decode_attention(
            a, b, c, ln, impl="plain"), d_sets),
        "library_ms": time_ms(sdpa_masked, dlib_sets),
        "library_device_ms": device_ms(sdpa_masked, dlib_sets),
        "library_max_abs_err": lib_err,
        "bound_ms": max(d_bound.values()),
        "bound_by": max(d_bound, key=d_bound.get),
        "flops": d_flops, "bytes": d_bytes,
        "n_splits": n_splits, "blocks": n_splits * B_D * KVH,
        "combine_blocks": B_D * H,
    }
    # device ms of the decode kernels against the split count, at the
    # serving decode shapes of qwen2, granite and jamba (the wrapper's
    # choice is marked)
    split_sweep = {}
    for Hs, KVHs, Dhs in ((H, KVH, Dh), (16, 8, 64), (64, 8, 128)):
        sets = [(rnd((B_D, Hs, Dhs), bf16), rnd((B_D, S_D, KVHs, Dhs), bf16),
                 rnd((B_D, S_D, KVHs, Dhs), bf16), d_lens) for _ in range(4)]
        planned = da.plan_splits(B_D, KVHs, S_D, torch.cuda
                                 .get_device_properties(dev)
                                 .multi_processor_count)
        split_sweep[f"H={Hs} KVH={KVHs} Dh={Dhs}"] = {
            f"{n}{'*' if n == planned else ''}": device_ms(
                lambda a, b, c, ln, n=n: da.decode_attention(
                    a, b, c, ln, n_splits=n), sets)
            for n in sorted({planned, 2, 4, 8, 16, 32})}
        del sets
    print(f"decode split sweep (device ms; * = planned): "
          f"{json.dumps(split_sweep)}")
    print(f"attention timing: flash {flash_row['blocks']} blocks of "
          f"BQ={fa.BLOCK_Q}, device {flash_row['ms']:.5f} ms, call "
          f"{flash_row['call_ms']:.5f} ms, SDPA {flash_row['library_ms']:.5f}"
          f" ms; decode {n_splits} splits, {decode_row['blocks']} blocks, "
          f"device {decode_row['ms']:.5f} ms, call {decode_row['call_ms']:.5f}"
          f" ms, SDPA + mask {decode_row['library_ms']:.5f} ms")
    del pf_sets, lib_sets, d_sets, dlib_sets

    def library_gating(lg, k):
        """One PyTorch composition of the same function (never called by
        the port): softmax, topk, renormalise."""
        vals, ids = torch.topk(torch.softmax(lg, dim=-1), k)
        return vals / vals.sum(-1, keepdim=True).clamp_min(1e-9), ids

    def gating_timing(Tg, Eg, k):
        sets = [(torch.randn((Tg, Eg), generator=gen, device=dev) * 2,)
                for _ in range(8)]
        w, ids = mg.moe_gating_topk(sets[0][0], k)
        w_ref, ids_ref, _ = ref.topk_gating(sets[0][0], k)
        if not torch.equal(ids, ids_ref):
            raise AssertionError(f"moe_gating T={Tg} E={Eg} k={k}: ids "
                                 "differ from the plain version")
        nbytes = Tg * Eg * 4 + Tg * k * 8
        n_ops = Tg * Eg * (5 + k)      # softmax ~5 per logit, k argmax rounds
        bound = {"bytes": nbytes / PEAK_BYTES * 1e3,
                 "operations": n_ops / PEAK_FP32_FLOPS * 1e3}
        fns = {"": lambda x: mg.moe_gating_topk(x, k),
               "plain_": lambda x: ref.topk_gating(x, k),
               "ops_cuda_": lambda x: ops.moe_gating(x, k),
               "library_": lambda x: library_gating(x, k)}
        # ms / plain_ms / ...: device time per call; *call_ms: per call as
        # CUDA events see it back to back, the host's issue time included
        times = {}
        for key, fn in fns.items():
            times[f"{key}ms"] = device_ms(fn, sets)
            times[f"{key}call_ms"] = time_ms(fn, sets)
        return {
            "shape": f"T={Tg} E={Eg} k={k} fp32",
            "max_abs_err": err(w, w_ref), **times,
            "library_max_abs_err": err(library_gating(sets[0][0], k)[0], w),
            "bound_ms": max(bound.values()),
            "bound_by": max(bound, key=bound.get),
            "bytes": nbytes, "operations": n_ops,
        }

    moe_row = {
        "name": "moe_gating", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/moe_gating.cu",
        "replaces": "src/repro/kernels/moe_gating.py:43",
        "tpu_kernel": "src/repro/kernels/moe_gating.py:43",
        **gating_timing(1024, 32, 8), "tol": GATING_TOL,
        "decode_shape": gating_timing(B_D, 32, 8),
    }

    def scan_timing(kernel, plain, make_args, nbytes, n_ops):
        """Device ms (torch.profiler) and call ms (CUDA events) per call of
        the kernel's wrapper and of the plain version (ops impl="plain"),
        bf16 as served; the bound from the shapes: each input read once,
        each output written once, and the scan's fp32 operations."""
        sets = [make_args() for _ in range(4)]
        times = {}
        for key, fn in (("", kernel), ("plain_", plain)):
            times[f"{key}ms"] = device_ms(fn, sets, iters=10)
            times[f"{key}call_ms"] = time_ms(fn, sets, iters=10)
        bound = {"bytes": nbytes / PEAK_BYTES * 1e3,
                 "operations": n_ops / PEAK_FP32_FLOPS * 1e3}
        return {**times, "bound_ms": max(bound.values()),
                "bound_by": max(bound, key=bound.get), "bytes": nbytes,
                "operations": n_ops}

    bf16_size = 2

    def rwkv_timing(B, Tn, H, K):
        n = B * Tn * H * K
        # r, k, v (bf16) and w (fp32) in, out (bf16); u; state in and out.
        # Operations: per state element a step, 2 for the output (r * S,
        # summed), 3 for the update (w * S + k * v); the bonus term is O(K).
        return {"shape": f"B={B} T={Tn} H={H} K={K} bf16 r/k/v, fp32 w",
                **scan_timing(rk.rwkv6_scan,
                              lambda *a: ops.rwkv6_scan(*a, impl="plain"),
                              lambda: rwkv_inputs(B, Tn, H, K, bf16),
                              n * (4 * bf16_size + 4) + H * K * 4
                              + 2 * B * H * K * K * 4,
                              5 * B * Tn * H * K * K)}

    def ssm_timing(B, Tn, Din, N):
        n = B * Tn * Din
        # x (bf16) and dt (fp32) in, y (bf16) out; Bm, Cm (bf16); A, D;
        # h0 and hT. Operations: per state element a step, dt * A, exp,
        # the update's product and FMA (3), the output's FMA (2); 3 a
        # channel (dt * x, D * x, the sum).
        return {"shape": f"B={B} T={Tn} Din={Din} N={N} bf16 x/Bm/Cm, fp32 "
                         "dt/A/D/h0",
                **scan_timing(ss.ssm_scan,
                              lambda *a: ops.ssm_scan(*a, impl="plain"),
                              lambda: ssm_inputs(B, Tn, Din, N, bf16),
                              n * (2 * bf16_size + 4)
                              + 2 * B * Tn * N * bf16_size
                              + Din * N * 4 + Din * 4 + 2 * B * Din * N * 4,
                              n * (7 * N + 3))}

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    # the SM clock the card can reach: the special-function-unit bound of
    # the Mamba scan (one accurate exponential per state and step, 16
    # results a clock per SM on Hopper) is taken at it
    max_sm_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])

    def sfu_bound_ms(B, Tn, Din, N):
        return B * Tn * Din * N / (16 * sms * max_sm_mhz * 1e6) * 1e3

    rwkv_row = {
        "name": "rwkv6_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rwkv6_scan.cu",
        "replaces": "src/repro/kernels/rwkv6_scan.py:46",
        "tpu_kernel": "src/repro/kernels/rwkv6_scan.py:46",
        **rwkv_timing(*RWKV_PF),
        "chunk": rk.plan_chunks(*RWKV_PF[:3], sms),
        # vs rwkv6_sequential at this shape in this run's case sweep
        "max_abs_err": scan_errs[("rwkv6_scan", RWKV_PF, "float32")],
        "tol": SCAN_TOL,
        "bf16_max_abs_err": scan_errs[("rwkv6_scan", RWKV_PF, "bfloat16")],
        "library_ms": None, "library": "none: no one PyTorch call computes "
                                       "the WKV6 recurrence",
        "decode_shape": rwkv_timing(*RWKV_DEC),
    }
    ssm_row = {
        "name": "ssm_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssm_scan.cu",
        "replaces": "src/repro/kernels/ssm_scan.py:47",
        "tpu_kernel": "src/repro/kernels/ssm_scan.py:47",
        **ssm_timing(*SSM_PF),
        "sfu_bound_ms": sfu_bound_ms(*SSM_PF), "max_sm_mhz": max_sm_mhz,
        "max_abs_err": scan_errs[("ssm_scan", SSM_PF, "float32")],
        "tol": SCAN_TOL,
        "bf16_max_abs_err": scan_errs[("ssm_scan", SSM_PF, "bfloat16")],
        "library_ms": None, "library": "none: no one PyTorch call computes "
                                       "the selective scan",
        "decode_shape": {**ssm_timing(*SSM_DEC),
                         "sfu_bound_ms": sfu_bound_ms(*SSM_DEC)},
    }
    # device ms of rwkv6_scan against the chunk size (* = planned) at the
    # timing shape, a served prompt length and the shortest one
    chunk_sweep = {}
    for Tn in (1024, 881, 323, 79):
        sets = [rwkv_inputs(1, Tn, 32, 64, bf16) for _ in range(4)]
        planned = rk.plan_chunks(1, Tn, 32, sms)
        chunk_sweep[f"B=1 T={Tn} H=32 K=64"] = {
            f"{c}{'*' if c == planned else ''}": device_ms(
                lambda *a, c=c: rk.rwkv6_scan(*a, chunk=c), sets, iters=10)
            for c in rk.CHUNKS}
        del sets
    print(f"chunk sweep: rwkv6_scan device ms by chunk size (* = planned): "
          f"{json.dumps(chunk_sweep)}")
    rwkv_row["chunk_sweep"] = chunk_sweep
    kernel_rows = [flash_row, decode_row, moe_row, rwkv_row, ssm_row]
    for row in kernel_rows:
        row["kernel_ms"] = row["ms"]
        if not row["max_abs_err"] < row["tol"]:
            raise AssertionError(f"{row['name']} at the serving shape: "
                                 f"{row['max_abs_err']} >= {row['tol']}")

    # -- helpers of phases 3-5 ----------------------------------------------
    def free():
        """Drop what the last model left behind before the next is built."""
        gc.collect()
        torch.cuda.empty_cache()

    def build(cfg):
        t0 = time.perf_counter()
        model = T.Transformer(
            cfg, device="cuda",
            generator=torch.Generator(device=dev).manual_seed(0))
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in model.parameters())
        print(f"model: {cfg.name} {cfg.n_layers} layers d_model "
              f"{cfg.d_model} {n_params} params {cfg.param_dtype}, init "
              f"{time.perf_counter() - t0:.3f} s")
        return model

    def serve(cfg, model):
        """8 requests x 32 new tokens; every kernel's launches are counted
        from 0 over exactly this run and must match the layer counts."""
        eng = ServingEngine(cfg, model, EngineConfig(max_batch=8,
                                                     max_seq=S_D))
        eng.submit(Request(rid=-1, prompt=list(range(1, 65)),
                           max_new_tokens=2))
        eng.run()                                # warm-up: cuBLAS, allocator
        eng.finished.clear()
        eng.prefills = eng.decodes = 0
        rng = np.random.default_rng(0)
        prompt_lens = rng.integers(64, 1025, size=N_REQUESTS)
        prompts = [list(map(int, rng.integers(0, cfg.vocab_size, size=L)))
                   for L in prompt_lens]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for mod in kernel_mods.values():
            mod.launches = 0
        t0 = time.perf_counter()
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=p, max_new_tokens=NEW_TOKENS))
        done = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: mod.launches for name, mod in kernel_mods.items()}
        kinds = [spec.kind for spec in cfg.layer_specs()]
        if len(done) != N_REQUESTS or any(len(r.generated) != NEW_TOKENS
                                          for r in done):
            raise AssertionError(f"serving {cfg.name}: {len(done)} finished,"
                                 f" tokens {[len(r.generated) for r in done]}")
        if eng.prefills != N_REQUESTS:
            raise AssertionError(f"serving {cfg.name}: {eng.prefills} "
                                 "prefills")
        n_moe = sum(spec.mlp == "moe" for spec in cfg.layer_specs())
        steps = eng.prefills + eng.decodes
        expected = {"flash_attention": kinds.count("attn") * eng.prefills,
                    "decode_attention": kinds.count("attn") * eng.decodes,
                    "moe_gating": n_moe * steps,
                    "rwkv6_scan": kinds.count("rwkv") * steps,
                    "ssm_scan": kinds.count("mamba") * steps}
        if launches != expected:
            raise AssertionError(
                f"serving {cfg.name}: launches {launches} for "
                f"{eng.prefills} prefills and {eng.decodes} decode steps, "
                f"expected {expected}")
        for r in done:
            if not all(0 <= t < cfg.vocab_size for t in r.generated):
                raise AssertionError(f"request {r.rid}: token out of range")
        stats = LatencyStats()
        for r in done:
            stats.observe(r.ttft, r.tpot)
        serving = {
            "model": cfg.name, "layers": cfg.n_layers,
            "requests": len(done),
            "new_tokens": NEW_TOKENS, "prompt_lens": prompt_lens.tolist(),
            "prefills": eng.prefills, "decode_steps": eng.decodes,
            "flash_launches": launches["flash_attention"],
            "decode_launches": launches["decode_attention"],
            "moe_gating_launches": launches["moe_gating"],
            "rwkv6_scan_launches": launches["rwkv6_scan"],
            "ssm_scan_launches": launches["ssm_scan"],
            "wall_s": wall,
            "output_tok_per_s": N_REQUESTS * NEW_TOKENS / wall,
            "ttft_p50_s": stats.percentile("ttfts", 50),
            "ttft_p99_s": stats.percentile("ttfts", 99),
            "tpot_p50_s": stats.percentile("tpots", 50),
            "tpot_p99_s": stats.percentile("tpots", 99),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        }
        print(f"serving: {json.dumps(serving)}")
        return launches

    P, STEPS = 1000, 8
    gating = ops.moe_gating

    def drive(cfg, model, impl, prompt, forced):
        """Prefill + teacher-forced decode steps; returns the logits rows,
        times and the expert ids of every gating call (recorded by wrapping
        ops.moe_gating for this run only)."""
        routes = []

        def recording_gating(logits, top_k, *, impl=None):
            out = gating(logits, top_k, impl=impl)
            routes.append(out[1])
            return out

        ops.moe_gating = recording_gating
        cache = T.init_cache(cfg, 1, S_D)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        logits, pf = model.prefill(prompt, impl=impl)
        T.cache_insert(cfg, cache, pf, 0, P)
        ev[1].record()
        rows = [logits[0, P - 1]]
        lengths = torch.tensor([P], device=dev)
        for t in range(STEPS):
            step_logits, cache = model.decode_step(cache, forced[t], lengths,
                                                   impl=impl)
            rows.append(step_logits[0])
            lengths = lengths + 1
        ev[2].record()
        torch.cuda.synchronize()
        ops.moe_gating = gating
        return (torch.stack(rows).float(), routes,
                {"prefill_ms": ev[0].elapsed_time(ev[1]),
                 "decode_step_ms": ev[1].elapsed_time(ev[2]) / STEPS})

    def path(cfg, model, tol, gate_argmax=False):
        """Kernel path vs plain path on one prompt; gated on ``tol`` and,
        when given, on zero differing expert choices (and with
        ``gate_argmax`` on equal argmax at every position)."""
        prng = np.random.default_rng(2)
        prompt = torch.from_numpy(prng.integers(0, cfg.vocab_size,
                                                size=(1, P))).to(dev)
        forced = torch.from_numpy(prng.integers(0, cfg.vocab_size,
                                                size=(STEPS, 1))).to(dev)
        out_k, routes_k, t_k = drive(cfg, model, "cuda", prompt, forced)
        out_p, routes_p, t_p = drive(cfg, model, "plain", prompt, forced)
        if len(routes_k) != len(routes_p):
            raise AssertionError("kernel and plain paths routed a different "
                                 "number of times")
        choices = differing = reordered = 0
        for a, b in zip(routes_k, routes_p):
            E = cfg.n_experts
            oh_a = torch.zeros(a.shape[0], E, device=dev).scatter_(
                1, a.long(), 1.0)
            oh_b = torch.zeros(b.shape[0], E, device=dev).scatter_(
                1, b.long(), 1.0)
            same_set = (oh_a == oh_b).all(-1)
            choices += a.numel()
            differing += int((oh_a != oh_b).sum()) // 2
            reordered += int((same_set & (a != b).any(-1)).sum())
        path_err = err(out_k, out_p)
        if not bool(torch.isfinite(out_k).all()):
            raise AssertionError(f"{cfg.name} kernel path logits are not "
                                 "finite")
        res = {"model": cfg.name, "layers": cfg.n_layers,
               "layer_kinds": [f"{spec.kind}+{spec.mlp}"
                               for spec in cfg.layer_specs()],
               "dtype": cfg.dtype, "prompt": P,
               "decode_steps": STEPS, "max_abs_err": path_err, "tol": tol,
               "argmax_agree": int((out_k.argmax(-1)
                                    == out_p.argmax(-1)).sum()),
               "positions": STEPS + 1, "logit_std": float(out_p.std()),
               "gating_calls": len(routes_k), "expert_choices": choices,
               "differing_routes": differing,
               "reordered_tokens": reordered,
               "prefill_ms": t_k["prefill_ms"],
               "plain_prefill_ms": t_p["prefill_ms"],
               "times": {"cuda": t_k, "plain": t_p}}
        print(f"path: {json.dumps(res)}")
        if tol is not None:
            if not path_err < tol:
                raise AssertionError(f"{cfg.name} kernel path vs plain path "
                                     f"logits: {path_err} >= {tol}")
            if differing:
                raise AssertionError(f"{cfg.name}: {differing} of {choices} "
                                     "expert choices differ between the "
                                     "kernel and plain paths")
            if gate_argmax and res["argmax_agree"] != res["positions"]:
                raise AssertionError(f"{cfg.name}: argmax differs at "
                                     f"{res['positions'] - res['argmax_agree']}"
                                     " positions")
        return res

    def trace(cfg, model, n_steps=5):
        """Where a serving decode step's time goes (torch.profiler)."""
        cache = T.init_cache(cfg, B_D, S_D)
        toks = torch.zeros(B_D, dtype=torch.int64, device=dev)
        for _ in range(3):
            model.decode_step(cache, toks, d_lens)
        torch.cuda.synchronize()
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
        res = {"model": cfg.name, "layers": cfg.n_layers, "batch": B_D,
               "lengths": d_lens.tolist(),
               "step_wall_ms": step_ms, "traced": True,
               "kernels_per_step": sum(e.count for e in dev_events) / n_steps,
               "device_busy_ms": busy_ms if kernels else "not measured",
               "device_idle_share": 1 - busy_ms / step_ms if kernels
               else "not measured",
               "top_kernels_ms": [[k[:60], ms] for k, ms in kernels[:8]]}
        print(f"trace: {json.dumps(res)}")

    # -- 3-5. qwen2-1.5b: serving, path (bf16), trace ----------------------
    launches_by_path = {}
    cfg = get_config("qwen2-1.5b")
    model = build(cfg)
    launches_by_path[cfg.name] = serve(cfg, model)
    path(cfg, model, PATH_TOL)
    trace(cfg, model)
    del model
    free()

    # -- 3-5. granite-moe-1b-a400m: serving, path (fp32 gated, bf16), trace --
    cfg = get_config("granite-moe-1b-a400m")
    model = build(cfg)
    launches_by_path[cfg.name] = serve(cfg, model)
    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    model32 = build(cfg32)
    path(cfg32, model32, PATH_TOL_FP32)
    del model32
    free()
    path(cfg, model, None)          # bf16: reported, not gated
    trace(cfg, model)
    del model
    free()

    # -- 3-5. rwkv6-1.6b: serving, path (bf16, fp32 gated), trace ----------
    cfg = get_config("rwkv6-1.6b")
    model = build(cfg)
    launches_by_path[cfg.name] = serve(cfg, model)
    path(cfg, model, None)          # bf16: reported, not gated
    trace(cfg, model)
    del model
    free()
    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    model32 = build(cfg32)
    path(cfg32, model32, PATH_TOL_FP32, gate_argmax=True)
    del model32
    free()

    # -- 3-5. jamba-1.5-large at full width: the first 4 layers of its
    # period (mamba+dense, mamba+MoE, mamba+dense, attn+MoE; 46 GB in bf16)
    # serve, path (bf16) and trace. In fp32 only 2 layers fit (48-49 GB):
    # layers 0-1 (mamba+dense, mamba+MoE) and layers 2-3 (mamba+dense,
    # attn+MoE), each path gated, so every layer kind, attention at Jamba's
    # 64/8 heads included, is held to the plain path in fp32.
    jamba = get_config("jamba-1.5-large-398b")

    def layers(lo, hi):
        return dataclasses.replace(jamba, groups=((jamba.groups[0][0][lo:hi],
                                                   1),))

    cfg = layers(0, 4)
    model = build(cfg)
    launches_by_path[f"{cfg.name} ({cfg.n_layers} layers)"] = serve(cfg,
                                                                     model)
    path(cfg, model, None)          # bf16: reported, not gated
    trace(cfg, model)
    del model
    free()
    for lo in (0, 2):
        cfg32 = dataclasses.replace(layers(lo, lo + 2), dtype="float32",
                                    param_dtype="float32")
        model32 = build(cfg32)
        path(cfg32, model32, PATH_TOL_FP32)
        del model32
        free()

    for row in kernel_rows:
        row["launches_by_path"] = {m: n[row["name"]]
                                   for m, n in launches_by_path.items()}
        row["launches"] = sum(row["launches_by_path"].values())
        if not row["launches"]:
            raise AssertionError(f"{row['name']} was never launched on the "
                                 "served paths")
    print(json.dumps({"kernels": kernel_rows}))
    print(smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""One-card dry-run record of the port's decode step: the port of
``repro/launch/dryrun.py::run_cell`` for one NVIDIA card.

The reference lowers and compiles a sharded serve step for a TPU pod and
reads XLA's cost analysis. Here the port's model decodes one step at the
shape case's context length, and the record carries the same fields as far
as they mean something on one card, so the port's copy of
``core/profiler.py::profile_from_dryrun`` consumes it unchanged:

  * ``devices`` is 1 (it takes precedence over ``mesh``, which is a name);
  * ``global_batch`` is the case's batch, cut to the largest batch whose
    decode cache fits beside the weights in 92% of the card's memory
    (``EngineModelParams.activation_reserve`` keeps 8%), from the free
    memory ``torch.cuda.mem_get_info`` reports; every cut is listed under
    ``reduced``;
  * ``flops`` (= ``flops_tc``) is one decode step's operation count from
    ``torch.utils.flop_counter.FlopCounterMode`` over the plain path
    (``impl="plain"``), which does the kernels' math in aten ops, on the
    meta device; the counter cannot see the kernels, which are ctypes calls;
  * ``bytes_accessed`` (= ``bytes_tc``) is a model of the step's traffic,
    stated in ``bytes_source``: every weight as stored, read once (the
    capacity MoE path reads every expert); each sequence's K/V read at the
    context length (the cached tokens and the new one; a sliding window's
    layers read the window; a cross layer its vision tokens, writing none)
    and written for one token; each recurrent state read and written; and
    the logits written (C rows a sequence with C codebooks);
  * measured on the card: ``step_ms`` (CUDA events, the median of the timed
    append-mode steps on the kernel path, after a warm-up),
    ``device_busy_ms`` (torch.profiler) and ``card`` (``nvidia-smi``'s name
    and power limit). A CPU run records none of these and says so.

The record is of the decode step only: training shapes raise (a one-card
train record is ROADMAP A9), and a record must never say that a training
step ran. Prefill shapes are not ported either. Codebook configs decode
tokens (batch, C) into logits (batch, C, V); a vision config's cross layers
read a cache of its n_vision_tokens, part of each sequence's bytes. Run
from the repository root, with ``PYTHONPATH=src``, as

    python -m repro_torch.launch.dryrun --arch qwen2-1.5b --shape decode_32k

(on the card), or on the CPU at a reduced size with ``--device cpu
--reduced --seq-len 256``.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path
from typing import Optional

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import get_config
from repro_torch.configs.shapes import applicable, get_shape
from repro_torch.core.engine_model import DEFAULT_ENGINE
from repro_torch.models import transformer as T

DEFAULT_OUT = Path("results/dryrun_torch")
MESH = "single_card"
WARMUP_STEPS, TIMED_STEPS, PROFILED_STEPS = 3, 7, 5
SEED = 0            # of the random weights and tokens

BYTES_SOURCE = (
    "model of the append-mode decode step: every weight as stored, read "
    "once; per sequence, each attention layer's K/V read at the context "
    "length (cached tokens and the new one; a local layer the window; a "
    "cross layer its vision tokens, none written) and one token written; "
    "each recurrent state read and written; the logits written, one row a "
    "codebook")


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size()
               for t in torch.utils._pytree.tree_leaves(tree))


def step_traffic(cfg, model: T.Transformer, batch: int,
                 seq_len: int) -> dict:
    """The bytes of one append-mode decode step of ``batch`` sequences at
    context ``seq_len`` (``BYTES_SOURCE``), by part."""
    elem = torch.finfo(getattr(torch, cfg.dtype)).bits // 8
    kv_tok = 2 * cfg.n_kv_heads * cfg.head_dim * elem       # K and V
    kv = state = 0
    for spec in cfg.layer_specs():
        if spec.kind == "attn" and spec.attn_type == "cross":
            kv += max(cfg.n_vision_tokens, 1) * kv_tok      # read only
        elif spec.kind == "attn":
            read = seq_len
            if spec.attn_type == "local" and cfg.sliding_window:
                read = min(seq_len, cfg.sliding_window)
            kv += (read + 1) * kv_tok
    one = T.init_cache(cfg, 1, 1, device="meta")
    for gi, (period, _) in enumerate(cfg.groups):
        for li, spec in enumerate(period):
            if spec.kind != "attn":
                state += 2 * _nbytes(one[f"g{gi}"][li])
    weights = _nbytes(list(model.parameters()))
    logits = max(cfg.n_codebooks, 1) * T._padded_vocab(cfg) * elem
    return {"weights": weights, "kv": batch * kv, "states": batch * state,
            "logits": batch * logits}


def decode_tokens(cfg, batch: int, generator=None) -> torch.Tensor:
    """Random decode tokens on the CPU: (batch,), or (batch, C) with
    codebooks."""
    shape = (batch, cfg.n_codebooks) if cfg.n_codebooks else (batch,)
    return torch.randint(0, cfg.vocab_size, shape, generator=generator)


def count_flops(cfg, batch: int, seq_len: int) -> int:
    """One append-mode decode step's operations (FlopCounterMode) on the
    plain path, on the meta device: nothing is allocated or run. A cross
    layer's cache holds its n_vision_tokens, so its read counts those."""
    model = T.Transformer(cfg, device="meta")
    cache = T.init_cache(cfg, batch, seq_len, device="meta")
    tokens = decode_tokens(cfg, batch).to("meta")
    lengths = torch.full((batch,), seq_len - 1, dtype=torch.int64,
                         device="meta")
    with FlopCounterMode(display=False) as counter:
        model.decode_step(cache, tokens, lengths, append=True, impl="plain")
    return int(counter.get_total_flops())


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def _device_time(step, n: int):
    """(device ms per step, the five kernels that take most of it as
    [name, ms per step, launches per step]) under torch.profiler, every
    CUDA kernel's self time; a session that saw no device time is retried
    twice."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                step()
            torch.cuda.synchronize()
        kernels = sorted((e for e in prof.key_averages()
                          if e.device_type == DeviceType.CUDA
                          and e.self_device_time_total > 0),
                         key=lambda e: -e.self_device_time_total)
        if kernels:
            busy = sum(e.self_device_time_total for e in kernels) / 1e3 / n
            return busy, [[e.key[:60], e.self_device_time_total / 1e3 / n,
                           e.count / n] for e in kernels[:5]]
    return "not measured: three profiler sessions saw no device time", []


def run_cell(arch: str, shape: str, out_dir: Path = DEFAULT_OUT, *,
             device="cuda", reduced: bool = False,
             seq_len: Optional[int] = None) -> dict:
    """Decode ``arch`` at ``shape`` on one device and write its record.
    ``seq_len`` overrides the case's context length (a CPU run's cut)."""
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    case = get_shape(shape)
    if case.kind == "train":
        raise NotImplementedError(
            f"{shape}: the one-card record is of the decode step only; a "
            "train record is ROADMAP A9, and no record may say that a "
            "training step ran")
    if case.kind != "decode":
        raise NotImplementedError(f"{shape}: only decode records are "
                                  "ported")
    dev = T.resolve_device(device)
    S = case.seq_len if seq_len is None else seq_len
    rec = {
        "arch": arch, "shape": shape, "mesh": MESH, "kind": case.kind,
        "seq_len": S, "global_batch": case.global_batch,
        "n_params": cfg.param_count(),
        "n_params_active": cfg.active_param_count(),
        "ok": False, "devices": 1, "device": str(dev),
        "config": cfg.name, "decode_mode": "append", "reduced": {},
    }
    if S != case.seq_len:
        rec["reduced"]["seq_len"] = [case.seq_len, S]
    ok, reason = applicable(cfg, case)
    if not ok:
        rec["skipped"] = reason
        _write(out_dir, rec)
        return rec
    model = T.Transformer(cfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(SEED))
    batch = case.global_batch
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        free, total = torch.cuda.mem_get_info(dev)
        per_seq = _nbytes(T.init_cache(cfg, 1, S, device="meta"))
        budget = free - DEFAULT_ENGINE.activation_reserve * total
        batch = min(batch, int(budget // max(per_seq, 1)))
        if batch < 1:
            raise ValueError(f"{arch} at {shape}: one sequence's cache "
                             f"({per_seq} bytes) does not fit beside the "
                             f"weights ({free} bytes free of {total})")
    if batch != case.global_batch:
        rec["reduced"]["global_batch"] = [case.global_batch, batch]
    rec["global_batch"] = batch

    rec["flops"] = rec["flops_tc"] = count_flops(cfg, batch, S)
    rec["flops_source"] = ("FlopCounterMode over decode_step(append=True, "
                           "impl='plain') on the meta device")
    traffic = step_traffic(cfg, model, batch, S)
    rec["bytes_accessed"] = rec["bytes_tc"] = sum(traffic.values())
    rec["bytes_by_part"] = traffic
    rec["bytes_source"] = BYTES_SOURCE

    tokens = decode_tokens(cfg, batch,
                           torch.Generator().manual_seed(SEED)).to(dev)
    # lengths on the host, as the engine passes them: bounds-checked there
    lengths = torch.full((batch,), S - 1, dtype=torch.int64)
    cache = T.init_cache(cfg, batch, S, device=dev)

    steps = [0]

    def step():
        steps[0] += 1
        return model.decode_step(cache, tokens, lengths, append=True)[0]

    logits = step()
    C = (cfg.n_codebooks,) if cfg.n_codebooks else ()
    want = (batch,) + C + (T._padded_vocab(cfg),)
    if tuple(logits.shape) != want or not bool(
            torch.isfinite(logits[..., :cfg.vocab_size]).all()):
        raise AssertionError(f"{arch} at {shape}: decode logits of shape "
                             f"{tuple(logits.shape)} are not all finite")
    if dev.type == "cuda":
        for _ in range(WARMUP_STEPS):
            step()
        times = []
        for _ in range(TIMED_STEPS):
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            step()
            t1.record()
            torch.cuda.synchronize()
            times.append(t0.elapsed_time(t1))
        rec["step_ms"] = statistics.median(times)
        rec["step_ms_all"] = times
        rec["device_busy_ms"], rec["device_top_kernels"] = _device_time(
            step, PROFILED_STEPS)
        rec["card"] = _card()
        rec["device_name"] = torch.cuda.get_device_name(dev)
        rec["peak_mem_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    else:
        rec["not_measured"] = ("step_ms, device_busy_ms, card: a CPU run "
                               "measures no device")
    rec["decode_steps"] = steps[0]
    rec["ok"] = True
    _write(out_dir, rec)
    return rec


def _write(out_dir: Path, rec: dict) -> None:
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    name = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}.json"
    (out_dir / name).write_text(json.dumps(rec, indent=1, default=str))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="one-card decode dry-run")
    ap.add_argument("--arch", default="qwen2-1.5b",
                    help="architecture id, or a comma-separated list")
    ap.add_argument("--shape", default="decode_32k",
                    help="decode shape case, or a comma-separated list")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true",
                    help="reduced configs (CPU sanity)")
    ap.add_argument("--seq-len", type=int, default=None,
                    help="override the case's context length")
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    args = ap.parse_args(argv)
    for arch in args.arch.split(","):
        for shape in args.shape.split(","):
            rec = run_cell(arch, shape, Path(args.out), device=args.device,
                           reduced=args.reduced, seq_len=args.seq_len)
            status = "SKIP" if "skipped" in rec else "OK"
            print(f"[{status}] {arch} x {shape}: "
                  + json.dumps({k: rec[k] for k in (
                      "global_batch", "seq_len", "flops", "bytes_accessed",
                      "step_ms", "device_busy_ms", "skipped", "reduced")
                      if k in rec}))
    sys.stdout.flush()


if __name__ == "__main__":
    main()

"""One-card dry-run records of the port's decode, prefill and train steps:
the port of ``repro/launch/dryrun.py::run_cell`` for one NVIDIA card.

The reference lowers and compiles a sharded step for a TPU pod and reads
XLA's cost analysis. Here the cell's step (``launch/steps.py::build_cell``)
runs on the card at the shape case's size, cut to what fits, and the
record carries the same fields as far as they mean something on one card,
so the port's copy of ``core/profiler.py::profile_from_dryrun`` consumes a
decode record unchanged. Every kind writes the same fields and file name:

  * ``devices`` is 1 (it takes precedence over ``mesh``, which is a name);
  * ``global_batch`` is the case's batch, cut to what fits in 92% of the
    card's memory (``EngineModelParams.activation_reserve`` keeps 8%) from
    the free memory ``torch.cuda.mem_get_info`` reports beside the weights:
    decode by its cache bytes a sequence; prefill by the peak memory a
    one-sequence prefill takes above the weights (its (S, V) logits
    included: ~10 GB for qwen2 at 32k); train to ``TRAIN_BATCH`` sequences
    in ``n_micro`` microbatches (``TRAIN_CUT``). Every cut is listed under
    ``reduced``, with its reason under ``reduced_why``. Where the weights,
    one sequence (decode, prefill) or the optimizer state and one step
    (train) do not fit, the record says so under ``not_fitting`` (``ok``
    false);
  * ``flops`` (= ``flops_tc``) is the step's operation count from
    ``torch.utils.flop_counter.FlopCounterMode`` over the plain path
    (``impl="plain"``), which does the kernels' math in aten ops, on the
    meta device; the counter cannot see the kernels, which are ctypes
    calls. The plain attention computes every (query, key) block, masked
    ones included, so its count does not depend on the block sizes; it is
    taken with one block a call (``_whole_blocks``), which counts the same
    operations with far fewer meta ops;
  * ``bytes_accessed`` (= ``bytes_tc``) is a model of the step's traffic,
    stated in ``bytes_source`` (decode ``BYTES_SOURCE``, prefill
    ``PREFILL_BYTES_SOURCE``, train ``TRAIN_BYTES_SOURCE``);
  * measured on the card: ``step_ms`` (CUDA events, the median of the
    timed steps on the kernel path, after a warm-up), ``device_busy_ms``
    (torch.profiler), ``peak_mem_gb`` and ``card`` (``nvidia-smi``'s name
    and power limit). A CPU run records none of these and says so.

The decode record is of the append-mode step (the engine's: variant
``cacheappend``). The train record states that train steps ran
(``train_steps``), with which optimizer, ``n_micro`` and cut, and their
losses. Codebook configs decode tokens (batch, C) into logits (batch, C,
V); a vision config's cross layers read a cache of its n_vision_tokens,
and its prefill and train batches carry vision embeddings. Run from the
repository root, with ``PYTHONPATH=src``, as

    python -m repro_torch.launch.dryrun --arch all --shape all

(on the card), or on the CPU at a reduced size with ``--device cpu
--reduced --seq-len 256``. ``--cards 4 --mesh 1x4`` (or ``2x2``) spawns one
rank a card and records on that mesh (NCCL; gloo ranks on the CPU with
``--device cpu``); ``--layers`` cuts the depth.

On a mesh (``run_cell(..., mesh=)``, every rank of a ``DeviceMesh`` calling
it with the same arguments) the prefill and decode steps run sharded under
``steps.rules_for``'s rules, and the record follows the reference's
per-device convention, which ``core/profiler.py::record_devices`` scales
back: ``devices`` is the mesh's size and ``mesh`` its name (``h100_1x4``);
``flops`` are one card's (FlopCounterMode over rank 0's local plain step on
the meta device, where a collective only counts) and ``bytes_accessed``
the busiest card's (``BYTES_SOURCE`` over its shards: its weights, its
cache rows and kv heads, its logits); ``collectives`` are the helpers'
counts over one step (``sharding.collectives()``), held to
``Transformer.step_collectives``; ``step_ms`` is the median over the timed
steps of the slowest card's CUDA-event time, every step started after a
barrier; ``device_busy_ms``, ``nccl_ms``, ``peak_mem_gb`` are listed by
rank (``*_by_rank``). The batch is cut by each card's free memory and its
bytes a sequence, the smallest over the cards. Rank 0 writes the record,
named by arch, shape and mesh, beside the one-card ones.

A train record on a mesh (``train_4k``, the sharded step of
``steps.build_train_step``): whether the weights, gradients and ZeRO-1
moments fit is reckoned per card from the specs before anything is built
(``not_fitting`` if not, as gemma2-27b on four cards); the batch is cut as
the one-card record's, to ``TRAIN_ROWS`` rows a card a microbatch, and
further where the peak memory a step at one row a card took says fewer
fit (``MESH_TRAIN_CUT``), and for a MoE config to the rows whose
microbatch the routing kernel takes in one block (``ROUTE_CUT``: Tb * k
<= 65,536; granite at 4096 tokens routes 2 rows a microbatch, one a card
on mesh 2x2; a bigger microbatch raises); ``flops`` are one card's (one microbatch's
``value_and_grad`` of rank 0's shards on the meta device, times n_micro);
``bytes_accessed`` the busiest card's ``TRAIN_BYTES_SOURCE`` over its
shards; ``collectives`` one step's, held to
``steps.train_step_collectives``; step, compute, NCCL and peak memory by
rank as for the other kinds.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import statistics
import subprocess
import sys
from pathlib import Path
from typing import Optional

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import get_config, list_archs
from repro_torch.configs.shapes import SHAPES, applicable, get_shape
from repro_torch.core.engine_model import DEFAULT_ENGINE
from repro_torch.distributed import sharding as SH
from repro_torch.kernels import moe_gating as MG
from repro_torch.kernels import ops, ref
from repro_torch.launch import steps as ST
from repro_torch.models import transformer as T

DEFAULT_OUT = Path("results/dryrun_torch")
MESH = "single_card"
WARMUP_STEPS, TIMED_STEPS, PROFILED_STEPS = 3, 7, 5        # decode
PREFILL_TIMED, TRAIN_TIMED = 3, 3     # each after one warm-up step
SEED = 0            # of the random weights and inputs
TRAIN_BATCH = 8     # train_4k's global batch on one card
TRAIN_CUT = ("global batch 256 cut to 8 sequences (n_micro microbatches): "
             "256 sequences at seq 4096 are 32 such steps of one card")
TRAIN_ROWS = TRAIN_BATCH // 4     # rows a card a microbatch, as one card's
MESH_TRAIN_CUT = (
    "global batch 256 cut to n_micro x data x rows sequences: at most "
    f"{TRAIN_ROWS} rows a card a microbatch (the one-card record's), fewer "
    "where the peak memory of a step at one row a card leaves room for "
    "fewer (85% of the card's budget)")
ROWS_MARGIN = 0.85
ROUTE_CUT = ("a MoE microbatch's tokens times top_k within the routing "
             "kernel's block of 65,536 entries (moe_gating.plan_route)")
DECODE_VARIANT = "cacheappend"        # the engine's append-mode step

BYTES_SOURCE = (
    "model of the append-mode decode step: every weight as stored, read "
    "once; per sequence, each attention layer's K/V read at the context "
    "length (cached tokens and the new one; a local layer the window; a "
    "cross layer its vision tokens, none written) and one token written; "
    "each recurrent state read and written; the logits written, one row a "
    "codebook")
PREFILL_BYTES_SOURCE = (
    "model of the prefill step: every weight as stored, read once; per "
    "sequence, each attention layer's K/V written for its S tokens (a cross "
    "layer's for its vision tokens), each recurrent state written, and the "
    "logits written (S rows, one a codebook); the tokens read")
TRAIN_BYTES_SOURCE = (
    "lower-bound model of the train step: every weight as stored, read once "
    "and written once by the update; every gradient written once (fp32, or "
    "grad_dtype); the optimizer state read and written once; the logits of "
    "every microbatch written once; the batch read")


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size()
               for t in torch.utils._pytree.tree_leaves(tree))


def _weight_bytes(cfg, mesh=None, rules=None) -> int:
    """The weights' bytes (on a mesh, one card's)."""
    return _nbytes(list(T.Transformer(cfg, device="meta", mesh=mesh,
                                      rules=rules).parameters()))


def _elem(cfg) -> int:
    return torch.finfo(getattr(torch, cfg.dtype)).bits // 8


def _logit_bytes(cfg, rows: int) -> int:
    return rows * max(cfg.n_codebooks, 1) * T._padded_vocab(cfg) * _elem(cfg)


def step_traffic(cfg, model: T.Transformer, batch: int,
                 seq_len: int, cache=None) -> dict:
    """The bytes of one append-mode decode step of ``batch`` sequences at
    context ``seq_len`` (``BYTES_SOURCE``), by part. On a mesh (``cache``
    this card's ``ShardedCache``) the busiest card's: its weights, its
    batch rows and kv heads, at most its rows of the context (a cross
    layer's: its rows of the vision tokens), its logits."""
    kvh, rows, vocab = cfg.n_kv_heads, seq_len, 1
    cross_rows = max(cfg.n_vision_tokens, 1)
    if cache is not None:
        lay = cache.layout
        axes = ("layers",) + T.L.CACHE_AXES
        _, (_, batch), (_, rows), (_, kvh), _ = lay.ranges(
            axes, cache.leaf_shape(cfg))
        _, _, (_, cross_rows), _, _ = lay.ranges(
            axes, cache.leaf_shape(cfg, cross=True))
        vocab = lay.size(model._unembed_vocab[0])
    kv_tok = 2 * kvh * cfg.head_dim * _elem(cfg)                # K and V
    kv = 0
    for spec in cfg.layer_specs():
        if spec.kind == "attn" and spec.attn_type == "cross":
            kv += cross_rows * kv_tok                       # read only
        elif spec.kind == "attn":
            read = seq_len
            if spec.attn_type == "local" and cfg.sliding_window:
                read = min(seq_len, cfg.sliding_window)
            kv += (min(read, rows) + 1) * kv_tok
    return {"weights": _nbytes(list(model.parameters())),
            "kv": batch * kv,
            "states": batch * 2 * _state_bytes(cfg, cache and cache.layout),
            "logits": _logit_bytes(cfg, batch) // vocab}


def _state_bytes(cfg, layout: Optional[SH.Layout] = None) -> int:
    """One sequence's recurrent states (Mamba and RWKV layers); under
    ``layout`` one card's (its channels or heads)."""
    one = T.init_cache(cfg, 1, 1, device="meta", mesh=layout)
    return sum(_nbytes(one[f"g{gi}"][li])
               for gi, (period, _) in enumerate(cfg.groups)
               for li, spec in enumerate(period) if spec.kind != "attn")


def prefill_traffic(cfg, model: T.Transformer, batch: int,
                    seq_len: int) -> dict:
    """The bytes of one prefill of ``batch`` sequences of ``seq_len``
    tokens (``PREFILL_BYTES_SOURCE``), by part; on a mesh one card's (its
    batch rows, ``wk``'s kv heads, its vocab columns)."""
    kvh, vocab = cfg.n_kv_heads, 1
    if model.tp is not None:
        (_, batch), _ = model.layout.ranges(("batch", "seq"),
                                            (batch, seq_len))
        kvh, vocab = model.tp.kvl, model.layout.size(
            model._unembed_vocab[0])
    kv_tok = 2 * kvh * cfg.head_dim * _elem(cfg)
    kv = sum((max(cfg.n_vision_tokens, 1) if spec.attn_type == "cross"
              else seq_len) * kv_tok
             for spec in cfg.layer_specs() if spec.kind == "attn")
    tokens = batch * seq_len * max(cfg.n_codebooks, 1) * 4
    return {"weights": _nbytes(list(model.parameters())),
            "kv": batch * kv,
            "states": batch * _state_bytes(cfg, model.layout),
            "logits": _logit_bytes(cfg, batch * seq_len) // vocab,
            "tokens": tokens}


def train_traffic(cfg, model: T.Transformer, opt_state: dict, batch: int,
                  seq_len: int, n_micro: int, grad_dtype) -> dict:
    """The bytes of one train step (``TRAIN_BYTES_SOURCE``), by part; on a
    mesh one card's (its shards, its rows of each microbatch and its vocab
    columns of their logits)."""
    weights = _nbytes(list(model.parameters()))
    grad_elem = torch.finfo(grad_dtype).bits // 8
    n_params = sum(p.numel() for p in model.parameters())
    micro = batch // n_micro if batch % n_micro == 0 else batch
    rows, vocab = micro, 1
    if model.layout is not None:
        (_, rows), = model.layout.ranges(("batch",), (micro,))
        vocab = model.layout.size(model._unembed_vocab[0])
    return {"weights": 2 * weights, "grads": n_params * grad_elem,
            "optimizer": 2 * _nbytes(opt_state),
            "logits": _logit_bytes(cfg, rows * seq_len) * (batch // micro)
            // vocab,
            "tokens": 2 * rows * (batch // micro) * seq_len
            * max(cfg.n_codebooks, 1) * 4}


def train_state_bytes(cfg, variant: str, mesh=None, rules=None) -> dict:
    """The bytes a card holds for training before any activation, from the
    specs on the meta device: its weights, its gradients (fp32 or
    bf16grad's bf16) and its optimizer state (on a mesh its ZeRO-1
    slices)."""
    grad_dtype = (torch.bfloat16 if "bf16grad" in ST.variant_tokens(variant)
                  else torch.float32)
    model = T.Transformer(cfg, device="meta", mesh=mesh, rules=rules)
    n = sum(p.numel() for p in model.parameters())
    return {"weights": _nbytes(list(model.parameters())),
            "grads": n * grad_dtype.itemsize,
            "optimizer": _nbytes(ST.init_opt_state(model))}


def decode_tokens(cfg, batch: int, generator=None) -> torch.Tensor:
    """Random decode tokens on the CPU: (batch,), or (batch, C) with
    codebooks."""
    shape = (batch, cfg.n_codebooks) if cfg.n_codebooks else (batch,)
    return torch.randint(0, cfg.vocab_size, shape, generator=generator)


@contextlib.contextmanager
def _whole_blocks():
    """The plain attention paths (``ref.blockwise_attention`` and the
    trainable ``ref.blockwise_fwd_lse`` / ``ref.flash_attention_bwd``)
    compute every (query block, key block) pair, masked ones included, so
    the operations they count do not depend on the block sizes. On the
    meta device one block a call counts the same operations: a 32k prefill
    is ~2000 blocks a layer otherwise, each a dozen meta ops."""
    defaults = ref.blockwise_attention.__kwdefaults__
    saved = dict(defaults), (ops.TRAIN_Q_BLOCK, ops.TRAIN_KV_BLOCK)
    big = 1 << 30
    defaults.update(q_block=big, kv_block=big)
    ops.TRAIN_Q_BLOCK = ops.TRAIN_KV_BLOCK = big
    try:
        yield
    finally:
        defaults.clear()
        defaults.update(saved[0])
        ops.TRAIN_Q_BLOCK, ops.TRAIN_KV_BLOCK = saved[1]


def _n_micro(variant: str, batch: int) -> int:
    """The train step's microbatches (``steps.value_and_grad``'s rule)."""
    n = 8 if "micro8" in ST.variant_tokens(variant) else 4
    return n if batch % n == 0 and batch >= n else 1


def count_flops(cfg, case, variant: str = "baseline", mesh=None,
                rules=None) -> int:
    """The operations of ``case``'s step (its batch and seq_len as given)
    on the plain path (FlopCounterMode), on the meta device: nothing is
    allocated or run. A decode step runs at context seq_len - 1 (a cross
    layer's cache holds its n_vision_tokens, so its read counts those). A
    train step is its microbatches' ``value_and_grad`` (the clip and the
    optimizer update are elementwise: no operations the counter counts),
    so one microbatch is counted, n_micro times: the trainable attention
    skips the blocks its mask removes, so it is counted at its own blocks,
    and a full step takes minutes of meta ops. With ``mesh`` (a
    ``sharding.Layout`` of one rank) the rank's local step under ``rules``
    (the cell's, whatever its batch was cut to), its collectives only
    counted."""
    if case.kind == "train":
        nm = _n_micro(variant, case.global_batch)
        micro = dataclasses.replace(case,
                                    global_batch=case.global_batch // nm)
        _, kwargs, *_ = ST.build_cell(cfg, micro, "meta", variant, mesh=mesh,
                                      rules=rules)
        with FlopCounterMode(display=False) as counter:
            ST.value_and_grad(cfg, kwargs["params"], kwargs["batch"],
                              impl="plain")
        return nm * int(counter.get_total_flops())
    fn, kwargs, *_ = ST.build_cell(cfg, case, "meta", variant, impl="plain",
                                   mesh=mesh, rules=rules)
    if case.kind == "decode":
        kwargs["tokens"] = decode_tokens(cfg, case.global_batch).to("meta")
        kwargs["lengths"] = torch.full((case.global_batch,),
                                       case.seq_len - 1, dtype=torch.int64,
                                       device="meta")
    with _whole_blocks(), FlopCounterMode(display=False) as counter:
        fn(*kwargs.values())
    return int(counter.get_total_flops())


def materialize(cfg, case, kwargs: dict, model: T.Transformer, dev,
                generator: torch.Generator) -> list:
    """The inputs of ``case``'s cell (``kwargs`` from ``build_cell``) on
    ``dev`` in ``fn``'s order: "params" is ``model``; the optimizer state
    ``steps.init_opt_state`` of it; tokens and labels random ints below the
    vocabulary; vision embeddings N(0, 1); a decode cache zeros at the
    case's batch and seq_len, its lengths seq_len - 1 on the host (as the
    engine passes them: bounds-checked there), in the abstract dtypes."""
    def ints(t):
        return torch.randint(0, cfg.vocab_size, t.shape, generator=generator,
                             dtype=torch.int64).to(dev, t.dtype)

    out = []
    for name, v in kwargs.items():
        if name == "params":
            out.append(model)
        elif name == "opt_state":
            out.append(ST.init_opt_state(model))
        elif name == "batch":
            out.append({k: (torch.randn(t.shape, generator=generator)
                            .to(dev, t.dtype) if t.is_floating_point()
                            else ints(t)) for k, t in v.items()})
        elif name == "cache":
            out.append(T.init_cache(cfg, case.global_batch, case.seq_len,
                                    device=dev, mesh=model.layout))
        elif name == "tokens":
            out.append(ints(v))
        else:                                           # lengths
            out.append(torch.full(v.shape, case.seq_len - 1, dtype=v.dtype))
    return out


def _card(dev=None) -> str:
    """``nvidia-smi``'s name and power limit: of every card, or of ``dev``
    (found by its UUID) where torch reports one."""
    query = ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"]
    uuid = getattr(torch.cuda.get_device_properties(dev), "uuid", None) \
        if dev is not None else None
    if uuid is not None:
        one = subprocess.run(query + [f"--id=GPU-{uuid}"],
                             capture_output=True, text=True)
        if one.returncode == 0 and one.stdout.strip():
            return one.stdout.strip()
    return subprocess.run(query, capture_output=True, text=True,
                          check=True).stdout.strip()


def _device_time(step, n: int, host_activity: bool = True):
    """(device ms per step, the five kernels that take most of it as
    [name, ms per step, launches per step], the NCCL kernels' ms per step)
    under torch.profiler, every CUDA kernel's self time; a session that
    saw no device time is retried twice. ``host_activity`` False traces
    the device only (a train step's ~100k host ops would take minutes to
    read)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA]
    if host_activity:
        acts.insert(0, ProfilerActivity.CPU)
    for _ in range(3):
        with profile(activities=acts) as prof:
            for _ in range(n):
                step()
            torch.cuda.synchronize()
        kernels = sorted((e for e in prof.key_averages()
                          if e.device_type == DeviceType.CUDA
                          and e.self_device_time_total > 0),
                         key=lambda e: -e.self_device_time_total)
        if kernels:
            busy = sum(e.self_device_time_total for e in kernels) / 1e3 / n
            nccl = sum(e.self_device_time_total for e in kernels
                       if "nccl" in e.key.lower()) / 1e3 / n
            return busy, [[e.key[:60], e.self_device_time_total / 1e3 / n,
                           e.count / n] for e in kernels[:5]], nccl
    return ("not measured: three profiler sessions saw no device time", [],
            "not measured")


def _budget(dev) -> tuple[int, int, float]:
    """(free, total, the bytes a cell may take: free less the reserve)."""
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info(dev)
    return free, total, free - DEFAULT_ENGINE.activation_reserve * total


def _cut(rec: dict, what: str, full, now, why: str) -> None:
    if full != now:
        rec["reduced"][what] = [full, now]
        rec["reduced_why"][what] = why


def mesh_name(mesh) -> str:
    """A mesh's record name: ``h100_1x4`` for (data 1, model 4) on H100s,
    else the device type's (``cpu_1x4``)."""
    sizes = SH.axis_sizes(mesh)
    kind = mesh.device_type
    if kind == "cuda" and "H100" in torch.cuda.get_device_name():
        kind = "h100"
    return f"{kind}_{sizes['data']}x{sizes['model']}"


class _Ranks:
    """The collectives a record takes over the ranks of its mesh (nothing
    on one card): the smallest budget, every rank's measurements."""

    def __init__(self, mesh):
        self.mesh = mesh

    @property
    def rank(self) -> int:
        if self.mesh is None:
            return 0
        import torch.distributed as dist
        return dist.get_rank()

    def min(self, x: int) -> int:
        return min(self.all(x))

    def all(self, obj) -> list:
        if self.mesh is None:
            return [obj]
        import torch.distributed as dist
        out = [None] * dist.get_world_size()
        dist.all_gather_object(out, obj)
        return out

    def barrier(self) -> None:
        if self.mesh is not None:
            import torch.distributed as dist
            dist.barrier()


def cut_depth(cfg, n: int):
    """The first ``n`` layers of a config, group by group: whole periods
    of a group, then the first layers of one more period (kimi-k2's first
    2: its dense layer 0 and the first of its 60 MoE layers; Jamba's first
    25: three periods of 8 and a Mamba + dense layer)."""
    groups, left = [], n
    for period, rep in cfg.groups:
        k = min(left, rep * len(period))
        if k == 0:
            break
        whole, part = divmod(k, len(period))
        if whole:
            groups.append((period, whole))
        if part:
            groups.append((period[:part], 1))
        left -= k
    return dataclasses.replace(cfg, groups=tuple(groups))


def run_cell(arch: str, shape: str, out_dir: Path = DEFAULT_OUT, *,
             device="cuda", reduced: bool = False,
             seq_len: Optional[int] = None,
             variant: str = "baseline", mesh=None,
             layers: Optional[int] = None) -> dict:
    """Run ``arch``'s step at ``shape`` on one device and write its record.
    ``seq_len`` overrides the case's length (a CPU run's cut); ``layers``
    cuts the depth to the first ``layers`` layers (``cut_depth``);
    ``variant`` as ``steps.apply_variant_config`` (a decode record adds
    ``cacheappend``). ``mesh``: run it sharded, every rank of the
    ``DeviceMesh`` calling with the same arguments (module docstring)."""
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    depth = cfg.n_layers
    if layers is not None:
        cfg = cut_depth(cfg, layers)
    case = get_shape(shape)
    if case.kind == "decode":
        variant = "+".join(sorted(ST.variant_tokens(variant)
                                  | {DECODE_VARIANT}))
    # sharding variants raise on one card
    cfg = ST.apply_variant_config(cfg, variant, mesh)
    dev = T.resolve_device(device)
    S = case.seq_len if seq_len is None else seq_len
    ranks = _Ranks(mesh)
    rules = None if mesh is None else ST.rules_for(cfg, case, mesh, variant)
    rec = {
        "arch": arch, "shape": shape,
        "mesh": MESH if mesh is None else mesh_name(mesh),
        "variant": variant,
        "kind": case.kind, "seq_len": S, "global_batch": case.global_batch,
        "n_params": cfg.param_count(),
        "n_params_active": cfg.active_param_count(),
        "ok": False, "devices": 1 if mesh is None else mesh.size(),
        "device": str(dev),
        "config": cfg.name, "reduced": {}, "reduced_why": {},
    }
    if mesh is not None:
        rec["rules"] = {k: list(v) for k, v in rules.rules.items() if v}
    if case.kind == "decode":
        rec["decode_mode"] = "append"
    _cut(rec, "seq_len", case.seq_len, S, "seq_len override (--seq-len)")
    _cut(rec, "n_layers", depth, cfg.n_layers,
         "depth cut to the first layers (run_cell's layers)")
    ok, reason = applicable(cfg, case)
    if not ok:
        rec["skipped"] = reason
        _write(out_dir, rec, ranks)
        return rec
    weights = _weight_bytes(cfg, mesh, rules)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)    # peak_mem_gb: this cell's
        free, total, budget = _budget(dev)
        if ranks.min(int(budget - weights)) < 0:
            return _not_fitting(out_dir, rec, (
                f"the weights ({weights} bytes a card) do not fit "
                f"({free} bytes free of {total}, 8% kept in reserve)"),
                ranks)
        if case.kind == "train":
            state = train_state_bytes(
                cfg, variant, None if mesh is None
                else _flop_layout_of(mesh, rules), rules)
            rec["state_bytes_a_card"] = state
            if ranks.min(int(budget - sum(state.values()))) < 0:
                return _not_fitting(out_dir, rec, (
                    f"the weights, gradients and optimizer state "
                    f"({sum(state.values())} bytes a card: {state}) do not "
                    f"fit ({free} bytes free of {total}, 8% kept in "
                    "reserve)"), ranks)
    model = T.Transformer(cfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(SEED), mesh=mesh, rules=rules)
    gen = torch.Generator().manual_seed(SEED)
    if case.kind == "decode":
        return _decode(rec, cfg, case, S, model, dev, gen, variant, out_dir,
                       ranks)
    if case.kind == "prefill":
        return _prefill(rec, cfg, case, S, model, dev, gen, variant, out_dir,
                        ranks)
    return _train(rec, cfg, case, S, model, dev, gen, variant, out_dir,
                  ranks)


def _not_fitting(out_dir: Path, rec: dict, why: str,
                 ranks: Optional[_Ranks] = None) -> dict:
    rec["not_fitting"] = why
    _write(out_dir, rec, ranks)
    return rec


def _cell(cfg, case, variant: str, model, dev, gen):
    """(fn, its inputs on ``dev``) of ``case``'s cell, ``model`` its
    params (a train cell, or one of a sharding variant, on a mesh built on
    the model's layout: those variants run only there)."""
    sharding = ST.variant_tokens(variant) & set(ST.SHARDING_VARIANTS)
    lay = model.layout if case.kind == "train" or sharding else None
    fn, kwargs, *_ = ST.build_cell(cfg, case, "meta", variant, mesh=lay,
                                   rules=lay and lay.rules)
    return fn, materialize(cfg, case, kwargs, model, dev, gen)


def _flop_layout(model: T.Transformer) -> Optional[SH.Layout]:
    """Rank 0's layout without a process group: FlopCounterMode counts one
    card's step on the meta device (every card's is the same size)."""
    if model.layout is None:
        return None
    return _flop_layout_of(model.layout, model.layout.rules)


def _flop_layout_of(mesh, rules) -> SH.Layout:
    sizes = SH.axis_sizes(mesh)
    return SH.Layout(sizes, {ax: 0 for ax in sizes}, rules)


def _measure(rec: dict, dev, step, timed: int, warmup: int, profiled: int,
             host_activity: bool = True,
             ranks: Optional[_Ranks] = None) -> None:
    """step_ms (the median of ``timed`` CUDA-event steps after ``warmup``),
    device_busy_ms over ``profiled`` steps, the peak memory and the card;
    on the CPU, says that nothing was measured. On a mesh every step starts
    after a barrier, step_ms is the median of the slowest card's times,
    and each rank's measurements are listed by rank."""
    if dev.type != "cuda":
        rec["not_measured"] = ("step_ms, device_busy_ms, card: a CPU run "
                               "measures no device")
        return
    ranks = ranks or _Ranks(None)
    for _ in range(warmup):
        step()
    times = []
    for _ in range(timed):
        ranks.barrier()
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        step()
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1))
    ranks.barrier()        # the cards enter their profiled steps together
    busy, top, nccl = _device_time(step, profiled, host_activity)
    mine = {"times": times, "busy": busy, "nccl": nccl,
            "peak": torch.cuda.max_memory_allocated(dev) / 1e9,
            "card": _card(dev if ranks.mesh is not None else None)}
    every = ranks.all(mine)
    slowest = [max(r["times"][i] for r in every) for i in range(timed)]
    rec["step_ms"] = statistics.median(slowest)
    rec["step_ms_all"] = slowest
    rec["device_top_kernels"] = top
    rec["device_name"] = torch.cuda.get_device_name(dev)
    if ranks.mesh is None:
        rec["device_busy_ms"], rec["card"] = busy, mine["card"]
        rec["peak_mem_gb"] = mine["peak"]
        return
    rec["step_ms_by_rank"] = [statistics.median(r["times"]) for r in every]
    for key, name in (("busy", "device_busy_ms"), ("nccl", "nccl_ms"),
                      ("peak", "peak_mem_gb"), ("card", "card")):
        rec[f"{name}_by_rank"] = [r[key] for r in every]
    # NCCL kernels spin while they wait for the other cards: busy less NCCL
    # is the card's own work
    rec["compute_ms_by_rank"] = [
        r["busy"] - r["nccl"] if isinstance(r["busy"], float) else r["busy"]
        for r in every]
    nums = [r["busy"] for r in every if isinstance(r["busy"], float)]
    rec["device_busy_ms"] = max(nums) if nums else busy
    rec["peak_mem_gb"] = max(r["peak"] for r in every)
    rec["card"] = mine["card"]


def _finite(arch, shape, logits, want, vocab: int) -> None:
    """Raise unless ``logits`` has shape ``want`` and its first ``vocab``
    columns are finite, checked 4096 rows at a time: a 32k prefill's
    logits are tens of GB, and a mask of them would not fit beside them."""
    rows = logits.reshape(-1, logits.shape[-1]) \
        if tuple(logits.shape) == want else None
    if rows is None or not all(bool(torch.isfinite(c[:, :vocab]).all())
                               for c in rows.split(4096)):
        raise AssertionError(f"{arch} at {shape}: logits of shape "
                             f"{tuple(logits.shape)} are not all finite")


def _decode(rec, cfg, case, S, model, dev, gen, variant, out_dir,
            ranks: _Ranks) -> dict:
    batch = case.global_batch
    if dev.type == "cuda":
        free, total, budget = _budget(dev)
        per_seq = _nbytes(T.init_cache(cfg, 1, S, device="meta",
                                       mesh=model.layout))
        batch = ranks.min(min(batch, int(budget // max(per_seq, 1))))
        if batch < 1:
            return _not_fitting(out_dir, rec, (
                f"one sequence's cache ({per_seq} bytes a card) does not "
                f"fit beside the weights ({free} bytes free of {total})"),
                ranks)
    _cut(rec, "global_batch", case.global_batch, batch,
         "the largest batch whose decode cache fits beside the weights")
    rec["global_batch"] = batch
    cut_case = dataclasses.replace(case, global_batch=batch, seq_len=S)
    layout = _flop_layout(model)
    rec["flops"] = rec["flops_tc"] = count_flops(
        cfg, cut_case, variant, mesh=layout, rules=model.layout and
        model.layout.rules)
    rec["flops_source"] = ("FlopCounterMode over decode_step(append=True, "
                           "impl='plain') on the meta device"
                           + ("" if layout is None else ", one card's"))

    fn, args = _cell(cfg, cut_case, variant, model, dev, gen)
    cache = args[1] if model.layout is not None else None
    traffic = step_traffic(cfg, model, batch, S, cache)
    rec["bytes_accessed"] = rec["bytes_tc"] = sum(traffic.values())
    rec["bytes_by_part"] = traffic
    rec["bytes_source"] = BYTES_SOURCE + (
        "" if cache is None else "; the busiest card's")
    steps = [0]

    def step():
        steps[0] += 1
        return fn(*args)[0]

    C = (cfg.n_codebooks,) if cfg.n_codebooks else ()
    want = (batch,) + C + (T._padded_vocab(cfg),)
    if cache is not None:
        (_, bl), = cache.layout.ranges(("batch",), (batch,))
        want = (bl,) + C + (model._unembed_vocab[2],)
    SH.reset_collectives()
    _finite(rec["arch"], rec["shape"], step(), want,
            cfg.vocab_size - (0 if cache is None else
                              model._unembed_vocab[1]))
    if cache is not None:
        rec["cache_spec"] = list(cache.spec(cfg))
        rec["collectives"] = SH.collectives()
        rec["collectives_formula"] = model.step_collectives(cache)
        rec["collectives_source"] = (
            "sharding.collectives() over one decode step; the formula "
            "Transformer.step_collectives")
    _measure(rec, dev, step, TIMED_STEPS, WARMUP_STEPS, PROFILED_STEPS,
             ranks=ranks)
    rec["decode_steps"] = steps[0]
    rec["ok"] = True
    _write(out_dir, rec, ranks)
    return rec


def _prefill(rec, cfg, case, S, model, dev, gen, variant, out_dir,
             ranks: _Ranks) -> dict:
    batch = case.global_batch
    steps = [0]
    if dev.type == "cuda":
        # one sequence's peak above the weights: it sets the batch cut
        fn, args = _cell(cfg, dataclasses.replace(
            case, global_batch=1, seq_len=S), variant, model, dev, gen)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        try:
            steps[0] += 1
            fn(*args)
            torch.cuda.synchronize()
        except torch.cuda.OutOfMemoryError as e:
            del args
            return _not_fitting(out_dir, rec, (
                f"a one-sequence prefill at {S} tokens does not fit beside "
                f"the weights: {str(e).splitlines()[0]}"), ranks)
        per_seq = torch.cuda.max_memory_allocated(dev) - base
        del args
        free, total, budget = _budget(dev)
        batch = ranks.min(min(batch, max(1, int(budget // max(per_seq, 1)))))
        rec["bytes_one_sequence_peak"] = per_seq
    _cut(rec, "global_batch", case.global_batch, batch,
         "the largest batch whose prefill (its (B, S, V) logits and cache "
         "included) fits beside the weights, at the peak memory one "
         "sequence's prefill took")
    rec["global_batch"] = batch
    cut_case = dataclasses.replace(case, global_batch=batch, seq_len=S)
    layout = _flop_layout(model)
    rec["flops"] = rec["flops_tc"] = count_flops(
        cfg, cut_case, variant, mesh=layout, rules=model.layout and
        model.layout.rules)
    rec["flops_source"] = ("FlopCounterMode over prefill(impl='plain') on "
                           "the meta device"
                           + ("" if layout is None else ", one card's"))
    traffic = prefill_traffic(cfg, model, batch, S)
    rec["bytes_accessed"] = rec["bytes_tc"] = sum(traffic.values())
    rec["bytes_by_part"] = traffic
    rec["bytes_source"] = PREFILL_BYTES_SOURCE

    fn, args = _cell(cfg, cut_case, variant, model, dev, gen)

    def step():
        steps[0] += 1
        return fn(*args)

    C = (cfg.n_codebooks,) if cfg.n_codebooks else ()
    want, vocab = (batch, S) + C + (T._padded_vocab(cfg),), cfg.vocab_size
    if model.tp is not None:
        (_, bl), _ = model.layout.ranges(("batch", "seq"), (batch, S))
        want = (bl, S) + C + (model._unembed_vocab[2],)
        vocab -= model._unembed_vocab[1]
    SH.reset_collectives()
    out = step()
    _finite(rec["arch"], rec["shape"], out[0], want, vocab)
    del out
    if model.tp is not None:
        rec["collectives"] = SH.collectives()
        rec["collectives_formula"] = model.step_collectives(batch=batch,
                                                            seq=S)
        rec["collectives_source"] = (
            "sharding.collectives() over one prefill step; the formula "
            "Transformer.step_collectives")
    _measure(rec, dev, step, PREFILL_TIMED, 0, 1, ranks=ranks)
    rec["prefill_steps"] = steps[0]
    rec["ok"] = True
    _write(out_dir, rec, ranks)
    return rec


def _train(rec, cfg, case, S, model, dev, gen, variant, out_dir,
           ranks: _Ranks) -> dict:
    grad_dtype = (torch.bfloat16 if "bf16grad" in ST.variant_tokens(variant)
                  else torch.float32)
    layout = model.layout
    if layout is None:
        batch = min(case.global_batch, TRAIN_BATCH)
        _cut(rec, "global_batch", case.global_batch, batch, TRAIN_CUT)
    else:      # n_micro chunks of rows a card over the data axes
        dp = layout.size(layout.spec(("batch",), (case.global_batch,))[0])
        per_row = _n_micro(variant, TRAIN_BATCH) * dp
        rows, why = TRAIN_ROWS, MESH_TRAIN_CUT
        if cfg.n_experts:
            routed = route_rows(cfg, S) // dp
            if routed < 1:
                return _not_fitting(out_dir, rec, (
                    f"one row a card of {S} tokens is more than {ROUTE_CUT}"),
                    ranks)
            if routed < rows:
                rows, why = routed, f"{MESH_TRAIN_CUT}; {ROUTE_CUT}"
        if dev.type == "cuda":
            fit = _rows_that_fit(cfg, case, S, model, dev, gen, variant,
                                 per_row, grad_dtype, rec, ranks)
            if fit < 1:
                return _not_fitting(out_dir, rec, (
                    "a train step at one row a card a microbatch leaves no "
                    f"room ({rec['bytes_one_row_peak']} bytes above the "
                    "state)"), ranks)
            rows = min(rows, fit)
        batch = min(case.global_batch, per_row * rows)
        _cut(rec, "global_batch", case.global_batch, batch, why)
    rec["global_batch"] = batch
    n_micro = _n_micro(variant, batch)
    rec.update(optimizer=cfg.optimizer, n_micro=n_micro,
               grad_dtype=str(grad_dtype).split(".")[-1], remat=cfg.remat)
    cut_case = dataclasses.replace(case, global_batch=batch, seq_len=S)
    flop_layout = _flop_layout(model)
    rec["flops"] = rec["flops_tc"] = count_flops(
        cfg, cut_case, variant, mesh=flop_layout,
        rules=layout and layout.rules)
    rec["flops_source"] = ("FlopCounterMode over one microbatch's loss and "
                           "gradients (forward, remat recompute, backward; "
                           "impl='plain') on the meta device, times "
                           "n_micro" + ("" if layout is None
                                        else ", one card's"))
    fn, args = _cell(cfg, cut_case, variant, model, dev, gen)
    traffic = train_traffic(cfg, model, args[1], batch, S, n_micro,
                            grad_dtype)
    rec["bytes_accessed"] = rec["bytes_tc"] = sum(traffic.values())
    rec["bytes_by_part"] = traffic
    rec["bytes_source"] = TRAIN_BYTES_SOURCE + (
        "" if layout is None else "; one card's")
    losses, ces = [], []

    def step():
        args[1], metrics = fn(*args)
        losses.append(metrics["loss"])
        ces.append(metrics["ce"])

    SH.reset_collectives()
    try:
        step()
    except torch.cuda.OutOfMemoryError as e:
        return _not_fitting(out_dir, rec, (
            f"a train step of {batch} sequences of {S} tokens does not fit "
            f"beside the weights and the optimizer state: "
            f"{str(e).splitlines()[0]}"), ranks)
    if layout is not None:
        rec["collectives"] = SH.collectives()
        rec["collectives_formula"] = ST.train_step_collectives(
            model, batch, n_micro, S)
        rec["collectives_source"] = (
            "sharding.collectives() over one train step; the formula "
            "steps.train_step_collectives")
    _measure(rec, dev, step, TRAIN_TIMED, 0, 1, host_activity=False,
             ranks=ranks)
    rec["losses"] = [float(x) for x in losses]
    rec["first_ce"] = float(ces[0])
    rec["train_steps"] = len(losses)
    if not all(torch.isfinite(torch.tensor(rec["losses"]))):
        raise AssertionError(f"{rec['arch']} at {rec['shape']}: losses "
                             f"{rec['losses']} are not all finite")
    if layout is not None and any(r != rec["losses"]
                                  for r in ranks.all(rec["losses"])):
        raise AssertionError(f"{rec['arch']} at {rec['shape']}: losses "
                             "differ between cards")
    rec["ok"] = True
    _write(out_dir, rec, ranks)
    return rec


def route_rows(cfg, S: int) -> int:
    """The most rows of ``S`` tokens a MoE microbatch may hold: its tokens
    times top_k within the routing kernel's block limit, over the
    config's dispatch blocks."""
    nb = cfg.moe_block_dispatch or 1
    return MG.MAX_CTAS * MG.MAX_CTA_ENTRIES * nb // (cfg.moe_top_k * S)


def _rows_that_fit(cfg, case, S, model, dev, gen, variant, batch: int,
                   grad_dtype, rec: dict, ranks: _Ranks) -> int:
    """Rows a card a microbatch that fit (the smallest over the cards):
    one step at ``batch`` (one row a card a microbatch) on ``model``, whose
    peak above the weights and the optimizer state, less the gradients',
    is one row's; ``ROWS_MARGIN`` of the budget left for them."""
    probe = dataclasses.replace(case, global_batch=batch, seq_len=S)
    fn, args = _cell(cfg, probe, variant, model, dev, gen)
    grads = sum(p.numel() for p in model.parameters()) * grad_dtype.itemsize
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    fn(*args)
    torch.cuda.synchronize()
    one = torch.cuda.max_memory_allocated(dev) - base - grads
    del fn, args
    free, total, budget = _budget(dev)
    rec["bytes_one_row_peak"] = one
    rec["probe_steps"] = 1
    return ranks.min(int(ROWS_MARGIN * (budget - grads) // max(one, 1)))


def _write(out_dir: Path, rec: dict,
           ranks: Optional[_Ranks] = None) -> None:
    """The record's file (rank 0's on a mesh), named by the sharding
    variant too where it has one, so that it sits beside the baseline's."""
    if ranks is not None and ranks.rank != 0:
        return
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    sharding = sorted(ST.variant_tokens(rec["variant"])
                      & set(ST.SHARDING_VARIANTS))
    name = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}" + "".join(
        f"__{v}" for v in sharding) + ".json"
    (out_dir / name).write_text(json.dumps(rec, indent=1, default=str))


def _run_cells(args, mesh=None, rank: int = 0) -> None:
    """``run_cell`` for every cell of the command line (on ``mesh`` where
    given, every rank calling it alike); rank 0 prints a line a cell."""
    archs = list_archs() if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    cells = [(arch, shape) for arch in archs for shape in shapes]
    for i, (arch, shape) in enumerate(cells):
        rec = run_cell(arch, shape, Path(args.out), device=args.device,
                       reduced=args.reduced, seq_len=args.seq_len,
                       variant=args.variant, mesh=mesh, layers=args.layers)
        status = ("SKIP" if "skipped" in rec else "NOFIT"
                  if "not_fitting" in rec else "OK")
        if rank == 0:
            print(f"[{status}] {arch} x {shape}"
                  + ("" if mesh is None else f" on {rec['mesh']}") + ": "
                  + json.dumps({k: rec[k] for k in (
                      "global_batch", "seq_len", "flops", "bytes_accessed",
                      "step_ms", "device_busy_ms", "skipped", "not_fitting",
                      "reduced") if k in rec}))
        if i + 1 < len(cells):
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
        sys.stdout.flush()


def _mesh_rank(rank: int, n: int, data: int, port: int, args) -> None:
    """One rank of ``--cards``: NCCL on its card (gloo on the CPU with
    ``--device cpu``), the (data, n // data) mesh, every cell."""
    import os

    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    cpu = torch.device(args.device).type == "cpu"
    if not cpu:
        torch.cuda.set_device(rank)
    # the host's cores shared by the ranks
    torch.set_num_threads(max(1, (os.cpu_count() or n) // n))
    dist.init_process_group("gloo" if cpu else "nccl",
                            init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=n)
    try:
        mesh = make_mesh(n, data, device="cpu" if cpu else "cuda")
        _run_cells(args, mesh, rank)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="dry-run records on one card, "
                                 "or on a mesh of cards with --cards")
    ap.add_argument("--arch", default="qwen2-1.5b",
                    help="architecture id, a comma-separated list, or 'all'")
    ap.add_argument("--shape", default="decode_32k",
                    help="shape case, a comma-separated list, or 'all'")
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true",
                    help="reduced configs (CPU sanity)")
    ap.add_argument("--seq-len", type=int, default=None,
                    help="override the case's length")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to the first LAYERS layers")
    ap.add_argument("--cards", type=int, default=None,
                    help="spawn one rank a card and record on a mesh of "
                    "CARDS cards (NCCL; gloo ranks with --device cpu)")
    ap.add_argument("--mesh", default=None,
                    help="with --cards: the mesh as DATAxMODEL (1x4, 2x2); "
                    "default 1xCARDS")
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    args = ap.parse_args(argv)
    if args.cards is None:
        if args.mesh is not None:
            ap.error("--mesh needs --cards")
        _run_cells(args)
        return
    shape = args.mesh or f"1x{args.cards}"
    try:
        data, model = (int(x) for x in shape.split("x"))
    except ValueError:
        ap.error(f"--mesh {shape}: expected DATAxMODEL, e.g. 1x4")
    if args.cards < 1 or data * model != args.cards:
        ap.error(f"--mesh {shape} does not hold --cards {args.cards}")
    if T.resolve_device(args.device).type == "cuda" and \
            torch.cuda.device_count() < args.cards:
        raise RuntimeError(f"--cards {args.cards}: "
                           f"{torch.cuda.device_count()} cards visible")
    torch.multiprocessing.spawn(_mesh_rank, args=(args.cards, data,
                                                  _free_port(), args),
                                nprocs=args.cards, join=True)


if __name__ == "__main__":
    main()

"""Training loop with checkpoint/restart fault tolerance (port of
``repro/training/train_loop.py``).

Wraps ``launch/steps.build_train_step`` with the synthetic data stream,
periodic checkpoints (atomic; async by default), automatic resume from the
latest committed step, and a failure-injection hook for the
fault-tolerance tests. Runs on one device, CUDA unless the caller asks for
the CPU.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import torch

from repro_torch.checkpoint.checkpoint import Checkpointer
from repro_torch.configs.base import ModelConfig
from repro_torch.launch.steps import build_train_step
from repro_torch.models import transformer as T
from repro_torch.training import optimizer as OPT
from repro_torch.training.data import DataConfig, SyntheticDataset
from repro_torch.tree import flatten


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    global_batch: int = 8
    seq_len: int = 64
    n_micro: int = 1
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 25
    ckpt_async: bool = True
    log_every: int = 10
    seed: int = 0


def _state(model: T.Transformer, opt_state: dict, kind: str) -> dict:
    """What a checkpoint holds, in the reference's structure."""
    return {"params": T.param_tree(model),
            "opt": OPT.state_to_tree(opt_state, kind)}


def vision_embeddings(cfg: ModelConfig, tcfg: TrainConfig, step: int,
                      device) -> torch.Tensor:
    """Step ``step``'s vision embeddings (global_batch, n_vision_tokens,
    d_model) in the config's dtype: standard normals drawn in fp32 on
    ``device`` from a ``torch.Generator`` seeded from (tcfg.seed, step),
    so a resumed run draws what the uninterrupted one drew."""
    gen = torch.Generator(device=device).manual_seed(
        tcfg.seed * 1_000_003 + step)
    x = torch.randn((tcfg.global_batch, cfg.n_vision_tokens, cfg.d_model),
                    generator=gen, device=device, dtype=torch.float32)
    return x.to(getattr(torch, cfg.dtype))


def train(cfg: ModelConfig, tcfg: TrainConfig, *,
          fail_at_step: Optional[int] = None,
          log_fn: Callable[[str], None] = print, device="cuda",
          init_params: Optional[dict] = None) -> dict:
    """Train ``tcfg.steps`` steps from the latest committed checkpoint in
    ``tcfg.ckpt_dir`` (or from step 0). The weights start from the seeded
    init (a ``torch.Generator`` seeded ``tcfg.seed`` on ``device``) or,
    given ``init_params`` (a JAX params pytree of numpy arrays), from those.
    Batch ``step`` is ``SyntheticDataset.batch(step)`` (tokens and labels
    (B, S), or (B, S, C) with codebooks), so a resumed run sees the stream
    the uninterrupted one saw. A vision config's batch also gets
    ``vision_embeddings(cfg, tcfg, step, dev)``; the reference draws its
    embeddings from ``jax.random``, a stream this cannot equal, so the two
    packages' vision runs are compared per train step on shared
    embeddings, not per train loop. ``fail_at_step`` raises
    before that step (after the pending save lands).

    Returns {"losses", "metrics", "resumed_from" (int or None),
    "steps_run", "model", "opt_state", "step_ms", "step_timer"}:
    ``metrics`` holds each step's train-step metrics as floats (loss,
    grad_norm, lr, ce, z, lb_loss, z_loss), read back before the next step
    starts; the step times are CUDA-event times on CUDA ("cuda_events"),
    host-clock times on the CPU ("host_clock")."""
    dev = T.resolve_device(device)
    data = SyntheticDataset(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=tcfg.seq_len,
        global_batch=tcfg.global_batch, seed=tcfg.seed,
        n_codebooks=cfg.n_codebooks))
    T.check_trainable(cfg)
    step_fn = build_train_step(cfg, n_micro=tcfg.n_micro)

    if init_params is None:
        model = T.Transformer(cfg, device=dev, generator=torch.Generator(
            device=dev).manual_seed(tcfg.seed))
    else:
        model = T.from_jax_params(cfg, init_params, device=dev)
    opt_state = OPT.init(dict(model.named_parameters()), cfg.optimizer)

    ckpt = Checkpointer(tcfg.ckpt_dir, async_save=tcfg.ckpt_async) \
        if tcfg.ckpt_dir else None
    start = 0
    resumed_from = None
    try:
        if ckpt is not None:
            latest = ckpt.latest_step()
            if latest is not None:
                state = ckpt.restore(latest, _state(model, opt_state,
                                                    cfg.optimizer))
                with torch.no_grad():
                    for (_, p), (_, new) in zip(
                            flatten(T.param_tree(model)),
                            flatten(state["params"])):
                        p.copy_(new)
                opt_state = OPT.state_from_tree(state["opt"], cfg.optimizer)
                start = latest
                resumed_from = latest
                log_fn(f"[train] resumed from step {latest}")

        losses, history, step_ms = [], [], []
        cuda = dev.type == "cuda"
        t0 = time.perf_counter()
        for step in range(start, tcfg.steps):
            if fail_at_step is not None and step == fail_at_step:
                if ckpt:
                    ckpt.wait()
                raise RuntimeError(f"injected failure at step {step}")
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in data.batch(step).items()}
            if cfg.n_vision_tokens:
                batch["vision_embeds"] = vision_embeddings(cfg, tcfg, step,
                                                           dev)
            if cuda:
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
            else:
                h0 = time.perf_counter()
            opt_state, metrics = step_fn(model, opt_state, batch)
            if cuda:
                ev[1].record()
            values = torch.stack([v.float() for v in metrics.values()])
            history.append(dict(zip(metrics, values.tolist())))
            loss = history[-1]["loss"]
            step_ms.append(ev[0].elapsed_time(ev[1]) if cuda
                           else (time.perf_counter() - h0) * 1e3)
            losses.append(loss)
            if (step + 1) % tcfg.log_every == 0:
                dt = (time.perf_counter() - t0) / max(1, len(losses))
                log_fn(f"[train] step {step+1}/{tcfg.steps} "
                       f"loss={loss:.4f} ({dt*1e3:.0f} ms/step)")
            if ckpt is not None and (step + 1) % tcfg.ckpt_every == 0:
                ckpt.save(step + 1, _state(model, opt_state, cfg.optimizer))
        if ckpt is not None:
            ckpt.save(tcfg.steps, _state(model, opt_state, cfg.optimizer))
            ckpt.wait()
    finally:
        if ckpt is not None:
            ckpt.close()
    return {"losses": losses, "metrics": history,
            "resumed_from": resumed_from,
            "steps_run": len(losses), "model": model,
            "opt_state": opt_state, "step_ms": step_ms,
            "step_timer": "cuda_events" if cuda else "host_clock"}

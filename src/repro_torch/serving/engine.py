"""Single-instance serving engine: continuous batching over the PyTorch model
(port of ``repro/serving/engine.py``).

Same admission, prefill-budget, retire and TTFT/TPOT logic as the JAX
engine: slot-based batch, paged-block admission control (kv_cache.py),
greedy/temperature sampling. Attention-only configs prefill at a power of
two as the JAX engine does; configs with Mamba or RWKV layers prefill at the
prompt's exact length, because a recurrent state taken at the padded end
has also absorbed the pad tokens (the JAX engine's padded prefill does
that, and its decode then departs from its own model's). Decode runs in
append mode, as the JAX engine's does: the attention layers read the slot
cache as it was and the decode kernel merges each new token (on CUDA,
through the hand-written kernels), then each group's new K/V is committed
with one batched write per stacked leaf; recurrent states are written in
place.
Greedy sampling is one argmax over the batch on the device.

On a mesh (``mesh=``, a ``DeviceMesh`` of ``launch/mesh.py``) the engine
runs SPMD: every card runs the same loop over the same requests with its
shard of the model and of the slot cache, which is cut by the decode rules
of a ``ShapeCase("serve", "decode", max_seq, max_batch)``
(``serving_rules``; the model must be built under them). The prefill cache
goes into each card's shard (its kv heads or its sequence range), and the
logits are gathered over the vocab (and batch) before ``argmax`` /
``_sample``, so every card picks the same token: the cards share the seeded
generator and see the same logits. Wall-clock times only stamp the
requests; admission and sampling never read them.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import ShapeCase
from repro_torch.launch import steps as ST
from repro_torch.models import transformer as T
from repro_torch.serving.kv_cache import BlockManager, OutOfBlocks


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new_tokens: int
    temperature: float = 0.0
    arrival_t: float = 0.0
    # filled during serving:
    generated: list[int] = dataclasses.field(default_factory=list)
    first_token_t: float = -1.0
    finish_t: float = -1.0
    slot: int = -1

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.max_new_tokens

    @property
    def ttft(self) -> float:
        return self.first_token_t - self.arrival_t

    @property
    def tpot(self) -> float:
        n = len(self.generated)
        if n <= 1 or self.first_token_t < 0:
            return 0.0
        return (self.finish_t - self.first_token_t) / (n - 1)


@dataclasses.dataclass
class EngineConfig:
    max_batch: int = 8
    max_seq: int = 256
    block_size: int = 16
    prefill_budget_tokens: int = 512
    seed: int = 0


def serving_rules(cfg: ModelConfig, ecfg: EngineConfig, mesh):
    """The sharding rules of an engine on ``mesh``: the decode policy of a
    ``ShapeCase("serve", "decode", max_seq, max_batch)``. Build the model
    under them (``Transformer(..., mesh=mesh, rules=serving_rules(...))``)."""
    return ST.rules_for(cfg, ShapeCase("serve", "decode", ecfg.max_seq,
                                       ecfg.max_batch), mesh)


class ServingEngine:
    """Serves ``model`` (a ``transformer.Transformer``) on ``device``, CUDA
    by default; raises when CUDA is missing and no device was given. The
    model must already live on that device.

    Vision and codebook configs raise ``NotImplementedError``, as the
    reference engine cannot serve them either: its prefill passes no
    ``vision_embeds`` (which the model requires) and it samples one token
    a step where a codebook model gives C. Their entry points are the
    model's ``prefill`` / ``decode_step`` and ``launch/dryrun.py``.

    ``mesh``: serve on a mesh (module docstring); ``model`` is this card's
    shard, built on ``mesh`` under ``serving_rules``."""

    def __init__(self, cfg: ModelConfig, model: T.Transformer,
                 ecfg: EngineConfig, *, device="cuda", mesh=None):
        if cfg.n_vision_tokens or cfg.n_codebooks:
            raise NotImplementedError(
                f"{cfg.name}: the engine serves one token stream without "
                "vision inputs, as the reference engine does (its prefill "
                "takes no vision_embeds and it samples one token a step, "
                "not one per codebook)")
        self.device = T.resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model is on {model.device}, engine on "
                             f"{self.device}")
        self.cfg = cfg
        self.model = model
        self.ecfg = ecfg
        layout = None
        if mesh is not None:
            rules = serving_rules(cfg, ecfg, mesh)
            if model.layout is None or model.layout.rules != rules:
                raise ValueError("on a mesh the model must be built under "
                                 "serving_rules(cfg, ecfg, mesh)")
            layout = model.layout
        elif model.layout is not None:
            raise ValueError("a model built on a mesh serves with mesh=")
        self.cache = T.init_cache(cfg, ecfg.max_batch, ecfg.max_seq,
                                  device=self.device, mesh=layout)
        self.blocks = BlockManager(
            n_blocks=ecfg.max_batch * (ecfg.max_seq // ecfg.block_size),
            block_size=ecfg.block_size)
        self.lengths = np.zeros(ecfg.max_batch, dtype=np.int64)
        self.slot_req: list[Optional[Request]] = [None] * ecfg.max_batch
        self.queue: deque[Request] = deque()
        self.finished: list[Request] = []
        self.generator = torch.Generator(device=self.device).manual_seed(
            ecfg.seed)
        self.exact_prefill = T.is_recurrent(cfg)
        self.steps = 0
        self.prefills = 0        # model.prefill calls
        self.decodes = 0         # model.decode_step calls

    # -- public -----------------------------------------------------------
    def submit(self, req: Request) -> None:
        # epoch wall time, as in the JAX engine: latencies are reported
        # against client-visible arrival clocks
        req.arrival_t = req.arrival_t or time.time()
        self.queue.append(req)

    @property
    def n_active(self) -> int:
        return sum(r is not None for r in self.slot_req)

    def run(self, max_steps: int = 10_000) -> list[Request]:
        while (self.queue or self.n_active) and self.steps < max_steps:
            self.step()
        return self.finished

    # -- internals ----------------------------------------------------------
    def _admit(self) -> None:
        budget = self.ecfg.prefill_budget_tokens
        while self.queue and budget > 0:
            req = self.queue[0]
            L = len(req.prompt)
            if L + req.max_new_tokens > self.ecfg.max_seq:
                self.queue.popleft()
                req.finish_t = time.time()
                self.finished.append(req)      # rejected: too long
                continue
            free_slots = [i for i, r in enumerate(self.slot_req) if r is None]
            if not free_slots:
                return
            if not self.blocks.can_allocate(L + req.max_new_tokens):
                return
            if L > budget and self.n_active > 0:
                return                          # defer big prefill (chunking)
            self.queue.popleft()
            slot = free_slots[0]
            self.blocks.allocate(req.rid, L)
            padded = L if self.exact_prefill else max(
                8, 1 << (L - 1).bit_length())
            toks = np.zeros((1, padded), np.int64)
            toks[0, :L] = req.prompt
            logits, pf_cache = self.model.prefill(
                torch.from_numpy(toks).to(self.device))
            self.prefills += 1
            T.cache_insert(self.cfg, self.cache, pf_cache, slot, L)
            first = self._sample(
                self.model.gather_logits(logits[:, L - 1], 1), req)
            req.generated.append(first)
            req.first_token_t = time.time()
            self.blocks.append_token(req.rid)
            req.slot = slot
            self.slot_req[slot] = req
            # lengths = number of tokens whose KV is in the cache
            self.lengths[slot] = L
            budget -= L
            if req.done:
                self._retire(req)

    def _sample(self, logits: torch.Tensor, req: Request) -> int:
        lg = logits[-1] if logits.dim() > 1 else logits
        if req.temperature <= 0:
            return int(torch.argmax(lg))
        probs = torch.softmax(lg.float() / req.temperature, dim=-1)
        return int(torch.multinomial(probs, 1, generator=self.generator))

    def _retire(self, req: Request) -> None:
        req.finish_t = time.time()
        self.finished.append(req)
        self.blocks.free_seq(req.rid)
        if req.slot >= 0 and self.slot_req[req.slot] is req:
            self.slot_req[req.slot] = None
            self.lengths[req.slot] = 0
        req.slot = -1

    def step(self) -> None:
        self.steps += 1
        self._admit()
        active = [r for r in self.slot_req if r is not None]
        if not active:
            return
        toks = np.zeros(self.ecfg.max_batch, np.int64)
        for r in active:
            toks[r.slot] = r.generated[-1]
        # decode commits the new token's KV at position `lengths`
        logits, self.cache = self.model.decode_step(
            self.cache, torch.from_numpy(toks).to(self.device),
            torch.from_numpy(self.lengths.copy()), append=True)
        logits = self.model.gather_logits(logits, self.ecfg.max_batch)
        self.decodes += 1
        greedy = torch.argmax(logits, dim=-1).tolist()
        now = time.time()
        for r in list(active):
            tok = (greedy[r.slot] if r.temperature <= 0
                   else self._sample(logits[r.slot], r))
            r.generated.append(tok)
            self.lengths[r.slot] += 1
            try:
                self.blocks.append_token(r.rid)
            except OutOfBlocks:
                r.max_new_tokens = len(r.generated)
            if r.done or self.lengths[r.slot] + 1 >= self.ecfg.max_seq:
                r.finish_t = now
                self._retire(r)

"""Paged KV-cache block manager (the port's own copy of
``repro.serving.kv_cache``, which cannot be imported without JAX).

Management-plane allocator in the vLLM style: the cache is divided into
fixed-size token blocks; sequences own chains of blocks with ref-counting
(copy-on-write prefix sharing ready).  The data plane maps block chains onto
the engine's slot-contiguous device buffers.

Invariants (differential-tested against the JAX package's copy in
tests/test_torch_serving.py):
  * a block is owned by ≥1 sequence iff not in the free list,
  * Σ blocks(seq) == ceil(len(seq)/block_size),
  * free+used == total, always.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


class OutOfBlocks(RuntimeError):
    pass


@dataclasses.dataclass
class SeqAlloc:
    seq_id: int
    blocks: list[int]
    tokens: int = 0


class BlockManager:
    def __init__(self, n_blocks: int, block_size: int):
        assert n_blocks > 0 and block_size > 0
        self.n_blocks = n_blocks
        self.block_size = block_size
        self.free: list[int] = list(range(n_blocks - 1, -1, -1))
        self.ref: list[int] = [0] * n_blocks
        self.seqs: dict[int, SeqAlloc] = {}

    # -- queries -------------------------------------------------------------
    @property
    def n_free(self) -> int:
        return len(self.free)

    @property
    def n_used(self) -> int:
        return self.n_blocks - len(self.free)

    def blocks_needed(self, n_tokens: int) -> int:
        return -(-n_tokens // self.block_size)

    def can_allocate(self, n_tokens: int) -> bool:
        return self.blocks_needed(n_tokens) <= self.n_free

    def block_table(self, seq_id: int) -> list[int]:
        return list(self.seqs[seq_id].blocks)

    # -- lifecycle -------------------------------------------------------------
    def allocate(self, seq_id: int, n_tokens: int) -> SeqAlloc:
        if seq_id in self.seqs:
            raise ValueError(f"seq {seq_id} already allocated")
        need = self.blocks_needed(max(1, n_tokens))
        if need > self.n_free:
            raise OutOfBlocks(f"need {need} blocks, {self.n_free} free")
        blocks = [self._take() for _ in range(need)]
        alloc = SeqAlloc(seq_id, blocks, n_tokens)
        self.seqs[seq_id] = alloc
        return alloc

    def append_token(self, seq_id: int) -> Optional[int]:
        """Grow a sequence by one token; returns newly allocated block id if
        a block boundary was crossed."""
        a = self.seqs[seq_id]
        a.tokens += 1
        if self.blocks_needed(a.tokens) > len(a.blocks):
            if not self.free:
                a.tokens -= 1
                raise OutOfBlocks("cache full on append")
            b = self._take()
            a.blocks.append(b)
            return b
        return None

    def fork(self, src_seq: int, dst_seq: int) -> None:
        """Share the prefix blocks (ref-counted) — beam/prefix reuse."""
        src = self.seqs[src_seq]
        if dst_seq in self.seqs:
            raise ValueError("dst exists")
        for b in src.blocks:
            self.ref[b] += 1
        self.seqs[dst_seq] = SeqAlloc(dst_seq, list(src.blocks), src.tokens)

    def free_seq(self, seq_id: int) -> None:
        a = self.seqs.pop(seq_id)
        for b in a.blocks:
            self.ref[b] -= 1
            if self.ref[b] == 0:
                self.free.append(b)

    def _take(self) -> int:
        b = self.free.pop()
        self.ref[b] += 1
        return b

    # -- integrity -------------------------------------------------------------
    def check_invariants(self) -> None:
        owned = [0] * self.n_blocks
        for a in self.seqs.values():
            assert len(a.blocks) == self.blocks_needed(max(1, a.tokens)), (
                a.seq_id, a.tokens, len(a.blocks))
            for b in a.blocks:
                owned[b] += 1
        for b in range(self.n_blocks):
            assert owned[b] == self.ref[b], (b, owned[b], self.ref[b])
            assert (self.ref[b] == 0) == (b in set(self.free)), b
        assert self.n_used + self.n_free == self.n_blocks

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
               Sq=Skv=1024, decode B=8, S=2048), and phase 9's: the
               vision cross prefill (non-causal, Sq=1024 and 1000 over
               Skv=1600, a ragged Skv=1601; H=32, KVH=8, Dh=128) and cross
               decode (B=8, every length 1600; 1601), musicgen's prefill
               and decode (H=KVH=32, Dh=64: G = 1), timed at those shapes
               too (a `modality kernel shapes:` line). MoE gating (the routing
               kernel without its maps): the tests/test_kernels.py shapes,
               granite's decode and prefill and jamba's shapes, and an
               exp-underflow case; ids exactly equal. MoE routing (gating,
               dispatch maps and aux in one launch): granite's and jamba's
               served shapes up to T = 8192, E = 384, a dropping cap, an
               adversarial jamba route, nb = 2 and 4 and the underflow
               rows; every integer equal. WKV6 and Mamba scans: the
               tests/test_kernels.py shapes, full-width prefill
               (rwkv6-1.6b: H=32, K=64; jamba: Din=16384, N=16; T=1024)
               and the decode batch (B=8, T=1, also against the
               single-step versions and with the state written in place),
               fp32 and bf16, against the sequential oracles; rwkv6 also
               at the chunk edges T = c - 1, c, c + 1 of every chunk size,
               T = 881, B = 8 at T = 200 and decays down to ~e^-20 (there
               also against the exact plain path); ssm also at N = 8 and
               16 with Din = 16608 (not whole blocks), T = 1023. A chunk
               sweep times rwkv6's chunk sizes. The attention sweeps also
               hold the split-KV decode at its edges (G = 16, lengths 0
               and 1, a window under one split, int64 and int32 lengths)
               and the prefill at Sq = Skv = 64 k + 1 with a window under
               one tile. The decode kernel also in append mode (the new
               token's k_new / v_new merged by its combine pass; lengths 0,
               1 and S - 1, a window under one split and over several, a
               window of 1, a softcap, G = 16, int32 and int64 lengths, the
               served shapes) against its plain version and against the
               committed kernel over the cache with the token written.
               Times with CUDA events and torch.profiler, append mode
               beside committed mode. kimi-k2's head dim 112 (both
               attention kernels stage it at 128 columns): its served
               shapes (prefill B=1, Sq=Skv=1024, H=64, KVH=8; decode B=8,
               S=2048, committed and append), ragged Sq and Skv, a window
               under one tile and one split, lengths 0 and 1, int32 and
               int64 lengths, fp32 and bf16; the routing at its E = 384,
               k = 8 (T = 8, 1000 and 1024, every integer equal); both
               kernels and the routing timed at its served shapes beside
               SDPA (a `kimi kernel shapes:` line).
  3. serving — qwen2-1.5b, granite-moe-1b-a400m and rwkv6-1.6b at full
               width and depth, then jamba-1.5-large at full width on the
               first 4 layers of its period (bf16, seeded random weights)
               behind ServingEngine(max_batch=8, max_seq=2048), which
               decodes in append mode: 8 requests, 32 new tokens each. The
               launch counters, zeroed just before each run, must show
               every prefill and decode step of every layer going through
               its kernels, per layer kind.
  4. path    — one prompt through prefill and 8 teacher-forced decode steps,
               once through the kernels and once with impl="plain": qwen2
               in bf16; granite in fp32 (gated, with no differing expert
               choice over every recorded choice, and no differing dispatch
               slot) and in bf16 (reported); rwkv6 in fp32 (gated, argmax
               equal) and in bf16 (reported); jamba in fp32 on layers 0-1
               (Mamba + dense, Mamba + MoE) and on layers 2-3 (Mamba +
               dense, attention + MoE), each gated with no differing expert
               choice, and in bf16 on the 4 (reported); kimi-k2 (below).
               On each gated path
               the kernel path's append-mode decode is also held to its
               committed decode (qwen2 bf16 0.1, fp32 1e-4, the same route
               and argmax gates).
  5. trace   — torch.profiler over 5 serving-shaped append-mode decode steps
               (B=8) of each model: step wall time, device busy time, top
               kernels, launches by kernel name.
     3-5 for kimi-k2-1t-a32b at full width, cut to its first 2 of 61
               layers (KIMI_CUT: the dense layer 0 and one MoE layer of 384
               experts, 38.6 GB in bf16): served in bf16 with exact
               launches, its bf16 path reported and traced; the same bf16
               weights computed in fp32 gated (1e-3, argmax equal, no
               differing expert choice, append vs committed 1e-4); layer 0
               alone in fp32 gated the same way.
  6. profile — repro_torch.launch.dryrun.run_cell for qwen2-1.5b at
               decode_32k on the card (the batch cut to what fits), printed
               on a dryrun: line; the H100 MaxTput row built from it by
               profile_from_dryrun beside the analytic row, bucket by
               bucket, and the engine model's step time beside the
               measured one, on a profile: line. Then the decode_32k
               records of internlm2-1.8b, minitron-4b, gemma2-27b (its
               window and softcap at full size, about one sequence),
               granite-moe-1b-a400m and rwkv6-1.6b, each with its profile:
               line; rwkv6's long_500k; qwen2-1.5b's prefill_32k (batch
               cut to what fits, logits finite) and train_4k (8 sequences,
               n_micro 4, the first cross-entropy in phase 8's band)
               records; every record gated (ok, one device, operations
               counted, bytes at least the weights', launches exact), and
               gemma2-27b's long_500k, jamba and kimi-k2 at full depth
               logged as not fitting one card, with why. Each record
               prints its seconds.
  7. cluster — qwen2-1.5b behind ServingCluster (the serving example
               twin's data_plane) with {"H100": 2} (two
               engines sharing one model on the card) under phase 6's
               profile: phase 3's 8 requests, each of whose tokens must
               equal the single engine's, exact launch counts.
  7b. control — the port's own Mélange control plane, through the
               functions of examples/serve_heterogeneous_torch.py: Melange
               over PAPER_GPUS for qwen2-1.5b (the analytic profile with
               phase 6's record-derived H100 row) allocates arena traffic
               at CONTROL_RATE req/s, which must hold at least 2 instances
               (the analytic profile's allocation printed beside it);
               phase 3's 8 requests through a ServingCluster of that
               allocation's counts, every instance sharing phase 7's bf16
               model, gated as phase 7; then the port's simulator on the
               allocation (attainment, TPOT p50 / p99), on a control: line.
  7c. twins  — examples/serve_heterogeneous_torch.py (--requests 8
               --sim-requests 200) and examples/train_small_torch.py
               (--steps 4) in subprocesses with --device cuda, each wrapped
               to list the modules it loaded: exit 0, their lines printed,
               completed plus rejected equal to the requests, finite
               losses, no jax or repro module loaded (a twins: line).
  8. training — the flash kernel's lse output against
               ref.blockwise_fwd_lse (qwen2's and granite's heads, S = 1024,
               window and softcap, a case with fully masked rows; fp32 2e-5,
               bf16 2e-2) and its out equal to the kernel's without lse;
               the CUDA autograd.Function's dq, dk, dv against autograd
               through ref.attention_naive (fp32, 1e-4), causal and (the
               vision cross layers) non-causal over Skv = 1600 and 1601,
               a ragged last block of the backward; the trainable scans
               with the kernel forward: fp32 gradients of every input
               against autograd through the sequential oracles (T ragged
               against the segment, WKV6 at mild and strong decays; 1e-4
               of each gradient's largest magnitude, one launch a
               segment) and bf16 ones at the training shapes against the
               plain Functions (2e-2), with the forward, the plain
               backward and its peak memory timed; the lse kernel at the
               vision cross and musicgen training shapes; one train
               step's loss (1e-5 relative), grad norm (1e-4 relative) and
               every gradient (1e-3 of its leaf's largest magnitude) on
               the kernel path against impl="plain", full width, fp32,
               seq 1024: qwen2, granite (no differing expert choice or
               slot), rwkv6 (2 layers each), Jamba's layer 0 and vision's
               first cross and self layers; then train_loop.train, bf16,
               remat, seq 4096, global batch 8: qwen2-1.5b (n_micro 4, 6
               steps), granite-moe-1b-a400m (8, 4), rwkv6-1.6b (4, 3) and
               musicgen-large (4, 3) at full size, jamba-1.5-large (8, 3,
               Adafactor) on its layer 0 and llama-3.2-vision-11b (8, 3)
               on its first 10 layers at full width (TRAIN_CUTS), every
               loss and grad norm finite, the first step's cross-entropy
               within 10% of ln V of its expected value, launch counts
               exact (flash = attention layers x microbatches x 2 a step,
               routing = MoE layers x microbatches x 2, a scan = its
               layers x segments x microbatches x 2, decode 0), and one
               more step under torch.profiler with the plain backward of
               its scans, else of its attention, marked (a train: line
               each); last, qwen2 at 2 layers through a failure at step 4
               and a resume from the step-3 checkpoint, its losses equal
               to an uninterrupted run's (1e-6 relative; bitwise or not is
               printed).
  9. modality — llama-3.2-vision-11b (9.79 B parameters; every 5th layer
               cross-attends over 1600 vision tokens, vision embeddings
               (1, 1600, 4096) drawn from numpy's default_rng) and
               musicgen-large (2.45 B; 4 codebook streams) at full size,
               bf16, through the model's entry points (the engine serves
               neither, as the reference's cannot): one 1024-token prompt
               prefilled, then 32 greedy append-mode decode steps, launches
               exact (a `generate:` line with TPOT at B=1); phase 4's path,
               bf16 reported and fp32 gated (1e-3, argmax equal at every
               position and codebook, append vs committed 1e-4); phase 5's
               trace; phase 6's dryrun: record at decode_32k and profile:
               row.

Prints the card's name and power limit, a {"kernels": [...]} line, and as
its last line {"ok": true, "device": {...}}. Without CUDA, or without the
repository beside it, it exits non-zero and prints no result.

    python3 chip_smoke.py --cards 4

is the tensor- and expert-parallel mode on four cards of one host (the
default run above is unchanged). It exits non-zero when fewer than 4 cards are
visible, builds the kernels once, then starts one process a card
(`torch.multiprocessing` spawn, NCCL, a 300 s process-group timeout so a
hung rank fails the run; any rank's failure fails it).

    python3 chip_smoke.py --cards 4 --phases sp

runs only the named groups of phases (a comma-separated list of sp, rec,
mod, tp and ep; all of them by default, in that order), kernels tp with
any of them, and with sp the baseline records of the dryrun sp records
whose groups are not named (`phase sp baselines:`). The four-card train_4k
records are cut to their first 2 layers (RECORD_TRAIN_LAYERS; the record
lists the cut under `reduced`), but vision's, which keeps its 40. On a
(data 1, model 4) mesh (train tp: also (2, 2) and (4, 1)), under the
reference's sharding rules:
  path sp     — sequence parallelism (seqpar: the residual stream's
               sequence over "model", each layer's input all-gathered and
               its output reduce-scattered; the sp phases run first,
               before kernels tp): prefill and 4 teacher-forced decode steps
               (append and committed; decode is the baseline's, S = 1) of
               qwen2-1.5b and granite-moe-1b-a400m at full size in fp32 on
               1x4 and 2x2 against card 0 without a mesh (path tp's prompt
               lengths: 1535 does not divide, and there the rule does
               nothing: the prefill's all-reduces show which way each
               went; only Mamba's x_proj all-reduces where it cuts); then
               the same for rwkv6-1.6b at full size, Jamba's first 4
               layers (bf16 weights computed in fp32), llama-3.2-vision's
               first 10 (two cross layers) and musicgen-large at full size
               (path rec's prompt lengths, each prefilled at its own
               length: the scans and token shifts over the gathered
               sequence); PATH_TOL_FP32, argmax equal, expert choices
               equal but at near ties, launches exact.
  train sp    — the gates of train tp under seqpar, fsdp+seqpar on 2x2:
               qwen2's, granite's and rwkv6's first 2 layers, fp32, on 2x2
               and 1x4 against one card's step (the norms' gradients summed
               over "model"), a step's collectives with its
               reduce-scatters; then Jamba's layer 0 (8 rows), vision's
               first 5 layers (one cross layer) and musicgen's first 2 on
               2x2 and 1x4.
  dryrun sp   — qwen2's prefill_32k on 1x4 and qwen2's, granite's and
               llama-3.2-vision's train_4k on 2x2 under seqpar; at the end
               of the run each beside its baseline record of the same run
               (`dryrun sp vs baseline:`).
  kernels tp  — (card 0) the decode kernel's partial mode (`start`, the
               (m, l, o) partials) against its plain version, and the
               merge of 4 partials by the combine pass against the
               one-call kernel over the whole cache: qwen2's and gemma2's
               heads at Dh 128, start > 0, windows across shard edges,
               empty shards, the new token merged on its owner card only,
               committed and append, fp32 2e-5 and bf16 2e-2; a kv-head
               view of a replicated cache; timings at the four-card shapes;
               the routing kernel at the global tokens every card routes
               (granite's train_4k microbatch on 2x2: T = 8192 at the
               block limit; its decode_32k step: T = 128; kimi-k2's served
               step: T = 8, E = 384), every integer against the plain
               version; the Mamba and WKV6 scans at a card's shapes
               (Jamba's Din 4096 of 16384, rwkv6's 8 of 32 heads; a B=8
               decode step with the state a slot of a stacked cache,
               written in place, a B=1 T=1024 prefill and a B=1 T=4096
               training sequence) against their plain versions in fp32
               and bf16 (SCAN_TOL, bf16 outputs one more ulp), timed beside
               the plain version's and their bytes bounds; both attention
               kernels at a card's shapes of llama-3.2-vision-11b and
               musicgen-large beside SDPA and their bounds (`kernels tp
               mod:`): the cross prefill (8 / 2 heads of 128, Sq 1024 over
               Skv 1600, non-causal), the cross decode (B=8 over 1600
               rows, G = 4) and its row-cut case (400 rows a card, every
               head, the 4 partials merged), musicgen's 8 / 8 heads of 64
               at prefill (causal, 1024) and decode (B=8 over 2048).
  path rec    — Mamba and RWKV-6 on the mesh (their d_inner channels and
               heads over "model"; the phases run right after kernels tp):
               prefill and 4 teacher-forced decode steps (append and
               committed) on meshes 1x4 and 2x2 against card 0 without a
               mesh: rwkv6-1.6b at full size in fp32, Jamba at full width
               on its first 4 layers (Mamba + dense, Mamba + MoE, Mamba +
               dense, attention + MoE; bf16 weights computed in fp32);
               PATH_TOL_FP32, argmax equal, expert choices equal but at
               near ties, launches exact (every scan), the collectives of
               every step (here and in path tp / path ep) equal to
               Transformer.step_collectives.
  serving rec — the 8 requests on mesh 1x4: rwkv6 in bf16 (tokens equal
               on every rank; TTFT, TPOT, busy, NCCL and idle a decode step
               by rank) and fp32 compute (tokens equal to the one-card
               engine's); Jamba at full width on the most layers four cards
               hold, reckoned from the specs (shards drawn on the cards),
               tokens equal on every rank.
  train rec   — rwkv6 at full width on its first 2 layers, fp32, AdamW, on
               2x2, 4x1, 1x4 and fsdp on 2x2, and Jamba's layer 0, fp32,
               Adafactor (8 rows of 1024), on 2x2, 4x1 and 1x4, two steps
               from count 99 against one card's step (the gates of train
               tp); Jamba's first 2 layers in bf16 with Adafactor on 2x2
               (finite losses equal on every rank, first cross-entropy in
               phase 8's band, collectives exact, peak memory a card).
  dryrun rec  — rwkv6's decode_32k and long_500k (batch 1) on 1x4 and
               train_4k on 2x2 (batch cut by the measured peak); Jamba's
               three not fitting (~200 GB of weights a card), reckoned from
               the specs before anything is built, logged with why.
  path mod    — cross-attention and codebook layers on the mesh (after
               the rec phases): prefill and 4 teacher-forced decode steps
               (append and committed) against card 0 without a mesh,
               fp32: llama-3.2-vision-11b at full width on its first 10
               layers (two periods: two cross layers) on 1x4 and 2x2 (the
               kv heads cut), and at batch 1 on 1x4 (every cache, the
               cross ones too, cut by rows over the 4 cards: the partial
               mode and the merge), musicgen-large at full size on 1x4
               and 2x2; PATH_TOL_FP32, argmax equal at every position and
               codebook, launches exact, collectives as step_collectives.
  train mod   — the gates of train tp: vision at full width on its first
               5 layers (one cross layer) on 2x2, 4x1, 1x4 and fsdp on
               2x2, musicgen at full width on its first 2 layers on 2x2,
               4x1 and 1x4, fp32, two steps from count 99 against one
               card's step; then vision at full depth (40 layers) in bf16
               with AdamW on 2x2 (finite losses equal on every rank, first
               cross-entropy in phase 8's band, collectives exact, peak
               memory a card).
  dryrun mod  — vision's and musicgen's decode_32k on 1x4 and train_4k on
               2x2, their batches cut to what a card holds.
  train tp    — the sharded train step (launch/steps.py build_cell(mesh=))
               of qwen2-1.5b at full width on its first 2 layers, fp32, on
               meshes (2, 2), (4, 1) and (1, 4), two steps from count 99
               against one card's train step from the same weights on card
               0 (loss 1e-5 and grad norm 1e-4 relative, every leaf within
               1e-3 after the update), fsdp and micro8+bf16grad on (2, 2)
               against the same variant on one card (bf16grad: grad norm
               and leaves within bf16's 2e-2); losses equal on every rank,
               collectives equal to steps.train_step_collectives, launches
               exact; the flash kernel with lse at a card's training shape
               against its plain version (and aten's flash attention with
               its lse); then the train_4k records on mesh
               (2, 2): qwen2-1.5b, internlm2-1.8b and minitron-4b (batch cut
               by the measured peak), gemma2-27b not fitting, reckoned from
               the specs before anything is built.
  path tp     — prefill and 4 teacher-forced decode steps (append and
               committed) on the mesh against the same weights on card 0
               without a mesh: qwen2-1.5b at full size (cache by
               sequence), gemma2-27b at full width on its first 2 layers
               (by kv heads at B 4, by sequence at B 1 with the window
               across a shard edge); fp32 within PATH_TOL_FP32 and argmax
               equal, bf16 reported; launches exact on every rank.
  serving tp  — phase 3's 8 requests through ServingEngine on the mesh,
               qwen2 at full size and gemma2 at full width on its first 12
               layers (TP_SERVE_LAYERS): bf16 (tokens equal on every
               rank; TTFT, TPOT, busy, NCCL and idle time a decode step by
               rank) and fp32 compute over the bf16 weights (tokens equal
               to the one-card engine's on card 0).
  dryrun tp   — four-card records: qwen2 decode_32k (batch 128 uncut),
               gemma2 decode_32k, gemma2 long_500k and qwen2 prefill_32k;
               ok, 4 devices, collectives equal to the formula, launches
               exact.
  path ep     — expert parallelism (the MoE layers' experts over "model",
               their d_ff over "data"): granite-moe-1b-a400m at full size
               in fp32 on meshes 1x4 and 2x2, and kimi-k2 at full width on
               its first 2 layers (bf16 weights computed in fp32) on 1x4,
               prefill and 4 teacher-forced decode steps (append and
               committed) against card 0 without a mesh: PATH_TOL_FP32,
               argmax and every expert choice equal (``ops.moe_route``
               wrapped), launches exact.
  serving ep  — phase 3's 8 requests through ServingEngine on mesh 1x4:
               granite in bf16 (tokens equal on every rank; TTFT, TPOT,
               busy, NCCL and idle a decode step by rank), granite in fp32
               compute (tokens equal to the one-card engine's), kimi-k2 at
               full width on the most layers four cards hold, reckoned
               from the specs (shards drawn on the cards), tokens equal on
               every rank.
  train ep    — granite at full width on its first 2 layers, fp32, two
               steps from count 99 against one card's step, as train tp:
               meshes 2x2, 4x1 and 1x4; expdata, fsdp and blockdispatch on
               2x2; granite with Adafactor on 2x2 (a gate-only config
               change); then kimi-k2's Adafactor step in bf16 on 2x2 on
               its first 2 layers (finite losses, equal on every rank,
               first cross-entropy in phase 8's band, collectives exact).
  dryrun ep   — granite's decode_32k on 1x4 (batch 128 uncut) and train_4k
               on 2x2 (the batch cut to the routing kernel's block: one
               row a card a microbatch); kimi-k2's decode_32k and train_4k
               not fitting, reckoned from the specs.
  profile tp  — each decode record's (granite's, rwkv6's, vision's and
               musicgen's too) H100x4
               MaxTput row beside the analytic H100x4 and H100 rows, the
               engine model's step beside the measured one.
  dryrun cli  — with tp, after the ranks have joined: `python -m
               repro_torch.launch.dryrun --cards 4 --mesh 1x4` for qwen2's
               decode_32k (its own four NCCL ranks) into
               results/dryrun_cli, held to dryrun tp's record of the cell
               (batch, operations, bytes, mesh, collective calls and link
               bytes by kind equal; both step times printed).
It ends with a {"kernels": [...]} line, the cards' names and power limits,
and the same last line with "count": 4.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
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
# the aux losses, relative: z_loss reaches ~60 at E = 384, where one fp32
# ulp is 3.8e-6 (tests/test_torch_moe.py)
AUX_RTOL = 1e-6
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
# Append-mode decode vs committed decode on the kernel path, fp32: the two
# differ only in where the decode kernel merges the new token (the combine
# pass against the split pass), ~1e-7 per attention call at O(1) inputs.
APPEND_TOL_FP32 = 1e-4
SLO_TPOT_S = 0.12           # the repo's tests' TPOT SLO (Melange(..., 0.12))
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
GEN_PROMPT, GEN_STEPS = 1024, 32    # phase 9: one prompt, decode steps
KIMI_CUT = ("kimi-k2-1t-a32b at full width (d_model 7168, 64/8 heads of 112, "
            "384 experts of d_ff 2048, top 8, vocab 163840), cut to its first "
            "2 of 61 layers: the dense layer 0 and one MoE layer, 19.3 B "
            "parameters, 38.6 GB in bf16 (33.8 GB of experts); all 61 layers "
            "are ~2 TB")
# phase 6's records beside qwen2's decode_32k: every other config's decode
# record that fits one card, rwkv6's long_500k, and qwen2's prefill and
# train records; then the cells that do not fit, each logged with why
DECODE_RECORDS = ("internlm2-1.8b", "minitron-4b", "gemma2-27b",
                  "granite-moe-1b-a400m", "rwkv6-1.6b")
NOT_FITTING = (("gemma2-27b", "long_500k"),
               ("jamba-1.5-large-398b", "decode_32k"),
               ("kimi-k2-1t-a32b", "decode_32k"))


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


def hot_logits(T: int, E: int) -> np.ndarray:
    """An adversarial route: experts 0 and 1 lead every row by 20, so they
    take all T tokens and drop above their capacity."""
    lg = (np.random.default_rng(T).standard_normal((T, E)) * 2).astype(
        np.float32)
    lg[:, :2] += 20.0
    return lg


# ---------------------------------------------------------------------------
# 8. training
# ---------------------------------------------------------------------------
TRAIN_SEQ, TRAIN_BATCH = 4096, 8   # train_4k's sequence, global batch 8
# arch, n_micro, steps, layers kept (None: all; see TRAIN_CUTS)
TRAIN_RUNS = [("qwen2-1.5b", 4, 6, None), ("granite-moe-1b-a400m", 8, 4, None),
              ("rwkv6-1.6b", 4, 3, None), ("jamba-1.5-large-398b", 8, 3, 1),
              ("llama-3.2-vision-11b", 8, 3, 10), ("musicgen-large", 4, 3, None)]
TRAIN_CUTS = {
    "jamba-1.5-large-398b":
        "layer 0 of 72 (Mamba + dense MLP) with the embeddings and head, full "
        "width, Adafactor: layer 1's MoE alone is 9.7 B parameters (16 "
        "experts x 3 x 8192 x 24576), which with its gradients does not fit "
        "one card; granite trains MoE",
    "llama-3.2-vision-11b":
        "the first 10 of 40 layers (two periods of a cross layer and 4 self "
        "layers), full width: 9.79 B parameters with AdamW need ~137 GB",
}
# tests/test_kernels.py::test_flash_vjp_matches_naive_autodiff
GRAD_TOL = 1e-4
# the trainable scans with the kernel forward: fp32 gradients against
# autograd through the sequential oracles, bf16 ones at the training shapes
# against the plain Functions; each relative to the gradient's largest
# magnitude
SCAN_GRAD_TOL, SCAN_BF16_TOL = 1e-4, 2e-2
# the scans' shapes in the training runs: rwkv6's micro batch of 2 at H 32,
# K 64; Jamba's layer 0 at micro batch 1, Din 16384, N 16
SCAN_TRAIN_SHAPES = {"rwkv6_scan": (2, TRAIN_SEQ, 32, 64),
                     "ssm_scan": (1, TRAIN_SEQ, 16384, 16)}
SCAN_KERNEL_NAMES = ("ssm_kernel", "walk_kernel", "carry_kernel")
# the plain backward each training run's profiled step marks in its trace,
# by layer kind: (ref function, label of the breakdown's keys)
MARKED_BWD = {"rwkv": ("rwkv6_scan_bwd", "scan"),
              "mamba": ("ssm_scan_bwd", "scan"),
              "attn": ("flash_attention_bwd", "attention")}
LOSS_RTOL, GNORM_RTOL, LEAF_TOL = 1e-5, 1e-4, 1e-3
RESUME_RTOL = 1e-6
FIRST_LOSS_RTOL = 0.1
CUBLAS_NAMES = ("gemm", "nvjet", "cutlass", "xmma", "cublas")
# the kernel of torch.cuda._sleep, launched before and after each plain
# attention backward call of the profiled train step to mark it in the trace
BWD_MARKER = "spin_kernel"


def library_flash_lse(torch, q, k, v, causal=True):
    """aten's flash attention with its lse: (B, H, S, Dh) q, k, v -> (out,
    lse (B, H, S), ...). Timed beside the kernel, never used by the
    port."""
    return torch.ops.aten._scaled_dot_product_flash_attention(q, k, v, 0.0,
                                                               causal)


def is_cublas(name: str) -> bool:
    return any(n in name.lower() for n in CUBLAS_NAMES)


def step_breakdown(prof, DeviceType, wall_ms: float, step_ms: float,
                   bwd_calls: int, what: str = "attention") -> dict:
    """Device ms of one profiled train step by kind, all read from the
    step's trace: the flash kernel, the scan kernels, the marked plain
    backward (``what``: the attention's or the scans'; the kernels between
    the two ``BWD_MARKER`` launches around each of its ``bwd_calls``
    calls; one stream, so the order of start times is the order of
    launch), cuBLAS inside and outside that backward, the rest, and the
    idle share against the profiled step's wall time and against the
    unprofiled median step. The backward's span (first marker to second,
    summed) shows how long the stream spent in it, idle gaps included."""
    evs = sorted((e for e in prof.events()
                  if e.device_type == DeviceType.CUDA
                  and e.self_device_time_total > 0),
                 key=lambda e: e.time_range.start)
    busy = flash = scan = cublas = bwd = bwd_cublas = span = 0.0
    inside, marks, opened, n, per = False, 0, 0.0, 0, {}
    for e in evs:
        if BWD_MARKER in e.name:
            marks += 1
            if inside:
                span += (e.time_range.start - opened) / 1e3
            opened = e.time_range.end
            inside = not inside
            continue
        ms = e.self_device_time_total / 1e3
        n += 1
        busy += ms
        per[e.name[:60]] = per.get(e.name[:60], 0.0) + ms
        flash += ms if "flash_" in e.name else 0.0
        scan += ms if any(k in e.name for k in SCAN_KERNEL_NAMES) else 0.0
        cublas += ms if is_cublas(e.name) else 0.0
        if inside:
            bwd += ms
            bwd_cublas += ms if is_cublas(e.name) else 0.0
    res = {"wall_ms": wall_ms, "device_busy_ms": busy, "kernels": n,
           "flash_kernel_ms": flash, "scan_kernel_ms": scan,
           "idle_share": 1 - busy / wall_ms,
           "idle_share_vs_unprofiled_step": 1 - busy / step_ms,
           "top_kernels_ms": sorted(per.items(), key=lambda kv: -kv[1])[:8]}
    if marks != 2 * bwd_calls or inside:
        res[f"{what}_backward_ms"] = (
            f"not measured: {marks} markers in the trace for {bwd_calls} "
            "calls")
        return res
    res.update({
        f"{what}_backward_ms": bwd,
        f"{what}_backward_calls": bwd_calls,
        f"{what}_backward_share_of_busy": bwd / busy,
        f"{what}_backward_span_ms": span,
        f"{what}_backward_span_share_of_wall": span / wall_ms,
        f"cublas_in_{what}_backward_ms": bwd_cublas,
        f"cublas_outside_{what}_backward_ms": cublas - bwd_cublas,
        "rest_ms": busy - flash - scan - bwd - (cublas - bwd_cublas)})
    return res


def cut(cfg, n):
    """The first ``n`` layers of a config (``dryrun.cut_depth``)."""
    from repro_torch.launch.dryrun import cut_depth
    return cut_depth(cfg, n)


def attention_flops(cfg, B: int, S: int) -> int:
    """Forward and backward (3x) FLOPs of a train step's attention scores
    and values: causal S x S for self layers, S x Nv for cross layers."""
    total = 0
    for spec in cfg.layer_specs():
        if spec.kind == "attn":
            pairs = S * cfg.n_vision_tokens if spec.attn_type == "cross" \
                else S * (S + 1) // 2
            total += 3 * 4 * B * pairs * cfg.n_heads * cfg.head_dim
    return total


def scan_gates(torch, rnd, err, time_ms, free, f32, bf16, ops, ref, rk, ss):
    """The trainable scans with the kernel forward (``ops`` on CUDA tensors
    that need a gradient). fp32, small shapes (T ragged against the
    segment and the chunks; WKV6 at mild and at strong decays, median w
    ~0.011): every input's gradient against autograd through the
    sequential oracle within SCAN_GRAD_TOL of its largest magnitude, and
    the kernel launched once a segment. bf16, at the training shapes
    (rwkv6: B 2, T 4096, H 32, K 64; Jamba's layer 0: B 1, T 4096, Din
    16384, N 16): outputs and gradients against the plain Functions
    (impl="plain") within SCAN_BF16_TOL of their largest magnitude, with
    the forward and the plain backward timed (the second call of each,
    CUDA events), the backward's peak extra bytes (the gradients it returns
    included), and the kernel alone over T (one launch) beside its
    bound. Returns {kernel: those numbers}."""
    def rwkv_args(B, Tn, H, K, dtype, mu=None):
        """r/k/v in ``dtype``; w = exp(-exp(z / 2 - 1)) (mild) or exp(-exp(
        z + mu)) (median exp(-e^mu)), z ~ N(0, 1); u and state fp32."""
        r, k, v = (rnd((B, Tn, H, K), f32) * 0.5 for _ in range(3))
        z = rnd((B, Tn, H, K), f32)
        w = torch.exp(-torch.exp(z * 0.5 - 1 if mu is None else z + mu))
        return [r.to(dtype), k.to(dtype), v.to(dtype), w,
                rnd((H, K), f32) * 0.3, rnd((B, H, K, K), f32) * 0.1]

    def ssm_args(B, Tn, Din, N, dtype):
        dt = torch.nn.functional.softplus(rnd((B, Tn, Din), f32)) * 0.1
        return [rnd((B, Tn, Din), dtype), dt,
                -torch.exp(rnd((Din, N), f32) * 0.3), rnd((B, Tn, N), dtype),
                rnd((B, Tn, N), dtype), rnd((Din,), f32),
                rnd((B, Din, N), f32) * 0.1]

    scans = {"rwkv6_scan": (ops.rwkv6_scan, rk, ref.rwkv6_sequential),
             "ssm_scan": (ops.ssm_scan, ss, ref.ssm_sequential)}
    res = {"fp32_cases": [], "segment": ref.SCAN_SEGMENT}
    worst = {}
    # name, shape (T = 300: two segments, the last ragged; T = 45: one,
    # no multiple of a chunk), mild / strong decays
    for name, shape, mu in (("rwkv6_scan", (2, 300, 4, 64), None),
                            ("rwkv6_scan", (2, 300, 4, 64), 1.5),
                            ("rwkv6_scan", (1, 45, 2, 16), 1.5),
                            ("ssm_scan", (2, 300, 64, 16), None),
                            ("ssm_scan", (1, 45, 24, 8), None)):
        entry, mod, oracle = scans[name]
        args = (rwkv_args(*shape, f32, mu) if name == "rwkv6_scan"
                else ssm_args(*shape, f32))
        got = [a.clone().requires_grad_(True) for a in args]
        before = mod.launches
        outs = entry(*got)
        segs = len(ref.scan_segments(shape[1]))
        if mod.launches - before != segs or "Trainable" not in \
                type(outs[0].grad_fn).__name__:
            raise AssertionError(f"{name} {shape}: {mod.launches - before} "
                                 f"launches for {segs} segments, grad_fn "
                                 f"{type(outs[0].grad_fn).__name__}")
        cot = [rnd(o.shape, f32) for o in outs]
        torch.autograd.backward(outs, cot)
        want = [a.clone().requires_grad_(True) for a in args]
        ref_outs = oracle(*want)
        torch.autograd.backward(ref_outs, cot)
        e_out = max(err(a, b) for a, b in zip(outs, ref_outs))
        e_grad = max(err(a.grad, b.grad) / float(b.grad.abs().max())
                     for a, b in zip(got, want))
        case = {"scan": name, "shape": list(shape), "decay_mu": mu,
                "launches": segs,
                "out_max_abs_err": e_out, "grad_max_err_over_max": e_grad}
        res["fp32_cases"].append(case)
        if not (e_out < SCAN_TOL and e_grad < SCAN_GRAD_TOL):
            raise AssertionError(f"trainable {case}")
        worst[name] = max(worst.get(name, 0.0), e_grad)
    res["fp32_worst_grad_err_over_max"] = worst

    def timed(fn):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        ev[0].record()
        out = fn()
        ev[1].record()
        torch.cuda.synchronize()
        return out, ev[0].elapsed_time(ev[1])

    bf16_size = 2
    for name, shape in SCAN_TRAIN_SHAPES.items():
        entry, mod, _ = scans[name]
        args = (rwkv_args(*shape, bf16) if name == "rwkv6_scan"
                else ssm_args(*shape, bf16))
        row = {"shape": list(shape), "dtype": "bf16 (w, dt, A, D, u and "
               "states fp32)",
               "segments": len(ref.scan_segments(shape[1]))}
        cot = None
        runs = {}
        for impl in ("plain", None):
            for _ in range(2):      # the second, warm, forward and backward
                got = [a.clone().requires_grad_(True) for a in args]
                before = mod.launches
                outs, fwd_ms = timed(lambda: entry(*got, impl=impl))
                launched = mod.launches - before
                if cot is None:
                    cot = [rnd(o.shape, f32).to(o.dtype) for o in outs]
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                grads, bwd_ms = timed(lambda: torch.autograd.grad(outs, got,
                                                                  cot))
                peak = torch.cuda.max_memory_allocated() - base
            key = "kernel" if impl is None else "plain"
            runs[key] = (outs, grads)
            row[f"{key}_forward_ms"] = fwd_ms
            row[f"{key}_forward_launches"] = launched
            row[f"backward_ms_after_{key}_forward"] = bwd_ms
            row[f"backward_peak_extra_bytes_after_{key}_forward"] = peak
            del got
        (ok, gk), (op, gp) = runs["kernel"], runs["plain"]
        row["out_err_over_max"] = max(err(a, b) / float(b.abs().max())
                                      for a, b in zip(ok, op))
        row["grad_err_over_max"] = max(err(a, b) / float(b.abs().max())
                                       for a, b in zip(gk, gp))
        if row["kernel_forward_launches"] != row["segments"] \
                or row["plain_forward_launches"] \
                or not (row["out_err_over_max"] < SCAN_BF16_TOL
                        and row["grad_err_over_max"] < SCAN_BF16_TOL):
            raise AssertionError(f"trainable {name} bf16: {row}")
        del runs, ok, gk, op, gp
        # the kernel alone over the whole T (one launch) and its bound
        kernel = getattr(mod, name)
        row["kernel_one_launch_ms"] = time_ms(kernel, [args], iters=5)
        if name == "rwkv6_scan":
            B, Tn, H, K = shape
            n = B * Tn * H * K
            nbytes = n * (3 * bf16_size + 4 + bf16_size) + H * K * 4 \
                + 2 * B * H * K * K * 4
            n_ops = 5 * B * Tn * H * K * K
        else:
            B, Tn, Din, N = shape
            n = B * Tn * Din
            nbytes = n * (2 * bf16_size + 4) + 2 * B * Tn * N * bf16_size \
                + Din * N * 4 + Din * 4 + 2 * B * Din * N * 4
            n_ops = n * (7 * N + 3)
        bound = {"bytes": nbytes / PEAK_BYTES * 1e3,
                 "operations": n_ops / PEAK_FP32_FLOPS * 1e3}
        row.update({"bound_ms": max(bound.values()),
                    "bound_by": max(bound, key=bound.get), "bytes": nbytes,
                    "operations": n_ops})
        res[name] = row
        del args, cot
        free()
    return res


def training_phase(torch, dev, rnd, err, time_ms, free, zero_launches,
                   read_launches):
    """Phase 8: the lse kernel, the attention gradient (ragged blocks
    included), the trainable scans' gradients, one train step on the
    kernel path against the plain path, training of qwen2, granite,
    rwkv6, Jamba (cut), llama-3.2-vision (cut) and musicgen through
    ``train_loop.train``, and resume after a failure. Returns (the kernels
    line's lse row, {path: launches}, {scan kernel: its training-shape
    numbers})."""
    import statistics
    import tempfile

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import rwkv6_scan as rk
    from repro_torch.kernels import ssm_scan as ss
    from repro_torch.launch.steps import build_train_step, value_and_grad
    from repro_torch.models import transformer as T
    from repro_torch.training.data import DataConfig, SyntheticDataset
    from repro_torch.training.train_loop import (TrainConfig, train,
                                                 vision_embeddings)

    t_phase = time.perf_counter()
    f32, bf16 = torch.float32, torch.bfloat16
    launches_by_path = {}

    # -- lse gate: the kernel's out and lse against ref.blockwise_fwd_lse --
    lse_cases = [  # B, Sq, Skv, H, KVH, Dh, window, softcap
        (1, 1024, 1024, 12, 2, 128, None, None),       # qwen2
        (1, 1024, 1024, 12, 2, 128, 256, None),
        (1, 1024, 1024, 12, 2, 128, None, 30.0),
        (1, 1024, 1024, 12, 2, 128, 200, 50.0),
        (1, 1024, 1024, 16, 8, 64, None, None),        # granite
        (1, 1024, 1024, 16, 8, 64, 256, None),
        (1, 1024, 1024, 16, 8, 64, None, 30.0),
        (1, 1024, 1024, 16, 8, 64, 100, 50.0),
        (1, 4096, 4096, 16, 8, 64, None, None),        # granite's micro batch
        (1, 256, 64, 4, 2, 64, 16, None),              # rows 79.. masked
    ]
    lse_err = {}
    for dtype in (f32, bf16):
        key = str(dtype).split(".")[-1]
        tol = TOL[key]
        for B, Sq, Skv, H, KVH, Dh, window, cap in lse_cases:
            case = (B, Sq, Skv, H, KVH, Dh, window, cap, key)
            q = rnd((B, Sq, H, Dh), dtype)
            k, v = rnd((B, Skv, KVH, Dh), dtype), rnd((B, Skv, KVH, Dh), dtype)
            out, lse = fa.flash_attention(q, k, v, window=window,
                                          softcap=cap, lse=True)
            out_p, lse_p = ref.blockwise_fwd_lse(q, k, v, window=window,
                                                 softcap=cap)
            e_out, e_lse = err(out, out_p), err(lse, lse_p)
            if not (e_out < tol and e_lse < tol):
                raise AssertionError(f"flash lse {case}: out {e_out}, lse "
                                     f"{e_lse} >= {tol}")
            dead = lse_p == ref.NEG_INF
            if Sq > Skv and not (bool(dead.any())
                                 and torch.equal(lse == ref.NEG_INF, dead)
                                 and not bool(out[:, Skv + window - 1:]
                                              .any())):
                raise AssertionError(f"flash lse {case}: fully masked rows")
            if not torch.equal(out, fa.flash_attention(
                    q, k, v, window=window, softcap=cap)):
                raise AssertionError(f"flash lse {case}: out differs from "
                                     "the kernel without lse")
            lse_err[key] = max(lse_err.get(key, 0.0), e_out, e_lse)

    # -- attention gradient gate: the CUDA autograd.Function against
    # autograd through ref.attention_naive, fp32 --------------------------
    grad_err = 0.0
    for H, KVH, Dh in ((12, 2, 128), (16, 8, 64)):
        q, do = rnd((1, 1024, H, Dh), f32), rnd((1, 1024, H, Dh), f32)
        k, v = rnd((1, 1024, KVH, Dh), f32), rnd((1, 1024, KVH, Dh), f32)
        got = [t.clone().requires_grad_(True) for t in (q, k, v)]
        before = fa.launches
        out = ops.flash_attention(*got)
        if fa.launches != before + 1 or type(out.grad_fn).__name__ != \
                "FlashAttentionTrainableBackward":
            raise AssertionError("the differentiable call did not launch "
                                 "the kernel through the trainable path")
        out.backward(do)
        want = [t.clone().requires_grad_(True) for t in (q, k, v)]
        ref.attention_naive(*want).backward(do)
        for name, a, b in zip("qkv", got, want):
            e = err(a.grad, b.grad)
            if not e < GRAD_TOL:
                raise AssertionError(f"d{name} H={H} KVH={KVH} Dh={Dh}: "
                                     f"{e} >= {GRAD_TOL}")
            grad_err = max(grad_err, e)
    # the same at the vision cross layers' keys: non-causal over Skv =
    # 1600 and 1601, a ragged last block of the backward's 1024 keys
    ragged_err = 0.0
    for Skv in (1600, 1601):
        q, do = rnd((1, 1024, 32, 128), f32), rnd((1, 1024, 32, 128), f32)
        k, v = rnd((1, Skv, 8, 128), f32), rnd((1, Skv, 8, 128), f32)
        got = [t.clone().requires_grad_(True) for t in (q, k, v)]
        before = fa.launches
        out = ops.flash_attention(*got, causal=False)
        if fa.launches != before + 1 or type(out.grad_fn).__name__ != \
                "FlashAttentionTrainableBackward":
            raise AssertionError(f"Skv={Skv}: the differentiable call did "
                                 "not launch the kernel through the "
                                 "trainable path")
        out.backward(do)
        want = [t.clone().requires_grad_(True) for t in (q, k, v)]
        ref.attention_naive(*want, causal=False).backward(do)
        for name, a, b in zip("qkv", got, want):
            e = err(a.grad, b.grad)
            if not e < GRAD_TOL:
                raise AssertionError(f"d{name} non-causal Skv={Skv}: {e} >= "
                                     f"{GRAD_TOL}")
            ragged_err = max(ragged_err, e)
    del q, k, v, do, got, want, out
    free()
    print(f"train kernels: {2 * len(lse_cases)} lse cases, max abs err "
          f"{json.dumps(lse_err)}; attention gradient max abs err "
          f"{grad_err}, non-causal Skv 1600 / 1601 (ragged blocks) "
          f"{ragged_err} (tol {GRAD_TOL}); "
          f"{time.perf_counter() - t_phase:.1f} s into phase 8", flush=True)

    scan_train = scan_gates(torch, rnd, err, time_ms, free, f32, bf16, ops,
                            ref, rk, ss)
    print(f"train scans: {json.dumps(scan_train)}; "
          f"{time.perf_counter() - t_phase:.1f} s into phase 8", flush=True)

    # -- the lse variant's times at qwen2's training micro batch ---------
    Bm, S, H, KVH, Dh = 2, TRAIN_SEQ, 12, 2, 128
    G = H // KVH
    sets = [(rnd((Bm, S, H, Dh), bf16), rnd((Bm, S, KVH, Dh), bf16),
             rnd((Bm, S, KVH, Dh), bf16)) for _ in range(3)]
    lib_sets = [(a.transpose(1, 2).contiguous(),
                 b.repeat_interleave(G, dim=2).transpose(1, 2).contiguous(),
                 c.repeat_interleave(G, dim=2).transpose(1, 2).contiguous())
                for a, b, c in sets]

    def with_lse(a, b, c):
        return fa.flash_attention(a, b, c, lse=True)

    def without_lse(a, b, c):
        return fa.flash_attention(a, b, c)

    def library(a, b, c):
        return library_flash_lse(torch, a, b, c)

    out, lse = with_lse(*sets[0])
    out_p, lse_p = ref.blockwise_fwd_lse(*sets[0])
    lib_out = library(*lib_sets[0])
    do = rnd((Bm, S, H, Dh), bf16)
    bwd_args = (*sets[0], out, lse, do)
    pairs = Bm * S * (S + 1) // 2
    flops = 4 * H * Dh * pairs
    nbytes = 2 * (2 * Bm * S * H * Dh + 2 * Bm * S * KVH * Dh) \
        + 4 * Bm * H * S
    bound = {"operations": flops / PEAK_BF16_FLOPS * 1e3,
             "bytes": nbytes / PEAK_BYTES * 1e3}
    bwd_flops = 2.5 * flops     # dS, dP, dQ, dK, dV products with S again
    lse_row = {
        "name": "flash_attention_lse", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:92",
        "tpu_kernel": "src/repro/kernels/flash_attention.py:92",
        "entry": "ops.flash_attention under autograd (training forward and "
                 "its recompute)",
        "shape": f"B={Bm} Sq=Skv={S} H={H} KVH={KVH} Dh={Dh} bf16 causal, "
                 "lse fp32",
        "max_abs_err": max(err(out, out_p), err(lse, lse_p)),
        "tol": TOL["bfloat16"],
        # a call runs ~0.3 ms, far longer than it takes to issue, so CUDA
        # events around calls back to back time the device; short profiler
        # sessions dropped launches of it on an H100
        "timer": "CUDA events, back to back",
        "ms": time_ms(with_lse, sets, iters=20),
        "no_lse_ms": time_ms(without_lse, sets, iters=20),
        "plain_ms": time_ms(lambda a, b, c: ref.blockwise_fwd_lse(a, b, c),
                            sets, iters=3),
        "library_ms": time_ms(library, lib_sets, iters=20),
        "library_max_abs_err": max(
            err(lib_out[0].transpose(1, 2), out),
            err(lib_out[1].reshape(lse.shape), lse)),
        "library": "torch.ops.aten._scaled_dot_product_flash_attention "
                   "(out and lse)",
        "bound_ms": max(bound.values()),
        "bound_by": max(bound, key=bound.get),
        "flops": flops, "bytes": nbytes,
        "attention_backward_plain_ms": time_ms(
            lambda *a: ref.flash_attention_bwd(*a), [bwd_args], iters=3),
        "attention_backward_bound_ms": bwd_flops / PEAK_BF16_FLOPS * 1e3,
    }
    lse_row["kernel_ms"] = lse_row["ms"]
    if not lse_row["max_abs_err"] < lse_row["tol"]:
        raise AssertionError(f"flash lse at the training shape: "
                             f"{lse_row['max_abs_err']}")
    del sets, lib_sets, bwd_args, out, lse, out_p, lse_p, lib_out, do
    free()
    print(f"lse timing (CUDA events): {lse_row['ms']:.5f} ms with lse, "
          f"{lse_row['no_lse_ms']:.5f} without; plain backward "
          f"{lse_row['attention_backward_plain_ms']:.3f} ms; "
          f"{time.perf_counter() - t_phase:.1f} s into phase 8", flush=True)

    # -- the lse kernel at the new training runs' shapes: the vision cross
    # layers (non-causal over 1600 keys, 32/8 heads of 128, micro batch 1)
    # and musicgen (causal, 32/32 heads of 64, micro batch 2) --------------
    lse_row["train_shapes"] = {}
    for what, (Bm, Sq, Skv, H, KVH, Dh, causal) in (
            ("vision cross", (1, TRAIN_SEQ, 1600, 32, 8, 128, False)),
            ("musicgen", (2, TRAIN_SEQ, TRAIN_SEQ, 32, 32, 64, True))):
        G = H // KVH
        sets = [(rnd((Bm, Sq, H, Dh), bf16), rnd((Bm, Skv, KVH, Dh), bf16),
                 rnd((Bm, Skv, KVH, Dh), bf16)) for _ in range(3)]
        lib_sets = [(a.transpose(1, 2).contiguous(),
                     b.repeat_interleave(G, dim=2).transpose(1, 2)
                     .contiguous(),
                     c.repeat_interleave(G, dim=2).transpose(1, 2)
                     .contiguous()) for a, b, c in sets]
        out, lse = fa.flash_attention(*sets[0], causal=causal, lse=True)
        out_p, lse_p = ref.blockwise_fwd_lse(*sets[0], causal=causal)
        pairs = Bm * (Sq * (Sq + 1) // 2 if causal else Sq * Skv)
        flops = 4 * H * Dh * pairs
        nbytes = 2 * (2 * Bm * Sq * H * Dh + 2 * Bm * Skv * KVH * Dh) \
            + 4 * Bm * H * Sq
        bound = {"operations": flops / PEAK_BF16_FLOPS * 1e3,
                 "bytes": nbytes / PEAK_BYTES * 1e3}
        do = rnd((Bm, Sq, H, Dh), bf16)
        row = {"shape": f"B={Bm} Sq={Sq} Skv={Skv} H={H} KVH={KVH} Dh={Dh} "
                        f"bf16 {'causal' if causal else 'non-causal'}",
               "max_abs_err": max(err(out, out_p), err(lse, lse_p)),
               "ms": time_ms(lambda a, b, c: fa.flash_attention(
                   a, b, c, causal=causal, lse=True), sets, iters=10),
               "plain_ms": time_ms(lambda a, b, c: ref.blockwise_fwd_lse(
                   a, b, c, causal=causal), sets, iters=2),
               "library_ms": time_ms(lambda a, b, c: library_flash_lse(
                   torch, a, b, c, causal), lib_sets, iters=10),
               "bound_ms": max(bound.values()),
               "bound_by": max(bound, key=bound.get),
               "attention_backward_plain_ms": time_ms(
                   lambda *a: ref.flash_attention_bwd(*a, causal=causal),
                   [(*sets[0], out, lse, do)], iters=1)}
        if not row["max_abs_err"] < TOL["bfloat16"]:
            raise AssertionError(f"flash lse {what}: {row}")
        lse_row["train_shapes"][what] = row
        del sets, lib_sets, out, lse, out_p, lse_p, do
        free()
    print(f"train kernel shapes (CUDA events): "
          f"{json.dumps(lse_row['train_shapes'])}; "
          f"{time.perf_counter() - t_phase:.1f} s into phase 8", flush=True)

    def batch_of(cfg, B, S, step=0):
        data = SyntheticDataset(DataConfig(vocab_size=cfg.vocab_size,
                                           seq_len=S, global_batch=B,
                                           n_codebooks=cfg.n_codebooks))
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in data.batch(step).items()}
        if cfg.n_vision_tokens:
            batch["vision_embeds"] = vision_embeddings(
                cfg, TrainConfig(global_batch=B, seq_len=S), step, dev)
        return batch

    def expected_train(cfg, micro, steps, S=TRAIN_SEQ):
        """Launches per kernel of ``steps`` train steps of ``micro``
        microbatches of length S: every attention, MoE and scan layer's
        forward and its recompute (a scan launches once a segment)."""
        kinds = [s.kind for s in cfg.layer_specs()]
        n_moe = sum(s.mlp == "moe" for s in cfg.layer_specs())
        per = 2 * micro * steps if cfg.remat else micro * steps
        segs = len(ref.scan_segments(S))
        return {"flash_attention": kinds.count("attn") * per,
                "decode_attention": 0, "moe_gating": n_moe * per,
                "rwkv6_scan": kinds.count("rwkv") * segs * per,
                "ssm_scan": kinds.count("mamba") * segs * per}

    # -- path gate: one train step's loss and gradients, kernel vs plain --
    path_res = []
    for name, keep in (("qwen2-1.5b", 2), ("granite-moe-1b-a400m", 2),
                       ("rwkv6-1.6b", 2), ("jamba-1.5-large-398b", 1),
                       ("llama-3.2-vision-11b", 2)):
        cfg = dataclasses.replace(cut(get_config(name), keep),
                                  dtype="float32", param_dtype="float32")
        model = T.Transformer(cfg, device="cuda", generator=torch.Generator(
            device=dev).manual_seed(0))
        batch = batch_of(cfg, 2, 1024)
        runs = {}
        for impl in ("cuda", "plain"):
            routes = []
            route = ops.moe_route

            def recording_route(logits, top_k, **kw):
                res = route(logits, top_k, **kw)
                routes.append((res[1], res[2]))
                return res

            ops.moe_route = recording_route
            zero_launches()
            try:
                loss, metrics, grads = value_and_grad(cfg, model, batch,
                                                      impl=impl)
            finally:
                ops.moe_route = route
            torch.cuda.synchronize()
            runs[impl] = (loss, grads, routes, read_launches())
        (lk, gk, rk_, nk), (lp, gp, rp, np_) = runs["cuda"], runs["plain"]
        if nk != expected_train(cfg, 1, 1, 1024) or any(np_.values()):
            raise AssertionError(f"path {name}: launches {nk} (kernel), "
                                 f"{np_} (plain)")
        gnorm = {i: float(torch.sqrt(sum((g.float() ** 2).sum()
                                         for g in gr.values())))
                 for i, gr in (("cuda", gk), ("plain", gp))}
        leaf = max(err(gk[n], gp[n]) / max(float(gp[n].abs().max()), 1e-30)
                   for n in gp)
        choices = sum(a[0].numel() for a in rk_)
        differing = sum(int((a[0] != b[0]).sum()) for a, b in zip(rk_, rp))
        slots = sum(int((a[1] != b[1]).sum()) for a, b in zip(rk_, rp))
        n_moe = sum(s.mlp == "moe" for s in cfg.layer_specs())
        res = {"model": cfg.name, "layers": cfg.n_layers, "dtype": "float32",
               "batch": [2, 1024], "loss": [float(lk), float(lp)],
               "loss_rel_err": abs(float(lk) - float(lp)) / abs(float(lp)),
               "grad_norm": [gnorm["cuda"], gnorm["plain"]],
               "grad_norm_rel_err": abs(gnorm["cuda"] - gnorm["plain"])
               / gnorm["plain"],
               "max_leaf_err_over_leaf_max": leaf,
               "routing_calls": len(rk_), "expert_choices": choices,
               "differing_choices": differing, "differing_slots": slots,
               "launches": nk}
        res["seconds_into_phase"] = time.perf_counter() - t_phase
        print(f"train path: {json.dumps(res)}", flush=True)
        if not (res["loss_rel_err"] < LOSS_RTOL
                and res["grad_norm_rel_err"] < GNORM_RTOL
                and leaf < LEAF_TOL):
            raise AssertionError(f"train path {name}: {res}")
        if len(rk_) != 2 * n_moe or len(rp) != 2 * n_moe or differing \
                or slots:
            raise AssertionError(f"train path {name}: routes {res}")
        path_res.append(res)
        del model, batch, runs, gk, gp
        free()

    # -- training runs: full size, or cut in depth at full width ------------
    for name, micro, steps, keep in TRAIN_RUNS:
        cfg = get_config(name)
        if keep is not None:
            cfg = cut(cfg, keep)
        t0 = time.perf_counter()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_launches()
        out = train(cfg, TrainConfig(steps=steps, global_batch=TRAIN_BATCH,
                                     seq_len=TRAIN_SEQ, n_micro=micro,
                                     log_every=1),
                    device="cuda", log_fn=lambda s: print(f"  {s}"))
        torch.cuda.synchronize()
        launches = read_launches()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        wall = time.perf_counter() - t0
        want = expected_train(cfg, micro, steps)
        if launches != want:
            raise AssertionError(f"train {name}: launches {launches}, "
                                 f"expected {want}")
        launches_by_path[f"{name} train"] = launches
        # random weights: a unit-RMS final hidden state through a head of
        # std 0.02 gives logits of std sigma = 0.02 sqrt(D), uncorrelated
        # with the labels, so the first cross-entropy is near ln V +
        # sigma^2 / 2 (0.31 for qwen2's D = 1536, 1.64 for Jamba's 8192);
        # the loss adds 1e-2 lb_loss + 1e-3 z_loss summed over the MoE
        # layers (~5 more for granite's 24), so the CE is gated
        ce0 = out["metrics"][0]["ce"]
        ce_center = math.log(cfg.vocab_size) + 0.5 * 0.02 ** 2 * cfg.d_model
        first_ok = abs(ce0 - ce_center) \
            <= FIRST_LOSS_RTOL * math.log(cfg.vocab_size)
        grad_norms = [m["grad_norm"] for m in out["metrics"]]
        if not (all(map(math.isfinite, out["losses"] + grad_norms))
                and first_ok):
            raise AssertionError(f"train {name}: losses {out['losses']}, "
                                 f"first ce {ce0}, grad norms {grad_norms}")
        # one more step under the profiler (the device's kernels only: a
        # trace of the host's ops would slow the step and its reading),
        # its launches counted alone
        step_ms = statistics.median(out["step_ms"][1:])
        model, opt_state = out["model"], out["opt_state"]
        step_fn = build_train_step(cfg, n_micro=micro)
        batch = batch_of(cfg, TRAIN_BATCH, TRAIN_SEQ, steps)
        # the calls of the plain backward of the step's recurrent layers,
        # else of its attention, are marked in its trace
        kinds = [s.kind for s in cfg.layer_specs()]
        kind = next(k for k in MARKED_BWD if k in kinds)
        fn_name, label = MARKED_BWD[kind]
        t_prof = time.perf_counter()
        plain_bwd = getattr(ref, fn_name)

        def marked_bwd(*a, **kw):
            torch.cuda._sleep(1)
            res = plain_bwd(*a, **kw)
            torch.cuda._sleep(1)
            return res

        breakdown = "not measured"
        for _ in range(3):   # a session without device records is retried
            zero_launches()
            setattr(ref, fn_name, marked_bwd)
            try:
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    h0 = time.perf_counter()
                    opt_state, _ = step_fn(model, opt_state, batch)
                    torch.cuda.synchronize()
                    prof_wall = (time.perf_counter() - h0) * 1e3
            finally:
                setattr(ref, fn_name, plain_bwd)
            if read_launches() != expected_train(cfg, micro, 1):
                raise AssertionError(f"train {name}: profiled step "
                                     f"launches {read_launches()}")
            # one pass over the trace's events (reading ~400k of them, an
            # rwkv6 step's, takes over a minute)
            breakdown = step_breakdown(prof, DeviceType, prof_wall, step_ms,
                                       kinds.count(kind) * micro, label)
            if breakdown["kernels"]:
                break
            breakdown = "not measured"
        del model, opt_state, step_fn, batch, prof
        free()
        print(f"  profiled step read in "
              f"{time.perf_counter() - t_prof:.1f} s", flush=True)
        tokens = TRAIN_BATCH * TRAIN_SEQ
        n_params = T.count_params(cfg, active_only=any(
            s.mlp == "moe" for s in cfg.layer_specs()))
        model_flops = 6 * n_params * tokens \
            + attention_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)
        line = {
            "model": name, "layers": cfg.n_layers, "cut": TRAIN_CUTS.get(name),
            "dtype": cfg.dtype, "optimizer": cfg.optimizer,
            "remat": cfg.remat, "global_batch": TRAIN_BATCH,
            "seq_len": TRAIN_SEQ, "n_micro": micro, "steps": steps,
            "losses": out["losses"], "grad_norms": grad_norms,
            "first_step": out["metrics"][0],
            "first_ce_vs_expected": [ce0, ce_center],
            "step_ms_all": out["step_ms"], "step_ms": step_ms,
            "step_timer": out["step_timer"] + ", median of steps 2..",
            "tokens_per_s": tokens / (step_ms / 1e3),
            "peak_mem_gb": peak_gb,
            "params_counted": n_params,
            "model_flops_per_step": model_flops,
            "mfu_6N_plus_attn_vs_989tflops":
                model_flops / (step_ms / 1e3) / PEAK_BF16_FLOPS,
            "launches": launches, "wall_s": wall,
            "profiled_step": breakdown,
        }
        print(f"train: {json.dumps(line)}", flush=True)
        del out
        free()

    # -- resume gate: qwen2 at full width, 2 layers --------------------------
    cfg = cut(get_config("qwen2-1.5b"), 2)
    tc = dict(steps=6, global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
              n_micro=4, log_every=100, ckpt_every=3)
    whole = train(cfg, TrainConfig(**tc), device="cuda",
                  log_fn=lambda s: None)["losses"]
    free()
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    t0 = time.perf_counter()
    try:
        try:
            train(cfg, TrainConfig(**tc, ckpt_dir=ckpt_dir), fail_at_step=4,
                  device="cuda", log_fn=lambda s: None)
            raise AssertionError("resume: the injected failure did not "
                                 "happen")
        except RuntimeError as e:
            if "injected failure at step 4" not in str(e):
                raise
        free()
        logs = []
        resumed = train(cfg, TrainConfig(**tc, ckpt_dir=ckpt_dir),
                        device="cuda", log_fn=logs.append)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    rel = max(abs(a - b) / abs(b) for a, b in
              zip(resumed["losses"], whole[3:]))
    res = {"model": cfg.name, "layers": cfg.n_layers, "steps": 6,
           "checkpoint_at": 3, "failure_at": 4,
           "resumed_from": resumed["resumed_from"],
           "losses_uninterrupted": whole, "losses_resumed": resumed["losses"],
           "bitwise": resumed["losses"] == whole[3:], "max_rel_diff": rel,
           "tol": RESUME_RTOL, "seconds": time.perf_counter() - t0}
    print(f"train resume: {json.dumps(res)}", flush=True)
    if resumed["resumed_from"] != 3 or len(resumed["losses"]) != 3 \
            or logs != ["[train] resumed from step 3"] \
            or not rel <= RESUME_RTOL:
        raise AssertionError(f"resume: {res}")
    del resumed
    free()
    print(f"phase 8 (training): {time.perf_counter() - t_phase:.1f} s")
    return lse_row, launches_by_path, scan_train


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.core.accelerators import PAPER_GPUS
    from repro_torch.core.engine_model import EngineModel, ModelPerf
    from repro_torch.core.profiler import (
        decode_bytes_per_step_base_from_record,
        decode_flops_per_token_from_record, profile_catalog,
        profile_from_dryrun)
    from repro_torch.core.workload import bucket_grid
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gating as mg
    from repro_torch.kernels import rwkv6_scan as rk
    from repro_torch.kernels import ssm_scan as ss
    from repro_torch.launch import dryrun
    from repro_torch.models import transformer as T
    from repro_torch.models.moe import capacity
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

    def aux_check(what, got, want):
        """The aux losses within AUX_RTOL relative."""
        for name, w in want.items():
            g, w = float(got[name]), float(w)
            if not abs(g - w) <= AUX_RTOL * abs(w):
                raise AssertionError(f"{what}: {name} {g} vs plain {w}")

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

    # how device_ms took each time: a profiler session on the first try, on
    # a retry, or CUDA events behind a spin (printed as "device timer:")
    timer_use = {"profiler": 0, "profiler_retry": 0, "events_behind_spin": 0}

    def queued_ms(fn, args_sets, iters):
        """Device ms per call without the profiler: the calls are queued
        behind a spin kernel that outlasts the host's issue time, so the
        two events bracket the device running them back to back."""
        torch.cuda.synchronize()
        h0 = time.perf_counter()
        for i in range(iters):
            fn(*args_sets[i % len(args_sets)])
        issue_s = time.perf_counter() - h0
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        # clock64 cycles at <= 1.98 GHz: 3x the issue time, at least 1 ms
        torch.cuda._sleep(int(max(3 * issue_s, 1e-3) * 2e9))
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
        and this the device. A profiler session that sees no device time
        (CUPTI drops a session's records now and then) is retried twice,
        then the calls are timed by queued_ms."""
        for i in range(3):
            fn(*args_sets[i % len(args_sets)])
        torch.cuda.synchronize()
        for attempt in range(3):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for i in range(iters):
                    fn(*args_sets[i % len(args_sets)])
                torch.cuda.synchronize()
            total = sum(e.self_device_time_total
                        for e in prof.key_averages()
                        if e.device_type == DeviceType.CUDA)
            if total > 0:
                timer_use["profiler_retry" if attempt else "profiler"] += 1
                return total / 1e3 / iters
        timer_use["events_behind_spin"] += 1
        return queued_ms(fn, args_sets, iters)

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
        (1, 1024, 1600, 32, 8, 128, False, None, None),  # vision cross
        (1, 1000, 1600, 32, 8, 128, False, None, None),  # vision cross path
        (1, 200, 1601, 32, 8, 128, False, None, None),  # ragged last kv tile
        (1, 1024, 1024, 32, 32, 64, True, None, None),  # musicgen, G = 1
        (1, 1000, 1000, 32, 32, 64, True, None, None),  # musicgen path
        (1, 1024, 1024, 64, 8, 112, True, None, None),  # kimi-k2 serving
        (1, 1000, 1000, 64, 8, 112, True, None, None),  # kimi-k2 path
        (1, 200, 200, 64, 8, 112, True, None, None),    # Dh 112: ragged
        (2, 129, 129, 64, 8, 112, True, 24, 30.0),      # window < one tile
        (1, 100, 161, 64, 8, 112, False, None, None),   # ragged Sq != Skv
        (1, 8, 8, 64, 8, 112, True, None, None),        # smallest padded
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
        (8, 1600, 32, 8, 128, None, None, [1600] * 8),  # vision cross
        (2, 1601, 32, 8, 128, None, None, [1601, 1601]),  # ragged, whole
        (8, 2048, 32, 32, 64, None, None, None),        # musicgen, G = 1
        (8, 2048, 64, 8, 112, None, None, None),        # kimi-k2 serving
        (4, 2048, 64, 8, 112, None, None, [2048, 0, 1, 900]),  # Dh 112
        (8, 2048, 64, 8, 112, 50, 30.0, None),          # window < one split
        (3, 300, 64, 8, 112, 64, None, [300, 0, 129]),  # ragged last tile
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

    # append mode: the cache read-only with `lengths` old tokens, the new
    # token's k_new / v_new merged by the combine pass. Against the plain
    # version with k_new / v_new, and against the committed kernel over the
    # cache with the token written at lengths and lengths + 1 (the
    # reference's contract, tests/test_kernels.py::
    # test_decode_append_mode_parity); lengths 0 must give exactly v_new.
    append_cases = [  # B, S, H, KVH, Dh, window, softcap, lengths
        (8, 2048, 12, 2, 128, None, None, None),        # qwen2 serving
        (8, 2048, 16, 8, 64, None, None, None),         # granite serving
        (3, 300, 12, 2, 128, None, None, [0, 1, 299]),  # lengths 0, 1, S-1
        (4, 2048, 12, 2, 128, None, None, [2047, 0, 1, 1000]),
        (8, 2048, 12, 2, 128, 50, None, None),          # window < one split
        (4, 2048, 12, 2, 128, 600, None, [2047, 0, 1500, 700]),  # > splits
        (4, 2048, 12, 2, 128, 1, None, [2047, 0, 1, 128]),   # self alone
        (2, 512, 4, 2, 64, 128, 30.0, [0, 511]),        # window + softcap
        (1, 256, 4, 4, 128, None, 30.0, [255]),         # softcap
        (4, 2048, 32, 2, 128, None, None, [2047, 0, 1, 900]),   # G = 16
        (4, 2048, 32, 2, 64, 40, 30.0, [0, 39, 40, 2047]),
        (8, 2048, 32, 32, 64, None, None, None),        # musicgen, G = 1
        (8, 2048, 64, 8, 112, None, None, None),        # kimi-k2 serving
        (3, 300, 64, 8, 112, None, None, [0, 1, 299]),  # Dh 112: 0, 1, S-1
        (4, 2048, 64, 8, 112, 50, 30.0, [2047, 0, 1, 128]),
    ]
    n_append = 0
    sweep["decode_attention_append"] = {}
    sweep["decode_attention_append_vs_committed"] = {}
    for dtype in (torch.float32, torch.bfloat16):
        tol = TOL[str(dtype).split(".")[-1]]
        for B, S, H, KVH, Dh, window, cap, lens in append_cases:
            q = rnd((B, H, Dh), dtype)
            kc, vc = rnd((B, S, KVH, Dh), dtype), rnd((B, S, KVH, Dh), dtype)
            kn, vn = rnd((B, KVH, Dh), dtype), rnd((B, KVH, Dh), dtype)
            if lens is None:
                lens = lrng.integers(0, S, size=B)
                lens[0], lens[-1] = 0, S - 1              # both extremes
            kw = dict(window=window, softcap=cap)
            for ldt in (torch.int64, torch.int32):
                ln = torch.tensor(lens, dtype=ldt, device=dev)
                case = (B, S, H, KVH, Dh, window, cap, str(ldt), "append")
                before = da.launches
                got = ops.decode_attention(q, kc, vc, ln, k_new=kn, v_new=vn,
                                           impl="cuda", **kw)
                if da.launches != before + 1:
                    raise AssertionError(f"decode append {case}: "
                                         f"{da.launches - before} launches")
                check("decode_attention_append", dtype, got,
                      ops.decode_attention(q, kc, vc, ln, k_new=kn, v_new=vn,
                                           impl="plain", **kw), case)
                bidx = torch.arange(B, device=dev)
                kc2, vc2 = kc.clone(), vc.clone()
                kc2[bidx, ln.long()] = kn
                vc2[bidx, ln.long()] = vn
                committed = ops.decode_attention(q, kc2, vc2, ln + 1,
                                                 impl="cuda", **kw)
                e = err(got, committed)
                if not e < tol:
                    raise AssertionError(f"decode append {case}: {e} from "
                                         f"the committed kernel >= {tol}")
                key = str(dtype).split(".")[-1]
                sweep["decode_attention_append_vs_committed"][key] = max(
                    sweep["decode_attention_append_vs_committed"].get(key, 0),
                    e)
                zero = ln == 0
                if not torch.equal(got[zero], vn[zero].repeat_interleave(
                        H // KVH, dim=1)):
                    raise AssertionError(f"decode append {case}: lengths 0 "
                                         "rows are not v_new")
                n_append += 1

    gating_cases = [  # T, E, k
        (100, 32, 4), (64, 8, 3), (257, 384, 8),        # tests/test_kernels
        (8, 32, 8), (1024, 32, 8),                      # granite serving
        (256, 16, 2),                                   # jamba
        (8, 384, 8), (1024, 384, 8),                    # kimi-k2
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
        w, ids, aux = ops.moe_gating(lg, k, impl="cuda")
        w_ref, ids_ref, aux_ref = ops.moe_gating(lg, k, impl="plain")
        if not torch.equal(ids, ids_ref):
            raise AssertionError(f"moe_gating {case}: ids differ from the "
                                 "plain version")
        if any(len(set(row)) != k for row in ids.tolist()):
            raise AssertionError(f"moe_gating {case}: repeated ids")
        e = err(w, w_ref)
        if not e < GATING_TOL:
            raise AssertionError(f"moe_gating {case}: weights max abs err "
                                 f"{e} >= {GATING_TOL}")
        aux_check(f"moe_gating {case}", aux, aux_ref)
        gating_err = max(gating_err, e)
    sweep["moe_gating"] = {"float32": gating_err}

    def served_cap(Tb, E, k):
        """Slots per expert as the served configs size them (factor 1.25)."""
        return capacity(dataclasses.replace(
            get_config("granite-moe-1b-a400m"), n_experts=E, moe_top_k=k),
            Tb)

    # T, E, k, cap (None: as served), nb, logits ("rand", "hot" or
    # "underflow")
    route_cases = [
        (8, 32, 8, None, 1, "rand"),            # granite decode
        (1024, 32, 8, None, 1, "rand"),         # granite serving prefill
        (2048, 32, 8, None, 1, "rand"),         # a max_seq prefill
        (4096, 32, 8, None, 1, "rand"),
        (8192, 32, 8, None, 1, "rand"),         # the kernel's limit at k = 8
        (8192, 384, 8, None, 1, "rand"),        # > 48 KB of shared memory
        (1000, 32, 8, None, 1, "rand"),         # granite's path prefill
        (1000, 16, 2, None, 1, "rand"),         # jamba's path prefill
        (8, 16, 2, None, 1, "rand"),            # jamba decode
        (257, 384, 8, None, 1, "rand"),         # tests/test_kernels shape
        (1024, 32, 8, 8, 1, "rand"),            # a dropping cap
        (1000, 16, 2, None, 1, "hot"),          # experts 0, 1 take all
        (1024, 32, 8, None, 2, "rand"),         # two dispatch blocks
        (2048, 16, 2, None, 4, "hot"),
        (3, 16, 8, 8, 1, "underflow"),
        (8, 384, 8, None, 1, "rand"),           # kimi-k2 decode
        (1024, 384, 8, None, 1, "rand"),        # kimi-k2 serving prefill
        (1000, 384, 8, None, 1, "rand"),        # kimi-k2's path prefill
    ]
    route_err = 0.0
    dropped_total = 0
    for Tg, Eg, k, cap, nb, kind in route_cases:
        case = (Tg, Eg, k, cap, nb, kind)
        cap = cap or served_cap(Tg // nb, Eg, k)
        lg = {"rand": lambda: (np.random.default_rng(Tg).standard_normal(
                  (Tg, Eg)) * 2).astype(np.float32),
              "hot": lambda: hot_logits(Tg, Eg),
              "underflow": underflow_logits}[kind]()
        lg = torch.from_numpy(lg).to(dev)
        before = mg.launches
        got = ops.moe_route(lg, k, cap=cap, nb=nb, impl="cuda")
        if mg.launches != before + 1:
            raise AssertionError(f"moe_route {case}: {mg.launches - before} "
                                 "launches, expected 1")
        want = ops.moe_route(lg, k, cap=cap, nb=nb, impl="plain")
        for name, a, b in zip(("ids", "slot_of", "token_of_slot",
                               "tk_of_slot"), got[1:5], want[1:5]):
            if a.shape != b.shape or not torch.equal(a.long(), b.long()):
                raise AssertionError(f"moe_route {case}: {name} differs from "
                                     "the plain version")
        if any(len(set(row)) != k for row in got[1].tolist()):
            raise AssertionError(f"moe_route {case}: repeated ids")
        e = err(got[0], want[0])
        if not e < GATING_TOL:
            raise AssertionError(f"moe_route {case}: weights max abs err "
                                 f"{e} >= {GATING_TOL}")
        aux_check(f"moe_route {case}", got[5], want[5])
        route_err = max(route_err, e)
        dropped_total += int((got[2] == Eg * cap).sum())
    if not dropped_total:
        raise AssertionError("moe_route: no case dropped an entry")
    sweep["moe_route"] = {"float32": route_err}

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
                   (1, 300, 32, 64, None, True), (1, 300, 32, 64, 16, True)]
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
            if strong:      # the plain path is exact there too (C1)
                scan_check("rwkv6_scan", dtype, got,
                           ops.rwkv6_scan(*args, impl="plain"), case,
                           "rwkv6_chunked_exact")
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
    print(f"kernels: {n_flash} flash, {n_decode} decode, {n_append} "
          f"append-mode decode, "
          f"{len(gating_cases) + 1} moe_gating, {len(route_cases)} moe_route "
          f"({dropped_total} entries dropped), {2 * len(rwkv_cases) + 2} "
          f"rwkv6_scan and {2 * len(ssm_cases) + 2} ssm_scan cases within "
          f"tolerance (ids and maps equal); max abs err {json.dumps(sweep)}")

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
    # append mode (the engine's) on the same caches and lengths: the new
    # token's K/V read besides, the same bytes plus one token a sequence
    a_sets = [s + (rnd((B_D, KVH, Dh), bf16), rnd((B_D, KVH, Dh), bf16))
              for s in d_sets]

    def decode_append(a, b, c, ln, kn, vn):
        return ops.decode_attention(a, b, c, ln, k_new=kn, v_new=vn,
                                    impl="cuda")

    q, kc, vc, lens, kn, vn = a_sets[0]
    append_err = err(decode_append(*a_sets[0]), ops.decode_attention(
        q, kc, vc, lens, k_new=kn, v_new=vn, impl="plain"))
    a_bytes = d_bytes + 2 * B_D * KVH * Dh * 2
    a_flops = d_flops + 4 * B_D * H * Dh
    a_bound = {"bytes": a_bytes / PEAK_BYTES * 1e3,
               "operations": a_flops / PEAK_BF16_FLOPS * 1e3}
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
        "append": {
            "shape": "as above, k_new / v_new (B, KVH, Dh) merged by the "
                     "combine pass, the cache read-only",
            "ms": device_ms(decode_append, a_sets),
            "call_ms": time_ms(decode_append, a_sets),
            "plain_ms": time_ms(lambda *a: ops.decode_attention(
                *a[:4], k_new=a[4], v_new=a[5], impl="plain"), a_sets),
            "max_abs_err": append_err, "tol": TOL["bfloat16"],
            "bound_ms": max(a_bound.values()),
            "bound_by": max(a_bound, key=a_bound.get),
            "flops": a_flops, "bytes": a_bytes},
    }
    if not append_err < TOL["bfloat16"]:
        raise AssertionError(f"decode append at the serving shape: "
                             f"{append_err}")
    # device_ms's fallback beside the profiler on the same calls, for a
    # kernel longer and one shorter than its call's host time (reported)
    print("device timer check (ms, profiler vs events behind a spin): "
          + json.dumps({
              "flash_attention": [flash_row["ms"],
                                  queued_ms(flash_kernel, pf_sets, 30)],
              "decode_attention": [decode_row["ms"],
                                   queued_ms(decode_kernel, d_sets, 30)]}))
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
          f" ms, SDPA + mask {decode_row['library_ms']:.5f} ms; append "
          f"mode device {decode_row['append']['ms']:.5f} ms, call "
          f"{decode_row['append']['call_ms']:.5f} ms")
    del pf_sets, lib_sets, d_sets, dlib_sets, a_sets

    # both attention kernels at the shapes phase 9's models give them
    # (bf16): the vision cross prefill (non-causal, Sq=1024 over the 1600
    # vision tokens) and musicgen's self prefill (G = 1, Dh 64); the
    # vision cross decode (every length 1600) and musicgen's decode (G = 1,
    # Dh 64, the serving lengths). Bounds: the bytes read and written once
    # at the HBM rate, the products at the bf16 tensor-core rate.
    def flash_shape(B, Sq, Skv, Hs, KVHs, Dhs, causal):
        sets = [(rnd((B, Sq, Hs, Dhs), bf16), rnd((B, Skv, KVHs, Dhs), bf16),
                 rnd((B, Skv, KVHs, Dhs), bf16)) for _ in range(4)]
        Gs = Hs // KVHs
        lsets = [(a.transpose(1, 2).contiguous(),
                  b.repeat_interleave(Gs, dim=2).transpose(1, 2).contiguous(),
                  c.repeat_interleave(Gs, dim=2).transpose(1, 2).contiguous())
                 for a, b, c in sets]

        def kern(a, b, c):
            return ops.flash_attention(a, b, c, causal=causal, impl="cuda")

        def plain(a, b, c):
            return ops.flash_attention(a, b, c, causal=causal, impl="plain")

        def lib(a, b, c):
            return sdpa(a, b, c, is_causal=causal)

        e = err(kern(*sets[0]), plain(*sets[0]))
        pairs = Sq * (Sq + 1) // 2 if causal else Sq * Skv
        flops = 4 * B * Hs * Dhs * pairs
        nbytes = 2 * B * (2 * Sq * Hs * Dhs + 2 * Skv * KVHs * Dhs)
        bound = {"operations": flops / PEAK_BF16_FLOPS * 1e3,
                 "bytes": nbytes / PEAK_BYTES * 1e3}
        return {"max_abs_err": e, "tol": TOL["bfloat16"],
                "ms": device_ms(kern, sets), "call_ms": time_ms(kern, sets),
                "plain_ms": time_ms(plain, sets, iters=10),
                "library_ms": time_ms(lib, lsets),
                "library_max_abs_err": err(lib(*lsets[0]).transpose(1, 2),
                                           kern(*sets[0])),
                "bound_ms": max(bound.values()),
                "bound_by": max(bound, key=bound.get),
                "flops": flops, "bytes": nbytes}

    def decode_shape(B, S, Hs, KVHs, Dhs, lens, append=False):
        """The decode kernel at one shape, committed, or with ``append`` in
        append mode (k_new / v_new merged by the combine pass: no one
        PyTorch call computes it, so no library time)."""
        ln = torch.as_tensor(lens, dtype=torch.int64, device=dev)
        sets = [(rnd((B, Hs, Dhs), bf16), rnd((B, S, KVHs, Dhs), bf16),
                 rnd((B, S, KVHs, Dhs), bf16), ln) for _ in range(4)]
        if append:
            return append_shape(sets, B, Hs, KVHs, Dhs, ln)
        Gs = Hs // KVHs
        posn = torch.arange(S, device=dev)
        lsets = [(a[:, :, None],
                  b.repeat_interleave(Gs, dim=2).transpose(1, 2).contiguous(),
                  c.repeat_interleave(Gs, dim=2).transpose(1, 2).contiguous(),
                  (posn[None] < l[:, None])[:, None, None])
                 for a, b, c, l in sets]
        e = err(decode_kernel(*sets[0]), ops.decode_attention(
            *sets[0], impl="plain"))
        live = int(ln.sum())
        flops = 4 * live * Hs * Dhs
        nbytes = 2 * live * KVHs * Dhs * 2 + 2 * B * Hs * Dhs * 2 + 8 * B
        bound = {"bytes": nbytes / PEAK_BYTES * 1e3,
                 "operations": flops / PEAK_BF16_FLOPS * 1e3}
        return {"max_abs_err": e, "tol": TOL["bfloat16"],
                "ms": device_ms(decode_kernel, sets),
                "call_ms": time_ms(decode_kernel, sets),
                "plain_ms": time_ms(lambda a, b, c, l: ops.decode_attention(
                    a, b, c, l, impl="plain"), sets),
                "library_ms": time_ms(sdpa_masked, lsets),
                "library_max_abs_err": err(sdpa_masked(*lsets[0])[:, :, 0],
                                           decode_kernel(*sets[0])),
                "n_splits": da.plan_splits(B, KVHs, S, sms),
                "bound_ms": max(bound.values()),
                "bound_by": max(bound, key=bound.get),
                "flops": flops, "bytes": nbytes}

    def append_shape(sets, B, Hs, KVHs, Dhs, ln):
        sets = [s_ + (rnd((B, KVHs, Dhs), bf16), rnd((B, KVHs, Dhs), bf16))
                for s_ in sets]

        def plain(a, b, c, l, kn, vn):
            return ops.decode_attention(a, b, c, l, k_new=kn, v_new=vn,
                                        impl="plain")

        e = err(decode_append(*sets[0]), plain(*sets[0]))
        live = int(ln.sum()) + B
        flops = 4 * live * Hs * Dhs
        nbytes = 2 * live * KVHs * Dhs * 2 + 2 * B * Hs * Dhs * 2 + 8 * B
        bound = {"bytes": nbytes / PEAK_BYTES * 1e3,
                 "operations": flops / PEAK_BF16_FLOPS * 1e3}
        return {"max_abs_err": e, "tol": TOL["bfloat16"],
                "ms": device_ms(decode_append, sets),
                "call_ms": time_ms(decode_append, sets),
                "plain_ms": time_ms(plain, sets), "library_ms": None,
                "n_splits": da.plan_splits(B, KVHs, sets[0][1].shape[1], sms),
                "bound_ms": max(bound.values()),
                "bound_by": max(bound, key=bound.get),
                "flops": flops, "bytes": nbytes}

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    flash_row["modality_shapes"] = {
        "vision cross prefill B=1 Sq=1024 Skv=1600 H=32 KVH=8 Dh=128 bf16 "
        "non-causal": flash_shape(1, 1024, 1600, 32, 8, 128, False),
        "musicgen prefill B=1 Sq=Skv=1024 H=KVH=32 Dh=64 bf16 causal":
            flash_shape(1, 1024, 1024, 32, 32, 64, True)}
    decode_row["modality_shapes"] = {
        "vision cross decode B=8 S=1600 H=32 KVH=8 Dh=128 bf16 lengths "
        "1600": decode_shape(8, 1600, 32, 8, 128, [1600] * B_D),
        f"musicgen decode B=8 S=2048 H=KVH=32 Dh=64 bf16 lengths "
        f"{d_lens.tolist()}": decode_shape(8, S_D, 32, 32, 64, d_lens)}
    for row in (flash_row, decode_row):
        for shape, res in row["modality_shapes"].items():
            if not res["max_abs_err"] < res["tol"]:
                raise AssertionError(f"{row['name']} at {shape}: "
                                     f"{res['max_abs_err']} >= {res['tol']}")
    print("modality kernel shapes: " + json.dumps(
        {row["name"]: row["modality_shapes"]
         for row in (flash_row, decode_row)}))

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

    def route_timing(Tg, Eg, k):
        """The routing kernel (one launch: gating, dispatch maps, aux) at a
        served shape and capacity, against the PyTorch composition it
        replaces on the MoE layer's path (ops.moe_route impl="plain":
        ref.topk_gating with gating_aux, then ref.dispatch_indices)."""
        cap = served_cap(Tg, Eg, k)
        sets = [(torch.randn((Tg, Eg), generator=gen, device=dev) * 2,)
                for _ in range(8)]
        got = ops.moe_route(sets[0][0], k, cap=cap, nb=1, impl="cuda")
        want = ops.moe_route(sets[0][0], k, cap=cap, nb=1, impl="plain")
        if not all(torch.equal(a.long(), b.long())
                   for a, b in zip(got[1:5], want[1:5])):
            raise AssertionError(f"moe_route T={Tg} E={Eg} k={k}: integers "
                                 "differ from the plain version")
        # logits in; weights and ids (8 bytes an entry) and slot_of (8)
        # out; token_of_slot and tk_of_slot (8 bytes a slot); the aux
        nbytes = Tg * Eg * 4 + Tg * k * 16 + 2 * (Eg * cap + 1) * 8
        n_ops = Tg * Eg * (5 + k)      # softmax ~5 per logit, k argmax rounds
        bound = {"bytes": nbytes / PEAK_BYTES * 1e3,
                 "operations": n_ops / PEAK_FP32_FLOPS * 1e3}
        fns = {"": lambda x: ops.moe_route(x, k, cap=cap, nb=1, impl="cuda"),
               "plain_": lambda x: ops.moe_route(x, k, cap=cap, nb=1,
                                                 impl="plain")}
        times = {}
        for key, fn in fns.items():
            times[f"{key}ms"] = device_ms(fn, sets)
            times[f"{key}call_ms"] = time_ms(fn, sets)
        return {
            "shape": f"T={Tg} E={Eg} k={k} cap={cap} nb=1 fp32",
            "ctas": mg.plan_route(Tg, k, Eg),
            "max_abs_err": err(got[0], want[0]), **times,
            "bound_ms": max(bound.values()),
            "bound_by": max(bound, key=bound.get),
            "bytes": nbytes, "operations": n_ops,
        }

    moe_row = {
        "name": "moe_gating", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/moe_gating.cu",
        "replaces": "src/repro/kernels/moe_gating.py:43",
        "tpu_kernel": "src/repro/kernels/moe_gating.py:43",
        "entry": "ops.moe_route (one launch a MoE layer call)",
        **route_timing(1024, 32, 8), "tol": GATING_TOL,
        "library_ms": None,
        "library": "none: no one PyTorch call computes the routing; "
                   "softmax + topk of the gating alone under gating_topk",
        "decode_shape": route_timing(B_D, 32, 8),
        "jamba_shape": route_timing(1000, 16, 2),
        "gating_topk": gating_timing(1024, 32, 8),
        "gating_topk_decode": gating_timing(B_D, 32, 8),
    }
    # both attention kernels (Dh 112, 64/8 heads) and the routing (E 384,
    # k 8) at kimi-k2's served shapes, bf16 attention
    kimi_lens = d_lens.tolist()
    kimi = {
        "flash_attention": {
            "kimi-k2 prefill B=1 Sq=Skv=1024 H=64 KVH=8 Dh=112 bf16 causal":
                flash_shape(1, 1024, 1024, 64, 8, 112, True)},
        "decode_attention": {
            f"kimi-k2 decode B=8 S=2048 H=64 KVH=8 Dh=112 bf16 lengths "
            f"{kimi_lens}": decode_shape(B_D, S_D, 64, 8, 112, kimi_lens),
            f"kimi-k2 decode B=8 S=2048 H=64 KVH=8 Dh=112 bf16 append, "
            f"lengths {kimi_lens}": decode_shape(B_D, S_D, 64, 8, 112,
                                                 kimi_lens, append=True)},
        "moe_gating": {"kimi-k2 route T=1024 E=384 k=8":
                           route_timing(1024, 384, 8),
                       "kimi-k2 route T=8 E=384 k=8": route_timing(B_D, 384,
                                                                   8)}}
    for row in (flash_row, decode_row, moe_row):
        row["kimi_shapes"] = kimi[row["name"]]
        for shape, res in row["kimi_shapes"].items():
            if not res["max_abs_err"] < res.get("tol", GATING_TOL):
                raise AssertionError(f"{row['name']} at {shape}: "
                                     f"{res['max_abs_err']}")
    print("kimi kernel shapes: " + json.dumps(kimi))
    print(f"moe timing: route T=1024 device {moe_row['ms']:.5f} ms call "
          f"{moe_row['call_ms']:.5f} (composition device "
          f"{moe_row['plain_ms']:.5f}, call {moe_row['plain_call_ms']:.5f});"
          f" T=8 device {moe_row['decode_shape']['ms']:.5f} ms call "
          f"{moe_row['decode_shape']['call_ms']:.5f} (composition "
          f"{moe_row['decode_shape']['plain_ms']:.5f} / "
          f"{moe_row['decode_shape']['plain_call_ms']:.5f})")

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

    def zero_launches():
        for mod in kernel_mods.values():
            mod.launches = 0

    def read_launches():
        return {name: mod.launches for name, mod in kernel_mods.items()}

    def expected_launches(cfg, prefills, decodes):
        """Launches per kernel of ``prefills`` prefills and ``decodes``
        decode steps, by layer kind."""
        kinds = [spec.kind for spec in cfg.layer_specs()]
        n_moe = sum(spec.mlp == "moe" for spec in cfg.layer_specs())
        steps = prefills + decodes
        return {"flash_attention": kinds.count("attn") * prefills,
                "decode_attention": kinds.count("attn") * decodes,
                "moe_gating": n_moe * steps,
                "rwkv6_scan": kinds.count("rwkv") * steps,
                "ssm_scan": kinds.count("mamba") * steps}

    def serving_prompts(cfg):
        """The 8 prompts of every serving run (default_rng(0))."""
        rng = np.random.default_rng(0)
        prompt_lens = rng.integers(64, 1025, size=N_REQUESTS)
        return [list(map(int, rng.integers(0, cfg.vocab_size, size=L)))
                for L in prompt_lens]

    def latency(done):
        stats = LatencyStats()
        for r in done:
            stats.observe(r.ttft, r.tpot)
        return {"ttft_p50_s": stats.percentile("ttfts", 50),
                "ttft_p99_s": stats.percentile("ttfts", 99),
                "tpot_p50_s": stats.percentile("tpots", 50),
                "tpot_p99_s": stats.percentile("tpots", 99)}

    def serve(cfg, model):
        """8 requests x 32 new tokens through one engine (append-mode
        decode); every kernel's launches are counted from 0 over exactly
        this run and must match the layer counts. Returns the launches and
        each request's tokens."""
        eng = ServingEngine(cfg, model, EngineConfig(max_batch=8,
                                                     max_seq=S_D))
        eng.submit(Request(rid=-1, prompt=list(range(1, 65)),
                           max_new_tokens=2))
        eng.run()                                # warm-up: cuBLAS, allocator
        eng.finished.clear()
        eng.prefills = eng.decodes = 0
        prompts = serving_prompts(cfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_launches()
        t0 = time.perf_counter()
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=p, max_new_tokens=NEW_TOKENS))
        done = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        if len(done) != N_REQUESTS or any(len(r.generated) != NEW_TOKENS
                                          for r in done):
            raise AssertionError(f"serving {cfg.name}: {len(done)} finished,"
                                 f" tokens {[len(r.generated) for r in done]}")
        if eng.prefills != N_REQUESTS:
            raise AssertionError(f"serving {cfg.name}: {eng.prefills} "
                                 "prefills")
        expected = expected_launches(cfg, eng.prefills, eng.decodes)
        if launches != expected:
            raise AssertionError(
                f"serving {cfg.name}: launches {launches} for "
                f"{eng.prefills} prefills and {eng.decodes} decode steps, "
                f"expected {expected}")
        for r in done:
            if not all(0 <= t < cfg.vocab_size for t in r.generated):
                raise AssertionError(f"request {r.rid}: token out of range")
        serving = {
            "model": cfg.name, "layers": cfg.n_layers,
            "requests": len(done), "decode_mode": "append",
            "new_tokens": NEW_TOKENS,
            "prompt_lens": [len(p) for p in prompts],
            "prefills": eng.prefills, "decode_steps": eng.decodes,
            "flash_launches": launches["flash_attention"],
            "decode_launches": launches["decode_attention"],
            "moe_gating_launches": launches["moe_gating"],
            "rwkv6_scan_launches": launches["rwkv6_scan"],
            "ssm_scan_launches": launches["ssm_scan"],
            "wall_s": wall,
            "output_tok_per_s": N_REQUESTS * NEW_TOKENS / wall,
            **latency(done),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        }
        print(f"serving: {json.dumps(serving)}")
        return launches, {r.rid: list(r.generated) for r in done}

    P, STEPS = 1000, 8
    gating, route = ops.moe_gating, ops.moe_route

    def drive(cfg, model, impl, prompt, forced, append=False, vision=None):
        """Prefill (with ``vision`` embeddings for a vision config) +
        teacher-forced decode steps (committed, or with ``append`` in append
        mode); returns the logits rows, times and, for
        every gating call, its expert ids and dispatch slots (recorded by
        wrapping ops.moe_route, which the MoE layers call, and
        ops.moe_gating, which the dense path calls, for this run only)."""
        routes = []

        def recording_gating(logits, top_k, *, impl=None):
            out = gating(logits, top_k, impl=impl)
            routes.append((out[1], None))
            return out

        def recording_route(logits, top_k, **kw):
            out = route(logits, top_k, **kw)
            routes.append((out[1], out[2]))
            return out

        ops.moe_gating, ops.moe_route = recording_gating, recording_route
        cache = T.init_cache(cfg, 1, S_D)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        logits, pf = model.prefill(prompt, vision_embeds=vision, impl=impl)
        T.cache_insert(cfg, cache, pf, 0, P)
        ev[1].record()
        rows = [logits[0, P - 1]]
        lengths = torch.tensor([P], device=dev)
        for t in range(STEPS):
            step_logits, cache = model.decode_step(cache, forced[t], lengths,
                                                   append=append, impl=impl)
            rows.append(step_logits[0])
            lengths = lengths + 1
        ev[2].record()
        torch.cuda.synchronize()
        ops.moe_gating, ops.moe_route = gating, route
        return (torch.stack(rows).float(), routes,
                {"prefill_ms": ev[0].elapsed_time(ev[1]),
                 "decode_step_ms": ev[1].elapsed_time(ev[2]) / STEPS})

    def compare_routes(cfg, routes_a, routes_b, what):
        """Expert choices and dispatch slots of two drives, call by call:
        (choices, differing choices, reordered tokens, slots compared,
        differing slots). Slots are compared where the routes are equal."""
        n_moe = sum(spec.mlp == "moe" for spec in cfg.layer_specs())
        calls = n_moe * (1 + STEPS)
        want_choices = n_moe * (P + STEPS) * cfg.moe_top_k
        if not len(routes_a) == len(routes_b) == calls:
            raise AssertionError(f"{cfg.name} {what}: {len(routes_a)} and "
                                 f"{len(routes_b)} gating calls recorded, "
                                 f"expected {calls}")
        choices = differing = reordered = slots = differing_slots = 0
        for (a, sa), (b, sb) in zip(routes_a, routes_b):
            if sa is not None and torch.equal(a, b):
                slots += sa.numel()
                differing_slots += int((sa != sb).sum())
            E = cfg.n_experts
            oh_a = torch.zeros(a.shape[0], E, device=dev).scatter_(
                1, a.long(), 1.0)
            oh_b = torch.zeros(b.shape[0], E, device=dev).scatter_(
                1, b.long(), 1.0)
            same_set = (oh_a == oh_b).all(-1)
            choices += a.numel()
            differing += int((oh_a != oh_b).sum()) // 2
            reordered += int((same_set & (a != b).any(-1)).sum())
        if choices != want_choices:
            raise AssertionError(f"{cfg.name} {what}: {choices} expert "
                                 f"choices recorded, expected {want_choices}")
        if differing_slots:
            raise AssertionError(f"{cfg.name} {what}: {differing_slots} of "
                                 f"{slots} dispatch slots differ where the "
                                 "routes are equal")
        return choices, differing, reordered, slots, differing_slots

    def path(cfg, model, tol, gate_argmax=False, append_tol=None):
        """Kernel path vs plain path on one prompt (committed decode);
        gated on ``tol`` and on zero differing expert choices (and with
        ``gate_argmax`` on equal argmax at every position). Then the kernel
        path's append-mode decode (the engine's) vs its committed decode,
        gated on ``append_tol`` the same way. Codebook configs take (1, P,
        C) prompts and (1, C) decode tokens (argmax compared per codebook);
        vision configs also take vision embeddings (1, Nv, D)."""
        prng = np.random.default_rng(2)
        C = (cfg.n_codebooks,) if cfg.n_codebooks else ()
        prompt = torch.from_numpy(prng.integers(0, cfg.vocab_size,
                                                size=(1, P) + C)).to(dev)
        forced = torch.from_numpy(prng.integers(0, cfg.vocab_size,
                                                size=(STEPS, 1) + C)).to(dev)
        vision = None
        if cfg.n_vision_tokens:
            vision = torch.from_numpy(prng.standard_normal(
                (1, cfg.n_vision_tokens, cfg.d_model)).astype(
                    np.float32)).to(dev)
        out_k, routes_k, t_k = drive(cfg, model, "cuda", prompt, forced,
                                     vision=vision)
        out_p, routes_p, t_p = drive(cfg, model, "plain", prompt, forced,
                                     vision=vision)
        out_a, routes_a, t_a = drive(cfg, model, "cuda", prompt, forced,
                                     append=True, vision=vision)
        choices, differing, reordered, slots, differing_slots = \
            compare_routes(cfg, routes_k, routes_p, "kernel vs plain")
        a_choices, a_differing, _, a_slots, _ = compare_routes(
            cfg, routes_a, routes_k, "append vs committed")
        path_err = err(out_k, out_p)
        append_err = err(out_a, out_k)
        for name, out in (("kernel path", out_k), ("append-mode", out_a)):
            if not bool(torch.isfinite(out).all()):
                raise AssertionError(f"{cfg.name} {name} logits are not "
                                     "finite")
        res = {"model": cfg.name, "layers": cfg.n_layers,
               "layer_kinds": [f"{spec.kind}+{spec.mlp}"
                               for spec in cfg.layer_specs()],
               "dtype": cfg.dtype, "param_dtype": cfg.param_dtype,
               "prompt": P,
               "decode_steps": STEPS, "max_abs_err": path_err, "tol": tol,
               "argmax_agree": int((out_k.argmax(-1)
                                    == out_p.argmax(-1)).sum()),
               "positions": int(out_k[..., 0].numel()),
               "logit_std": float(out_p.std()),
               "gating_calls": len(routes_k), "expert_choices": choices,
               "differing_routes": differing,
               "reordered_tokens": reordered,
               "slots_compared": slots, "differing_slots": differing_slots,
               "append_vs_committed": {
                   "max_abs_err": append_err, "tol": append_tol,
                   "argmax_agree": int((out_a.argmax(-1)
                                        == out_k.argmax(-1)).sum()),
                   "expert_choices": a_choices,
                   "differing_routes": a_differing,
                   "slots_compared": a_slots,
                   "decode_step_ms": t_a["decode_step_ms"]},
               "prefill_ms": t_k["prefill_ms"],
               "plain_prefill_ms": t_p["prefill_ms"],
               "times": {"cuda": t_k, "plain": t_p}}
        print(f"path: {json.dumps(res)}")
        gates = []
        if tol is not None:
            gates.append(("kernel vs plain", path_err, tol, differing,
                          res["argmax_agree"]))
        if append_tol is not None:
            gates.append(("append vs committed", append_err, append_tol,
                          a_differing,
                          res["append_vs_committed"]["argmax_agree"]))
        for what, e, limit, n_diff, agree in gates:
            if not e < limit:
                raise AssertionError(f"{cfg.name} {what} logits: {e} >= "
                                     f"{limit}")
            if n_diff:
                raise AssertionError(f"{cfg.name} {what}: {n_diff} of "
                                     f"{choices} expert choices differ")
            if gate_argmax and agree != res["positions"]:
                raise AssertionError(f"{cfg.name} {what}: argmax differs at "
                                     f"{res['positions'] - agree} positions")
        return res

    def trace(cfg, model, n_steps=5, extra=None):
        """Where a serving decode step's time goes (torch.profiler), and
        the same step's wall time untraced (its TPOT at B=8). ``extra`` is
        added to the printed line."""
        cache = T.init_cache(cfg, B_D, S_D)
        toks = torch.zeros((B_D, cfg.n_codebooks) if cfg.n_codebooks
                           else B_D, dtype=torch.int64, device=dev)
        for _ in range(3):
            model.decode_step(cache, toks, d_lens, append=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_steps):
            model.decode_step(cache, toks, d_lens, append=True)
        torch.cuda.synchronize()
        untraced_ms = (time.perf_counter() - t0) * 1e3 / n_steps
        for _ in range(3):      # a session without device records is retried
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(n_steps):
                    model.decode_step(cache, toks, d_lens, append=True)
                torch.cuda.synchronize()
                step_ms = (time.perf_counter() - t0) * 1e3 / n_steps
            dev_events = [e for e in prof.key_averages()
                          if e.device_type == DeviceType.CUDA
                          and e.self_device_time_total > 0]
            if dev_events:
                break
        kernels = sorted(((e.key, e.self_device_time_total / 1e3 / n_steps)
                          for e in dev_events), key=lambda kv: -kv[1])
        busy_ms = sum(ms for _, ms in kernels)
        res = {"model": cfg.name, "layers": cfg.n_layers, "batch": B_D,
               "lengths": d_lens.tolist(), "decode_mode": "append",
               "step_wall_ms": step_ms, "traced": True,
               "untraced_step_wall_ms": untraced_ms,
               "kernels_per_step": sum(e.count for e in dev_events) / n_steps,
               "device_busy_ms": busy_ms if kernels else "not measured",
               "device_idle_share": 1 - busy_ms / step_ms if kernels
               else "not measured",
               "top_kernels_ms": [[k[:60], ms] for k, ms in kernels[:8]],
               # launches by kernel name over the n_steps traced steps: the
               # profiler can miss a launch at the window's edge (a count
               # one short of a multiple of n_steps)
               "kernel_counts": {e.key: e.count for e in dev_events},
               **(extra or {})}
        print(f"trace: {json.dumps(res)}")

    # -- 3-5. qwen2-1.5b: serving, path (bf16), trace ----------------------
    launches_by_path = {}
    cfg = get_config("qwen2-1.5b")
    model = build(cfg)
    launches_by_path[cfg.name], qwen2_tokens = serve(cfg, model)
    path(cfg, model, PATH_TOL, append_tol=PATH_TOL)
    trace(cfg, model)
    del model
    free()

    # -- 3-5. granite-moe-1b-a400m: serving, path (fp32 gated, bf16), trace --
    cfg = get_config("granite-moe-1b-a400m")
    model = build(cfg)
    launches_by_path[cfg.name], _ = serve(cfg, model)
    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    model32 = build(cfg32)
    path(cfg32, model32, PATH_TOL_FP32, append_tol=APPEND_TOL_FP32)
    del model32
    free()
    path(cfg, model, None)          # bf16: reported, not gated
    trace(cfg, model)
    del model
    free()

    # -- 3-5. rwkv6-1.6b: serving, path (bf16, fp32 gated), trace ----------
    cfg = get_config("rwkv6-1.6b")
    model = build(cfg)
    launches_by_path[cfg.name], _ = serve(cfg, model)
    path(cfg, model, None)          # bf16: reported, not gated
    trace(cfg, model)
    del model
    free()
    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    model32 = build(cfg32)
    path(cfg32, model32, PATH_TOL_FP32, gate_argmax=True,
         append_tol=APPEND_TOL_FP32)
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
    launches_by_path[f"{cfg.name} ({cfg.n_layers} layers)"], _ = serve(
        cfg, model)
    path(cfg, model, None)          # bf16: reported, not gated
    trace(cfg, model)
    del model
    free()
    for lo in (0, 2):
        cfg32 = dataclasses.replace(layers(lo, lo + 2), dtype="float32",
                                    param_dtype="float32")
        model32 = build(cfg32)
        path(cfg32, model32, PATH_TOL_FP32, append_tol=APPEND_TOL_FP32)
        del model32
        free()

    # -- 3-5. kimi-k2 at full width, cut to its first 2 layers (KIMI_CUT):
    # serve (bf16), path and trace. The bf16 path is reported; the same
    # bf16 weights computed in fp32 (param_dtype bf16, dtype fp32: 38.6 GB,
    # where the fp32 two-layer model's ~77 GB does not fit) are gated, every
    # expert choice equal; layer 0 alone (the dense attention layer at 64/8
    # heads of 112, fp32 embedding and head, ~10 GB) is gated in fp32.
    t_phase = time.perf_counter()
    kimi = get_config("kimi-k2-1t-a32b")
    print(f"kimi-k2 cut: {KIMI_CUT}")
    cfg = cut(kimi, 2)
    model = build(cfg)
    launches_by_path[f"{cfg.name} ({cfg.n_layers} layers)"], _ = serve(
        cfg, model)
    path(cfg, model, None)          # bf16: reported, not gated
    trace(cfg, model)
    del model
    free()
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model32 = build(cfg32)
    path(cfg32, model32, PATH_TOL_FP32, gate_argmax=True,
         append_tol=APPEND_TOL_FP32)
    del model32
    free()
    cfg32 = dataclasses.replace(cut(kimi, 1), dtype="float32",
                                param_dtype="float32")
    model32 = build(cfg32)
    path(cfg32, model32, PATH_TOL_FP32, gate_argmax=True,
         append_tol=APPEND_TOL_FP32)
    del model32
    free()
    print(f"phases 3-5 (kimi-k2): {time.perf_counter() - t_phase:.1f} s")

    def dryrun_record(arch, shape="decode_32k"):
        """repro_torch.launch.dryrun.run_cell for ``arch`` at ``shape`` on
        the card (a dryrun: line), its launches counted from zero over
        exactly that run: a decode record's equal to its decode steps', a
        prefill record's to its prefills' (the one-sequence prefill that
        sets the batch cut included), a train record's to its train steps'
        (every attention, MoE and scan layer's forward and its remat
        recompute a microbatch), none where the cell is skipped or does not
        fit. Returns (cfg, rec)."""
        cfg = get_config(arch)
        zero_launches()
        t0 = time.perf_counter()
        rec = dryrun.run_cell(arch, shape, ROOT / "results" / "dryrun_torch")
        free()
        launches = read_launches()
        if not rec["ok"]:
            expected = {name: 0 for name in launches}
        elif rec["kind"] == "decode":
            # every step it ran (a profiler session that saw no device time
            # is run again)
            expected = expected_launches(cfg, 0, rec["decode_steps"])
            min_steps = 1 + dryrun.WARMUP_STEPS + dryrun.TIMED_STEPS \
                + dryrun.PROFILED_STEPS
            if rec["decode_steps"] < min_steps:
                raise AssertionError(f"dry-run {arch} {shape}: "
                                     f"{rec['decode_steps']} decode steps")
        elif rec["kind"] == "prefill":
            expected = expected_launches(cfg, rec["prefill_steps"], 0)
        else:
            kinds = [spec.kind for spec in cfg.layer_specs()]
            n_moe = sum(spec.mlp == "moe" for spec in cfg.layer_specs())
            per = rec["n_micro"] * rec["train_steps"] * (1 + cfg.remat)
            segs = len(ref.scan_segments(rec["seq_len"]))
            expected = {"flash_attention": kinds.count("attn") * per,
                        "decode_attention": 0, "moe_gating": n_moe * per,
                        "rwkv6_scan": kinds.count("rwkv") * segs * per,
                        "ssm_scan": kinds.count("mamba") * segs * per}
        if launches != expected:
            raise AssertionError(f"dry-run {arch} {shape}: launches "
                                 f"{launches}, expected {expected}")
        if rec["ok"]:
            launches_by_path[f"{cfg.name} dry-run {shape}"] = launches
        print(f"dryrun: {json.dumps(rec)}")
        print(f"dryrun time: {arch} {shape} "
              f"{time.perf_counter() - t0:.1f} s")
        return cfg, rec

    def record_gates(cfg, rec):
        """Every record's gates: ok, one device, operations counted, bytes
        at least the weights'; a train record's losses finite and its
        first cross-entropy in phase 8's band around ln V + sigma^2 / 2."""
        weight_bytes = sum(p.numel() * p.element_size() for p in
                           T.Transformer(cfg, device="meta").parameters())
        if not (rec["ok"] is True and rec["devices"] == 1
                and rec["flops"] > 0
                and rec["bytes_accessed"] >= weight_bytes):
            raise AssertionError(f"dry-run record fails its gates: ok "
                                 f"{rec['ok']}, devices {rec['devices']}, "
                                 f"flops {rec.get('flops')}, bytes "
                                 f"{rec.get('bytes_accessed')} against "
                                 f"{weight_bytes} weight bytes")
        if rec["kind"] == "train":
            center = math.log(cfg.vocab_size) + 0.5 * 0.02 ** 2 * cfg.d_model
            if not (all(map(math.isfinite, rec["losses"]))
                    and abs(rec["first_ce"] - center)
                    <= FIRST_LOSS_RTOL * math.log(cfg.vocab_size)):
                raise AssertionError(f"train record {cfg.name}: losses "
                                     f"{rec['losses']}, first ce "
                                     f"{rec['first_ce']} (band around "
                                     f"{center})")

    def profile_rows(cfg, rec):
        """The H100 MaxTput row profile_from_dryrun builds from ``rec``
        beside the analytic row, bucket by bucket, and the engine model's
        step time beside the measured one (a profile: line). Returns the
        record-derived profile."""
        record_gates(cfg, rec)
        h100 = {"H100": PAPER_GPUS["H100"]}
        buckets = bucket_grid()
        perf = ModelPerf.from_config(cfg)
        record_profile = profile_from_dryrun(h100, buckets, cfg, rec,
                                             SLO_TPOT_S)
        analytic = profile_catalog(h100, buckets, perf, SLO_TPOT_S)
        row = record_profile.max_tput["H100"]
        row_a = analytic.max_tput["H100"]
        if not (np.isfinite(row).all() and (row >= 0).all() and row.any()):
            raise AssertionError(f"record-derived H100 row of {cfg.name}: "
                                 f"{row.tolist()}")
        em_rec = EngineModel(
            perf, flops_per_token=decode_flops_per_token_from_record(rec),
            bytes_per_step_base=decode_bytes_per_step_base_from_record(
                rec, perf))
        em_ana = EngineModel(perf)
        B_rec, S_rec = rec["global_batch"], rec["seq_len"]
        print("profile: " + json.dumps({
            "gpu": "H100", "slo_tpot_s": SLO_TPOT_S, "model": cfg.name,
            "record": f"{rec['arch']} {rec['shape']} global_batch {B_rec} "
                      f"seq_len {S_rec}",
            "buckets": [[b.i_lo, b.i_hi, b.o_lo, b.o_hi, float(r), float(a),
                         float(r / a) if a > 0 else None]
                        for b, r, a in zip(buckets, row, row_a)],
            "columns": "i_lo, i_hi, o_lo, o_hi, record-derived req/s, "
                       "analytic req/s, ratio",
            "feasible_buckets": [int((row > 0).sum()),
                                 int((row_a > 0).sum())],
            "engine_model_step_ms": {
                "record": em_rec.decode_step_time(PAPER_GPUS["H100"], B_rec,
                                                  S_rec) * 1e3,
                "analytic": em_ana.decode_step_time(PAPER_GPUS["H100"],
                                                    B_rec, S_rec) * 1e3},
            "measured_step_ms": rec["step_ms"],
            "measured_device_busy_ms": rec["device_busy_ms"],
            "card": rec["card"]}))
        return record_profile

    # -- 6. profile: the one-card dry-run record of qwen2-1.5b's decode step
    # at decode_32k, and the H100 MaxTput row it gives against the analytic
    # row ----------------------------------------------------------------
    cfg, rec = dryrun_record("qwen2-1.5b")
    # the decode kernel alone at the record's shape (one layer's cache,
    # append mode, every sequence at seq_len - 1 old tokens), against its
    # byte bound, at the planned split count and at more splits. A call
    # takes ~2 ms, far above its host time, so back-to-back CUDA events
    # time the device; torch.profiler beside them (it has dropped launches
    # of these long kernels from short sessions)
    B_rec, S_rec = rec["global_batch"], rec["seq_len"]
    q = rnd((B_rec, cfg.n_heads, cfg.head_dim), bf16)
    kc = rnd((B_rec, S_rec, cfg.n_kv_heads, cfg.head_dim), bf16)
    vc = rnd((B_rec, S_rec, cfg.n_kv_heads, cfg.head_dim), bf16)
    kn = rnd((B_rec, cfg.n_kv_heads, cfg.head_dim), bf16)
    vn = rnd((B_rec, cfg.n_kv_heads, cfg.head_dim), bf16)
    ln = torch.full((B_rec,), S_rec - 1, dtype=torch.int64, device=dev)
    kv_bytes = 2 * B_rec * S_rec * cfg.n_kv_heads * cfg.head_dim * 2
    planned = da.plan_splits(B_rec, cfg.n_kv_heads, S_rec, sms)
    long_ctx = {"shape": f"B={B_rec} S={S_rec} H={cfg.n_heads} KVH="
                         f"{cfg.n_kv_heads} Dh={cfg.head_dim} bf16 append",
                "bound_ms": kv_bytes / PEAK_BYTES * 1e3, "bytes": kv_bytes,
                "events_ms_by_splits": {}, "profiler_ms_by_splits": {}}
    for n in sorted({planned, 2 * planned, 4 * planned}):
        def long_call(n=n):
            return da.decode_attention(q, kc, vc, ln, k_new=kn, v_new=vn,
                                       n_splits=n)
        key = f"{n}{'*' if n == planned else ''}"
        long_ctx["events_ms_by_splits"][key] = time_ms(long_call, [()],
                                                       iters=10)
        long_ctx["profiler_ms_by_splits"][key] = device_ms(long_call, [()],
                                                           iters=10)
    print(f"dryrun decode kernel: {json.dumps(long_ctx)}")
    del q, kc, vc, kn, vn, ln
    free()
    h100_profile = profile_rows(cfg, rec)

    # the decode records of the other configs that fit one card (their H100
    # rows beside the analytic ones), rwkv6's long_500k, qwen2's prefill_32k
    # and train_4k, and the cells that do not fit, logged with why
    t_phase = time.perf_counter()
    for arch in DECODE_RECORDS:
        profile_rows(*dryrun_record(arch))
    record_gates(*dryrun_record("rwkv6-1.6b", "long_500k"))
    for shape in ("prefill_32k", "train_4k"):
        record_gates(*dryrun_record("qwen2-1.5b", shape))
    for arch, shape in NOT_FITTING:
        _, rec_n = dryrun_record(arch, shape)
        if "not_fitting" not in rec_n:
            raise AssertionError(f"{arch} at {shape} was expected not to "
                                 f"fit one card: {rec_n}")
    print(f"phase 6 records: {time.perf_counter() - t_phase:.1f} s")

    # -- 7. cluster: qwen2-1.5b behind ServingCluster, two H100 instances
    # sharing one model on the card, routed under phase 6's profile, through
    # the serving example twin's data plane --------------------------------
    twin = load_example("serve_heterogeneous_torch")
    model = build(cfg)

    def cluster_run(label, counts, profile, extra=None):
        """Phase 3's 8 requests through ``twin.data_plane``: a
        ServingCluster of ``counts`` instances sharing ``model`` under
        ``profile``; every request completed, launches exact (counted from
        0 over exactly this run), tokens equal to phase 3's single engine.
        A ``label:`` line with ``extra``."""
        requests = [Request(rid=i, prompt=p, max_new_tokens=NEW_TOKENS)
                    for i, p in enumerate(serving_prompts(cfg))]
        torch.cuda.synchronize()
        zero_launches()
        t0 = time.perf_counter()
        cluster, stats = twin.data_plane(
            cfg, model, counts, profile, requests,
            EngineConfig(max_batch=B_D, max_seq=S_D), dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        prefills = sum(e.prefills for e in cluster.engines)
        decodes = sum(e.decodes for e in cluster.engines)
        expected = expected_launches(cfg, prefills, decodes)
        done = [r for e in cluster.engines for r in e.finished]
        tokens = {r.rid: list(r.generated) for r in done}
        differing = sorted(rid for rid in qwen2_tokens
                           if tokens.get(rid) != qwen2_tokens[rid])
        print(f"{label}: " + json.dumps({
            "model": cfg.name, "allocation": counts,
            "instances": [ref.gpu for ref in cluster.lb.instances],
            "routed": cluster.routed, "per_instance": stats.per_instance,
            "completed": stats.completed, "rejected": stats.rejected,
            "mean_tokens": stats.mean_tokens, "prefills": prefills,
            "decode_steps": decodes, "launches": launches, "wall_s": wall,
            "output_tok_per_s": N_REQUESTS * NEW_TOKENS / wall,
            **latency(done),
            "requests_with_tokens_as_single_engine":
                N_REQUESTS - len(differing), **(extra or {})}))
        if stats.completed != N_REQUESTS or stats.rejected or \
                sum(stats.per_instance.values()) != N_REQUESTS:
            raise AssertionError(f"{label}: {stats}")
        if prefills != N_REQUESTS or launches != expected:
            raise AssertionError(f"{label}: launches {launches} for "
                                 f"{prefills} prefills and {decodes} decode "
                                 f"steps, expected {expected}")
        if differing:
            raise AssertionError(f"{label}: requests {differing} generated "
                                 "other tokens than the single engine of "
                                 "phase 3")
        launches_by_path[f"{cfg.name} {label}"] = launches

    cluster_run("cluster", {"H100": 2}, h100_profile)

    # -- 7b. control: the port's own Mélange control plane (the serving
    # twin's functions) at full width: Melange over PAPER_GPUS with phase
    # 6's record-derived H100 row allocates arena traffic at CONTROL_RATE,
    # the allocation is served (cluster_run) and simulated -------------
    perf = ModelPerf.from_config(cfg)
    catalog = profile_catalog(PAPER_GPUS, bucket_grid(), perf, SLO_TPOT_S)
    catalog.max_tput["H100"] = h100_profile.max_tput["H100"]
    t0 = time.perf_counter()
    mel, alloc = twin.control_plane(CONTROL_RATE, perf, profile=catalog)
    alloc_s = time.perf_counter() - t0
    _, alloc_a = twin.control_plane(CONTROL_RATE, perf)
    if alloc is None or sum(alloc.counts.values()) < 2:
        raise AssertionError(f"control: allocation {alloc and alloc.counts} "
                             f"at {CONTROL_RATE} req/s holds fewer than 2 "
                             "instances")
    t0 = time.perf_counter()
    res = twin.slo_evaluation(alloc.counts, mel.profile, perf, CONTROL_RATE,
                              CONTROL_SIM_REQUESTS)
    sim_s = time.perf_counter() - t0
    pct = res.tpot_percentiles((50, 99))
    if not (0.0 <= res.slo_attainment <= 1.0 and pct
            and len(res.requests) == CONTROL_SIM_REQUESTS):
        raise AssertionError(f"control: simulation {res.slo_attainment}, "
                             f"{len(res.requests)} requests")
    cluster_run("control", alloc.counts, mel.profile, {
        "rate_req_s": CONTROL_RATE, "dataset": "arena",
        "slo_tpot_s": SLO_TPOT_S, "cost_per_hour": alloc.cost_per_hour,
        "optimal": alloc.solution.optimal, "allocate_s": alloc_s,
        "allocation_analytic": alloc_a.counts,
        "cost_per_hour_analytic": alloc_a.cost_per_hour,
        "sim_requests": CONTROL_SIM_REQUESTS,
        "sim_slo_attainment": res.slo_attainment,
        "sim_tpot_p50_s": pct[50], "sim_tpot_p99_s": pct[99],
        "sim_cost": res.cost, "sim_duration_s": res.duration_s,
        "simulate_s": sim_s})
    del model
    free()
    twins_phase()

    # -- 8. training: the lse kernel and the attention gradient, kernel vs
    # plain train step, qwen2 and granite at full size, resume -------------
    lse_row, train_launches, scan_train = training_phase(
        torch, dev, rnd, err, time_ms, free, zero_launches, read_launches)
    launches_by_path.update(train_launches)
    for row in kernel_rows:          # the scans at the training shapes
        if row["name"] in scan_train:
            row["train_shape"] = scan_train[row["name"]]
    # the lse variant is the flash kernel's launches on the training paths
    lse_row["counter"], lse_row["paths"] = "flash_attention", \
        sorted(train_launches)
    kernel_rows.append(lse_row)

    # -- 9. the modality configs at full size, bf16: llama-3.2-vision-11b
    # (cross-attention over a static vision cache) and musicgen-large (4
    # codebook streams). The engine serves neither (nor does the
    # reference's), so each runs through the model's entry points: one
    # prompt prefilled, then greedy append-mode decode steps; the path and
    # trace of phases 4-5; its dry-run record and profile row -------------
    def modality_inputs(cfg, rng, S):
        """Tokens (1, S) or (1, S, C) on the card and, for a vision config,
        vision embeddings (1, Nv, D) fp32 (else None), from ``rng``."""
        C = (cfg.n_codebooks,) if cfg.n_codebooks else ()
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                               size=(1, S) + C)).to(dev)
        vision = None
        if cfg.n_vision_tokens:
            vision = torch.from_numpy(rng.standard_normal(
                (1, cfg.n_vision_tokens, cfg.d_model)).astype(
                    np.float32)).to(dev)
        return tokens, vision

    def generate(cfg, model):
        """One GEN_PROMPT-token prompt prefilled into a batch-1 cache, then
        GEN_STEPS greedy append-mode decode steps, each timed to its
        synchronised end (the TPOT at B=1); the launches, counted from
        zero over exactly this run, must be one flash launch a layer (a
        cross layer's included) and one decode launch a layer a step."""
        rng = np.random.default_rng(3)
        warm, warm_vision = modality_inputs(cfg, rng, 64)
        cache = T.init_cache(cfg, 1, GEN_PROMPT + GEN_STEPS + 1)
        _, pf = model.prefill(warm, vision_embeds=warm_vision)  # warm-up
        T.cache_insert(cfg, cache, pf, 0, 64)
        model.decode_step(cache, warm[:, -1], torch.tensor([64]),
                          append=True)
        prompt, vision = modality_inputs(cfg, rng, GEN_PROMPT)
        cache = T.init_cache(cfg, 1, GEN_PROMPT + GEN_STEPS + 1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_launches()
        t0 = time.perf_counter()
        logits, pf = model.prefill(prompt, vision_embeds=vision)
        T.cache_insert(cfg, cache, pf, 0, GEN_PROMPT)
        tok = logits[:, -1].argmax(-1)                 # (1,) or (1, C)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        del pf
        lengths = torch.tensor([GEN_PROMPT])
        tokens, step_ms = [tok], []
        for _ in range(GEN_STEPS):
            t1 = time.perf_counter()
            step_logits, cache = model.decode_step(cache, tok, lengths,
                                                   append=True)
            tok = step_logits.argmax(-1)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t1) * 1e3)
            tokens.append(tok)
            lengths = lengths + 1
        launches = read_launches()
        expected = expected_launches(cfg, 1, GEN_STEPS)
        if launches != expected:
            raise AssertionError(f"generate {cfg.name}: launches {launches}"
                                 f", expected {expected}")
        out = torch.stack(tokens, dim=1)[0]            # (steps + 1[, C])
        if not bool(((out >= 0) & (out < cfg.vocab_size)).all()) or \
                not bool(torch.isfinite(step_logits[..., :cfg.vocab_size])
                         .all()):
            raise AssertionError(f"generate {cfg.name}: tokens out of range"
                                 " or logits not finite")
        res = {"model": cfg.name, "layers": cfg.n_layers,
               "cross_layers": sum(spec.attn_type == "cross"
                                   for spec in cfg.layer_specs()),
               "codebooks": cfg.n_codebooks,
               "vision_tokens": cfg.n_vision_tokens,
               "params": sum(p.numel() for p in model.parameters()),
               "prompt": GEN_PROMPT, "decode_steps": GEN_STEPS,
               "decode_mode": "append", "prefill_ms": prefill_ms,
               "tpot_p50_ms": float(np.percentile(step_ms, 50)),
               "tpot_p99_ms": float(np.percentile(step_ms, 99)),
               "launches": launches, "tokens_head": out[:4].tolist(),
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        print(f"generate: {json.dumps(res)}")
        launches_by_path[f"{cfg.name} generate"] = launches
        return res

    for arch in ("llama-3.2-vision-11b", "musicgen-large"):
        t_phase = time.perf_counter()
        cfg = get_config(arch)
        model = build(cfg)
        gen = generate(cfg, model)
        path(cfg, model, None)          # bf16: reported, not gated
        trace(cfg, model, extra={"tpot_p50_ms_b1": gen["tpot_p50_ms"]})
        del model
        free()
        cfg32 = dataclasses.replace(cfg, dtype="float32",
                                    param_dtype="float32")
        model32 = build(cfg32)
        path(cfg32, model32, PATH_TOL_FP32, gate_argmax=True,
             append_tol=APPEND_TOL_FP32)
        del model32
        free()
        cfg, rec = dryrun_record(arch)
        profile_rows(cfg, rec)
        free()
        print(f"phase 9 ({arch}): {time.perf_counter() - t_phase:.1f} s")

    for row in kernel_rows:
        counter = row.get("counter", row["name"])
        row["launches_by_path"] = {m: launches_by_path[m][counter]
                                   for m in row.get("paths",
                                                    launches_by_path)}
        row["launches"] = sum(row["launches_by_path"].values())
        if not row["launches"]:
            raise AssertionError(f"{row['name']} was never launched on the "
                                 "served paths")
    print(f"device timer: {json.dumps(timer_use)}")
    print(json.dumps({"kernels": kernel_rows}))
    print(smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


# ===========================================================================
# chip_smoke.py --cards 4: the tensor-parallel serving path on four cards
# ===========================================================================
CONTROL_RATE = 32.0     # req/s of arena traffic: the allocation holds 2
CONTROL_SIM_REQUESTS = 2000
TWIN_ARGS = {"serve_heterogeneous_torch": ("--requests", "8",
                                           "--sim-requests", "200"),
             "train_small_torch": ("--steps", "4")}
# runs a script as __main__ with the arguments after it, then lists the
# jax / repro modules it loaded
TWIN_WRAP = ("import json, runpy, sys\n"
             "sys.argv = sys.argv[1:]\n"
             "runpy.run_path(sys.argv[0], run_name='__main__')\n"
             "print('loaded: ' + json.dumps(sorted(n for n in sys.modules if "
             "n.split('.')[0] in ('jax', 'jaxlib', 'repro'))))\n")


def load_example(name: str):
    """examples/<name>.py as a module (its main not run)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def twins_phase() -> None:
    """Phase 7c: both example twins in subprocesses on the card (TWIN_ARGS,
    ``--device cuda``), each wrapped to list the jax / repro modules it
    loaded: exit 0, their lines printed, completed plus rejected equal to
    the requests sent, finite losses, nothing of jax or repro loaded. A
    twins: line with each one's wall time and lines."""
    ckpt = ROOT / "results" / "train_small_torch_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = {}
    for name, args in TWIN_ARGS.items():
        args = args + ("--device", "cuda") + ((
            "--ckpt-dir", str(ckpt)) if name == "train_small_torch" else ())
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", TWIN_WRAP,
             str(ROOT / "examples" / f"{name}.py"), *args],
            capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
        wall = time.perf_counter() - t0
        lines = proc.stdout.splitlines()
        out[name] = {"wall_s": wall, "rc": proc.returncode, "lines": lines}
        if proc.returncode or not lines or lines[-1] != "loaded: []":
            raise AssertionError(f"twin {name}: rc {proc.returncode}, "
                                 f"stdout {lines}, stderr "
                                 f"{proc.stderr[-3000:]}")
        lines = lines[:-1]
        if name == "serve_heterogeneous_torch":
            heads = ("[alloc] ", "[serve] completed=",
                     "[serve] per-instance", "[slo]   attainment=")
            if len(lines) != 4 or not all(
                    l.startswith(h) for l, h in zip(lines, heads)):
                raise AssertionError(f"twin {name}: lines {lines}")
            fields = dict(kv.split("=") for kv in lines[1].split()[1:3])
            if int(fields["completed"]) + int(fields["rejected"]) != \
                    int(args[1]):
                raise AssertionError(f"twin {name}: {lines[1]}")
        else:
            if len(lines) != 2 or not lines[0].startswith("training ") or \
                    not lines[1].startswith("loss "):
                raise AssertionError(f"twin {name}: lines {lines}")
            first, _, last = lines[1].split(" (")[0].split()[1:]
            if not (math.isfinite(float(first))
                    and math.isfinite(float(last))):
                raise AssertionError(f"twin {name}: {lines[1]}")
    shutil.rmtree(ckpt, ignore_errors=True)
    print("twins: " + json.dumps(out))


TP_TIMEOUT_S = 300      # process-group timeout: a hung rank fails the run
# path tp: gemma2-27b at full width on its first 2 layers (one local and
# one global layer, embedding and head: ~14 GB in fp32)
TP_PATH = (("qwen2-1.5b", None, 4, 2048, (700, 1100, 300, 1535)),
           ("gemma2-27b", 2, 4, 2048, (700, 1100, 300, 1535)),
           ("gemma2-27b", 2, 1, 16384, (9000,)))
TP_PATH_STEPS = 4
TP_PREFILL_ROWS = 64    # the last prefill positions compared
# the fp32-compute engines' max_seq: gemma2's one-card engine (56.8 GB of
# bf16 weights and a fp32 cache) fits card 0 at 1088, not at 2048
TP_SERVE_SEQ_FP32 = 1088
# serving tp's depth cuts (full width): gemma2-27b on the first 12 of its 46
# layers keeps the four-card mode near its time budget beside the rec phases
TP_SERVE_LAYERS = {"gemma2-27b": 12}
TP_RECORDS = (("qwen2-1.5b", "decode_32k"), ("gemma2-27b", "decode_32k"),
              ("gemma2-27b", "long_500k"), ("qwen2-1.5b", "prefill_32k"))
TP_TRACE_STEPS = 5
# train tp: qwen2 at full width on 2 layers, fp32; (data, model) meshes
TP_TRAIN_LAYERS, TP_TRAIN_BATCH, TP_TRAIN_SEQ, TP_TRAIN_STEPS = 2, 16, 1024, 2
TP_TRAIN_CASES = (((2, 2), "baseline"), ((4, 1), "baseline"),
                  ((1, 4), "baseline"), ((2, 2), "fsdp"),
                  ((2, 2), "micro8+bf16grad"))
TP_TRAIN_RECORDS = ("qwen2-1.5b", "internlm2-1.8b", "minitron-4b",
                    "gemma2-27b")
TP_TRAIN_NOT_FITTING = ("gemma2-27b",)
# A route the mesh and one card choose apart: fp32 sums in another order
# (the row-parallel all-reduces, the combine's parts summed over the cards)
# move a router logit by ~1e-6, which swaps a token's k-th and (k+1)-th
# expert where their logits are that close (about one token in 1e5 at
# granite's 32 experts, a few in a full-size prefill). The one-card run
# then takes the mesh's choice, and only where this run's own gap between
# the two logits is below NEAR_TIE, 100x that noise; a wider gap fails.
NEAR_TIE = 1e-4
# the expert-parallel (ep) phases: granite-moe at full size, fp32, on the
# (data, model) meshes below against card 0 without a mesh (batch, max_seq,
# prompt lengths), then kimi-k2 at full width on its first 2 layers
EP_ARCH, EP_KIMI = "granite-moe-1b-a400m", "kimi-k2-1t-a32b"
EP_PATH_MESHES = ((1, 4), (2, 2))
EP_PATH = (4, 2048, (300, 700, 1100, 1535))
EP_KIMI_PATH = (4, 2048, (100, 257, 600, 1023))
# train ep: granite at full width on its first 2 layers, fp32, as train tp
EP_TRAIN_CASES = (((2, 2), "baseline"), ((4, 1), "baseline"),
                  ((1, 4), "baseline"), ((2, 2), "expdata"),
                  ((2, 2), "fsdp"), ((2, 2), "blockdispatch"),
                  ((2, 2), "adafactor"))
# kimi-k2's Adafactor step in bf16 on mesh 2x2: its first 2 layers (8.45 GB
# of bf16 experts a card and their fp32 gradients, 25 GB), one row a card
EP_KIMI_TRAIN = (2, 2, 1024, 2)           # layers, batch, seq, steps
EP_RECORDS = ((EP_ARCH, "decode_32k", (1, 4)), (EP_ARCH, "train_4k", (2, 2)),
              (EP_KIMI, "decode_32k", (1, 4)), (EP_KIMI, "train_4k", (2, 2)))
EP_NOT_FITTING = (EP_KIMI,)
# serving ep: kimi-k2's depth on mesh 1x4 is the most layers whose weights
# leave this much of the smallest card's free memory for the cache, the
# activations and NCCL (its shards drawn on the cards: a whole 22.5 GB fp32
# expert leaf drawn on each card, as the model's init does, would not fit
# beside the layers before it)
EP_KIMI_RESERVE_BYTES = 12e9
# the recurrent (rec) phases: rwkv6-1.6b at full size and Jamba at full
# width, their Mamba channels and RWKV heads over "model"
REC_RWKV, REC_JAMBA = "rwkv6-1.6b", "jamba-1.5-large-398b"
REC_PATH_MESHES = ((1, 4), (2, 2))
REC_PATH = (4, 2048, (300, 700, 1100, 1535))
# path rec: Jamba's first 4 layers (Mamba + dense, Mamba + MoE, Mamba +
# dense, attention + MoE), bf16 weights computed in fp32; card 0 alone
# holds their 46 GB and one MoE layer's fp32 expert leaf (12.9 GB) at a time
REC_JAMBA_PATH_LAYERS = 4
REC_TRAIN_CASES = (((2, 2), "baseline"), ((4, 1), "baseline"),
                   ((1, 4), "baseline"), ((2, 2), "fsdp"))
# Jamba's layer 0 in fp32 (2.1 B parameters) against card 0 alone, at 8
# rows of TP_TRAIN_SEQ
REC_JAMBA_TRAIN_CASES = REC_TRAIN_CASES[:3]
REC_JAMBA_TRAIN_BATCH = 8
# Jamba's first 2 layers, bf16, Adafactor, on 2x2: layers, batch, seq, steps
REC_JAMBA_BF16_TRAIN = (2, 2, 1024, 2)
REC_RECORDS = ((REC_RWKV, "decode_32k", (1, 4)),
               (REC_RWKV, "long_500k", (1, 4)),
               (REC_RWKV, "train_4k", (2, 2)),
               (REC_JAMBA, "decode_32k", (1, 4)),
               (REC_JAMBA, "long_500k", (1, 4)),
               (REC_JAMBA, "train_4k", (2, 2)))
REC_NOT_FITTING = (REC_JAMBA,)
# the scans at a card's shapes (kernels tp): Jamba's 4096 of 16384 Mamba
# channels (d_state 16, dt_rank 512), rwkv6's 8 of 32 heads of 64; a B=8
# decode step, a B=1 prefill, a B=1 training sequence run whole
REC_SCAN_SHAPES = (("decode", 8, 1), ("prefill", 1, 1024),
                   ("train", 1, 4096))
REC_DIN, REC_N, REC_R, REC_H, REC_K = 4096, 16, 512, 8, 64
# the modality (mod) phases: llama-3.2-vision-11b's cross layers and
# musicgen-large's codebooks on the mesh. path mod: vision at full width on
# its first 10 layers (two periods, two cross layers: 13 GB in fp32),
# musicgen at full size (9.8 GB in fp32); then vision at batch 1 on 1x4,
# every cache cut by rows (batch, max_seq, prompt lengths)
MOD_VISION, MOD_MUSIC = "llama-3.2-vision-11b", "musicgen-large"
MOD_VISION_PATH_LAYERS = 10
MOD_PATH_B1 = (1, 4096, (3000,))
# train mod: vision on its first 5 layers (one period, one cross layer) on
# REC_TRAIN_CASES, musicgen on its first 2 without fsdp, fp32, against one
# card's step
MOD_VISION_TRAIN_LAYERS = 5
MOD_MUSIC_TRAIN_CASES = REC_TRAIN_CASES[:3]
# vision at full depth in bf16 on 2x2: layers, batch, seq, steps
MOD_VISION_BF16_TRAIN = (40, 8, 4096, 2)
MOD_RECORDS = ((MOD_VISION, "decode_32k", (1, 4)),
               (MOD_MUSIC, "decode_32k", (1, 4)),
               (MOD_VISION, "train_4k", (2, 2)),
               (MOD_MUSIC, "train_4k", (2, 2)))
# the sequence-parallel (sp) phases: seqpar on every layer kind (ROADMAP
# A9c items 4 and 4b). path sp: qwen2 and granite at full size, fp32, on
# these meshes at path tp's batch, max_seq and prompt lengths; then
# rwkv6 at full size, Jamba's first REC_JAMBA_PATH_LAYERS layers (bf16
# weights computed in fp32), vision's first MOD_VISION_PATH_LAYERS layers
# and musicgen at full size, fp32, at path rec's (1535 does not cut)
SP_ARCHS = ("qwen2-1.5b", EP_ARCH)
SP_PATH_MESHES = ((1, 4), (2, 2))
SP_PATH = (4, 2048, (700, 1100, 300, 1535))
# train sp: the archs' first TP_TRAIN_LAYERS layers, fp32, as train tp;
# then rwkv6's first TP_TRAIN_LAYERS (with fsdp+seqpar), Jamba's layer 0
# (REC_JAMBA_TRAIN_BATCH rows), vision's first MOD_VISION_TRAIN_LAYERS (a
# cross layer) and musicgen's first TP_TRAIN_LAYERS on SP_REC_TRAIN_CASES
SP_TRAIN_CASES = (((2, 2), "seqpar"), ((1, 4), "seqpar"),
                  ((2, 2), "fsdp+seqpar"))
SP_REC_TRAIN_CASES = SP_TRAIN_CASES[:2]
# dryrun sp: (arch, shape, mesh, variant), each beside its baseline record
SP_RECORDS = (("qwen2-1.5b", "prefill_32k", (1, 4), "seqpar"),
              ("qwen2-1.5b", "train_4k", (2, 2), "seqpar"),
              (EP_ARCH, "train_4k", (2, 2), "seqpar"),
              (MOD_VISION, "train_4k", (2, 2), "seqpar"))
# the phase groups of the four-card mode (--phases), in the order they run;
# kernels tp runs with any of them (the kernels line)
PHASE_GROUPS = ("sp", "rec", "mod", "tp", "ep")
# the group whose records include each sp record's baseline
SP_BASELINE_GROUP = {("qwen2-1.5b", "prefill_32k"): "tp",
                     ("qwen2-1.5b", "train_4k"): "tp",
                     (EP_ARCH, "train_4k"): "ep",
                     (MOD_VISION, "train_4k"): "mod"}
# the four-card train_4k records' depth (full where not listed): their
# steps and the meta-device operation count scale with it. vision keeps
# its 40 layers (the seqpar record's peak beside the baseline's, near a
# card's memory); gemma2, Jamba and kimi-k2 are reckoned not fitting at
# full depth before anything is built
RECORD_TRAIN_LAYERS = {"qwen2-1.5b": 2, "internlm2-1.8b": 2,
                       "minitron-4b": 2, REC_RWKV: 2, MOD_MUSIC: 2,
                       EP_ARCH: 2}


def record_config(arch: str, shape: str):
    """(the config of ``arch``'s four-card record at ``shape``, the depth
    ``run_cell`` cuts it to: RECORD_TRAIN_LAYERS for train_4k, else
    None)."""
    from repro_torch.configs import get_config
    layers = RECORD_TRAIN_LAYERS.get(arch) if shape == "train_4k" else None
    cfg = get_config(arch)
    return (cfg if layers is None else cut(cfg, layers)), layers


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def cards_main(n: int, phases=PHASE_GROUPS) -> int:
    """The four-card mode (module docstring of the four-card phases): builds
    the kernels, starts one process per card, and prints the kernels line
    and the last line from rank 0's results. ``phases``: the groups to run
    (``PHASE_GROUPS``; kernels tp runs with any)."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    unknown = set(phases) - set(PHASE_GROUPS)
    if unknown or not phases:
        print(f"chip_smoke --phases: unknown {sorted(unknown)}; the groups "
              f"are {', '.join(PHASE_GROUPS)}", file=sys.stderr)
        return 1
    if torch.cuda.device_count() < n:
        print(f"chip_smoke --cards {n}: {torch.cuda.device_count()} cards "
              "visible", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    print(f"cards: {smi()}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    _, build_s, log = _build.timed_load()
    print(f"build: {build_s:.3f} s -> {_build.library_path()}")
    # the ranks inherit it: a 32k prefill's transients (37 GB of logits at
    # batch 16 a card) fragment the default allocator's fixed segments
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    out = ROOT / "results" / "chip_smoke_tp.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    if out.exists():
        out.unlink()
    t0 = time.perf_counter()
    torch.multiprocessing.spawn(_tp_rank, args=(n, _free_port(), str(out),
                                                tuple(phases)),
                                nprocs=n, join=True)
    res = json.loads(out.read_text())
    print(f"ranks: {time.perf_counter() - t0:.1f} s")
    if "tp" in phases:
        cli_beside_records(n)
    print(json.dumps({"kernels": res["kernels"]}))
    print(smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


# the dry-run CLI's mesh mode (--cards), beside dryrun tp's record of the
# same cell: the fields that must be equal
CLI_CELL = TP_RECORDS[0]
CLI_EQUAL = ("global_batch", "seq_len", "flops", "bytes_accessed", "mesh",
             "devices", "variant", "reduced", "cache_spec")


def cli_beside_records(n: int) -> None:
    """After the ranks joined: ``python -m repro_torch.launch.dryrun --cards
    n --mesh 1xn`` for CLI_CELL into results/dryrun_cli, its record held to
    dryrun tp's ``run_cell(mesh=)`` record of the same cell in
    results/dryrun_torch (CLI_EQUAL, collective calls and link bytes by
    kind); both step times on a dryrun cli: line."""
    arch, shape = CLI_CELL
    cli_out = ROOT / "results" / "dryrun_cli"
    shutil.rmtree(cli_out, ignore_errors=True)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--cards",
         str(n), "--mesh", f"1x{n}", "--arch", arch, "--shape", shape,
         "--out", str(cli_out)], capture_output=True, text=True,
        timeout=900, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    wall = time.perf_counter() - t0
    files = sorted(cli_out.glob("*.json")) if cli_out.exists() else []
    if proc.returncode or len(files) != 1:
        raise AssertionError(f"dryrun cli: rc {proc.returncode}, files "
                             f"{files}, stdout {proc.stdout[-3000:]}, "
                             f"stderr {proc.stderr[-3000:]}")
    ref_file = ROOT / "results" / "dryrun_torch" / files[0].name
    got = json.loads(files[0].read_text())
    want = json.loads(ref_file.read_text())
    differ = [k for k in CLI_EQUAL if got.get(k) != want.get(k)]
    for k in ("calls", "per_op"):
        if got["collectives"][k] != want["collectives"][k]:
            differ.append(f"collectives.{k}")
    print("dryrun cli: " + json.dumps({
        "cell": f"{arch} {shape}", "file": files[0].name, "wall_s": wall,
        "step_ms": {"cli": got.get("step_ms"),
                    "chip_smoke": want.get("step_ms")},
        "device_busy_ms_by_rank": {
            "cli": got.get("device_busy_ms_by_rank"),
            "chip_smoke": want.get("device_busy_ms_by_rank")},
        **{k: got.get(k) for k in CLI_EQUAL},
        "collectives": got["collectives"], "differing": differ,
        "stdout": proc.stdout.splitlines()}))
    if differ or not got["ok"]:
        raise AssertionError(f"dryrun cli: {differ} differ from "
                             f"{ref_file.name}")


def _tp_rank(rank: int, n: int, port: int, out: str,
             phases=PHASE_GROUPS) -> None:
    import datetime
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    torch.cuda.set_device(rank)
    # the host's cores shared by the cards' processes
    torch.set_num_threads(max(1, (os.cpu_count() or n) // n))
    dist.init_process_group(
        "nccl", init_method=f"tcp://localhost:{port}", rank=rank,
        world_size=n, timeout=datetime.timedelta(seconds=TP_TIMEOUT_S))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run = _TPRun(torch, dist, rank, make_mesh(n))
    res = run.main(phases)
    if rank == 0:
        Path(out).write_text(json.dumps(res))
    dist.barrier()
    dist.destroy_process_group()


class _TPRun:
    """One rank of the four-card mode. Rank 0 prints; every gate raises."""

    def __init__(self, torch, dist, rank, mesh):
        from repro_torch.kernels import decode_attention as da
        from repro_torch.kernels import flash_attention as fa
        from repro_torch.kernels import moe_gating as mg
        from repro_torch.kernels import rwkv6_scan as rk
        from repro_torch.kernels import ssm_scan as ss
        self.torch, self.dist, self.rank, self.mesh = torch, dist, rank, mesh
        self.n = mesh.size()
        self.dev = torch.device("cuda", rank)
        self.da, self.fa, self.mg, self.rk, self.ss = da, fa, mg, rk, ss
        self.meshes = {(1, mesh.size()): mesh}
        self.gen = torch.Generator(device=self.dev).manual_seed(rank)
        self.launches_by_path = {}
        self.t_start = time.perf_counter()
        # card 0's last one-card reference (key, outputs), reused by the
        # next case of the same config and inputs (``one_card_run``)
        self.kept = (None, None)
        self.prefill_calls = []

    # -- helpers ------------------------------------------------------------
    def say(self, line: str) -> None:
        if self.rank == 0:
            print(line, flush=True)

    def all(self, obj) -> list:
        out = [None] * self.n
        self.dist.all_gather_object(out, obj)
        return out

    def free(self) -> None:
        gc.collect()
        self.torch.cuda.empty_cache()

    def zero(self) -> None:
        self.fa.launches = self.da.launches = self.da.merge_launches = 0
        self.mg.launches = self.rk.launches = self.ss.launches = 0

    def read(self) -> dict:
        return {"flash_attention": self.fa.launches,
                "decode_attention": self.da.launches,
                "decode_merge": self.da.merge_launches,
                "moe_route": self.mg.launches,
                "rwkv6_scan": self.rk.launches,
                "ssm_scan": self.ss.launches}

    def mesh_of(self, shape):
        """The (data, model) mesh of this shape, made once."""
        if shape not in self.meshes:
            from repro_torch.launch.mesh import make_mesh
            self.meshes[shape] = make_mesh(self.n, shape[0])
        return self.meshes[shape]

    def expect(self, what, cfg, prefills, decodes, seq_sharded) -> dict:
        """This rank's launches against the layer counts, equal on every
        rank; kept under ``what`` for the kernels line. Every MoE layer
        call routes its global tokens once on every card; every recurrent
        layer call scans its card's channels or heads once."""
        kinds = [spec.kind for spec in cfg.layer_specs()]
        attn = kinds.count("attn")
        moe = sum(spec.mlp == "moe" for spec in cfg.layer_specs())
        want = {"flash_attention": attn * prefills,
                "decode_attention": attn * decodes,
                "decode_merge": attn * decodes if seq_sharded else 0,
                "moe_route": moe * (prefills + decodes),
                "rwkv6_scan": kinds.count("rwkv") * (prefills + decodes),
                "ssm_scan": kinds.count("mamba") * (prefills + decodes)}
        got = self.read()
        every = self.all(got)
        if any(g != want for g in every):
            raise AssertionError(f"{what}: launches by rank {every}, "
                                 f"expected {want}")
        self.launches_by_path[what] = got
        return got

    def rnd(self, shape, dtype):
        return self.torch.randn(shape, generator=self.gen,
                                device=self.dev).to(dtype)

    def err(self, a, b) -> float:
        return float((a.float() - b.float()).abs().max())

    def time_ms(self, fn, args_sets, iters=20) -> float:
        torch = self.torch
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

    def device_ms(self, fn, args_sets, iters=20):
        """Device ms per call (every kernel's self time under torch.profiler;
        CUDA events where three sessions saw no device time)."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        for i in range(3):
            fn(*args_sets[i % len(args_sets)])
        self.torch.cuda.synchronize()
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for i in range(iters):
                    fn(*args_sets[i % len(args_sets)])
                self.torch.cuda.synchronize()
            total = sum(e.self_device_time_total for e in prof.key_averages()
                        if e.device_type == DeviceType.CUDA)
            if total > 0:
                return total / 1e3 / iters
        return self.time_ms(fn, args_sets, iters)

    def build(self, cfg, mesh=None, rules=None):
        from repro_torch.models import transformer as T
        torch = self.torch
        t0 = time.perf_counter()
        model = T.Transformer(
            cfg, device=self.dev, mesh=mesh, rules=rules,
            generator=torch.Generator(device=self.dev).manual_seed(0))
        torch.cuda.synchronize()
        self.say(f"model: {cfg.name} {cfg.n_layers} layers {cfg.dtype} "
                 f"(weights {cfg.param_dtype}) "
                 f"{'mesh' if mesh is not None else 'one card'}, "
                 f"{sum(p.numel() for p in model.parameters())} params on "
                 f"rank 0, init {time.perf_counter() - t0:.1f} s")
        return model

    def one_card_run(self, key, run, keep=True):
        """Card 0's one-card reference of ``key``: the kept one where the
        last case had the same key (the same config, weights and inputs
        give the same outputs), else ``run()``'s, kept where ``keep``
        (the previous one dropped first: one is held at a time, and
        ``memory`` drops it, so no phase measures beside it)."""
        if self.kept[0] == key:
            return self.kept[1]
        self.kept = (None, None)
        self.free()
        out = run()
        if keep:
            self.kept = (key, out)
        return out

    def memory(self, where: str) -> None:
        """Each card's free memory beside what this process's caching
        allocator holds (GB), on a `mem:` line (card 0's kept one-card
        reference dropped first)."""
        torch = self.torch
        self.kept = (None, None)
        self.free()
        free, total = torch.cuda.mem_get_info(self.dev)
        every = self.all([round(x / 1e9, 3) for x in (
            free, total, torch.cuda.memory_reserved(self.dev),
            torch.cuda.memory_allocated(self.dev))])
        self.say(f"mem: {where}: [free, total, reserved, allocated] GB by "
                 f"rank {every}")

    def warm_profiler(self) -> None:
        """One short profiler session on every card: CUPTI's first start
        takes seconds, which a card waiting in NCCL would count."""
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            self.torch.ones(1, device=self.dev).sum().item()
        self.dist.barrier()

    # -- phases -------------------------------------------------------------
    def main(self, phases=PHASE_GROUPS) -> dict:
        """The groups of ``phases`` in ``PHASE_GROUPS``' order, kernels tp
        after sp; with sp but without the group of an sp record's baseline,
        that baseline record alone (``sp_baselines``)."""
        self.warm_profiler()
        self.memory("start")
        if "sp" in phases:
            self.sp_phases()
        t = time.perf_counter()
        rows = self.kernels_tp() if self.rank == 0 else None
        self.dist.barrier()
        self.say(f"phase kernels tp: {time.perf_counter() - t:.1f} s")
        records, train_err = [], None
        if "rec" in phases:
            records += self.rec_phases()
        if "mod" in phases:
            records += self.mod_phases()
        if "tp" in phases:
            t = time.perf_counter()
            train_err = self.train_tp()
            self.say(f"phase train tp: {time.perf_counter() - t:.1f} s")
            self.memory("after train tp")
            t = time.perf_counter()
            self.path_tp()
            self.say(f"phase path tp: {time.perf_counter() - t:.1f} s")
            self.memory("after path tp")
            t = time.perf_counter()
            self.serving_tp()
            self.say(f"phase serving tp: {time.perf_counter() - t:.1f} s")
            self.memory("before the records")
            t = time.perf_counter()
            records += self.dryrun_tp()
            self.say(f"phase dryrun tp: {time.perf_counter() - t:.1f} s")
        if "ep" in phases:
            records += self.ep_phases()
        if "sp" in phases:
            t = time.perf_counter()
            self.sp_baselines(phases)
            self.say(f"phase sp baselines: {time.perf_counter() - t:.1f} s")
        if self.rank != 0:
            return {}
        if "sp" in phases:
            self.sp_beside_baseline()
        self.profile_tp(records)
        if train_err is not None:
            rows[0]["train_lse_err"] = train_err["max_abs_err"]
            rows[0]["train_shape"] = train_err
        # the sp phases, as the whole mode, run every kernel's layers
        every = "sp" in phases or set(phases) == set(PHASE_GROUPS)
        for row in rows:
            row["launches_by_path"] = {
                path: counts[row["counter"]]
                for path, counts in self.launches_by_path.items()}
            row["launches"] = sum(row["launches_by_path"].values())
            if every and not row["launches"]:
                raise AssertionError(f"{row['name']} was never launched on "
                                     "the four-card paths")
        self.say(f"four-card phases: {time.perf_counter() - self.t_start:.1f}"
                 " s")
        return {"kernels": rows}

    def kernels_tp(self) -> list:
        """The decode kernel's partial mode against its plain version, the
        merge of 4 partials against the one-call kernel, a kv-head view of
        a replicated cache; then the kernels line's timings at the
        four-card shapes."""
        torch, da = self.torch, self.da
        from repro_torch.kernels import ops, ref
        f32, bf16 = torch.float32, torch.bfloat16
        R = self.n
        cases = [  # name, B, S (all cards), H, KVH, window, softcap, lengths
            ("qwen2 heads, rows over 4 cards", 8, 2048, 12, 2, None, None,
             (0, 1, 511, 512, 513, 1024, 1535, 2047)),
            ("gemma2 local layer, window across shard edges", 8, 16384, 32,
             16, 4096, 50.0, (100, 4095, 4097, 6000, 8191, 8192, 12000,
                              16383)),
            ("gemma2 global layer", 4, 16384, 32, 16, None, 50.0,
             (1, 4096, 9000, 16383)),
        ]
        errs = {}
        n_calls = n_merges = 0
        self.zero()
        for name, B, S, H, KVH, window, softcap, lens in cases:
            Dh, Sl = 128, S // R
            for dtype in (f32, bf16):
                tol = TOL[str(dtype).split(".")[-1]]
                q = self.rnd((B, H, Dh), dtype)
                kc, vc = self.rnd((B, S, KVH, Dh), dtype), \
                    self.rnd((B, S, KVH, Dh), dtype)
                kn, vn = self.rnd((B, KVH, Dh), dtype), \
                    self.rnd((B, KVH, Dh), dtype)
                lengths = torch.tensor(lens, device=self.dev)
                for mode in ("committed", "append"):
                    news = {"k_new": kn, "v_new": vn} if mode == "append" \
                        else {}
                    ln = lengths if mode == "append" else \
                        torch.clamp(lengths, min=1)
                    parts = []
                    worst = {"m": 0.0, "l_rel": 0.0, "o": 0.0}
                    for r in range(R):
                        rows = slice(r * Sl, (r + 1) * Sl)
                        args = (q, kc[:, rows], vc[:, rows], ln)
                        kw = dict(window=window, softcap=softcap,
                                  start=r * Sl, partial=True, **news)
                        got = da.decode_attention(*args, **kw)
                        n_calls += 1
                        want = ref.decode_attention_direct(*args, **kw)
                        empty = want[..., 0] <= -1e29
                        if not torch.equal(empty, got[..., 0] <= -1e29):
                            raise AssertionError(f"kernels tp {name}: empty "
                                                 f"partials differ")
                        full = ~empty
                        if full.any():
                            worst["m"] = max(worst["m"], self.err(
                                got[..., 0][full], want[..., 0][full]))
                            worst["l_rel"] = max(worst["l_rel"], float(
                                ((got[..., 1] - want[..., 1]).abs()
                                 / want[..., 1].clamp(min=1e-30))[full]
                                .max()))
                            worst["o"] = max(worst["o"], self.err(
                                (got[..., 2:] / got[..., 1:2])[full],
                                (want[..., 2:] / want[..., 1:2])[full]))
                        parts.append(got)
                    merged = da.merge(torch.stack(parts), dtype)
                    n_merges += 1
                    one = da.decode_attention(q, kc, vc, ln, window=window,
                                              softcap=softcap, **news)
                    n_calls += 1
                    plain = ops.decode_attention(q, kc, vc, ln,
                                                 window=window,
                                                 softcap=softcap,
                                                 impl="plain", **news)
                    worst["merge_vs_one_call"] = self.err(merged, one)
                    worst["merge_vs_plain"] = self.err(merged, plain)
                    key = f"{name} {str(dtype)[6:]} {mode}"
                    errs[key] = worst
                    if not all(v <= tol for v in worst.values()):
                        raise AssertionError(f"kernels tp {key}: {worst} "
                                             f"(tol {tol})")
                del q, kc, vc, kn, vn
        # a replicated cache read through a view of the kv head a card's 3
        # query heads map to (qwen2: 12 / 2 heads over 4 cards)
        for dtype in (f32, bf16):
            tol = TOL[str(dtype).split(".")[-1]]
            kc, vc = self.rnd((8, 2048, 2, 128), dtype), \
                self.rnd((8, 2048, 2, 128), dtype)
            q = self.rnd((8, 3, 128), dtype)
            kn, vn = self.rnd((8, 1, 128), dtype), self.rnd((8, 1, 128),
                                                            dtype)
            ln = torch.tensor((1, 7, 300, 1024, 1500, 2000, 2046, 512),
                              device=self.dev)
            got = da.decode_attention(q, kc[:, :, 1:2], vc[:, :, 1:2], ln,
                                      k_new=kn, v_new=vn)
            n_calls += 1
            want = ref.decode_attention_direct(
                q, kc[:, :, 1:2].contiguous(), vc[:, :, 1:2].contiguous(),
                ln, k_new=kn, v_new=vn)
            e = self.err(got, want)
            errs[f"kv-head view {str(dtype)[6:]} append"] = {"o": e}
            if not e <= tol:
                raise AssertionError(f"kernels tp kv-head view: {e}")
        launched = (da.launches, da.merge_launches)
        if launched != (n_calls, n_merges):
            raise AssertionError(f"kernels tp: launches {launched}, calls "
                                 f"{(n_calls, n_merges)}")
        self.say("kernels tp: " + json.dumps(errs))
        self.free()
        rows = self.kernel_rows(errs)
        mod = self.mod_kernel_shapes()
        for row in rows:
            if row["name"] in mod:
                row["mod_shapes"] = mod[row["name"]]
                row["max_abs_err"] = max(row["max_abs_err"], max(
                    v["max_abs_err"] for v in mod[row["name"]].values()))
        return rows + self.scan_rows()

    def mod_kernel_shapes(self) -> dict:
        """Both attention kernels at a card's shapes of vision and musicgen
        on 1x4 (bf16), each against its plain version within bf16's 2e-2
        and timed beside it, SDPA on the same inputs (kv heads repeated to
        the query heads) and the bound of the larger of its bytes (each
        input read and the output written once) and its operations:
        {row name: {shape: numbers}}."""
        torch, da = self.torch, self.da
        from repro_torch.kernels import ops, ref
        bf16, tol = torch.bfloat16, TOL["bfloat16"]
        sdpa = torch.nn.functional.scaled_dot_product_attention
        out = {"flash_attention": {}, "decode_attention": {},
               "decode_attention.merge": {}}

        def bound(flops, nbytes):
            b = {"operations": flops / PEAK_BF16_FLOPS * 1e3,
                 "bytes": nbytes / PEAK_BYTES * 1e3}
            return {"bound_ms": max(b.values()),
                    "bound_by": max(b, key=b.get), "flops": flops,
                    "bytes": nbytes}

        def library(q, k, v, causal):
            """SDPA's (B, H, S, Dh) operands of (B, S, H, Dh) ones, or of
            decode's (B, H, Dh) q over a (B, S, KVH, Dh) cache."""
            G = q.shape[-2] // k.shape[-2]
            q = q[:, :, None] if q.dim() == 3 else q.transpose(1, 2)
            return (q, k.repeat_interleave(G, 2).transpose(1, 2).contiguous(),
                    v.repeat_interleave(G, 2).transpose(1, 2).contiguous(),
                    causal)

        def check(name, what, got, want):
            e = self.err(got, want)
            if not e <= tol:
                raise AssertionError(f"kernels tp mod {what}: {e}")
            return e

        prefills = (("vision cross", 1024, 1600, 8, 2, 128, False),
                    ("musicgen", 1024, 1024, 8, 8, 64, True))
        for what, Sq, Skv, H, KVH, Dh, causal in prefills:
            sets = [(self.rnd((1, Sq, H, Dh), bf16),
                     self.rnd((1, Skv, KVH, Dh), bf16),
                     self.rnd((1, Skv, KVH, Dh), bf16)) for _ in range(4)]

            def flash(q, k, v, impl="cuda"):
                return ops.flash_attention(q, k, v, causal=causal,
                                           impl=impl)

            e = check("flash_attention", what, flash(*sets[0]),
                      flash(*sets[0], impl="plain"))
            pairs = Sq * (Sq + 1) // 2 if causal else Sq * Skv
            lib = [library(*a, causal) for a in sets]
            out["flash_attention"][
                f"{what} prefill: B=1 Sq={Sq} Skv={Skv} H={H} KVH={KVH} "
                f"Dh={Dh} bf16 {'causal' if causal else 'non-causal'}"] = {
                "max_abs_err": e, "ms": self.device_ms(flash, sets),
                "plain_ms": self.time_ms(lambda *a: flash(*a, impl="plain"),
                                         sets, iters=5),
                "library_ms": self.time_ms(lambda a, b, c, d: sdpa(
                    a, b, c, is_causal=d), lib),
                **bound(4 * H * Dh * pairs,
                        2 * (2 * Sq * H * Dh + 2 * Skv * KVH * Dh))}
            del sets, lib
        decodes = (("vision cross", 8, 1600, 8, 2, 128),
                   ("musicgen", 8, 2048, 8, 8, 64))
        for what, Bd, S, H, KVH, Dh in decodes:
            sets = [(self.rnd((Bd, H, Dh), bf16),
                     self.rnd((Bd, S, KVH, Dh), bf16),
                     self.rnd((Bd, S, KVH, Dh), bf16),
                     torch.full((Bd,), S, device=self.dev))
                    for _ in range(2)]

            def decode(q, k, v, ln, impl="cuda"):
                return ops.decode_attention(q, k, v, ln, impl=impl)

            e = check("decode_attention", what, decode(*sets[0]),
                      decode(*sets[0], impl="plain"))
            lib = [library(q, k, v, False) for q, k, v, _ in sets]
            out["decode_attention"][
                f"{what} decode: B={Bd} S={S} (every row) H={H} KVH={KVH} "
                f"Dh={Dh} bf16"] = {
                "max_abs_err": e, "ms": self.device_ms(decode, sets),
                "plain_ms": self.time_ms(lambda *a: decode(*a, impl="plain"),
                                         sets, iters=5),
                "library_ms": self.time_ms(lambda a, b, c, d: sdpa(
                    a, b, c, is_causal=d), lib),
                **bound(4 * Bd * S * H * Dh,
                        2 * Bd * S * KVH * Dh * 2 + 2 * Bd * H * Dh * 2
                        + Bd * 8)}
            del sets, lib
        # the row-cut cross cache: every one of the 32 query heads over a
        # card's 400 of the 1600 rows, all 8 kv heads, the 4 partials merged
        Bd, Nv, H, KVH, Dh, R = 8, 1600, 32, 8, 128, self.n
        Sl = Nv // R
        q = self.rnd((Bd, H, Dh), bf16)
        kc, vc = self.rnd((Bd, Nv, KVH, Dh), bf16), \
            self.rnd((Bd, Nv, KVH, Dh), bf16)
        ln = torch.full((Bd,), Nv, device=self.dev)
        sets = [(q, kc[:, r * Sl:(r + 1) * Sl].contiguous(),
                 vc[:, r * Sl:(r + 1) * Sl].contiguous(), r * Sl)
                for r in range(R)]

        def partial(q, k, v, start, impl="cuda"):
            return ops.decode_attention(q, k, v, ln, start=start,
                                        partial=True, impl=impl)

        parts = torch.stack([partial(*a) for a in sets])
        merged = da.merge(parts, bf16)
        e = max(check("decode_attention", "row-cut merge vs one call",
                      merged, da.decode_attention(q, kc, vc, ln)),
                check("decode_attention", "row-cut merge vs plain", merged,
                      ops.decode_attention(q, kc, vc, ln, impl="plain")))
        lib = [library(q, k, v, False) for q, k, v, _ in sets[:1]]
        out["decode_attention"][
            f"vision cross decode, rows cut: B={Bd} {Sl} of {Nv} rows a "
            f"card (start {Sl}) H={H} KVH={KVH} Dh={Dh} bf16 partial"] = {
            "max_abs_err": e, "ms": self.device_ms(partial, sets[1:2]),
            "plain_ms": self.time_ms(lambda *a: partial(*a, impl="plain"),
                                     sets[1:2], iters=5),
            "library_ms": self.time_ms(lambda a, b, c, d: sdpa(
                a, b, c, is_causal=d), lib),
            "library": "SDPA over the card's rows, normalised (no "
                       "partials)",
            **bound(4 * Bd * Sl * H * Dh,
                    2 * Bd * Sl * KVH * Dh * 2 + Bd * H * Dh * 2 + Bd * 8
                    + Bd * H * (Dh + 2) * 4)}
        pset = [(parts,)]
        out["decode_attention.merge"][
            f"vision cross decode, rows cut: R={R} partials (R, B={Bd}, "
            f"H={H}, Dh+2) fp32 -> bf16"] = {
            "max_abs_err": check("decode_attention.merge", "merge vs its "
                                 "plain version", merged,
                                 ref.decode_merge(parts, bf16)),
            "ms": self.device_ms(lambda p: da.merge(p, bf16), pset),
            "plain_ms": self.time_ms(lambda p: ref.decode_merge(p, bf16),
                                     pset),
            "library_ms": None,
            **bound(0, R * Bd * H * (Dh + 2) * 4 + Bd * H * Dh * 2)}
        del q, kc, vc, sets, parts, merged, lib, pset
        self.free()
        self.say("kernels tp mod: " + json.dumps(out))
        return out

    def kernel_rows(self, errs) -> list:
        """The kernels line's rows at the four-card shapes: the decode
        kernel's partial mode at qwen2's decode_32k shard (B=128, 8192 of
        the 32768 rows, 12 / 2 heads), the merge of its 4 partials, and
        the flash kernel at qwen2's per-card prefill (3 query heads, 1 kv
        head, S=1024)."""
        torch, da = self.torch, self.da
        from repro_torch.kernels import ops, ref
        bf16 = torch.bfloat16
        B, Sl, H, KVH, Dh, R = 128, 8192, 12, 2, 128, self.n
        start, length = Sl * (R - 1), Sl * R - 1
        sets = [(self.rnd((B, H, Dh), bf16), self.rnd((B, Sl, KVH, Dh), bf16),
                 self.rnd((B, Sl, KVH, Dh), bf16),
                 torch.full((B,), length, device=self.dev),
                 self.rnd((B, KVH, Dh), bf16), self.rnd((B, KVH, Dh), bf16))
                for _ in range(2)]

        def partial(q, kc, vc, ln, kn, vn, impl="cuda"):
            return ops.decode_attention(q, kc, vc, ln, k_new=kn, v_new=vn,
                                        start=start, partial=True, impl=impl)

        got = partial(*sets[0])
        want = partial(*sets[0], impl="plain")
        p_err = self.err(got[..., 2:] / got[..., 1:2],
                         want[..., 2:] / want[..., 1:2])
        p_bytes = 2 * B * Sl * KVH * Dh * 2 + B * H * Dh * 2 \
            + 2 * B * KVH * Dh * 2 + B * 8 + B * H * (Dh + 2) * 4
        p_flops = 4 * B * (Sl + 1) * H * Dh
        p_bound = {"bytes": p_bytes / PEAK_BYTES * 1e3,
                   "operations": p_flops / PEAK_BF16_FLOPS * 1e3}
        decode_row = {
            "name": "decode_attention", "counter": "decode_attention",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
            "replaces": "src/repro/kernels/decode_attention.py:76",
            "shape": f"partial mode, one card of 4: B={B} S={Sl} of "
                     f"{Sl * R} (start {start}) H={H} KVH={KVH} Dh={Dh} "
                     "bf16 append, lengths all "
                     f"{length}",
            "max_abs_err": max(max(v.values()) for v in errs.values()),
            "partial_err_at_shape": p_err, "tol": TOL["bfloat16"],
            "errors": errs,
            "ms": self.device_ms(partial, sets),
            "call_ms": self.time_ms(partial, sets),
            "plain_ms": self.time_ms(lambda *a: partial(*a, impl="plain"),
                                     sets, iters=3),
            "bound_ms": max(p_bound.values()),
            "bound_by": max(p_bound, key=p_bound.get),
            "library_ms": None,
            "library": "none: no one PyTorch call gives a softmax's "
                       "unnormalised partials",
            "flops": p_flops, "bytes": p_bytes}
        parts = [(torch.stack([partial(*sets[0])] * R),)]
        m_bytes = R * B * H * (Dh + 2) * 4 + B * H * Dh * 2
        merged = da.merge(parts[0][0], bf16)
        m_err = self.err(merged, ref.decode_merge(parts[0][0], bf16))
        merge_row = {
            "name": "decode_attention.merge", "counter": "decode_merge",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
            "replaces": "src/repro/kernels/decode_attention.py:76",
            "shape": f"R={R} partials (R, B={B}, H={H}, Dh+2) fp32 -> "
                     f"(B, H, Dh) bf16 (the combine pass)",
            "max_abs_err": m_err, "tol": TOL["bfloat16"],
            "ms": self.device_ms(lambda p: da.merge(p, bf16), parts),
            "call_ms": self.time_ms(lambda p: da.merge(p, bf16), parts),
            "plain_ms": self.time_ms(lambda p: ref.decode_merge(p, bf16),
                                     parts),
            "bound_ms": m_bytes / PEAK_BYTES * 1e3, "bound_by": "bytes",
            "library_ms": None,
            "library": "none: no one PyTorch call merges softmax partials",
            "bytes": m_bytes}
        del sets, parts
        self.free()
        # flash at qwen2's per-card prefill: 3 query heads on 1 kv head
        S, Hq, Hk = 1024, 3, 1
        fsets = [(self.rnd((1, S, Hq, Dh), bf16), self.rnd((1, S, Hk, Dh),
                                                          bf16),
                  self.rnd((1, S, Hk, Dh), bf16)) for _ in range(4)]
        f_err = self.err(ops.flash_attention(*fsets[0], impl="cuda"),
                         ops.flash_attention(*fsets[0], impl="plain"))
        g_err = 0.0      # gemma2's per-card heads, window and softcap
        gq, gk, gv = self.rnd((1, S, 8, Dh), bf16), \
            self.rnd((1, S, 4, Dh), bf16), self.rnd((1, S, 4, Dh), bf16)
        for window in (None, 300):
            g_err = max(g_err, self.err(
                ops.flash_attention(gq, gk, gv, window=window, softcap=50.0,
                                    impl="cuda"),
                ops.flash_attention(gq, gk, gv, window=window, softcap=50.0,
                                    impl="plain")))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lib_sets = [(a.transpose(1, 2), b.repeat_interleave(Hq, 2)
                     .transpose(1, 2).contiguous(),
                     c.repeat_interleave(Hq, 2).transpose(1, 2).contiguous())
                    for a, b, c in fsets]
        pairs = S * (S + 1) // 2
        f_flops = 4 * Hq * Dh * pairs
        f_bytes = 2 * (2 * S * Hq * Dh + 2 * S * Hk * Dh)
        f_bound = {"operations": f_flops / PEAK_BF16_FLOPS * 1e3,
                   "bytes": f_bytes / PEAK_BYTES * 1e3}
        flash_row = {
            "name": "flash_attention", "counter": "flash_attention",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:92",
            "shape": f"one card of 4: B=1 Sq=Skv={S} H={Hq} KVH={Hk} "
                     f"Dh={Dh} bf16 causal (qwen2's heads / 4)",
            "max_abs_err": max(f_err, g_err), "tol": TOL["bfloat16"],
            "gemma2_card_err": g_err,
            "ms": self.device_ms(lambda *a: ops.flash_attention(
                *a, impl="cuda"), fsets),
            "plain_ms": self.time_ms(lambda *a: ops.flash_attention(
                *a, impl="plain"), fsets, iters=5),
            "library_ms": self.time_ms(lambda a, b, c: sdpa(
                a, b, c, is_causal=True), lib_sets),
            "bound_ms": max(f_bound.values()),
            "bound_by": max(f_bound, key=f_bound.get),
            "flops": f_flops, "bytes": f_bytes}
        for row in (decode_row, merge_row, flash_row):
            if not row["max_abs_err"] <= row["tol"]:
                raise AssertionError(f"kernels tp {row['name']}: "
                                     f"{row['max_abs_err']}")
        del fsets, lib_sets, gq, gk, gv
        self.free()
        route_row = self.route_row()
        self.say("kernels tp timing: " + json.dumps(
            {r["name"]: {k: r[k] for k in ("ms", "plain_ms", "bound_ms",
                                           "library_ms")}
             for r in (decode_row, merge_row, flash_row, route_row)}))
        return [flash_row, decode_row, merge_row, route_row]

    def route_row(self) -> dict:
        """The kernels line's routing row at the four-card shapes: the
        global tokens every card routes in granite's train_4k microbatch on
        mesh 2x2 (2 rows of 4096: T * k at the block limit), its
        decode_32k step on 1x4 (T = 128) and kimi-k2's served decode step
        (T = 8, E = 384); every integer against the plain version."""
        torch = self.torch
        from repro_torch.configs import get_config
        from repro_torch.kernels import ops
        from repro_torch.models.moe import capacity
        res = {}
        for arch, T_ in ((EP_ARCH, 8192), (EP_ARCH, 128), (EP_KIMI, B_D)):
            cfg = get_config(arch)
            E, k = cfg.n_experts, cfg.moe_top_k
            cap = capacity(cfg, T_)
            sets = [(self.rnd((T_, E), torch.float32) * 2,)
                    for _ in range(4)]

            def kernel(x, impl="cuda"):
                return ops.moe_route(x, k, cap=cap, nb=1, impl=impl)

            got, want = kernel(*sets[0]), kernel(*sets[0], impl="plain")
            if not all(torch.equal(a.long(), b.long())
                       for a, b in zip(got[1:5], want[1:5])):
                raise AssertionError(f"route row T={T_} E={E}: integers "
                                     "differ from the plain version")
            nbytes = T_ * E * 4 + T_ * k * 16 + 2 * (E * cap + 1) * 8
            n_ops = T_ * E * (5 + k)
            bound = {"bytes": nbytes / PEAK_BYTES * 1e3,
                     "operations": n_ops / PEAK_FP32_FLOPS * 1e3}
            res[f"{arch} T={T_} E={E} k={k} cap={cap}"] = {
                "max_abs_err": self.err(got[0], want[0]),
                "ms": self.device_ms(kernel, sets),
                "call_ms": self.time_ms(kernel, sets),
                "plain_ms": self.time_ms(lambda x: kernel(x, "plain"),
                                         sets),
                "bound_ms": max(bound.values()),
                "bound_by": max(bound, key=bound.get),
                "bytes": nbytes, "operations": n_ops}
            del sets
        (shape, first), = list(res.items())[:1]
        row = {"name": "moe_gating", "counter": "moe_route", "route": "cuda",
               "source": "src/repro_torch/kernels/csrc/moe_gating.cu",
               "replaces": "src/repro/kernels/moe_gating.py:43",
               "entry": "ops.moe_route: one launch a MoE layer call on "
                        "every card, over the layer's global tokens",
               "shape": shape, **first, "tol": GATING_TOL,
               "max_abs_err": max(r["max_abs_err"] for r in res.values()),
               "library_ms": None,
               "library": "none: no one PyTorch call computes the routing",
               "shapes": res}
        self.free()
        return row

    def scan_rows(self) -> list:
        """The kernels line's scan rows at a card's shapes (REC_SCAN_SHAPES:
        Jamba's Mamba at Din 4096 of 16384, rwkv6's WKV6 at 8 of 32 heads):
        fp32 and bf16 against the plain versions (ops impl="plain") within
        SCAN_TOL, a bf16 output within one more bf16 ulp of its magnitude;
        the decode step's state a slot of a stacked cache, written in
        place; Bm / Cm views of x_proj's output. Device ms a call (bf16,
        as served) beside the plain version's, the bound of each input
        read and output written once at 3.35 TB/s against the scan's fp32
        operations at 67 TFLOP/s."""
        torch = self.torch
        from repro_torch.kernels import ops
        f32, bf16 = torch.float32, torch.bfloat16
        Din, N, R, H, K = REC_DIN, REC_N, REC_R, REC_H, REC_K

        def rwkv_args(B, Tn, dtype):
            r, k, v = (self.rnd((B, Tn, H, K), f32) * 0.5 for _ in range(3))
            w = torch.exp(-torch.exp(self.rnd((B, Tn, H, K), f32) * 0.5
                                     - 1))
            cache = self.rnd((2, B, H, K, K), f32) * 0.1
            return (r.to(dtype), k.to(dtype), v.to(dtype), w,
                    self.rnd((H, K), f32) * 0.3, cache[1])

        def ssm_args(B, Tn, dtype):
            dt = torch.nn.functional.softplus(
                self.rnd((B, Tn, Din), f32)) * 0.1
            dbc = self.rnd((B, Tn, R + 2 * N), dtype)     # x_proj's output
            cache = self.rnd((2, B, Din, N), f32) * 0.1
            return (self.rnd((B, Tn, Din), dtype), dt,
                    -torch.exp(self.rnd((Din, N), f32) * 0.3),
                    dbc[..., R:R + N], dbc[..., R + N:],
                    self.rnd((Din,), f32), cache[1])

        def rwkv_bound(B, Tn):
            n = B * Tn * H * K
            return (n * (4 * 2 + 4) + H * K * 4 + 2 * B * H * K * K * 4,
                    5 * B * Tn * H * K * K)

        def ssm_bound(B, Tn):
            n = B * Tn * Din
            return (n * (2 * 2 + 4) + 2 * B * Tn * N * 2 + Din * N * 4
                    + Din * 4 + 2 * B * Din * N * 4, n * (7 * N + 3))

        rows = []
        for name, scan, make, bound, what in (
                ("rwkv6_scan", ops.rwkv6_scan, rwkv_args, rwkv_bound,
                 f"H={H} of 32 K={K} bf16 r/k/v, fp32 w"),
                ("ssm_scan", ops.ssm_scan, ssm_args, ssm_bound,
                 f"Din={Din} of 16384 N={N} bf16 x/Bm/Cm, fp32 dt/A/D")):
            errs, shapes = {}, {}
            for label, B, Tn in REC_SCAN_SHAPES:
                for dtype in (f32, bf16):
                    args = make(B, Tn, dtype)
                    out_r, st_r = scan(*args[:-1], args[-1].clone(),
                                       impl="plain")
                    out, st = scan(*args, impl="cuda", state_out=args[-1])
                    diff = (out.float() - out_r.float()).abs()
                    lim = SCAN_TOL + (BF16_ULP * out_r.float().abs()
                                      if dtype == bf16 else 0.0)
                    e = max(float(diff.max()), self.err(st, st_r))
                    if not (bool((diff < lim).all()) and st is args[-1]
                            and self.err(st, st_r) < SCAN_TOL):
                        raise AssertionError(
                            f"kernels tp {name} {label} {dtype}: {e}")
                    errs[f"{label} {str(dtype)[6:]}"] = e
                    del args, out_r, st_r, out, st, diff
                sets = [make(B, Tn, bf16) for _ in range(2)]
                nbytes, n_ops = bound(B, Tn)
                b = {"bytes": nbytes / PEAK_BYTES * 1e3,
                     "operations": n_ops / PEAK_FP32_FLOPS * 1e3}
                shapes[label] = {
                    "shape": f"B={B} T={Tn} {what}",
                    "ms": self.device_ms(
                        lambda *a: scan(*a, impl="cuda"), sets, iters=10),
                    "plain_ms": self.device_ms(
                        lambda *a: scan(*a, impl="plain"), sets, iters=3),
                    "bytes_bound_ms": b["bytes"],
                    "bound_ms": max(b.values()),
                    "bound_by": max(b, key=b.get), "bytes": nbytes,
                    "operations": n_ops}
                del sets
                self.free()
            kernel = "rwkv6" if name == "rwkv6_scan" else "ssm"
            lib = "the WKV6 recurrence" if kernel == "rwkv6" else \
                "the selective scan"
            rows.append({
                "name": name, "counter": name, "route": "cuda",
                "source": f"src/repro_torch/kernels/csrc/{name}.cu",
                "replaces": f"src/repro/kernels/{name}.py:"
                            f"{46 if kernel == 'rwkv6' else 47}",
                **shapes["prefill"], "max_abs_err": max(errs.values()),
                "tol": SCAN_TOL, "errors": errs, "shapes": shapes,
                "library_ms": None,
                "library": f"none: no one PyTorch call computes {lib}"})
        self.say("kernels tp scans: " + json.dumps(
            {r["name"]: r["shapes"] for r in rows}))
        return rows

    def path_tp(self) -> None:
        """Prefill and teacher-forced decode (append and committed) on the
        mesh against the same weights on card 0 without a mesh: fp32
        gated (1e-3, argmax equal), bf16 reported; launches exact."""
        from repro_torch.configs import get_config
        for arch, layers, B, max_seq, lens in TP_PATH:
            base = get_config(arch)
            if layers:
                base = cut(base, layers)
            for dtype in ("float32", "bfloat16"):
                cfg = dataclasses.replace(base, dtype=dtype, param_dtype=dtype)
                self._path_gate(cfg, (1, self.n), B, max_seq, lens,
                                "path tp", gate=dtype == "float32")

    def _path_run(self, cfg, model, tokens, steps, lens, max_seq,
                  vision=None):
        """The last prefill rows of every prompt (with its vision
        embeddings, ``vision`` (B, Nv, D) on the device, for a vision
        config) and each decode step's logits, append and committed
        (gathered on a mesh), on card 0's device for the comparison. On a
        mesh every prefill and decode step makes the collectives of
        ``Transformer.step_collectives``."""
        torch = self.torch
        from repro_torch.distributed import sharding as SH
        from repro_torch.models import transformer as T
        B = tokens.shape[0]
        out = {}
        caches = {m: T.init_cache(cfg, B, max_seq, device=self.dev,
                                  mesh=model.layout)
                  for m in ("append", "committed")}

        def collectives(what, want):
            got = SH.collectives()["calls"]
            if model.layout is not None and got != want():
                raise AssertionError(f"{cfg.name} {what}: collectives {got}"
                                     f" != {want()}")
            return got

        self.prefill_calls = []
        for b, L in enumerate(lens):
            SH.reset_collectives()
            logits, pf = model.prefill(
                torch.from_numpy(tokens[b:b + 1, :L]).to(self.dev),
                vision_embeds=None if vision is None else vision[b:b + 1])
            self.prefill_calls.append(collectives(
                f"prefill {b}", lambda: model.step_collectives(batch=1,
                                                               seq=L)))
            rows = model.gather_logits(logits[:, -TP_PREFILL_ROWS:], 1)
            out[f"prefill {b}"] = rows[0].float()
            for cache in caches.values():
                T.cache_insert(cfg, cache, pf, b, L)
            del logits, pf, rows
        for mode, cache in caches.items():
            lengths = np.array(lens)
            for i in range(len(steps)):
                SH.reset_collectives()
                logits, _ = model.decode_step(
                    cache, torch.from_numpy(steps[i]).to(self.dev),
                    torch.from_numpy(lengths), append=mode == "append")
                collectives(f"{mode} {i}",
                            lambda: model.step_collectives(cache))
                out[f"{mode} {i}"] = model.gather_logits(logits, B).float()
                lengths = lengths + 1
        del caches
        return out

    def serving_tp(self, archs=("qwen2-1.5b", "gemma2-27b"),
                   label="serving tp") -> None:
        """Phase 3's 8 requests through ServingEngine on the mesh: bf16 at
        max_seq 2048 (tokens equal on every rank; TTFT, TPOT; busy, idle
        and NCCL time a decode step by rank), then computed in fp32 over the
        bf16 weights, tokens equal to the one-card engine's on card 0 (which
        takes the mesh's expert choices at near ties: ``follow``)."""
        from repro_torch.configs import get_config
        from repro_torch.serving import EngineConfig, ServingEngine
        from repro_torch.serving.engine import serving_rules
        for arch in archs:
            base = get_config(arch)
            if arch in TP_SERVE_LAYERS:
                base = cut(base, TP_SERVE_LAYERS[arch])
            for dtype, max_seq in (("bfloat16", S_D),
                                   ("float32", TP_SERVE_SEQ_FP32)):
                cfg = dataclasses.replace(base, dtype=dtype)
                ecfg = EngineConfig(max_batch=8, max_seq=max_seq)
                rules = serving_rules(cfg, ecfg, self.mesh)
                model = self.build(cfg, self.mesh, rules)
                eng = ServingEngine(cfg, model, ecfg, mesh=self.mesh)
                sharded = eng.cache.layout.size(eng.cache.spec(cfg)[2]) > 1
                with self.routes() as mesh_ids:
                    res = self._serve(cfg, eng, sharded, dtype == "bfloat16",
                                      label=label)
                every = self.all(res["tokens"])
                if any(t != every[0] for t in every):
                    raise AssertionError(f"{label} {cfg.name}: tokens "
                                         "differ between ranks")
                del eng, model
                self.free()
                if dtype == "float32" and self.rank == 0:
                    one = self.build(cfg)
                    eng = ServingEngine(cfg, one, ecfg)
                    flips = []
                    with self.follow(mesh_ids, flips):
                        ref = self._serve(cfg, eng, False, False,
                                          counted=False)["tokens"]
                    del eng, one
                    self.free()
                    same = [a == b for a, b in zip(ref, every[0])]
                    res["equal_to_one_card"] = sum(same)
                    if cfg.n_experts:
                        res["near_tie_tokens_followed"] = sum(
                            f[0] for f in flips)
                        res["near_tie_largest_gap"] = max(
                            (f[1] for f in flips), default=None)
                    if not all(same):
                        raise AssertionError(
                            f"{label} {cfg.name} fp32: tokens of "
                            f"{len(same) - sum(same)} requests differ from "
                            "the one-card engine's")
                res.pop("tokens")
                self.say(f"{label}: " + json.dumps(res))
                self.dist.barrier()

    def _serve(self, cfg, eng, sharded, trace, counted=True,
               label="serving tp") -> dict:
        torch = self.torch
        from repro_torch.serving import LatencyStats, Request
        rng = np.random.default_rng(0)
        lens = rng.integers(64, 1025, size=N_REQUESTS)
        prompts = [list(map(int, rng.integers(0, cfg.vocab_size, size=L)))
                   for L in lens]
        eng.submit(Request(rid=-1, prompt=list(range(1, 65)),
                           max_new_tokens=2))
        eng.run()                                    # warm-up
        eng.finished.clear()
        eng.prefills = eng.decodes = 0
        torch.cuda.synchronize()
        self.zero()
        t0 = time.perf_counter()
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=p, max_new_tokens=NEW_TOKENS))
        done = sorted(eng.run(), key=lambda r: r.rid)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if len(done) != N_REQUESTS or any(len(r.generated) != NEW_TOKENS
                                          for r in done):
            raise AssertionError(f"serving tp {cfg.name}: {len(done)} done")
        res = {"model": cfg.name, "dtype": cfg.dtype,
               "weights": cfg.param_dtype, "max_seq": eng.ecfg.max_seq,
               "mesh": "one card" if eng.model.layout is None else
               f"{self.n} cards",
               "cache": "by sequence" if sharded else "not by sequence",
               "prefills": eng.prefills, "decode_steps": eng.decodes,
               "wall_s": wall,
               "output_tok_per_s": N_REQUESTS * NEW_TOKENS / wall,
               "tokens": [r.generated for r in done]}
        if counted:
            res["launches"] = self.expect(
                f"{cfg.name} {cfg.n_layers} layers {cfg.dtype} {label}",
                cfg, eng.prefills, eng.decodes, sharded)
        stats = LatencyStats()
        for r in done:
            stats.observe(r.ttft, r.tpot)
        res.update({k: stats.percentile(f"{k[:4]}s", p) for k, p in
                    (("ttft_p50_s", 50), ("ttft_p99_s", 99),
                     ("tpot_p50_s", 50), ("tpot_p99_s", 99))})
        if trace:
            res["trace_by_rank"] = self.all(self._trace(eng, prompts))
        return res

    def _trace(self, eng, prompts) -> dict:
        """TP_TRACE_STEPS decode steps of a full batch under torch.profiler:
        wall, device busy and NCCL ms a step on this rank."""
        torch = self.torch
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        from repro_torch.serving import Request
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=100 + i, prompt=p, max_new_tokens=64))
        while eng.queue:
            eng.step()
        torch.cuda.synchronize()
        self.dist.barrier()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(TP_TRACE_STEPS):
                eng.step()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / TP_TRACE_STEPS
        ks = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
        busy = sum(e.self_device_time_total for e in ks) / 1e3 \
            / TP_TRACE_STEPS
        nccl = sum(e.self_device_time_total for e in ks
                   if "nccl" in e.key.lower()) / 1e3 / TP_TRACE_STEPS
        eng.run()
        return {"step_wall_ms": wall, "device_busy_ms": busy,
                "nccl_ms": nccl, "compute_ms": busy - nccl,
                "idle_share": (1 - busy / wall) if wall > 0 else None,
                "compute_share": (busy - nccl) / wall if wall > 0 else None,
                "card": self._card()}

    def _card(self) -> str:
        from repro_torch.launch.dryrun import _card
        return _card(self.dev)

    def dryrun_tp(self) -> list:
        """The four-card records (launch/dryrun.py run_cell on the mesh):
        ok, 4 devices, finite logits, collectives equal to the formula,
        launches exact; qwen2 decode_32k at batch 128 uncut."""
        from repro_torch.configs import get_config
        from repro_torch.launch import dryrun
        records = []
        for arch, shape in TP_RECORDS:
            cfg = get_config(arch)
            self.memory(f"before {arch} {shape}")
            t0 = time.perf_counter()
            self.zero()
            rec = dryrun.run_cell(arch, shape, ROOT / "results" /
                                  "dryrun_torch", mesh=self.mesh)
            self.free()
            ok = (rec["ok"] is True and rec["devices"] == self.n
                  and rec["flops"] > 0 and rec["collectives"]["calls"]
                  == rec["collectives_formula"])
            if not ok:
                raise AssertionError(f"dryrun tp {arch} {shape}: {rec}")
            if (arch, shape) == ("qwen2-1.5b", "decode_32k") and \
                    "global_batch" in rec["reduced"]:
                raise AssertionError(f"dryrun tp qwen2 decode_32k: batch "
                                     f"cut {rec['reduced']}")
            seq = rec["kind"] == "decode" and rec["cache_spec"][2] is not None
            if rec["kind"] == "decode":
                self.expect(f"{arch} dry-run {shape} tp", cfg, 0,
                            rec["decode_steps"], seq)
            else:
                self.expect(f"{arch} dry-run {shape} tp", cfg,
                            rec["prefill_steps"], 0, False)
            self.say(f"dryrun tp: {json.dumps(rec)}")
            self.say(f"dryrun tp time: {arch} {shape} "
                     f"{time.perf_counter() - t0:.1f} s")
            records.append((cfg, rec))
            self.dist.barrier()
        return records

    # -- the sharded train step -----------------------------------------------
    def train_tp(self) -> float:
        """The train tp gates (module docstring), then the train_4k records
        on mesh (2, 2). Returns the lse kernel's error at a card's training
        shape."""
        from repro_torch.configs import get_config
        meshes = {m: self.mesh_of(m) for m, _ in TP_TRAIN_CASES}
        lse_err = self._train_lse() if self.rank == 0 else {}
        self.dist.barrier()
        base = dataclasses.replace(cut(get_config("qwen2-1.5b"),
                                       TP_TRAIN_LAYERS),
                                   dtype="float32", param_dtype="float32")
        for shape, variant in TP_TRAIN_CASES:
            self._train_gate(base, meshes[shape], shape, variant)
        self.memory("before the train records")
        self._train_records(meshes[(2, 2)])
        return lse_err

    def _train_lse(self) -> dict:
        """The flash kernel with lse at a card's share of qwen2's training
        step on mesh (2, 2) (2 rows, 4096 tokens, 6 / 1 heads) against
        ``ref.blockwise_fwd_lse``, fp32 and bf16; ms beside the plain
        version's and, in bf16, aten's flash attention with its lse (kv
        heads repeated to 6: ``library_flash_lse``). Returns the bf16
        numbers (the kernels line's flash row)."""
        torch = self.torch
        from repro_torch.kernels import ref
        worst, line = 0.0, {}
        for dtype in (torch.float32, torch.bfloat16):
            key = str(dtype).split(".")[-1]
            sets = [(self.rnd((2, 4096, 6, 128), dtype),
                     self.rnd((2, 4096, 1, 128), dtype),
                     self.rnd((2, 4096, 1, 128), dtype)) for _ in range(2)]
            out, lse = self.fa.flash_attention(*sets[0], lse=True)
            out_p, lse_p = ref.blockwise_fwd_lse(*sets[0])
            e = max(self.err(out, out_p), self.err(lse, lse_p))
            if not e < TOL[key]:
                raise AssertionError(f"train tp lse {key}: {e}")
            worst = max(worst, e) if key == "bfloat16" else worst
            line[key] = {
                "max_abs_err": e, "tol": TOL[key],
                "ms": self.time_ms(lambda *a: self.fa.flash_attention(
                    *a, lse=True), sets),
                "plain_ms": self.time_ms(lambda *a: ref.blockwise_fwd_lse(
                    *a), sets, iters=3)}
            if key == "bfloat16":
                lib = [(q.transpose(1, 2), k.repeat_interleave(6, 2)
                        .transpose(1, 2).contiguous(),
                        v.repeat_interleave(6, 2).transpose(1, 2)
                        .contiguous()) for q, k, v in sets]
                line[key]["library_ms"] = self.time_ms(
                    lambda *a: library_flash_lse(torch, *a), lib)
                del lib
            del sets, out, lse, out_p, lse_p
            self.free()
        self.say("train tp kernel: " + json.dumps({
            "kernel": "flash_attention lse=True", "shape":
            "B=2 S=4096 H=6 KVH=1 Dh=128 causal (qwen2's heads / 2)",
            **line, "card": self._card()}))
        return {"shape": "lse=True B=2 S=4096 H=6 KVH=1 Dh=128 causal bf16 "
                         "(a card's share of qwen2's train step on 2x2)",
                **line["bfloat16"], "max_abs_err": worst}

    def _train_run(self, cfg, mesh, variant, batch=TP_TRAIN_BATCH,
                   seq=TP_TRAIN_SEQ):
        """Two train steps of ``variant`` from count 99 on ``mesh`` (None:
        this card alone, the variant without its sharding-only tokens):
        (metrics by step, whole parameters, launches, collectives by step
        and their formula); the launch counters keep the run's."""
        torch = self.torch
        from repro_torch.configs.shapes import ShapeCase
        from repro_torch.distributed import sharding as SH
        from repro_torch.launch import steps as ST
        from repro_torch.models import transformer as T
        case = ShapeCase("train tp", "train", seq, batch)
        one = "+".join(sorted(ST.variant_tokens(variant)
                              - set(ST.SHARDING_VARIANTS))) or "baseline"
        sharded = mesh is not None
        out = ST.build_cell(cfg, case, "meta", variant if sharded else one,
                            mesh=mesh)
        fn = out[0]
        model = self.build(ST.apply_variant_config(cfg, one), mesh,
                           out[3] if sharded else None)
        st = ST.init_opt_state(model)
        st["count"] = torch.tensor(99, dtype=torch.int32, device=self.dev)
        metrics, calls = [], []
        self.zero()
        for i in range(TP_TRAIN_STEPS):
            b = self.train_batch(cfg, batch, seq, i)
            SH.reset_collectives()
            st, m = fn(model, st, b)
            metrics.append({k: float(v) for k, v in m.items()})
            calls.append(SH.collectives()["calls"])
        torch.cuda.synchronize()
        launches = self.read()
        nm = 8 if "micro8" in variant else 4
        formula = (ST.train_step_collectives(model, batch, nm, seq)
                   if mesh is not None else {})
        if mesh is None:
            params = {n: p.detach() for n, p in model.named_parameters()}
        else:
            full = dict(T.Transformer(cfg, device="meta").named_parameters())
            params = {n: SH.gather_whole(p.detach(), model.layout,
                                         model.layout.spec(
                                             T._axes_of(cfg, n),
                                             tuple(full[n].shape)))
                      for n, p in model.named_parameters()}
            del model, st
        return metrics, params, launches, calls, formula

    def _train_gate(self, cfg, mesh, shape, variant, label="tp",
                    batch=TP_TRAIN_BATCH, seq=TP_TRAIN_SEQ) -> None:
        """One train tp (or ep, rec, mod, sp) case (module docstring); a
        seqpar case's steps must reduce-scatter. Card 0's one-card steps
        serve the next case of the same config and one-card variant
        (``one_card_run``)."""
        t0 = time.perf_counter()
        metrics, params, launches, calls, formula = self._train_run(
            cfg, mesh, variant, batch, seq)
        from repro_torch.launch import steps as ST
        what = (f"{cfg.name} {shape[0]}x{shape[1]} {variant} "
                f"{cfg.optimizer} train {label}")
        self.expect_train(what, cfg, 8 if "micro8" in variant else 4,
                          TP_TRAIN_STEPS, seq)
        every = self.all([metrics, calls])
        if any(e[0] != every[0][0] for e in every):
            raise AssertionError(f"{what}: metrics differ between ranks")
        if any(c != formula for e in every for c in e[1]):
            raise AssertionError(f"{what}: collectives "
                                 f"{[e[1] for e in every]} != {formula}")
        if "seqpar" in variant and not calls[0].get("reduce-scatter"):
            raise AssertionError(f"{what}: no reduce-scatter in {calls[0]}")
        if self.rank == 0:
            mesh_params, params = params, None
            self.free()
            one = "+".join(sorted(ST.variant_tokens(variant)
                                  - set(ST.SHARDING_VARIANTS)))
            ref_metrics, ref_params = self.one_card_run(
                ("train", cfg, one, batch, seq),
                lambda: self._train_run(cfg, None, variant, batch, seq)[:2])
            tol_g = TOL["bfloat16"] if "bf16grad" in variant else GNORM_RTOL
            tol_p = TOL["bfloat16"] if "bf16grad" in variant else LEAF_TOL
            loss_err = max(abs(a["loss"] - b["loss"]) / abs(b["loss"])
                           for a, b in zip(metrics, ref_metrics))
            gn_err = max(abs(a["grad_norm"] - b["grad_norm"])
                         / b["grad_norm"] for a, b in zip(metrics,
                                                          ref_metrics))
            leaf = max(self.err(mesh_params[n], p) / max(
                1.0, float(p.abs().max())) for n, p in ref_params.items())
            line = {"model": cfg.name, "layers": cfg.n_layers,
                    "dtype": "float32", "mesh": list(shape),
                    "variant": variant, "optimizer": cfg.optimizer,
                    "batch": [batch, seq],
                    "losses": [m["loss"] for m in metrics],
                    "one_card_losses": [m["loss"] for m in ref_metrics],
                    "grad_norms": [m["grad_norm"] for m in metrics],
                    "loss_rel_err": loss_err, "grad_norm_rel_err": gn_err,
                    "max_leaf_err_after_update": leaf,
                    "tol": [LOSS_RTOL, tol_g, tol_p],
                    "collectives_a_step": calls[0],
                    "launches_rank0": launches,
                    "seconds": time.perf_counter() - t0}
            self.say(f"train {label}: " + json.dumps(line))
            if not (loss_err < LOSS_RTOL and gn_err < tol_g
                    and leaf < tol_p):
                raise AssertionError(f"{what}: {line}")
            del ref_params, mesh_params
        else:
            del params
        self.free()
        self.dist.barrier()

    def _train_records(self, mesh) -> None:
        """The train_4k records on ``mesh``: ok, 4 devices, finite and
        equal losses on every card, collectives equal to the formula,
        launches exact (the probe step at one row a card included), the
        batch cut from 256; the not-fitting ones reckoned before anything
        is built."""
        from repro_torch.launch import dryrun
        for arch in TP_TRAIN_RECORDS:
            cfg, layers = record_config(arch, "train_4k")
            t0 = time.perf_counter()
            self.zero()
            rec = dryrun.run_cell(arch, "train_4k", ROOT / "results" /
                                  "dryrun_torch", mesh=mesh, layers=layers)
            self.free()
            launches = self.read()
            if arch in TP_TRAIN_NOT_FITTING:
                if rec["ok"] or "not_fitting" not in rec or any(
                        launches.values()):
                    raise AssertionError(f"train record {arch}: {rec}")
            else:
                steps = rec["train_steps"] + rec.get("probe_steps", 0)
                ok = (rec["ok"] is True and rec["devices"] == self.n
                      and rec["flops"] > 0
                      and rec["collectives"]["calls"]
                      == rec["collectives_formula"]
                      and "global_batch" in rec["reduced"])
                if not ok:
                    raise AssertionError(f"train record {arch}: {rec}")
                self.expect_train(f"{arch} dry-run train_4k tp", cfg,
                                  rec["n_micro"], steps, rec["seq_len"])
            self.say(f"dryrun tp: {json.dumps(rec)}")
            self.say(f"dryrun tp time: {arch} train_4k "
                     f"{time.perf_counter() - t0:.1f} s")
            self.dist.barrier()

    # -- expert parallelism (the ep phases) ---------------------------------
    def ep_phases(self) -> list:
        """path ep, serving ep, train ep and dryrun ep (module docstring);
        returns the dryrun ep records for profile ep."""
        for name, phase in (("path ep", self.path_ep),
                            ("serving ep", self.serving_ep),
                            ("train ep", self.train_ep)):
            t = time.perf_counter()
            phase()
            self.say(f"phase {name}: {time.perf_counter() - t:.1f} s")
            self.memory(f"after {name}")
        t = time.perf_counter()
        records = self.dryrun_ep()
        self.say(f"phase dryrun ep: {time.perf_counter() - t:.1f} s")
        return records

    def routes(self):
        """A context that records the ids of every ``ops.moe_route`` call
        (the MoE layers' one gating entry on every path): yields the list."""
        import contextlib
        from repro_torch.kernels import ops

        @contextlib.contextmanager
        def spy():
            route, ids = ops.moe_route, []

            def wrapped(logits, top_k, **kw):
                out = route(logits, top_k, **kw)
                ids.append(out[1])
                return out

            ops.moe_route = wrapped
            try:
                yield ids
            finally:
                ops.moe_route = route

        return spy()

    def follow(self, ids_from, flips):
        """A context in which ``ops.moe_route`` takes ``ids_from``'s choices
        (another run's ids, call by call) for the tokens whose own choices
        differ from them at a near tie (NEAR_TIE), the weights renormalised
        over them and the maps built from them; a wider gap raises. Each
        such call appends (tokens, largest gap) to ``flips``."""
        import contextlib
        from repro_torch.kernels import ops, ref
        torch = self.torch

        @contextlib.contextmanager
        def spy():
            route, calls = ops.moe_route, iter(ids_from)

            def wrapped(logits, top_k, *, cap, nb, impl=None):
                out = route(logits, top_k, cap=cap, nb=nb, impl=impl)
                want = next(calls).to(out[1].device)
                rows = (out[1].sort(-1)[0] != want.sort(-1)[0]).any(-1)
                if not bool(rows.any()):
                    return out
                top = logits.float()[rows].sort(-1, descending=True)[0]
                gap = float((top[:, top_k - 1] - top[:, top_k]).max())
                flips.append((int(rows.sum()), gap))
                if not gap <= NEAR_TIE:
                    raise AssertionError(f"a route differs at a logit gap "
                                         f"of {gap} (near tie {NEAR_TIE})")
                vals = torch.softmax(logits.float(), -1).gather(
                    1, want.long())
                maps = ref.dispatch_indices(
                    want.long().reshape(nb, -1, top_k), logits.shape[1], cap)
                return (vals / vals.sum(-1, keepdim=True),
                        want.to(out[1].dtype), *maps, out[-1])

            ops.moe_route = wrapped
            try:
                yield flips
            finally:
                ops.moe_route = route
                if next(calls, None) is not None:
                    raise AssertionError("fewer route calls than the run "
                                         "followed")

        return spy()

    def path_ep(self) -> None:
        """Prefill and teacher-forced decode (append and committed) of
        granite at full size in fp32 on meshes 1x4 and 2x2, and of kimi-k2
        at full width on its first 2 layers (bf16 weights computed in fp32,
        PR 22's gate) on 1x4, each against the same weights on card 0
        without a mesh: PATH_TOL_FP32, argmax and every expert choice
        equal, but where the card's own logits put two experts within
        NEAR_TIE, which it then takes from the mesh (``follow``, counted);
        launches exact on every rank."""
        from repro_torch.configs import get_config
        base = get_config(EP_ARCH)
        cases = [(dataclasses.replace(base, dtype="float32",
                                      param_dtype="float32"), shape, EP_PATH)
                 for shape in EP_PATH_MESHES]
        kimi = dataclasses.replace(cut(get_config(EP_KIMI), 2),
                                   dtype="float32")
        cases.append((kimi, (1, self.n), EP_KIMI_PATH))
        for cfg, shape, (B, max_seq, lens) in cases:
            self._path_gate(cfg, shape, B, max_seq, lens, "path ep")

    def _path_gate(self, cfg, shape, B, max_seq, lens, label,
                   gate=True, variant="baseline") -> None:
        """One path case on the (data, model) mesh ``shape`` under
        ``variant``'s rules against card 0 (``path_tp``, ``path_ep``,
        ``path_sp``): the logits within PATH_TOL_FP32 and argmax equal
        where ``gate``, every expert choice equal but at near ties, which
        card 0 takes from the mesh (``follow``). Under seqpar a prefill
        all-reduces nothing but Mamba's ``x_proj`` exactly where its
        length cuts over "model" (``Transformer.seq_plan``), which must
        happen for some prompts and not for others. Card 0's outputs of a
        config without experts serve the next case of the same inputs
        (``one_card_run``; with experts it follows the mesh's near ties,
        so it is the mesh's own)."""
        torch = self.torch
        from repro_torch.configs.shapes import ShapeCase
        from repro_torch.launch import steps as ST
        from repro_torch.models import transformer as T
        mesh = self.mesh_of(shape)
        rules = ST.rules_for(cfg, ShapeCase("path", "decode", max_seq, B),
                             mesh, variant)
        rng = np.random.default_rng(0)
        C = (cfg.n_codebooks,) if cfg.n_codebooks else ()
        tokens = rng.integers(0, cfg.vocab_size, size=(B, max(lens)) + C)
        steps = rng.integers(0, cfg.vocab_size, size=(TP_PATH_STEPS, B) + C)
        vision = None
        if cfg.n_vision_tokens:
            vision = torch.from_numpy(rng.standard_normal(
                (B, cfg.n_vision_tokens, cfg.d_model)).astype(
                    np.float32)).to(self.dev)
        t0 = time.perf_counter()
        model = self.build(cfg, mesh, rules)
        self.zero()
        with self.routes() as mesh_ids:
            mesh_out = self._path_run(cfg, model, tokens, steps, lens,
                                      max_seq, vision)
        prefill_calls = self.prefill_calls
        cuts = [model.seq_plan(1, L).sp is not None for L in lens]
        what = (f"{cfg.name} {cfg.n_layers} layers {shape[0]}x{shape[1]} "
                f"B={B} max_seq={max_seq} {cfg.dtype} {label}")
        # a cut prefill's only all-reduces are Mamba's x_proj ones
        x_proj = [s.kind for s in cfg.layer_specs()].count("mamba") * (
            model.layout.size(model.tp.inner) > 1)
        if "seqpar" in variant and (
                [c.get("all-reduce", 0) == x_proj for c in prefill_calls]
                != cuts or all(cuts) or not any(cuts)):
            raise AssertionError(f"{what}: the sequence cut at {cuts}, "
                                 f"prefill collectives {prefill_calls}")
        meta = T.init_cache(cfg, B, max_seq, device="meta",
                            mesh=model.layout)
        _, _, seq, kv, _ = meta.spec(cfg)
        sharded = model.layout.size(seq) > 1
        if cfg.n_vision_tokens and sharded != (
                model.layout.size(meta.spec(cfg, cross=True)[2]) > 1):
            raise AssertionError(f"{cfg.name}: the launch count takes the "
                                 "cross caches cut as the self caches")
        model_kv = model.layout.size(kv)
        states = model.layout.size(model.tp.inner or model.tp.rwkv)
        self.expect(what, cfg, B, 2 * TP_PATH_STEPS, sharded)
        del model
        self.free()
        if self.rank == 0:
            flips = []

            def one_card():
                one = self.build(cfg)
                with self.routes() as one_ids, self.follow(mesh_ids, flips):
                    out = self._path_run(cfg, one, tokens, steps, lens,
                                         max_seq, vision)
                del one
                self.free()
                return out, one_ids

            ref_out, one_ids = self.one_card_run(
                ("path", cfg, B, max_seq, tuple(lens)), one_card,
                keep=not cfg.n_experts)
            diffs = {k: self.err(mesh_out[k], ref_out[k]) for k in ref_out}
            argmax = all(bool(torch.equal(mesh_out[k].argmax(-1),
                                          ref_out[k].argmax(-1)))
                         for k in ref_out)
            differing = sum(int((a.sort(-1)[0] != b.sort(-1)[0]).any(-1)
                                .sum()) for a, b in zip(mesh_ids, one_ids))
            choices = sum(int(a.numel()) for a in mesh_ids)
            worst = max(diffs.values())
            line = {"model": cfg.name, "layers": cfg.n_layers,
                    "dtype": cfg.dtype, "weights": cfg.param_dtype,
                    "mesh": list(shape), "variant": variant, "batch": B,
                    "max_seq": max_seq, "prompt_lens": list(lens),
                    "prefill_collectives": prefill_calls,
                    "cache": ("by sequence" if sharded else "by kv heads"
                              if model_kv > 1 else "replicated"),
                    "cross_cache_rows_a_card": (
                        meta.layout.local_shape(
                            ("layers",) + T.L.CACHE_AXES,
                            meta.leaf_shape(cfg, cross=True))[2]
                        if cfg.n_vision_tokens else None),
                    "recurrent_states_over_cards": states,
                    "max_abs_diff": worst,
                    "diffs": diffs, "argmax_equal": argmax,
                    "route_calls": [len(mesh_ids), len(one_ids)],
                    "expert_choices": choices,
                    "tokens_with_differing_choices": differing,
                    "near_tie_tokens_followed": sum(f[0] for f in flips),
                    "near_tie_largest_gap": max((f[1] for f in flips),
                                                default=None),
                    "tol": PATH_TOL_FP32,
                    "launches_rank0": self.launches_by_path[what],
                    "seconds": time.perf_counter() - t0}
            self.say(f"{label}: " + json.dumps(line))
            if gate and not (worst <= PATH_TOL_FP32 and argmax
                             and differing == sum(f[0] for f in flips)
                             and len(mesh_ids) == len(one_ids)):
                raise AssertionError(f"{what}: {line}")
            del ref_out
        del mesh_out
        self.free()
        self.dist.barrier()

    def _depth(self, arch, mesh, rules) -> tuple:
        """(``arch``'s layers on ``mesh``, its weights' bytes a card, the
        smallest card's free bytes): the most layers whose weights leave
        EP_KIMI_RESERVE_BYTES of the smallest card's free memory, reckoned
        from the specs on the meta device."""
        from repro_torch.configs import get_config
        from repro_torch.launch.dryrun import _weight_bytes
        self.free()
        free = min(self.all(self.torch.cuda.mem_get_info(self.dev)[0]))
        full = get_config(arch)
        n, nbytes = 1, _weight_bytes(cut(full, 1), mesh, rules)
        while n < full.n_layers:
            more = _weight_bytes(cut(full, n + 1), mesh, rules)
            if more > free - EP_KIMI_RESERVE_BYTES:
                break
            n, nbytes = n + 1, more
        return n, nbytes, free

    def _drawn_shards(self, cfg, mesh, rules):
        """``cfg``'s model on ``mesh`` with each card's shards drawn on the
        card: every leaf normal at its fan-in's scale (norms 1, the
        embedding and head 0.02, as the init), a shard's values seeded by
        its place in the whole leaf, so a replicated leaf is equal on every
        card and the cards' shards make one model."""
        torch = self.torch
        from repro_torch.models import transformer as T
        t0 = time.perf_counter()
        model = T.Transformer(cfg, device="meta", mesh=mesh, rules=rules)
        model = model.to_empty(device=self.dev)
        full = {n: tuple(p.shape) for n, p in
                T.Transformer(cfg, device="meta").named_parameters()}
        with torch.no_grad():
            for i, (name, p) in enumerate(model.named_parameters()):
                starts = [s for s, _ in model.layout.ranges(
                    T._axes_of(cfg, name), full[name])]
                seed = (i * 1_000_003 + sum(
                    (k + 1) * 7919 * s for k, s in enumerate(starts))) \
                    % (2 ** 62)
                g = torch.Generator(device=self.dev).manual_seed(seed)
                leaf = name.rsplit(".", 1)[-1]
                if "norm" in leaf:
                    p.fill_(1.0)
                else:
                    std = 0.02 if leaf in ("embed", "lm_head") else \
                        full[name][-2] ** -0.5
                    p.normal_(0.0, std, generator=g)
        torch.cuda.synchronize()
        self.say(f"model: {cfg.name} {cfg.n_layers} layers {cfg.dtype} on "
                 f"the mesh, shards drawn on the cards, "
                 f"{sum(p.numel() for p in model.parameters())} params on "
                 f"rank 0, {time.perf_counter() - t0:.1f} s")
        return model

    def serving_ep(self) -> None:
        """Phase 3's 8 requests through ServingEngine on mesh 1x4: granite
        as in serving tp (bf16, and fp32 against the one-card engine), then
        kimi-k2 at full width on the deepest cut the four cards hold
        (tokens equal on every rank)."""
        self.serving_tp((EP_ARCH,), "serving ep")
        self._serve_deepest(EP_KIMI, "serving ep", trace=True)

    def _serve_deepest(self, arch, label, trace) -> None:
        """``arch`` at full width on the most layers the four cards hold
        (``_depth``), its shards drawn on the cards, through ServingEngine
        on mesh 1x4 in bf16: tokens equal on every rank."""
        from repro_torch.configs import get_config
        from repro_torch.serving import EngineConfig, ServingEngine
        from repro_torch.serving.engine import serving_rules
        full = get_config(arch)
        ecfg = EngineConfig(max_batch=8, max_seq=S_D)
        rules = serving_rules(full, ecfg, self.mesh)
        n, nbytes, free = self._depth(arch, self.mesh, rules)
        cfg = cut(full, n)
        kinds = [f"{spec.kind} + {spec.mlp}" for spec in cfg.layer_specs()]
        kinds = ", ".join(f"{kinds.count(k)} {k}" for k in sorted(set(kinds)))
        self.say(f"{label} cut: {arch} at full width cut to its first {n} "
                 f"of {full.n_layers} layers ({kinds}), "
                 f"{cfg.param_count()} parameters, {nbytes / 1e9:.2f} GB of "
                 f"bf16 weights a card on 4 cards ({free / 1e9:.2f} GB free "
                 f"on the smallest card, {EP_KIMI_RESERVE_BYTES / 1e9:.0f} GB"
                 " kept for the cache, activations and NCCL)")
        model = self._drawn_shards(cfg, self.mesh, rules)
        eng = ServingEngine(cfg, model, ecfg, mesh=self.mesh)
        sharded = eng.cache.layout.size(eng.cache.spec(cfg)[2]) > 1
        res = self._serve(cfg, eng, sharded, trace, label=label)
        every = self.all(res["tokens"])
        if any(t != every[0] for t in every):
            raise AssertionError(f"{label} {arch}: tokens differ between "
                                 "ranks")
        res.pop("tokens")
        res["layers"] = n
        self.say(f"{label}: " + json.dumps(res))
        del eng, model
        self.free()
        self.dist.barrier()

    def train_ep(self) -> None:
        """The train ep gates (module docstring): granite's cases against
        one card's step, then kimi-k2's Adafactor step in bf16 on mesh
        2x2."""
        from repro_torch.configs import get_config
        base = dataclasses.replace(cut(get_config(EP_ARCH), TP_TRAIN_LAYERS),
                                   dtype="float32", param_dtype="float32")
        for shape, variant in EP_TRAIN_CASES:
            cfg = base
            if variant == "adafactor":
                # a gate-only config change: granite trains with AdamW;
                # Adafactor is kimi-k2's, which no card can step alone
                cfg, variant = dataclasses.replace(
                    base, optimizer="adafactor"), "baseline"
            self._train_gate(cfg, self.mesh_of(shape), shape, variant,
                             label="ep")
        self._train_bf16(EP_KIMI, EP_KIMI_TRAIN, "ep")

    def train_batch(self, cfg, batch, seq, step) -> dict:
        """Step ``step``'s global batch on the card, the same on every
        rank: tokens and labels (with codebooks (batch, seq, C)) and, for a
        vision config, its vision embeddings (as ``train_loop.train``
        draws them)."""
        torch = self.torch
        from repro_torch.training.data import DataConfig, SyntheticDataset
        from repro_torch.training.train_loop import (TrainConfig,
                                                     vision_embeddings)
        data = SyntheticDataset(DataConfig(
            vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch,
            n_codebooks=cfg.n_codebooks))
        out = {k: torch.from_numpy(v).to(self.dev)
               for k, v in data.batch(step).items()}
        if cfg.n_vision_tokens:
            out["vision_embeds"] = vision_embeddings(
                cfg, TrainConfig(global_batch=batch, seq_len=seq), step,
                self.dev)
        return out

    def _train_bf16(self, arch, spec, label) -> None:
        """``arch`` at full width on its first ``spec[0]`` layers, bf16,
        its optimizer, on mesh 2x2 (kimi-k2's, Jamba's, vision's): two
        steps of ``spec``'s
        batch and seq, losses finite and equal on every card, the first
        cross-entropy in phase 8's band, collectives equal to the formula,
        launches exact; each card's peak memory."""
        torch = self.torch
        from repro_torch.configs import get_config
        from repro_torch.configs.shapes import ShapeCase
        from repro_torch.distributed import sharding as SH
        from repro_torch.launch import steps as ST
        layers, batch, seq, steps = spec
        cfg = cut(get_config(arch), layers)
        mesh = self.mesh_of((2, 2))
        self.memory(f"before {arch} {layers} layers bf16 train {label}")
        t0 = time.perf_counter()
        fn, _, _, rules, *_ = ST.build_cell(
            cfg, ShapeCase(f"train {label}", "train", seq, batch), "meta",
            mesh=mesh)
        model = self.build(cfg, mesh, rules)
        st = ST.init_opt_state(model)
        self.zero()
        losses, ces, calls = [], [], []
        torch.cuda.reset_peak_memory_stats(self.dev)
        for i in range(steps):
            b = self.train_batch(cfg, batch, seq, i)
            SH.reset_collectives()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            st, m = fn(model, st, b)
            losses.append(float(m["loss"]))
            ces.append(float(m["ce"]))
            calls.append((SH.collectives()["calls"],
                          (time.perf_counter() - t1) * 1e3))
        nm = 4 if batch % 4 == 0 and batch >= 4 else 1
        formula = ST.train_step_collectives(model, batch, nm, seq)
        what = (f"{cfg.name} {layers} layers 2x2 bf16 {cfg.optimizer} train "
                f"{label}")
        self.expect_train(what, cfg, nm, steps, seq)
        every = self.all(losses)
        center = math.log(cfg.vocab_size) + 0.5 * 0.02 ** 2 * cfg.d_model
        line = {"model": cfg.name, "layers": layers, "dtype": cfg.dtype,
                "optimizer": cfg.optimizer, "mesh": [2, 2],
                "batch": [batch, seq], "n_micro": nm, "losses": losses,
                "first_ce": ces[0], "first_ce_center": center,
                "step_ms": [c[1] for c in calls],
                "collectives_a_step": calls[0][0], "formula": formula,
                "peak_mem_gb_by_rank": self.all(
                    torch.cuda.max_memory_allocated(self.dev) / 1e9),
                "seconds": time.perf_counter() - t0, "card": self._card()}
        self.say(f"train {label}: " + json.dumps(line))
        if not (all(map(math.isfinite, losses)) and all(e == losses
                                                        for e in every)
                and abs(ces[0] - center)
                <= FIRST_LOSS_RTOL * math.log(cfg.vocab_size)
                and all(c[0] == formula for c in calls)):
            raise AssertionError(f"train {label} {what}: {line}")
        del model, st
        self.free()
        self.dist.barrier()

    def dryrun_ep(self) -> list:
        """granite's decode_32k record on mesh 1x4 and train_4k on 2x2
        (the batch cut to the routing kernel's block), kimi-k2's two as
        not fitting, reckoned from the specs before anything is built."""
        return self._mesh_records(EP_RECORDS, EP_NOT_FITTING, "ep")

    def _mesh_records(self, cells, not_fitting, label,
                      decode_cut=False) -> list:
        """The records of ``cells`` ((arch, shape, mesh shape)): ok, 4
        devices, collectives equal to the formula, launches exact, a decode
        batch uncut (with ``decode_cut``, cut to what a card holds, and
        logged), finite train losses; the archs of ``not_fitting``
        not fitting, reckoned before anything is built, logged with why.
        Returns the decode records for profile tp."""
        from repro_torch.launch import dryrun
        records = []
        for arch, shape, mshape, *variant in cells:
            variant = variant[0] if variant else "baseline"
            cfg, layers = record_config(arch, shape)
            self.memory(f"before {arch} {shape} {variant}")
            t0 = time.perf_counter()
            self.zero()
            rec = dryrun.run_cell(arch, shape, ROOT / "results" /
                                  "dryrun_torch", mesh=self.mesh_of(mshape),
                                  variant=variant, layers=layers)
            self.free()
            launches = self.read()
            if arch in not_fitting:
                if rec["ok"] or "not_fitting" not in rec or any(
                        launches.values()):
                    raise AssertionError(f"dryrun {label} {arch} {shape}: "
                                         f"{rec}")
            else:
                ok = (rec["ok"] is True and rec["devices"] == self.n
                      and rec["flops"] > 0 and rec["collectives"]["calls"]
                      == rec["collectives_formula"])
                if not ok:
                    raise AssertionError(f"dryrun {label} {arch} {shape}: "
                                         f"{rec}")
                if rec["kind"] == "decode":
                    if ("global_batch" in rec["reduced"]) != decode_cut:
                        raise AssertionError(f"dryrun {label} {arch} "
                                             f"{shape}: batch cut "
                                             f"{rec['reduced']}")
                    self.expect(f"{arch} dry-run {shape} {label}", cfg, 0,
                                rec["decode_steps"],
                                rec["cache_spec"][2] is not None)
                    records.append((cfg, rec))
                elif rec["kind"] == "prefill":
                    self.expect(f"{arch} dry-run {shape} {label}", cfg,
                                rec["prefill_steps"], 0, False)
                else:
                    steps = rec["train_steps"] + rec.get("probe_steps", 0)
                    if not (all(map(math.isfinite, rec["losses"]))
                            and "global_batch" in rec["reduced"]):
                        raise AssertionError(f"dryrun {label} {arch}: "
                                             f"{rec}")
                    self.expect_train(f"{arch} dry-run {shape} {label}", cfg,
                                      rec["n_micro"], steps, rec["seq_len"])
            self.say(f"dryrun {label}: {json.dumps(rec)}")
            if "global_batch" in rec["reduced"]:
                self.say(f"dryrun {label} batch: {arch} {shape} on "
                         f"{rec['mesh']} holds {rec['global_batch']} of "
                         f"{rec['reduced']['global_batch'][0]} sequences: "
                         f"{rec['reduced_why']['global_batch']}")
            if "not_fitting" in rec:
                self.say(f"dryrun {label} not fitting: {arch} {shape} on "
                         f"{rec['mesh']}: {rec['not_fitting']}")
            self.say(f"dryrun {label} time: {arch} {shape} "
                     f"{time.perf_counter() - t0:.1f} s")
            self.dist.barrier()
        return records

    # -- sequence parallelism (the sp phases) -------------------------------
    def sp_phases(self) -> None:
        """path sp, train sp and dryrun sp (module docstring)."""
        for name, phase in (("path sp", self.path_sp),
                            ("train sp", self.train_sp),
                            ("dryrun sp", self.dryrun_sp)):
            t = time.perf_counter()
            phase()
            self.say(f"phase {name}: {time.perf_counter() - t:.1f} s")
            self.memory(f"after {name}")

    def path_sp(self) -> None:
        """qwen2 and granite at full size in fp32 under seqpar on 1x4 and
        2x2 against card 0; then rwkv6 at full size, Jamba's first 4
        layers, vision's first 10 (two cross layers) and musicgen at full
        size, the same way."""
        from repro_torch.configs import get_config
        B, max_seq, lens = SP_PATH
        for arch in SP_ARCHS:
            cfg = dataclasses.replace(get_config(arch), dtype="float32",
                                      param_dtype="float32")
            for shape in SP_PATH_MESHES:
                self._path_gate(cfg, shape, B, max_seq, lens, "path sp",
                                variant="seqpar")
        for cfg in self.rec_mod_paths():
            for shape in SP_PATH_MESHES:
                self._path_gate(cfg, shape, *REC_PATH, "path sp",
                                variant="seqpar")

    def rec_mod_paths(self) -> list:
        """The fp32 path configs of the rec and mod phases: rwkv6 at full
        size, Jamba's first REC_JAMBA_PATH_LAYERS layers (bf16 weights
        computed in fp32), vision's first MOD_VISION_PATH_LAYERS layers,
        musicgen at full size."""
        from repro_torch.configs import get_config
        f32 = {"dtype": "float32", "param_dtype": "float32"}
        return [dataclasses.replace(get_config(REC_RWKV), **f32),
                dataclasses.replace(cut(get_config(REC_JAMBA),
                                        REC_JAMBA_PATH_LAYERS),
                                    dtype="float32"),
                dataclasses.replace(cut(get_config(MOD_VISION),
                                        MOD_VISION_PATH_LAYERS), **f32),
                dataclasses.replace(get_config(MOD_MUSIC), **f32)]

    def train_sp(self) -> None:
        """The train sp gates: each arch's first TP_TRAIN_LAYERS layers in
        fp32 on SP_TRAIN_CASES against one card's steps; then rwkv6's
        first TP_TRAIN_LAYERS on SP_TRAIN_CASES, Jamba's layer 0 (Mamba +
        dense), vision's first MOD_VISION_TRAIN_LAYERS (one cross layer)
        and musicgen's first TP_TRAIN_LAYERS on SP_REC_TRAIN_CASES."""
        from repro_torch.configs import get_config

        def fp32(arch, layers):
            return dataclasses.replace(cut(get_config(arch), layers),
                                       dtype="float32", param_dtype="float32")

        for arch in SP_ARCHS + (REC_RWKV,):
            for shape, variant in SP_TRAIN_CASES:
                self._train_gate(fp32(arch, TP_TRAIN_LAYERS),
                                 self.mesh_of(shape), shape, variant,
                                 label="sp")
        for arch, layers, batch in (
                (REC_JAMBA, 1, REC_JAMBA_TRAIN_BATCH),
                (MOD_VISION, MOD_VISION_TRAIN_LAYERS, TP_TRAIN_BATCH),
                (MOD_MUSIC, TP_TRAIN_LAYERS, TP_TRAIN_BATCH)):
            for shape, variant in SP_REC_TRAIN_CASES:
                self._train_gate(fp32(arch, layers), self.mesh_of(shape),
                                 shape, variant, label="sp", batch=batch)

    def dryrun_sp(self) -> None:
        """The SP_RECORDS under seqpar (``_mesh_records``' gates)."""
        self._mesh_records(SP_RECORDS, (), "sp")

    def sp_baselines(self, phases) -> None:
        """The baseline records of the SP_RECORDS whose group
        (``SP_BASELINE_GROUP``) is not among ``phases``."""
        cells = tuple((arch, shape, mshape) for arch, shape, mshape, _ in
                      SP_RECORDS
                      if SP_BASELINE_GROUP[(arch, shape)] not in phases)
        self._mesh_records(cells, (), "sp baseline")

    def sp_beside_baseline(self) -> None:
        """(rank 0, at the end of the run) each seqpar record beside the
        baseline record of the same cell written earlier in this run: step
        ms, compute and NCCL ms by rank, peak a card, batch held and cuts,
        collectives and their link bytes; a `dryrun sp vs baseline:` line
        each."""
        from repro_torch.launch import dryrun
        out = ROOT / "results" / "dryrun_torch"
        keys = ("global_batch", "reduced", "step_ms", "compute_ms_by_rank",
                "nccl_ms_by_rank", "peak_mem_gb_by_rank", "peak_mem_gb",
                "bytes_one_sequence_peak", "bytes_one_row_peak",
                "collectives")
        for arch, shape, mshape, variant in SP_RECORDS:
            name = f"{arch}__{shape}__{dryrun.mesh_name(self.mesh_of(mshape))}"
            recs = {v: json.loads((out / f"{name}{s}.json").read_text())
                    for v, s in (("seqpar", f"__{variant}"),
                                 ("baseline", ""))}
            self.say("dryrun sp vs baseline: " + json.dumps({
                "arch": arch, "shape": shape, "mesh": list(mshape),
                **{k: {v: r.get(k) for v, r in recs.items()} for k in keys},
                "card": recs["seqpar"].get("card")}))

    # -- Mamba and RWKV-6 on the mesh (the rec phases) -------------------
    def rec_phases(self) -> list:
        """path rec, serving rec, train rec and dryrun rec (module
        docstring); returns the dryrun rec decode records for profile
        tp."""
        for name, phase in (("path rec", self.path_rec),
                            ("serving rec", self.serving_rec),
                            ("train rec", self.train_rec)):
            t = time.perf_counter()
            phase()
            self.say(f"phase {name}: {time.perf_counter() - t:.1f} s")
            self.memory(f"after {name}")
        t = time.perf_counter()
        records = self._mesh_records(REC_RECORDS, REC_NOT_FITTING, "rec")
        self.say(f"phase dryrun rec: {time.perf_counter() - t:.1f} s")
        return records

    def path_rec(self) -> None:
        """Prefill and 4 teacher-forced decode steps (append and
        committed) on meshes 1x4 and 2x2 against card 0 without a mesh:
        rwkv6 at full size in fp32, Jamba at full width on its first 4
        layers (bf16 weights computed in fp32); PATH_TOL_FP32, argmax
        equal, Jamba's expert choices equal but at near ties, launches
        exact (every recurrent layer's scan), collectives as
        ``step_collectives``."""
        for cfg in self.rec_mod_paths()[:2]:
            for shape in REC_PATH_MESHES:
                self._path_gate(cfg, shape, *REC_PATH, "path rec")

    def serving_rec(self) -> None:
        """Phase 3's 8 requests through ServingEngine on mesh 1x4: rwkv6 as
        in serving tp (bf16 with TTFT, TPOT, busy, NCCL and idle a decode
        step by rank; fp32 compute against the one-card engine), then Jamba
        at full width on the most layers four cards hold (shards drawn on
        the cards), tokens equal on every rank."""
        self.serving_tp((REC_RWKV,), "serving rec")
        self._serve_deepest(REC_JAMBA, "serving rec", trace=False)

    def train_rec(self) -> None:
        """rwkv6 at full width on its first 2 layers, fp32, AdamW, and
        Jamba's layer 0, fp32, Adafactor, two steps from count 99 against
        one card's step (the gates of train tp) on REC_TRAIN_CASES; then
        Jamba's first 2 layers in bf16 with Adafactor on 2x2."""
        from repro_torch.configs import get_config
        rwkv = dataclasses.replace(cut(get_config(REC_RWKV), TP_TRAIN_LAYERS),
                                   dtype="float32", param_dtype="float32")
        for shape, variant in REC_TRAIN_CASES:
            self._train_gate(rwkv, self.mesh_of(shape), shape, variant,
                             label="rec")
        jamba = dataclasses.replace(cut(get_config(REC_JAMBA), 1),
                                    dtype="float32", param_dtype="float32")
        for shape, variant in REC_JAMBA_TRAIN_CASES:
            self._train_gate(jamba, self.mesh_of(shape), shape, variant,
                             label="rec", batch=REC_JAMBA_TRAIN_BATCH)
        self._train_bf16(REC_JAMBA, REC_JAMBA_BF16_TRAIN, "rec")

    # -- cross-attention and codebooks on the mesh (the mod phases) --------
    def mod_phases(self) -> list:
        """path mod, train mod and dryrun mod (module docstring); returns
        the dryrun mod decode records for profile tp."""
        for name, phase in (("path mod", self.path_mod),
                            ("train mod", self.train_mod)):
            t = time.perf_counter()
            phase()
            self.say(f"phase {name}: {time.perf_counter() - t:.1f} s")
            self.memory(f"after {name}")
        t = time.perf_counter()
        records = self._mesh_records(MOD_RECORDS, (), "mod", decode_cut=True)
        self.say(f"phase dryrun mod: {time.perf_counter() - t:.1f} s")
        return records

    def path_mod(self) -> None:
        """Prefill and 4 teacher-forced decode steps (append and committed)
        against card 0 without a mesh, fp32: vision on its first 10 layers
        and musicgen at full size on meshes 1x4 and 2x2, vision at batch 1
        on 1x4 (every cache cut by rows); PATH_TOL_FP32, argmax equal,
        launches exact, collectives as ``step_collectives``."""
        vision, music = self.rec_mod_paths()[2:]
        for cfg in (vision, music):
            for shape in REC_PATH_MESHES:
                self._path_gate(cfg, shape, *REC_PATH, "path mod")
        self._path_gate(vision, (1, self.n), *MOD_PATH_B1, "path mod")

    def train_mod(self) -> None:
        """The gates of train tp for vision's first 5 layers and musicgen's
        first 2 (fp32, AdamW) against one card's step; then vision at full
        depth in bf16 on 2x2 with its peak memory a card."""
        from repro_torch.configs import get_config
        for arch, layers, cases in (
                (MOD_VISION, MOD_VISION_TRAIN_LAYERS, REC_TRAIN_CASES),
                (MOD_MUSIC, TP_TRAIN_LAYERS, MOD_MUSIC_TRAIN_CASES)):
            cfg = dataclasses.replace(cut(get_config(arch), layers),
                                      dtype="float32", param_dtype="float32")
            for shape, variant in cases:
                self._train_gate(cfg, self.mesh_of(shape), shape, variant,
                                 label="mod")
        self._train_bf16(MOD_VISION, MOD_VISION_BF16_TRAIN, "mod")

    def expect_train(self, what, cfg, n_micro, steps,
                     seq=TP_TRAIN_SEQ) -> dict:
        """This rank's launches against ``steps`` train steps of
        ``n_micro`` microbatches of ``seq`` tokens under remat, equal on
        every rank (a scan launches once a segment)."""
        from repro_torch.kernels import ref
        kinds = [spec.kind for spec in cfg.layer_specs()]
        moe = sum(spec.mlp == "moe" for spec in cfg.layer_specs())
        per = (2 if cfg.remat else 1) * n_micro * steps
        segs = len(ref.scan_segments(seq))
        want = {"flash_attention": kinds.count("attn") * per,
                "decode_attention": 0, "decode_merge": 0,
                "moe_route": moe * per,
                "rwkv6_scan": kinds.count("rwkv") * segs * per,
                "ssm_scan": kinds.count("mamba") * segs * per}
        got = self.read()
        every = self.all(got)
        if any(g != want for g in every):
            raise AssertionError(f"{what}: launches by rank {every}, "
                                 f"expected {want}")
        self.launches_by_path[what] = got
        return got

    def profile_tp(self, records) -> None:
        """For each four-card decode record: the H100x4 MaxTput row it gives
        beside the analytic H100x4 and one-card H100 rows, and the engine
        model's H100x4 step beside the measured one."""
        from repro_torch.core.accelerators import PAPER_GPUS, tp_variant
        from repro_torch.core.engine_model import EngineModel, ModelPerf
        from repro_torch.core.profiler import (
            decode_bytes_per_step_base_from_record,
            decode_flops_per_token_from_record, profile_catalog,
            profile_from_dryrun)
        from repro_torch.core.workload import bucket_grid
        h100 = PAPER_GPUS["H100"]
        x4 = tp_variant(h100, self.n)
        buckets = bucket_grid()
        for cfg, rec in records:
            if rec["kind"] != "decode":
                continue
            perf = ModelPerf.from_config(cfg)
            row = profile_from_dryrun({x4.name: x4}, buckets, cfg, rec,
                                      SLO_TPOT_S).max_tput[x4.name]
            row_a = profile_catalog({x4.name: x4}, buckets, perf,
                                    SLO_TPOT_S).max_tput[x4.name]
            row_1 = profile_catalog({"H100": h100}, buckets, perf,
                                    SLO_TPOT_S).max_tput["H100"]
            if not (np.isfinite(row).all() and (row >= 0).all()):
                raise AssertionError(f"H100x4 row of {cfg.name}: {row}")
            if rec["shape"] == "decode_32k" and not row.any():
                raise AssertionError(f"H100x4 row of {cfg.name} is all 0")
            em = EngineModel(
                perf, flops_per_token=decode_flops_per_token_from_record(rec),
                bytes_per_step_base=decode_bytes_per_step_base_from_record(
                    rec, perf))
            B, S = rec["global_batch"], rec["seq_len"]
            self.say("profile tp: " + json.dumps({
                "gpu": x4.name, "model": cfg.name, "slo_tpot_s": SLO_TPOT_S,
                "record": f"{rec['arch']} {rec['shape']} global_batch {B} "
                          f"seq_len {S} devices {rec['devices']}",
                "buckets": [[b.i_lo, b.i_hi, b.o_lo, b.o_hi, float(r),
                             float(a), float(o)]
                            for b, r, a, o in zip(buckets, row, row_a,
                                                  row_1)],
                "columns": "i_lo, i_hi, o_lo, o_hi, record-derived H100x4 "
                           "req/s, analytic H100x4 req/s, analytic H100 "
                           "req/s",
                "feasible_buckets": [int((row > 0).sum()),
                                     int((row_a > 0).sum()),
                                     int((row_1 > 0).sum())],
                "engine_model_step_ms": {
                    "record": em.decode_step_time(x4, B, S) * 1e3,
                    "analytic": EngineModel(perf).decode_step_time(
                        x4, B, S) * 1e3},
                "measured_step_ms": rec["step_ms"],
                "measured_device_busy_ms_by_rank":
                    rec["device_busy_ms_by_rank"],
                "measured_nccl_ms_by_rank": rec["nccl_ms_by_rank"],
                "measured_compute_ms_by_rank": rec["compute_ms_by_rank"],
                "card_by_rank": rec["card_by_rank"]}))


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser(description="drive the port on the card")
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4),
                    help="4: the tensor-parallel mode on four cards")
    ap.add_argument("--phases", default=",".join(PHASE_GROUPS),
                    help="--cards 4: the phase groups to run, a "
                    f"comma-separated list of {', '.join(PHASE_GROUPS)} "
                    "(kernels tp runs with any; sp adds the baseline "
                    "records of its own records)")
    args = ap.parse_args()
    if args.cards == 1:
        sys.exit(main())
    sys.exit(cards_main(4, tuple(p for p in args.phases.split(",") if p)))

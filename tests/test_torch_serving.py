"""Port serving (repro_torch.serving) vs the JAX package's engine and block
manager, on the CPU; and the port's import and device boundaries."""
import dataclasses
import functools
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import Melange, ModelPerf as JModelPerf
from repro.core import PAPER_GPUS as J_PAPER_GPUS
from repro.models import transformer as JT
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import Request as JRequest
from repro.serving import ServingCluster as JServingCluster
from repro.serving import ServingEngine as JServingEngine
from repro.serving.kv_cache import BlockManager as JBlockManager
from repro.serving.kv_cache import OutOfBlocks as JOutOfBlocks
from repro_torch.configs import get_config
from repro_torch.core.accelerators import PAPER_GPUS
from repro_torch.core.engine_model import ModelPerf
from repro_torch.core.profiler import profile_catalog
from repro_torch.core.workload import bucket_grid
from repro_torch.models import transformer as T
from repro_torch.serving import (BlockManager, EngineConfig, OutOfBlocks,
                                 Request, ServingCluster, ServingEngine)
# the reduced configs and the jitted JAX model entry points of the model
# tests: the same config, shapes and jitted functions share XLA compiles
from test_torch_model import PREFILL_LENS, _reduced, j_decode, jax_prefill

SRC = Path(__file__).resolve().parents[1] / "src"


@functools.cache
def _models(arch):
    """Reduced ``arch`` with numpy-drawn weights, in both packages."""
    cfg_j = _reduced(jax_get_config(arch))
    rng = np.random.default_rng(7)
    shapes = jax.eval_shape(lambda: JT.init_params(cfg_j,
                                                   jax.random.PRNGKey(0)))

    def draw(path, leaf):
        x = rng.standard_normal(leaf.shape).astype(np.float32)
        if "norm" in jax.tree_util.keystr(path):
            return 1.0 + 0.1 * x
        return 0.3 * x

    np_params = jax.tree_util.tree_map_with_path(draw, shapes)
    cfg_t = _reduced(get_config(arch))
    model = T.from_jax_params(cfg_t, np_params, device="cpu")
    return cfg_j, jax.tree.map(jnp.asarray, np_params), cfg_t, model


@pytest.fixture(scope="module")
def models():
    return _models("internlm2-1.8b")


def _prompts(vocab, lens=(5, 9, 13, 7)):
    rng = np.random.default_rng(0)
    return [list(map(int, rng.integers(1, vocab, size=L))) for L in lens]


def test_engine_greedy_matches_jax_engine():
    """Prompts of tests/test_serving.py::test_engine_matches_reference, for
    reduced internlm2 and granite-moe; both engines decode in append mode.
    Both decode the full slot batch, so granite's MoE sees the empty slots
    too and its capacity and drops match."""
    for arch in ("internlm2-1.8b", "granite-moe-1b-a400m"):
        cfg_j, params_j, cfg_t, model = _models(arch)
        prompts = _prompts(cfg_j.vocab_size)
        eng_j = JServingEngine(cfg_j, params_j,
                               JEngineConfig(max_batch=4, max_seq=64))
        eng_t = ServingEngine(cfg_t, model,
                              EngineConfig(max_batch=4, max_seq=64),
                              device="cpu")
        for i, p in enumerate(prompts):
            eng_j.submit(JRequest(rid=i, prompt=p, max_new_tokens=6))
            eng_t.submit(Request(rid=i, prompt=p, max_new_tokens=6))
        done_j = {r.rid: r.generated for r in eng_j.run()}
        done_t = eng_t.run()
        assert len(done_t) == 4, arch
        for r in done_t:
            assert r.generated == done_j[r.rid], (arch, r.rid)
            assert len(r.generated) == 6 and r.ttft >= 0 and r.tpot >= 0
        assert eng_t.blocks.n_used == 0
        eng_t.blocks.check_invariants()
        assert eng_t.prefills == 4


def test_cluster_routes_and_serves_as_jax_cluster():
    """tests/test_serving.py::test_cluster_routes_and_serves for the port,
    held to the JAX cluster: the same profile (the reference's Melange
    profile and the port's profile_catalog agree exactly), allocation
    {"A100": 1, "A10G": 1} and seed 0, 8 requests; equal routes, equal
    ClusterStats and equal tokens per request. Reduced internlm2 at the
    engine shape of test_engine_greedy_matches_jax_engine."""
    cfg_j, params_j, cfg_t, model = _models("internlm2-1.8b")
    profile_j = Melange(J_PAPER_GPUS, JModelPerf.llama2_7b(), 0.12).profile
    profile_t = profile_catalog(PAPER_GPUS, bucket_grid(),
                                ModelPerf.llama2_7b(), 0.12)
    assert profile_t.to_json() == profile_j.to_json()
    alloc = {"A100": 1, "A10G": 1}
    cl_j = JServingCluster(cfg_j, params_j, alloc, profile_j,
                           JEngineConfig(max_batch=4, max_seq=64), seed=0)
    cl_t = ServingCluster(cfg_t, model, alloc, profile_t,
                          EngineConfig(max_batch=4, max_seq=64), seed=0,
                          device="cpu")
    rng = np.random.default_rng(1)
    for i in range(8):
        prompt = list(map(int, rng.integers(1, cfg_j.vocab_size, size=6)))
        assert cl_t.submit(Request(rid=i, prompt=prompt, max_new_tokens=4)) \
            == cl_j.submit(JRequest(rid=i, prompt=prompt, max_new_tokens=4))
    stats_j, stats_t = cl_j.run(), cl_t.run()
    assert cl_t.routed == cl_j.routed and len(set(cl_t.routed.values())) == 2
    assert dataclasses.astuple(stats_t) == dataclasses.astuple(stats_j)
    assert stats_t.completed == 8 and stats_t.rejected == 0
    assert sum(stats_t.per_instance.values()) == 8

    def tokens(cluster):
        return {r.rid: r.generated for e in cluster.engines
                for r in e.finished}

    assert tokens(cl_t) == tokens(cl_j)
    assert all(e.model is model for e in cl_t.engines)
    assert cl_t.engines[0].cache is not cl_t.engines[1].cache


def _jax_exact_prefill_greedy(cfg, params, prompts, max_batch, max_seq,
                              new_tokens):
    """The JAX model driven at the model level, as the port's engine drives
    its own when all prompts fit the first step: each prompt prefilled at
    its exact length into its slot, then committed decode steps over the
    whole slot batch, greedy. (The JAX engine pads prompts to a power of
    two, and its recurrent states then absorb the pad tokens: ROADMAP
    C-ref-4. RWKV6 prefills through JAX's sequential oracle: ROADMAP C1.)"""
    cache, _ = JT.init_cache(cfg, max_batch, max_seq)
    lengths = np.zeros(max_batch, np.int32)
    toks = np.zeros(max_batch, np.int32)
    out = []
    for slot, p in enumerate(prompts):
        logits, pf = jax_prefill(cfg, params, jnp.asarray([p], jnp.int32))
        cache = JT.cache_insert(cfg, cache, pf, slot, len(p))
        out.append([int(jnp.argmax(logits[0, -1]))])
        lengths[slot] = len(p)
    for _ in range(new_tokens - 1):
        toks[:len(out)] = [g[-1] for g in out]
        logits, cache = j_decode(cfg, params, cache, jnp.asarray(toks),
                                 jnp.asarray(lengths))
        for slot, g in enumerate(out):
            g.append(int(jnp.argmax(logits[slot])))
        lengths[:len(out)] += 1
    return out


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "jamba-1.5-large-398b"])
def test_engine_prefills_recurrent_configs_at_exact_length(arch,
                                                           monkeypatch):
    """Configs with Mamba or RWKV layers: the port's engine prefills each
    prompt unpadded and matches the JAX model's exact-length prefill and
    committed decode on the same slot batch, token for token. The prompt
    lengths (40 and 23, neither a power of two, so the JAX engine would pad
    both) and the slot batch (2 x 48) are those of
    test_torch_model.py::test_prefill_then_decode_matches_jax, so the JAX
    side reuses its compiles."""
    cfg_j, params_j, cfg_t, model = _models(arch)
    prompts = _prompts(cfg_j.vocab_size, PREFILL_LENS)
    batch, max_seq, new = len(prompts), 48, 6
    want = _jax_exact_prefill_greedy(cfg_j, params_j, prompts, batch,
                                     max_seq, new)
    prefill_lens = []
    prefill = model.prefill

    def spy(tokens, **kw):
        prefill_lens.append(tokens.shape[1])
        return prefill(tokens, **kw)

    monkeypatch.setattr(model, "prefill", spy)
    eng = ServingEngine(cfg_t, model,
                        EngineConfig(max_batch=batch, max_seq=max_seq),
                        device="cpu")
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=new))
    done = {r.rid: r.generated for r in eng.run()}
    assert prefill_lens == list(PREFILL_LENS)
    assert [done[i] for i in range(len(prompts))] == want
    assert eng.decodes == new - 1 and eng.blocks.n_used == 0


def test_engine_rejects_too_long_and_batches_continuously(models):
    _, _, cfg, model = models
    eng = ServingEngine(cfg, model, EngineConfig(max_batch=2, max_seq=32),
                        device="cpu")
    eng.submit(Request(rid=0, prompt=list(range(1, 30)), max_new_tokens=20))
    assert [r.generated for r in eng.run()] == [[]]
    eng = ServingEngine(cfg, model, EngineConfig(max_batch=2, max_seq=64),
                        device="cpu")
    for i in range(5):                      # more requests than slots
        eng.submit(Request(rid=i, prompt=[3 + i, 5, 7], max_new_tokens=4))
    done = eng.run()
    assert len(done) == 5 and all(len(r.generated) == 4 for r in done)
    assert eng.n_active == 0 and not eng.queue and eng.blocks.n_used == 0


def test_temperature_sampling_is_seeded(models):
    _, _, cfg, model = models
    streams = []
    for _ in range(2):
        eng = ServingEngine(cfg, model,
                            EngineConfig(max_batch=2, max_seq=32, seed=5),
                            device="cpu")
        eng.submit(Request(rid=0, prompt=[4, 8, 15], max_new_tokens=5,
                           temperature=1.0))
        streams.append(eng.run()[0].generated)
    assert streams[0] == streams[1] and len(streams[0]) == 5


def test_engine_defaults_to_cuda(models, monkeypatch):
    _, _, cfg, model = models
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        ServingEngine(cfg, model, EngineConfig(max_batch=2, max_seq=32))


def _apply(bm, op, args, out_of_blocks):
    try:
        result = getattr(bm, op)(*args)
    except (out_of_blocks, ValueError, KeyError) as e:
        return type(e).__name__
    return getattr(result, "blocks", result)


def _state(bm):
    return (list(bm.free), list(bm.ref),
            {s: (list(a.blocks), a.tokens) for s, a in bm.seqs.items()})


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_block_manager_matches_jax_copy(seed):
    rng = np.random.default_rng(seed)
    ours, theirs = BlockManager(24, 4), JBlockManager(24, 4)
    for _ in range(400):
        op = rng.choice(["allocate", "append_token", "fork", "free_seq"],
                        p=[0.3, 0.45, 0.1, 0.15])
        seq = int(rng.integers(0, 8))
        args = {"allocate": (seq, int(rng.integers(0, 20))),
                "fork": (seq, int(rng.integers(0, 8)))}.get(op, (seq,))
        assert _apply(ours, op, args, OutOfBlocks) == \
            _apply(theirs, op, args, JOutOfBlocks), (op, args)
        assert _state(ours) == _state(theirs)
        ours.check_invariants()
        theirs.check_invariants()


def test_port_imports_no_jax_and_nothing_of_repro():
    code = (
        "import pkgutil, sys, importlib, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print(' '.join(n for n in sys.modules if n.startswith('repro_torch')))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env={"PYTHONPATH": str(SRC),
                                          "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr
    imported = set(proc.stdout.split())
    assert len(imported) >= 22         # every module was imported
    assert {"repro_torch.models.ssm", "repro_torch.kernels.rwkv6_scan",
            "repro_torch.kernels.ssm_scan", "repro_torch.serving.cluster",
            "repro_torch.launch.dryrun", "repro_torch.core.balancer",
            "repro_torch.core.profiler", "repro_torch.configs.shapes",
            "repro_torch.training.data", "repro_torch.training.optimizer",
            "repro_torch.training.train_loop", "repro_torch.launch.steps",
            "repro_torch.checkpoint.checkpoint",
            "repro_torch.distributed.sharding", "repro_torch.launch.mesh",
            "repro_torch.tree"} <= imported

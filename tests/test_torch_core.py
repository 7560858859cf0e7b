"""The port's copies of the JAX package's framework-free modules
(repro_torch/core/*, repro_torch/configs/shapes.py) against their originals,
and the port's one-card dry-run record (repro_torch.launch.dryrun) on the CPU.

The copies must agree with the originals exactly: the same numbers, the
same routes, the same JSON text. A source guard also holds each copy's code
to its original's, outside the docstring and the top-level imports.
"""
import ast
import dataclasses
import functools
import json
from pathlib import Path

import numpy as np
import pytest

import repro.core.accelerators as j_acc
import repro.core.allocator as j_alloc
import repro.core.balancer as j_bal
import repro.core.dominance as j_dom
import repro.core.engine_model as j_em
import repro.core.ilp as j_ilp
import repro.core.loadmatrix as j_lm
import repro.core.profiler as j_prof
import repro.core.simulator as j_sim
import repro.core.workload as j_wl
import repro.configs.shapes as j_shapes
from repro.configs import get_config as jax_get_config
from repro_torch.configs import get_config, list_archs
import repro_torch.configs.shapes as p_shapes
import repro_torch.core.accelerators as p_acc
import repro_torch.core.allocator as p_alloc
import repro_torch.core.balancer as p_bal
import repro_torch.core.dominance as p_dom
import repro_torch.core.engine_model as p_em
import repro_torch.core.ilp as p_ilp
import repro_torch.core.loadmatrix as p_lm
import repro_torch.core.profiler as p_prof
import repro_torch.core.simulator as p_sim
import repro_torch.core.workload as p_wl
from repro_torch.launch import dryrun
from repro_torch.models import transformer as T

SLO = 0.12
COPIES = {"accelerators": (j_acc, p_acc), "workload": (j_wl, p_wl),
          "engine_model": (j_em, p_em), "profiler": (j_prof, p_prof),
          "balancer": (j_bal, p_bal), "shapes": (j_shapes, p_shapes),
          "ilp": (j_ilp, p_ilp), "dominance": (j_dom, p_dom),
          "loadmatrix": (j_lm, p_lm), "allocator": (j_alloc, p_alloc),
          "simulator": (j_sim, p_sim)}


def _code(module) -> str:
    """The module's AST without its docstring and top-level imports."""
    tree = ast.parse(Path(module.__file__).read_text())
    body = tree.body
    if body and isinstance(body[0], ast.Expr) and \
            isinstance(body[0].value, ast.Constant):
        body = body[1:]
    tree.body = [n for n in body
                 if not isinstance(n, (ast.Import, ast.ImportFrom))]
    return ast.dump(tree)


@pytest.mark.parametrize("name", sorted(COPIES))
def test_copy_source_equals_original(name):
    orig, copy = COPIES[name]
    got = _code(copy)
    if name == "engine_model":    # ModelPerf.from_config's lazy import
        got = got.replace("repro_torch.models.transformer",
                          "repro.models.transformer")
    assert got == _code(orig)
    assert f"src/{orig.__name__.replace('.', '/')}.py" in copy.__doc__


def _fields(x):
    return dataclasses.astuple(x)


def test_accelerator_catalogs_equal():
    for j_cat, p_cat in ((j_acc.PAPER_GPUS, p_acc.PAPER_GPUS),
                         (j_acc.TPU_FLEET, p_acc.TPU_FLEET)):
        assert list(j_cat) == list(p_cat)
        for name in j_cat:
            assert _fields(p_cat[name]) == _fields(j_cat[name]), name
    h100 = p_acc.PAPER_GPUS["H100"]
    assert (h100.mem_gb, h100.bw_gbs, h100.flops_tf) == (80, 3350, 989)


def test_buckets_and_edges_equal():
    jb, pb = j_wl.bucket_grid(), p_wl.bucket_grid()
    assert len(pb) == 60
    assert [_fields(b) for b in pb] == [_fields(b) for b in jb]
    assert [(b.rep_input, b.rep_output) for b in pb] == \
        [(b.rep_input, b.rep_output) for b in jb]
    assert p_wl.grid_edges(pb) == j_wl.grid_edges(jb)
    for edges in (p_wl.INPUT_EDGES, p_wl.OUTPUT_EDGES):
        vals = sorted({v + d for v in edges for d in (-1, 0, 1)}
                      | {0, 10 ** 6})
        assert np.array_equal(p_wl.edge_bucket(vals, edges),
                              j_wl.edge_bucket(vals, edges))
        for v in vals:
            assert int(p_wl.edge_bucket(v, edges)) == \
                int(j_wl.edge_bucket(v, edges))


@functools.lru_cache(maxsize=None)
def _jax_perf(arch):
    """The JAX package's ModelPerf of ``arch`` (its parameter count traces
    the init, ~1 s a config, so each is made once)."""
    return j_em.ModelPerf.from_config(jax_get_config(arch))


@pytest.mark.parametrize("arch", list_archs())
def test_model_perf_from_config_equal(arch):
    got = p_em.ModelPerf.from_config(get_config(arch))
    assert _fields(got) == _fields(_jax_perf(arch))


@pytest.mark.parametrize("arch", list_archs())
def test_param_counts_equal(arch):
    """The port's meta-device count against the JAX package's, total and
    active, for every config (the vision projection and the codebook
    embed and head included)."""
    cfg, cfg_j = get_config(arch), jax_get_config(arch)
    assert cfg.param_count() == cfg_j.param_count()
    assert cfg.active_param_count() == cfg_j.active_param_count()


@pytest.mark.parametrize("arch", list_archs())
def test_analytic_profile_row_equal(arch):
    """The analytic MaxTput rows the solver reads, for every config and
    paper GPU: equal numbers and equal JSON (rows of configs that fit no
    single paper GPU, jamba's and kimi-k2's, are zero in both)."""
    jp, pp = _catalog_profiles(_jax_perf(arch),
                               p_em.ModelPerf.from_config(get_config(arch)))
    for gpu, row in jp.max_tput.items():
        assert np.array_equal(pp.max_tput[gpu], row), gpu
    assert pp.to_json() == jp.to_json()


def _catalog_profiles(j_perf, p_perf):
    jp = j_prof.profile_catalog(j_acc.PAPER_GPUS, j_wl.bucket_grid(),
                                j_perf, SLO)
    pp = p_prof.profile_catalog(p_acc.PAPER_GPUS, p_wl.bucket_grid(),
                                p_perf, SLO)
    return jp, pp


@pytest.mark.parametrize("arch", ["llama2-7b", "qwen2-1.5b"])
def test_max_throughput_rows_equal(arch):
    """EngineModel.max_throughput over the 60 buckets for every paper GPU
    (through profile_catalog), equal exactly."""
    if arch == "llama2-7b":
        perfs = j_em.ModelPerf.llama2_7b(), p_em.ModelPerf.llama2_7b()
    else:
        perfs = (j_em.ModelPerf.from_config(jax_get_config(arch)),
                 p_em.ModelPerf.from_config(get_config(arch)))
    jp, pp = _catalog_profiles(*perfs)
    assert list(pp.max_tput) == list(jp.max_tput)
    for gpu, row in jp.max_tput.items():
        assert row.shape == (60,)
        assert np.array_equal(pp.max_tput[gpu], row), gpu
    assert any(row.any() for row in pp.max_tput.values())
    assert pp.to_json() == jp.to_json()


def _record():
    """A synthetic one-card decode record."""
    return {"arch": "qwen2-1.5b", "shape": "decode_32k", "devices": 1,
            "mesh": "single_card", "seq_len": 32768, "global_batch": 72,
            "flops": 2.4e11, "bytes_accessed": 7.1e10, "bytes_tc": 7.0e10}


def test_profile_from_dryrun_equal():
    rec = _record()
    jp = j_prof.profile_from_dryrun(j_acc.PAPER_GPUS, j_wl.bucket_grid(),
                                    jax_get_config("qwen2-1.5b"), rec, SLO)
    pp = p_prof.profile_from_dryrun(p_acc.PAPER_GPUS, p_wl.bucket_grid(),
                                    get_config("qwen2-1.5b"), rec, SLO)
    for gpu, row in jp.max_tput.items():
        assert np.array_equal(pp.max_tput[gpu], row), gpu
    assert pp.to_json() == jp.to_json()
    assert p_prof.record_devices(rec) == j_prof.record_devices(rec) == 1
    assert p_prof.record_devices({"mesh": "pod_16x16"}) == 256


def test_load_balancer_routes_equal():
    j_perf, p_perf = j_em.ModelPerf.llama2_7b(), p_em.ModelPerf.llama2_7b()
    jp, pp = _catalog_profiles(j_perf, p_perf)
    gpus = sorted(j_acc.PAPER_GPUS)
    lbs = [mod.LoadBalancer(prof, [mod.InstanceRef(i, g) for i, g in
                                   enumerate(gpus * 2)],
                            seed=3, straggler_factor=0.5)
           for mod, prof in ((j_bal, jp), (p_bal, pp))]
    rng = np.random.default_rng(4)
    first = [int(x) for x in rng.integers(1, 20000, size=50)]
    second = [int(x) for x in rng.integers(1, 20000, size=50)]

    def routes(lb, inputs):
        return [lb.route(n).inst_id for n in inputs]

    assert routes(lbs[1], first) == routes(lbs[0], first)
    for lb in lbs:
        for k, n in enumerate(first[:20]):
            lb.observe(n, 10 + 37 * k, inst_id=k % len(lb.instances),
                       tpot=0.02 + 0.01 * k)
        lb.mark_draining(2)
        lb.mark_draining(5)
    assert routes(lbs[1], second) == routes(lbs[0], second)
    assert {2, 5}.isdisjoint(routes(lbs[1], second))
    assert [lb.estimate_output(n) for n in first[:10] for lb in lbs[1:]] \
        == [lbs[0].estimate_output(n) for n in first[:10]]


def test_shapes_and_applicability_equal():
    assert list(p_shapes.SHAPES) == list(j_shapes.SHAPES)
    for name, case in j_shapes.SHAPES.items():
        assert _fields(p_shapes.get_shape(name)) == _fields(case)
    for arch in list_archs():
        cfg_p, cfg_j = get_config(arch), jax_get_config(arch)
        for name in p_shapes.SHAPES:
            assert p_shapes.applicable(cfg_p, p_shapes.get_shape(name)) == \
                j_shapes.applicable(cfg_j, j_shapes.get_shape(name))


# ---------------------------------------------------------------------------
# the one-card dry-run record, on the CPU
# ---------------------------------------------------------------------------
CPU_SEQ = 64     # the CPU run's context length (the case's is 32768)


@pytest.fixture(scope="module")
def qwen2_record(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    rec = dryrun.run_cell("qwen2-1.5b", "decode_32k", out, device="cpu",
                          reduced=True, seq_len=CPU_SEQ)
    return rec, out


def test_run_cell_record(qwen2_record):
    rec, out = qwen2_record
    for key in ("arch", "shape", "kind", "seq_len", "global_batch",
                "n_params", "n_params_active", "ok", "devices", "mesh",
                "flops", "flops_tc", "flops_source", "bytes_accessed",
                "bytes_tc", "bytes_source", "reduced"):
        assert key in rec, key
    assert rec["ok"] is True and rec["devices"] == 1
    assert rec["kind"] == "decode" and rec["seq_len"] == CPU_SEQ
    assert rec["global_batch"] == 128        # no card: the case's batch
    assert rec["reduced"] == {"seq_len": [32768, CPU_SEQ]}
    assert "step_ms" not in rec and "device_busy_ms" not in rec
    assert "CPU" in rec["not_measured"]
    cfg = get_config("qwen2-1.5b").reduced()
    assert rec["n_params"] == jax_get_config("qwen2-1.5b").reduced() \
        .param_count() == cfg.param_count()
    assert rec["bytes_accessed"] >= rec["n_params"] * 4     # fp32 weights
    written = json.loads(
        (out / "qwen2-1.5b__decode_32k__single_card.json").read_text())
    assert written == json.loads(json.dumps(rec, default=str))


def test_run_cell_flops_match_analytic_count(qwen2_record):
    """FlopCounterMode over the plain append-mode step equals, exactly: 2 x
    the matmul parameters x batch (the unembed product included, the
    embedding lookup left out) + per attention layer 4 H Dh S (scores and
    values over the cache) + 2 H Dh (the new token's score) a sequence."""
    rec, _ = qwen2_record
    cfg = get_config("qwen2-1.5b").reduced()
    model = T.Transformer(cfg, device="meta")
    matmul = sum(p.numel() for name, p in model.named_parameters()
                 if name.rsplit(".", 1)[-1] in ("wq", "wk", "wv", "wo",
                                                "w_gate", "w_up", "w_down"))
    matmul += T._padded_vocab(cfg) * cfg.d_model          # tied unembed
    B, S = rec["global_batch"], rec["seq_len"]
    H, Dh = cfg.n_heads, cfg.head_dim
    n_attn = sum(spec.kind == "attn" for spec in cfg.layer_specs())
    want = 2 * matmul * B + n_attn * B * (4 * H * Dh * S + 2 * H * Dh)
    assert rec["flops"] == rec["flops_tc"] == want


def test_run_cell_feeds_both_profilers_alike(qwen2_record):
    rec, _ = qwen2_record
    jp = j_prof.profile_from_dryrun(j_acc.PAPER_GPUS, j_wl.bucket_grid(),
                                    jax_get_config("qwen2-1.5b").reduced(),
                                    rec, SLO)
    pp = p_prof.profile_from_dryrun(p_acc.PAPER_GPUS, p_wl.bucket_grid(),
                                    get_config("qwen2-1.5b").reduced(),
                                    rec, SLO)
    assert pp.to_json() == jp.to_json()
    assert all(np.isfinite(r).all() and (r >= 0).all()
               for r in pp.max_tput.values())
    assert pp.max_tput["H100"].any()


def test_run_cell_refuses_training_and_skips_like_reference(tmp_path):
    """A train record under a variant that only changes sharding (FSDP) is
    refused before anything is written (one card has no mesh); long_500k
    is skipped for a full-attention config as the reference skips it; the
    baseline train record states the train step that ran."""
    with pytest.raises(NotImplementedError, match="multi-card slice"):
        dryrun.run_cell("qwen2-1.5b", "train_4k", tmp_path, device="cpu",
                        reduced=True, variant="fsdp")
    assert not list(tmp_path.glob("*train_4k*"))
    rec = dryrun.run_cell("qwen2-1.5b", "long_500k", tmp_path,
                          device="cpu", reduced=True, seq_len=CPU_SEQ)
    cfg_j = jax_get_config("qwen2-1.5b").reduced()
    assert rec["ok"] is False
    assert rec["skipped"] == j_shapes.applicable(
        cfg_j, j_shapes.get_shape("long_500k"))[1]
    rec = dryrun.run_cell("qwen2-1.5b", "train_4k", tmp_path, device="cpu",
                          reduced=True, seq_len=16)
    assert rec["ok"] is True and rec["kind"] == "train"
    assert rec["train_steps"] == len(rec["losses"]) == 1
    assert (rec["optimizer"], rec["n_micro"]) == ("adamw", 4)
    assert rec["reduced"]["global_batch"] == [256, dryrun.TRAIN_BATCH]
    assert list(tmp_path.glob("qwen2-1.5b__train_4k__single_card.json"))

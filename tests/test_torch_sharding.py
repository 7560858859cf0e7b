"""The port's sharding rules and spec trees (repro_torch.distributed.
sharding, repro_torch.launch.steps) against the JAX package's on the CPU.

For all ten configs, the four shape cases and the meshes 1x1, 1x4, 2x2 and
16x16 (and for the dense and MoE configs' train cells under ``fsdp``,
``micro8+bf16grad`` and ``expdata``), the spec of every parameter, decode-cache, batch and
optimizer-state leaf that the port gives (``steps.shardings_of`` over ``param_axes`` /
``cache_axes`` / ``batch_axes`` / ``optimizer.state_axes`` under
``rules_for`` / ``opt_rules``) equals the reference's ``_resolve`` over its
own axes trees and rules. The reference's ``rules_for`` reads only
``mesh.shape``, so a stand-in with that mapping serves for every mesh (a
CPU test process has one JAX device, and the reference's ``lower_cell``
does not run on the CPU: ROADMAP C-ref-1). No process is spawned here.
"""
import subprocess
import sys
from pathlib import Path

import jax
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.shapes import get_shape as jax_get_shape
from repro.distributed import sharding as JSH
from repro.launch import steps as JS
from repro.models import transformer as JT
from repro.training import optimizer as JOPT
from repro_torch.configs import get_config, list_archs
from repro_torch.configs.shapes import SHAPES, ShapeCase
from repro_torch.distributed import sharding as SH
from repro_torch.launch import steps as ST
from repro_torch.models import transformer as T
from repro_torch.training import optimizer as OPT
from repro_torch.tree import flatten, keystr

SRC = Path(__file__).resolve().parents[1] / "src"
MESHES = {"1x1": (1, 1), "1x4": (1, 4), "2x2": (2, 2), "16x16": (16, 16)}


class _Mesh:
    """A mesh stand-in: its axis sizes (all the rules read)."""

    def __init__(self, data, model):
        self.shape = {"data": data, "model": model}


def _is_axes(v):
    return isinstance(v, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in v)


def _axes_leaves(tree):
    """{keystr: axes} of a tree whose leaves are logical-axes tuples."""
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=_is_axes)
    return {jax.tree_util.keystr(p): tuple(a) for p, a in leaves}


def _shapes(tree):
    """{keystr: shape} of a tree of tensors (the port's structure)."""
    return {keystr(p): tuple(t.shape) for p, t in flatten(tree)}


def _is_spec(v):
    return isinstance(v, tuple) and all(
        e is None or isinstance(e, str)
        or (isinstance(e, tuple) and all(isinstance(a, str) for a in e))
        for e in v)


def _specs(tree):
    """{keystr: spec} of a port spec tree."""
    out = {}

    def walk(node, path):
        if _is_spec(node):
            out[keystr(path)] = node
        elif isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (k,))
        else:
            for i, v in enumerate(node):
                walk(v, path + (i,))

    walk(tree, ())
    return out


def _ref(mesh, axes_tree, shapes, rules):
    """The reference's specs: ``_resolve`` of its axes at the port's
    shapes (equal shapes are held by tests/test_torch_core.py)."""
    sizes = dict(mesh.shape)
    return {k: tuple(JSH._resolve(sizes, a, shapes[k], rules))
            for k, a in _axes_leaves(axes_tree).items()}


def _jax_param_axes(cfg_j):
    """The reference's ``param_axes`` (its ``_init`` of the reduced config,
    axes half), traced abstractly: eager, its random init takes ~1 s a
    config."""
    out = {}

    def init(key):
        params, out["axes"] = JT._init(cfg_j.reduced(repeat_cap=1), key)
        return params

    jax.eval_shape(init, jax.random.PRNGKey(0))
    return out["axes"]


@pytest.fixture(scope="module")
def trees():
    """Per arch: the port's meta model and both packages' axes trees."""
    out = {}
    for arch in list_archs():
        cfg, cfg_j = get_config(arch), jax_get_config(arch)
        out[arch] = (cfg, cfg_j, T.Transformer(cfg, device="meta"),
                     _jax_param_axes(cfg_j), JT.cache_axes(cfg_j))
    assert _axes_leaves(out["qwen2-1.5b"][3]) == _axes_leaves(
        JT.param_axes(out["qwen2-1.5b"][1]))
    return out


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", list_archs())
def test_specs_match_reference(trees, arch, mesh_name):
    cfg, cfg_j, model, p_axes_j, c_axes_j = trees[arch]
    mesh = _Mesh(*MESHES[mesh_name])
    params = T.param_tree(model)
    p_shapes = _shapes(params)
    assert set(_axes_leaves(T.param_axes(cfg))) == set(p_shapes)
    for shape in SHAPES:
        case = SHAPES[shape]
        rules = ST.rules_for(cfg, case, mesh)
        rules_j = JS.rules_for(cfg_j, jax_get_shape(shape), mesh)
        assert dict(rules.rules) == dict(rules_j.rules), shape
        got = _specs(ST.shardings_of(mesh, T.param_axes(cfg), params, rules))
        assert got == _ref(mesh, p_axes_j, p_shapes, rules_j), shape
        cache = T.init_cache(cfg, case.global_batch, case.seq_len,
                             device="meta")
        got = _specs(ST.shardings_of(mesh, T.cache_axes(cfg), cache, rules))
        assert got == _ref(mesh, c_axes_j, _shapes(cache), rules_j), shape
        batch = ST.abstract_batch(cfg, case)
        got = _specs(ST.shardings_of(mesh, ST.batch_axes(cfg, case.kind),
                                     batch, rules))
        assert got == _ref(mesh, JS.batch_axes(cfg_j, case.kind),
                           _shapes(batch), rules_j), shape
        if case.kind != "train":
            continue
        named = dict(model.named_parameters())
        o_axes = OPT.state_axes(named, {k: T._axes_of(cfg, k)
                                        for k in named}, cfg.optimizer)
        state = OPT.init(named, cfg.optimizer)
        o_specs = ST.shardings_of(mesh, o_axes, state, ST.opt_rules(rules))
        got = _specs(OPT.state_to_tree(o_specs, cfg.optimizer))
        o_axes_j = JOPT.state_axes(params, p_axes_j, cfg_j.optimizer)
        o_shapes = _shapes(OPT.state_to_tree(state, cfg.optimizer))
        assert got == _ref(mesh, o_axes_j, o_shapes,
                           JS.opt_rules(rules_j)), shape


DENSE = ("qwen2-1.5b", "internlm2-1.8b", "minitron-4b", "gemma2-27b")
MOE = ("granite-moe-1b-a400m", "kimi-k2-1t-a32b")


@pytest.mark.parametrize("variant", ["fsdp", "micro8+bf16grad", "expdata"])
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", DENSE + MOE)
def test_train_cell_specs_match_reference(trees, arch, mesh_name, variant):
    """``build_cell(mesh=)``'s train cell under ``fsdp``,
    ``micro8+bf16grad`` and ``expdata`` (the experts over ("data",
    "model"): only the MoE configs have leaves it moves): its rules, and
    its parameter and optimizer-state spec trees (AdamW's moments,
    kimi-k2's Adafactor factors), equal the reference's ``rules_for`` /
    ``opt_rules`` over its own axes trees (its ``build_cell``'s
    shardings); its parameters and its optimizer state are the shards the
    specs give rank 0."""
    cfg, cfg_j, model, p_axes_j, _ = trees[arch]
    mesh = _Mesh(*MESHES[mesh_name])
    case = SHAPES["train_4k"]
    lay = SH.Layout(mesh.shape, {"data": 0, "model": 0}, SH.ShardingRules())
    _, kw, _, rules, ins, outs = ST.build_cell(cfg, case, "meta", variant,
                                               mesh=lay)
    rules_j = JS.rules_for(cfg_j, jax_get_shape("train_4k"), mesh, variant)
    assert dict(rules.rules) == dict(rules_j.rules)
    params = T.param_tree(model)
    p_shapes = _shapes(params)
    assert _specs(ins["params"]) == _ref(mesh, p_axes_j, p_shapes, rules_j)
    named = dict(model.named_parameters())
    o_shapes = _shapes(OPT.state_to_tree(OPT.init(named, cfg.optimizer),
                                         cfg.optimizer))
    o_axes_j = JOPT.state_axes(params, p_axes_j, cfg_j.optimizer)
    assert _specs(OPT.state_to_tree(ins["opt_state"], cfg.optimizer)) == \
        _ref(mesh, o_axes_j, o_shapes, JS.opt_rules(rules_j))
    assert outs[:2] == (ins["params"], ins["opt_state"])
    local = {keystr(p): tuple(t.shape) for p, t in
             flatten(T.param_tree(kw["params"]))}
    for k, spec in _specs(ins["params"]).items():
        assert local[k] == tuple(n // lay.size(e) for e, n in
                                 zip(spec, p_shapes[k])), k
    o_local = _shapes(OPT.state_to_tree(kw["opt_state"], cfg.optimizer))
    for k, spec in _specs(OPT.state_to_tree(ins["opt_state"],
                                            cfg.optimizer)).items():
        assert o_local[k] == tuple(n // lay.size(e) for e, n in
                                   zip(spec, o_shapes[k])), k


ITEM_4B = ("rwkv6-1.6b", "jamba-1.5-large-398b", "llama-3.2-vision-11b",
           "musicgen-large")


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ITEM_4B)
def test_seqpar_cell_specs_match_reference(trees, arch, mesh_name):
    """``build_cell(mesh=)``'s train cell under ``seqpar`` for the configs
    with Mamba, RWKV, cross or codebook layers: its rules, and its batch
    (the sequence over "model" where it divides), parameter and
    optimizer-state spec trees, equal the reference's ``rules_for`` /
    ``opt_rules`` over its own axes trees; a prefill case's batch specs
    too (the tokens' sequence over "model", a vision config's embeddings
    not: they are not the residual stream)."""
    cfg, cfg_j, model, p_axes_j, _ = trees[arch]
    mesh = _Mesh(*MESHES[mesh_name])
    lay = SH.Layout(mesh.shape, {"data": 0, "model": 0}, SH.ShardingRules())
    _, _, _, rules, ins, _ = ST.build_cell(cfg, SHAPES["train_4k"], "meta",
                                           "seqpar", mesh=lay)
    rules_j = JS.rules_for(cfg_j, jax_get_shape("train_4k"), mesh, "seqpar")
    assert dict(rules.rules) == dict(rules_j.rules)
    assert rules.rules["seq"] == ("model",)
    params = T.param_tree(model)
    assert _specs(ins["params"]) == _ref(mesh, p_axes_j, _shapes(params),
                                         rules_j)
    named = dict(model.named_parameters())
    o_shapes = _shapes(OPT.state_to_tree(OPT.init(named, cfg.optimizer),
                                         cfg.optimizer))
    o_axes_j = JOPT.state_axes(params, p_axes_j, cfg_j.optimizer)
    assert _specs(OPT.state_to_tree(ins["opt_state"], cfg.optimizer)) == \
        _ref(mesh, o_axes_j, o_shapes, JS.opt_rules(rules_j))
    for shape in ("train_4k", "prefill_32k"):
        case = SHAPES[shape]
        rules = ST.rules_for(cfg, case, mesh, "seqpar")
        rules_j = JS.rules_for(cfg_j, jax_get_shape(shape), mesh, "seqpar")
        batch = ST.abstract_batch(cfg, case)
        got = _specs(ST.shardings_of(mesh, ST.batch_axes(cfg, case.kind),
                                     batch, rules))
        assert got == _ref(mesh, JS.batch_axes(cfg_j, case.kind),
                           _shapes(batch), rules_j), shape
        assert got["['tokens']"][1] == "model", shape


@pytest.mark.parametrize("variant,item", [("expdata", "A9c item 1"),
                                          ("seqpar", "A9c item 4")])
def test_waiting_sharding_variants_raise_on_a_mesh(variant, item):
    """The sharding variants of ROADMAP A9c on a mesh. ``expdata`` (item
    1, done) builds on a mesh for a dense and a MoE config, granite's
    experts over ("data", "model"), and nothing of the port waits on an
    item any more. ``seqpar`` (items 4 and 4b, done) builds qwen2's and
    rwkv6's train cells with the residual stream's sequence over "model"
    (the tokens' spec) at the baseline's shapes."""
    mesh = _Mesh(2, 2)
    lay = SH.Layout(mesh.shape, {"data": 1, "model": 0}, SH.ShardingRules())
    cfg = get_config("qwen2-1.5b")
    if variant == "expdata":
        assert ST.apply_variant_config(cfg, variant, mesh) == cfg
        ST.build_cell(cfg, SHAPES["train_4k"], "meta", variant, mesh=lay)
        _, kw, _, rules, ins, _ = ST.build_cell(
            get_config("granite-moe-1b-a400m"), SHAPES["train_4k"], "meta",
            variant, mesh=lay)
        assert rules.rules["experts"] == ("data", "model")
        assert ins["params"]["g0"][0]["mlp"]["w_gate"] == (
            None, ("data", "model"), None, None)
        assert kw["params"].g0[0].mlp["w_gate"].shape == (24, 8, 1024, 512)
        assert (kw["params"].tp.e0, kw["params"].tp.el) == (16, 8)
        assert not hasattr(T, "A9C_SEQPAR")       # nothing waits
        return
    assert ST.apply_variant_config(cfg, variant, mesh) == cfg
    _, kw, _, rules, ins, _ = ST.build_cell(cfg, SHAPES["train_4k"], "meta",
                                            variant, mesh=lay)
    assert rules.rules["seq"] == ("model",)
    assert ins["batch"]["tokens"] == ("data", "model")
    assert kw["params"].g0[0].mixer["wq"].shape == (28, 1536, 6, 128)
    assert kw["params"].g0[0].norm1.shape == (28, 1536)
    assert kw["params"].seq_plan(256, 4096).sp == "model"
    rwkv = get_config("rwkv6-1.6b")           # item 4b, done
    assert ST.apply_variant_config(rwkv, variant, mesh) == rwkv
    _, kw, _, rules, ins, _ = ST.build_cell(rwkv, SHAPES["train_4k"], "meta",
                                            variant, mesh=lay)
    assert ins["batch"]["tokens"] == ("data", "model")
    assert kw["params"].seq_plan(256, 4096).sp == "model"


def test_resolver_cases_as_the_reference():
    """tests/test_sharding_dryrun.py's resolver cases on both packages."""
    sizes = {"pod": 2, "data": 16, "model": 16}
    for axes, shape in [(("heads",), (12,)), (("heads",), (32,)),
                        (("batch",), (8,)), (("batch",), (64,)),
                        (("experts", "model_d", "ff"), (16, 128, 16)),
                        (("batch", "kv_seq", "kv_heads", None),
                         (1, 524288, 16, 128))]:
        for over in ({}, {"kv_seq": ("pod", "data", "model"),
                          "kv_heads": ()}):
            rules = SH.ShardingRules().with_overrides(**over)
            rules_j = JSH.ShardingRules().with_overrides(**over)
            assert SH._resolve(sizes, axes, shape, rules) == tuple(
                JSH._resolve(sizes, axes, shape, rules_j))
    assert SH.DEFAULT_RULES == JSH.DEFAULT_RULES


def test_local_shard_and_placements():
    """Every card's ``local_shard`` tiles the tensor in the reference's
    order (a dim over ("data", "model") row-major), ``Layout`` cuts the
    same slices, and ``placements`` names each mesh dim's tensor dim."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = _Mesh(2, 2)
    x = torch.arange(8 * 6 * 4).reshape(8, 6, 4)
    for spec in [(("data", "model"), None, None), ("model", None, "data"),
                 (None, "model", None), (None, None, None)]:
        pieces = {}
        for d in range(2):
            for m in range(2):
                coords = {"data": d, "model": m}
                part = SH.local_shard(x, mesh, spec, coords)
                lay = SH.Layout(mesh.shape, coords, SH.ShardingRules())
                starts = [SH.shard_range(e, n, mesh.shape, coords)[0]
                          for e, n in zip(spec, x.shape)]
                pieces[tuple(starts)] = part
                assert part.shape == tuple(
                    n // lay.size(e) for e, n in zip(spec, x.shape))
        rebuilt = torch.zeros_like(x)
        for starts, part in pieces.items():
            rebuilt[tuple(slice(s, s + n) for s, n in
                          zip(starts, part.shape))] = part
        assert torch.equal(rebuilt, x), spec
    flat = SH.local_shard(x, mesh, (("data", "model"), None, None),
                          {"data": 1, "model": 0})
    assert torch.equal(flat, x[4:6])
    assert SH.placements(mesh, ("model", None, "data")) == (Shard(2),
                                                           Shard(0))
    assert SH.placements(mesh, (None, None)) == (Replicate(), Replicate())
    assert SH.placements(mesh, (("data", "model"),)) == (Shard(0), Shard(0))
    lay = SH.Layout({"data": 1, "model": 4}, {"data": 0, "model": 3},
                    ST.rules_for(get_config("qwen2-1.5b"),
                                 SHAPES["decode_32k"], _Mesh(1, 4)))
    w = torch.arange(1536 * 12 * 2).reshape(1536, 12, 2)
    assert torch.equal(lay.local(w, ("model_d", "heads", "head_dim")),
                       w[:, 9:12])
    assert lay.local_shape(("batch", "kv_seq", "kv_heads", None),
                           (128, 32768, 2, 128)) == (128, 8192, 2, 128)


def test_meta_collectives_only_count():
    """On the meta device (FlopCounterMode's) a collective counts its link
    bytes and calls no process group; an axis of size 1 is none."""
    lay = SH.Layout({"data": 1, "model": 4}, {"data": 0, "model": 0},
                    SH.ShardingRules())
    SH.reset_collectives()
    x = torch.empty((8, 3, 128), device="meta")
    assert SH.all_reduce(x, lay, "model") is x
    assert SH.all_gather(x, lay, "model", dim=1).shape == (8, 12, 128)
    assert SH.gather_partials(x, lay, "model").shape == (4, 8, 3, 128)
    assert SH.all_reduce(x, lay, "data") is x
    c = SH.collectives()
    nbytes = 8 * 3 * 128 * 4
    assert c["calls"] == {"all-reduce": 1, "all-gather": 2}
    assert c["per_op"] == {"all-reduce": 2 * nbytes * 3 / 4,
                           "all-gather": 2 * 4 * nbytes * 3 / 4}
    assert c["count"] == 3 and c["total_bytes"] == sum(c["per_op"].values())


def test_sharded_cell_on_the_meta_device():
    """``build_cell`` on a mesh: rank 2's shards of qwen2 at decode_32k (the
    cache by sequence, batch 128 uncut: 8192 rows a card) and gemma2 (by
    kv heads); its spec trees; the train step's ZeRO-1 moments, and the
    step itself on the meta device (its collectives only counted, equal
    to ``train_step_collectives``); granite and kimi-k2 build (their
    experts over "model", kimi-k2's Adafactor factors sliced), Jamba and
    rwkv6 build (their channels, heads and states over "model"), vision
    and musicgen too (the cross cache at its vision tokens' rows, the
    codebook embedding over vocab); ``seqpar`` and ``fsdp+seqpar`` build
    qwen2's train cell, rwkv6's raising naming ROADMAP A9c item 4b."""
    lay = SH.Layout({"data": 1, "model": 4}, {"data": 0, "model": 2},
                    SH.ShardingRules())
    fn, kw, donate, rules, ins, outs = ST.build_cell(
        get_config("qwen2-1.5b"), SHAPES["decode_32k"], "meta", mesh=lay)
    k = kw["cache"]["g0"][0]["mixer"]["k"]
    assert k.shape == (28, 128, 8192, 2, 128)
    assert ins["cache"]["g0"][0]["mixer"]["k"] == (None, "data", "model",
                                                   None, None)
    assert kw["params"].g0[0].mixer["wq"].shape == (28, 1536, 3, 128)
    assert kw["params"].g0[0].mixer["wk"].shape == (28, 1536, 2, 128)
    assert outs[1] == ins["cache"] and donate == ("cache",)
    _, kw, *_ = ST.build_cell(get_config("gemma2-27b"), SHAPES["decode_32k"],
                              "meta", mesh=lay)
    assert kw["cache"]["g0"][0]["mixer"]["k"].shape == (23, 128, 32768, 4,
                                                        128)
    _, kw, *_ = ST.build_cell(get_config("gemma2-27b"), SHAPES["long_500k"],
                              "meta", mesh=lay)
    assert kw["cache"]["g0"][1]["mixer"]["k"].shape == (23, 1, 131072, 16,
                                                        128)
    lay22 = SH.Layout({"data": 2, "model": 2}, {"data": 1, "model": 0},
                      SH.ShardingRules())
    fn, kw, *_ = ST.build_cell(get_config("qwen2-1.5b"), SHAPES["train_4k"],
                               "meta", mesh=lay22)
    assert kw["params"].g0[0].mixer["wq"].shape == (28, 1536, 6, 128)
    assert kw["opt_state"]["m"]["g0.0.mixer.wq"].shape == (28, 768, 6, 128)
    assert kw["opt_state"]["v"]["embed"].shape == (75968, 768)
    cfg = get_config("qwen2-1.5b").reduced()
    for variant in ("baseline", "fsdp", "micro8+bf16grad"):
        fn, kw, *_ = ST.build_cell(cfg, ShapeCase("t", "train", 32, 8),
                                   "meta", variant, mesh=lay22)
        kw["opt_state"]["count"] = torch.zeros((), dtype=torch.int32,
                                               device="meta")
        SH.reset_collectives()
        fn(*kw.values())
        assert SH.collectives()["calls"] == ST.train_step_collectives(
            kw["params"], 8, 8 if "micro8" in variant else 4), variant
    # granite and kimi-k2 build (A9c item 1)
    _, kw, *_ = ST.build_cell(get_config("granite-moe-1b-a400m"),
                              SHAPES["decode_32k"], "meta", mesh=lay)
    assert kw["params"].g0[0].mlp["w_gate"].shape == (24, 8, 1024, 512)
    assert kw["cache"]["g0"][0]["mixer"]["k"].shape == (24, 128, 32768, 2,
                                                        64)
    _, kw, *_ = ST.build_cell(get_config("kimi-k2-1t-a32b"),
                              SHAPES["train_4k"], "meta", mesh=lay22)
    assert kw["params"].g1[0].mlp["w_down"].shape == (60, 192, 1024, 7168)
    assert kw["opt_state"]["fac"]["g1.0.mlp.w_down"]["vr"].shape == (
        60, 192, 1024)
    # Jamba and rwkv6 build (A9c item 2): Mamba's channels and in_proj's
    # paired columns, the states and RWKV's heads over "model"
    _, kw, *_ = ST.build_cell(get_config("jamba-1.5-large-398b"),
                              SHAPES["decode_32k"], "meta", mesh=lay)
    assert kw["params"].g0[0].mixer["in_proj"].shape == (9, 8192, 8192)
    assert kw["params"].g0[0].mixer["x_proj"].shape == (9, 4096, 544)
    assert kw["cache"]["g0"][0]["mixer"]["h"].shape == (9, 128, 4096, 16)
    assert kw["cache"]["g0"][0]["mixer"]["conv"].shape == (9, 128, 3, 4096)
    _, kw, *_ = ST.build_cell(get_config("jamba-1.5-large-398b"),
                              SHAPES["train_4k"], "meta", mesh=lay22)
    assert kw["opt_state"]["fac"]["g0.0.mixer.in_proj"]["vc"].shape == (
        9, 16384)
    _, kw, *_ = ST.build_cell(get_config("rwkv6-1.6b"), SHAPES["decode_32k"],
                              "meta", mesh=lay)
    assert kw["params"].g0[0].mixer["wr"].shape == (24, 2048, 512)
    assert kw["params"].g0[0].mixer["u"].shape == (24, 8, 64)
    assert kw["params"].g0[0].mixer["wk_c"].shape == (24, 2048, 1792)
    assert kw["cache"]["g0"][0]["mixer"]["wkv"].shape == (24, 128, 8, 64, 64)
    assert kw["cache"]["g0"][0]["mixer"]["shift_tm"].shape == (24, 128, 2048)
    _, kw, *_ = ST.build_cell(get_config("rwkv6-1.6b"), SHAPES["train_4k"],
                              "meta", mesh=lay22)
    assert kw["opt_state"]["m"]["g0.0.mixer.wr"].shape == (24, 1024, 1024)
    # vision and musicgen build (A9c item 3): the cross cache at its
    # n_vision_tokens rows beside the self cache's, the codebook embedding
    # cut over vocab per codebook
    _, kw, *_ = ST.build_cell(get_config("llama-3.2-vision-11b"),
                              SHAPES["decode_32k"], "meta", mesh=lay)
    assert kw["params"].g0[0].mixer["wq"].shape == (8, 4096, 8, 128)
    assert kw["params"].vision_proj.shape == (4096, 4096)
    assert kw["cache"]["g0"][0]["mixer"]["k"].shape == (8, 128, 1600, 2, 128)
    assert kw["cache"]["g0"][1]["mixer"]["k"].shape == (8, 128, 32768, 2,
                                                        128)
    _, kw, *_ = ST.build_cell(get_config("musicgen-large"),
                              SHAPES["decode_32k"], "meta", mesh=lay)
    assert kw["params"].embed.shape == (4, 512, 2048)
    assert kw["params"].lm_head.shape == (4, 2048, 512)
    assert kw["cache"]["g0"][0]["mixer"]["k"].shape == (48, 128, 32768, 8,
                                                        64)
    _, kw, *_ = ST.build_cell(get_config("qwen2-1.5b"), SHAPES["train_4k"],
                              "meta", "expdata", mesh=lay)
    assert kw["params"].g0[0].mixer["wq"].shape == (28, 1536, 3, 128)
    # seqpar (A9c item 4) builds qwen2's train cell, fsdp's D dim cut too,
    # and rwkv6's (item 4b)
    for variant, shape in (("seqpar", (28, 1536, 3, 128)),
                           ("fsdp+seqpar", (28, 1536, 3, 128))):
        _, kw, _, rules, ins, _ = ST.build_cell(
            get_config("qwen2-1.5b"), SHAPES["train_4k"], "meta", variant,
            mesh=lay)
        assert rules.rules["seq"] == ("model",)
        assert ins["batch"]["tokens"] == ("data", "model")
        assert kw["params"].g0[0].mixer["wq"].shape == shape
        assert kw["params"].g0[0].mlp["w_up"].shape == (28, 1536, 2240)
        _, kw, _, rules, ins, _ = ST.build_cell(
            get_config("rwkv6-1.6b"), SHAPES["train_4k"], "meta", variant,
            mesh=lay)
        assert rules.rules["seq"] == ("model",)
        assert ins["batch"]["tokens"] == ("data", "model")
        assert kw["params"].g0[0].mixer["wr"].shape == (24, 2048, 512)


def test_import_creates_no_process_group():
    code = ("import torch.distributed as dist\n"
            "import repro_torch.distributed.sharding, repro_torch.launch.mesh\n"
            "from repro_torch.launch.mesh import make_mesh\n"
            "assert not dist.is_initialized()\n"
            "try:\n"
            "    make_mesh(4)\n"
            "except RuntimeError as e:\n"
            "    assert 'process group' in str(e)\n"
            "else:\n"
            "    raise AssertionError('make_mesh without a process group')\n"
            "assert not dist.is_initialized()\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env={"PYTHONPATH": str(SRC),
                                          "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr

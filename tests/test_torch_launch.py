"""The port's launch layer (repro_torch.launch.steps, launch.dryrun) against
the JAX package's (repro.launch.steps) on the CPU, at reduced configs.

The prefill and decode steps run on shared numpy weights (the plain path
on the CPU), also at kimi-k2's head dim 112, fp32 within 2e-5
(tests/test_kernels.py::_tol); ``build_cell``'s abstract inputs equal the
reference's ShapeDtypeStructs leaf for leaf (the reference's ``build_cell``
runs on the CPU, its ``lower_cell`` does not: ROADMAP C-ref-1);
``run_cell`` writes prefill and train records with exact operation counts;
the variants that only change sharding raise on one card.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.shapes import get_shape as jax_get_shape
from repro.launch import steps as JS
from repro.launch.mesh import make_local_mesh
from repro.models import transformer as JT
from repro_torch.configs import get_config
from repro_torch.configs.shapes import ShapeCase, get_shape
from repro_torch.launch import dryrun
from repro_torch.launch import steps as ST
from repro_torch.models import transformer as T
from repro_torch.training import optimizer as OPT
from repro_torch.tree import flatten, keystr
from test_torch_model import (_check_routes, _numpy_params,  # noqa: F401
                              _reduced, router_margins)

TOL = 2e-5
CPU_SEQ = 64     # the CPU records' length (one attention block)
# the head dim of kimi-k2, which the reduced configs set to 16
STEP_CASES = [("qwen2-1.5b", None), ("kimi-k2-1t-a32b", 112)]


def _both(arch, head_dim):
    """Reduced configs of both packages (``head_dim`` replaced where
    given), shared numpy weights, the JAX params and the port's model."""
    cfg_j, cfg_t = _reduced(jax_get_config(arch)), _reduced(get_config(arch))
    if head_dim:
        cfg_j = dataclasses.replace(cfg_j, head_dim=head_dim)
        cfg_t = dataclasses.replace(cfg_t, head_dim=head_dim)
    np_params = _numpy_params(cfg_j, 4)
    return (cfg_j, cfg_t, jax.tree.map(jnp.asarray, np_params),
            T.from_jax_params(cfg_t, np_params, device="cpu"))


def _err(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


@pytest.mark.parametrize("arch,head_dim", STEP_CASES)
def test_prefill_and_decode_steps_match_jax(arch, head_dim, router_margins):
    """``build_prefill_step`` on two prompts, each inserted into a slot
    cache, then two committed steps of ``build_decode_step``: logits and
    every cache leaf against the reference's steps (jitted)."""
    cfg_j, cfg_t, params_j, model = _both(arch, head_dim)
    j_prefill = jax.jit(JS.build_prefill_step(cfg_j))
    j_decode = jax.jit(JS.build_decode_step(cfg_j))
    prefill, decode = ST.build_prefill_step(cfg_t), ST.build_decode_step(
        cfg_t)
    rng = np.random.default_rng(5)
    lens, max_seq = [12, 7], 16
    cache_j, _ = JT.init_cache(cfg_j, 2, max_seq)
    cache_t = T.init_cache(cfg_t, 2, max_seq, device="cpu")
    for slot, L in enumerate(lens):
        tokens = rng.integers(0, cfg_j.vocab_size, size=(1, max(lens)))
        lj, pf_j = j_prefill(params_j, {"tokens": jnp.asarray(tokens)})
        lt, pf_t = prefill(model, {"tokens": torch.from_numpy(tokens)})
        _check_routes(cfg_t, router_margins)
        assert _err(lt, lj) < TOL
        cache_j = JT.cache_insert(cfg_j, cache_j, pf_j, slot, L)
        T.cache_insert(cfg_t, cache_t, pf_t, slot, L)
    lengths = np.asarray(lens)
    for _ in range(2):
        toks = rng.integers(0, cfg_j.vocab_size, size=2)
        lj, cache_j = j_decode(params_j, cache_j, jnp.asarray(toks, jnp.int32),
                               jnp.asarray(lengths, jnp.int32))
        lt, cache_t = decode(model, cache_t, torch.from_numpy(toks),
                             torch.from_numpy(lengths))
        _check_routes(cfg_t, router_margins)
        assert _err(lt, lj) < TOL
        lengths = lengths + 1
    for gi in range(len(cfg_t.groups)):
        for li, layer in enumerate(cache_t[f"g{gi}"]):
            for name, leaf in layer["mixer"].items():
                assert _err(leaf, cache_j[f"g{gi}"][li]["mixer"][name]) \
                    < TOL, (gi, li, name)


def _jax_leaves(tree) -> dict:
    return {jax.tree_util.keystr(path): (tuple(leaf.shape), leaf.dtype.name)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def _port_leaves(tree) -> dict:
    return {keystr(path): (tuple(t.shape), str(t.dtype).split(".")[-1])
            for path, t in flatten(tree)}


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "musicgen-large",
                                  "llama-3.2-vision-11b"])
def test_build_cell_abstract_inputs_match_reference(arch, shape):
    """Every input of the cell, named as the reference names it, with the
    shape and dtype of every leaf the reference's ShapeDtypeStructs give
    (params in the JAX structure, the optimizer state through
    ``state_to_tree``), all on the meta device, and the same donations."""
    cfg_j, cfg_t = jax_get_config(arch).reduced(), get_config(arch).reduced()
    _, kw_j, _, _, donate_j, _ = JS.build_cell(cfg_j, jax_get_shape(shape),
                                               make_local_mesh())
    _, kw_t, donate_t = ST.build_cell(cfg_t, get_shape(shape), "cpu")
    assert list(kw_t) == list(kw_j) and donate_t == donate_j
    ports = dict(kw_t, params=T.param_tree(kw_t["params"]))
    if "opt_state" in ports:
        ports["opt_state"] = OPT.state_to_tree(ports["opt_state"],
                                               cfg_t.optimizer)
    for name, tree in ports.items():
        assert all(t.device.type == "meta" for _, t in flatten(tree)), name
        assert _port_leaves(tree) == _jax_leaves(kw_j[name]), name


# ---------------------------------------------------------------------------
# run_cell: prefill and train records on the CPU
# ---------------------------------------------------------------------------
def _matmul_params(cfg, names):
    model = T.Transformer(cfg, device="meta")
    return sum(p.numel() for name, p in model.named_parameters()
               if name.rsplit(".", 1)[-1] in names)


LAYER_MATMULS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    return {shape: dryrun.run_cell("qwen2-1.5b", shape, out, device="cpu",
                                   reduced=True, seq_len=CPU_SEQ)
            for shape in ("prefill_32k", "train_4k")}, out


def test_run_cell_prefill_and_train_records(records):
    recs, out = records
    for shape, rec in recs.items():
        for key in ("arch", "shape", "kind", "seq_len", "global_batch",
                    "n_params", "ok", "devices", "mesh", "flops", "flops_tc",
                    "flops_source", "bytes_accessed", "bytes_tc",
                    "bytes_source", "bytes_by_part", "reduced",
                    "reduced_why", "not_measured"):
            assert key in rec, (shape, key)
        assert rec["ok"] is True and rec["devices"] == 1
        assert "step_ms" not in rec and "CPU" in rec["not_measured"]
        assert rec["bytes_accessed"] == sum(rec["bytes_by_part"].values()) \
            >= rec["n_params"] * 4                       # fp32 weights
        written = json.loads(
            (out / f"qwen2-1.5b__{shape}__single_card.json").read_text())
        assert written == json.loads(json.dumps(rec, default=str))
    pre, tr = recs["prefill_32k"], recs["train_4k"]
    assert pre["global_batch"] == 32                 # no card: no cut
    assert pre["reduced"] == {"seq_len": [32768, CPU_SEQ]}
    assert pre["prefill_steps"] == 1
    assert tr["reduced"] == {"seq_len": [4096, CPU_SEQ],
                             "global_batch": [256, dryrun.TRAIN_BATCH]}
    assert tr["reduced_why"]["global_batch"] == dryrun.TRAIN_CUT
    assert (tr["optimizer"], tr["n_micro"], tr["train_steps"]) == \
        ("adamw", 4, 1)
    assert np.isfinite(tr["losses"]).all() and len(tr["losses"]) == 1


def test_run_cell_prefill_and_train_flops_match_analytic_count(records):
    """FlopCounterMode over the plain steps equals, exactly: prefill, 2 x
    the matmul parameters x tokens (the tied unembed included) + per
    attention layer 4 H Dh S^2 a sequence (every block, masked ones too);
    train, per layer 2 P T forward + 2 (P - P_down) T for the remat
    recompute (torch.utils.checkpoint stops after the last saved tensor,
    before each layer's down projection) + 4 P T backward, the unembed
    6 P T, and per attention layer 18 H Dh S^2 a sequence (forward 4,
    recompute 4, backward 10: the scores again, dV, dP, dQ, dK); at S = 64
    the trainable attention is one block."""
    recs, _ = records
    cfg = get_config("qwen2-1.5b").reduced()
    layer = _matmul_params(cfg, LAYER_MATMULS)
    down = _matmul_params(cfg, ("w_down",))
    unembed = T._padded_vocab(cfg) * cfg.d_model
    H, Dh, S = cfg.n_heads, cfg.head_dim, CPU_SEQ
    n_attn = sum(spec.kind == "attn" for spec in cfg.layer_specs())
    pre, tr = recs["prefill_32k"], recs["train_4k"]
    tokens = pre["global_batch"] * S
    assert pre["flops"] == pre["flops_tc"] == \
        2 * (layer + unembed) * tokens \
        + n_attn * pre["global_batch"] * 4 * H * Dh * S * S
    tokens = tr["global_batch"] * S
    assert tr["flops"] == tr["flops_tc"] == \
        (2 * layer + 2 * (layer - down) + 4 * layer) * tokens \
        + 6 * unembed * tokens \
        + n_attn * tr["global_batch"] * 18 * H * Dh * S * S


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m",
                                  "llama-3.2-vision-11b"])
def test_train_flops_of_one_microbatch_equal_the_whole_step(arch):
    """count_flops takes one microbatch's value_and_grad n_micro times: the
    same count as FlopCounterMode over the whole train step (MoE routing,
    vision embeddings, the clip and the optimizer included)."""
    from torch.utils.flop_counter import FlopCounterMode
    cfg = get_config(arch).reduced()
    case = ShapeCase("train_4k", "train", 32, 8)
    fn, kwargs, _ = ST.build_cell(cfg, case, "cpu", impl="plain")
    with FlopCounterMode(display=False) as counter:
        fn(*kwargs.values())
    assert dryrun.count_flops(cfg, case) == counter.get_total_flops() > 0


def test_prefill_flops_do_not_depend_on_attention_blocks():
    """The plain prefill's count with one block a call (``_whole_blocks``)
    equals its count at its own blocks, over several blocks of a window
    config (gemma2's local layers)."""
    from torch.utils.flop_counter import FlopCounterMode
    cfg = get_config("gemma2-27b").reduced()
    case = ShapeCase("prefill_32k", "prefill", 1100, 1)
    fn, kwargs, _ = ST.build_cell(cfg, case, "cpu", impl="plain")
    with FlopCounterMode(display=False) as counter:
        fn(*kwargs.values())
    assert dryrun.count_flops(cfg, case) == counter.get_total_flops()


# ---------------------------------------------------------------------------
# variants
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("variant", ["seqpar", "expdata", "fsdp",
                                     "vocabpad+fsdp"])
def test_sharding_variants_raise_on_one_card(variant, tmp_path):
    cfg = get_config("qwen2-1.5b").reduced()
    with pytest.raises(NotImplementedError, match="multi-card slice"):
        ST.apply_variant_config(cfg, variant)
    with pytest.raises(NotImplementedError, match="multi-card slice"):
        ST.build_cell(cfg, get_shape("train_4k"), "cpu", variant)
    with pytest.raises(NotImplementedError, match="multi-card slice"):
        dryrun.run_cell("qwen2-1.5b", "decode_32k", tmp_path, device="cpu",
                        reduced=True, seq_len=CPU_SEQ, variant=variant)
    assert not list(tmp_path.iterdir())


def test_config_variants_match_reference():
    """vocabpad and blockdispatch change the config as the reference's;
    micro8 and bf16grad choose the train record's n_micro and grad dtype;
    the default steps decode in committed mode, cacheappend in append
    mode."""
    for arch in ("qwen2-1.5b", "granite-moe-1b-a400m"):
        for variant in ("baseline", "vocabpad", "blockdispatch",
                        "vocabpad+blockdispatch+micro8"):
            got = ST.apply_variant_config(get_config(arch), variant)
            want = JS.apply_variant_config(jax_get_config(arch), variant)
            assert (got.vocab_pad_to, got.moe_block_dispatch) == \
                (want.vocab_pad_to, want.moe_block_dispatch), variant
    assert ST.variant_tokens("baseline+micro8") == \
        JS.variant_tokens("baseline+micro8") == {"micro8"}
    cfg = get_config("qwen2-1.5b").reduced()
    with pytest.raises(ValueError, match="unknown variant"):
        ST.apply_variant_config(cfg, "decodefast")


def test_run_cell_train_variants(tmp_path):
    rec = dryrun.run_cell("qwen2-1.5b", "train_4k", tmp_path, device="cpu",
                          reduced=True, seq_len=16,
                          variant="micro8+bf16grad")
    assert (rec["n_micro"], rec["grad_dtype"]) == (8, "bfloat16")
    assert rec["variant"] == "micro8+bf16grad" and rec["ok"] is True
    rec = dryrun.run_cell("qwen2-1.5b", "decode_32k", tmp_path,
                          device="cpu", reduced=True, seq_len=16)
    assert rec["variant"] == "cacheappend" and rec["decode_mode"] == "append"


def test_run_cell_depth_cut(tmp_path):
    """``run_cell(..., layers=)`` records the first layers only (the cut
    under ``reduced``); ``cut_depth`` keeps whole periods, then part of
    one (Jamba's first 25: three periods of 8 and one Mamba layer)."""
    rec = dryrun.run_cell("qwen2-1.5b", "decode_32k", tmp_path,
                          device="cpu", reduced=True, seq_len=16, layers=1)
    cfg = dryrun.cut_depth(get_config("qwen2-1.5b").reduced(), 1)
    assert rec["ok"] is True and rec["reduced"]["n_layers"] == [2, 1]
    assert rec["n_params"] == cfg.param_count()
    full = get_config("jamba-1.5-large-398b")
    jamba = dryrun.cut_depth(full, 25)
    (period, rep), = full.groups
    assert jamba.groups == ((period, 3), (period[:1], 1))
    assert jamba.n_layers == 25


def test_decode_step_modes():
    """build_decode_step's append mode (variant cacheappend) gives the
    committed step's logits and cache, fp32 within 1e-5 (the two compute
    the new token's K/V in differently batched products)."""
    cfg = get_config("qwen2-1.5b").reduced()
    model = T.Transformer(cfg, device="cpu")
    case = ShapeCase("decode_32k", "decode", 16, 2)
    caches = [T.init_cache(cfg, 2, 16, device="cpu") for _ in range(2)]
    for c in caches:
        for leaf in torch.utils._pytree.tree_leaves(c):
            leaf.normal_(generator=torch.Generator().manual_seed(0))
    tokens, lengths = torch.tensor([3, 5]), torch.tensor([4, 9])
    outs = []
    for variant, cache in zip(("baseline", "cacheappend"), caches):
        fn, _, donate = ST.build_cell(cfg, case, "cpu", variant)
        outs.append(fn(model, cache, tokens, lengths)[0])
        assert donate == ("cache",)
    assert _err(outs[0], outs[1]) < 1e-5
    for a, b in zip(torch.utils._pytree.tree_leaves(caches[0]),
                    torch.utils._pytree.tree_leaves(caches[1])):
        assert _err(a, b) < 1e-5

"""The port's checkpointer (repro_torch.checkpoint) and the train loop's
fault tolerance, on the CPU: the Checkpointer's own properties (round trip,
partial directories ignored, keep-k, async save, dtype cast on restore),
the on-disk layout shared with the JAX package (a JAX-written checkpoint
restores into the port and a port-written one into JAX, bf16 included),
and resume-after-failure losses equal bit for bit to an uninterrupted run.
"""
import functools
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpoint import Checkpointer as JCheckpointer
from repro.configs import get_config as jax_get_config
from repro.training import optimizer as JOPT
from repro_torch.checkpoint.checkpoint import Checkpointer
from repro_torch.tree import keystr, named, nest, path_of
from repro_torch.configs import get_config
from repro_torch.models import transformer as T
from repro_torch.training import optimizer as OPT
from repro_torch.training.train_loop import TrainConfig, train
from test_torch_model import _numpy_params, _reduced


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn(8, 16, generator=g),
            "nested": {"b": torch.randn(4, generator=g),
                       "c": torch.arange(10, dtype=torch.int32)},
            "pair": (torch.randn(3, generator=g).to(torch.bfloat16),
                     torch.tensor(3.5)),
            "scalar": torch.tensor(7, dtype=torch.int64)}


def _equal(a, b):
    fa, fb = named(a), named(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert fa[k].dtype == fb[k].dtype, k
        assert torch.equal(fa[k], fb[k]), k


def test_roundtrip(tmp_path):
    ck = Checkpointer(tmp_path)
    tree = _tree()
    ck.save(5, tree)
    out = ck.restore(5, _tree(1))
    _equal(out, tree)
    assert isinstance(out["pair"], tuple)
    manifest = json.loads((tmp_path / "step_5" / "manifest.json").read_text())
    assert manifest["keys"]["['pair'][0]"]["dtype"] == "bfloat16"
    assert manifest["keys"]["['nested']['c']"]["dtype"] == "int32"


def test_uncommitted_checkpoint_ignored(tmp_path):
    ck = Checkpointer(tmp_path)
    ck.save(1, _tree())
    bad = tmp_path / "step_2"          # a crash mid-save: no marker
    bad.mkdir()
    (bad / "manifest.json").write_text("{}")
    assert ck.latest_step() == 1
    with pytest.raises(FileNotFoundError):
        ck.restore(2, _tree())


def test_gc_keeps_last_k(tmp_path):
    ck = Checkpointer(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, _tree(s))
    assert ck.all_steps() == [3, 4]
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_3", "step_4"]


def test_async_save(tmp_path):
    ck = Checkpointer(tmp_path, async_save=True)
    tree = _tree(1)
    ck.save(7, tree)
    tree["a"].zero_()         # the host copy was taken at save
    ck.wait()
    assert ck.latest_step() == 7
    assert float(ck.restore(7, _tree())["a"].abs().sum()) > 0
    ck.close()


def test_dtype_cast_on_restore(tmp_path):
    ck = Checkpointer(tmp_path)
    ck.save(1, {"w": torch.full((4, 4), 1.5), "h": torch.full((2,), 0.25,
                                                              dtype=torch
                                                              .bfloat16)})
    out = ck.restore(1, {"w": torch.empty(4, 4, dtype=torch.bfloat16),
                         "h": torch.empty(2)})
    assert out["w"].dtype == torch.bfloat16 and out["h"].dtype == torch.float32
    assert torch.equal(out["w"], torch.full((4, 4), 1.5, dtype=torch.bfloat16))
    assert torch.equal(out["h"], torch.full((2,), 0.25))


def test_names_map_to_jax_keystrs():
    params = _numpy_params(jax_get_config("granite-moe-1b-a400m").reduced(),
                           0)
    keys_j = {jax.tree_util.keystr(p) for p, _ in
              jax.tree_util.tree_leaves_with_path(params)}
    model = T.Transformer(get_config("granite-moe-1b-a400m").reduced(),
                          device="meta")
    names = [n for n, _ in model.named_parameters()]
    assert {keystr(path_of(n)) for n in names} == keys_j
    assert set(named(nest(dict.fromkeys(names, 0)))) == set(names)


# ---------------------------------------------------------------------------
# Across the two packages
# ---------------------------------------------------------------------------
def _jax_state(cfg_j, kind, seed):
    """Reduced qwen2's numpy weights and a JAX optimizer state after one
    update (moments non-zero)."""
    params = jax.tree.map(jnp.asarray, _numpy_params(cfg_j, seed))
    state = JOPT.init(params, kind)
    grads = jax.tree.map(lambda p: jnp.sin(p * 3.0), params)
    update = jax.jit(functools.partial(JOPT.update, kind=kind, lr=1e-3))
    params, state = update(params, grads, state)
    return params, state


def _both_ways(tmp_path, cfg_j, cfg, kind, seed):
    """A JAX checkpoint of ``cfg_j``'s weights and optimizer state (after
    one update) restores into the port bit for bit, and the port's save of
    it restores into JAX's structure bit for bit."""
    params_j, state_j = _jax_state(cfg_j, kind, seed)
    JCheckpointer(tmp_path / "jax").save(3, {"params": params_j,
                                             "opt": state_j})
    model = T.Transformer(cfg, device="cpu")
    opt = OPT.init(dict(model.named_parameters()), kind)
    like = {"params": T.param_tree(model), "opt": OPT.state_to_tree(opt,
                                                                    kind)}
    out = Checkpointer(tmp_path / "jax").restore(3, like)
    want = named(jax.tree.map(np.asarray, {"params": params_j,
                                           "opt": state_j}))
    got = named(out)
    assert got.keys() == want.keys()
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
    # and back: the port writes, JAX restores into its own structure
    state = OPT.state_from_tree(out["opt"], kind)
    Checkpointer(tmp_path / "port").save(4, {"params": out["params"],
                                             "opt": OPT.state_to_tree(
                                                 state, kind)})
    like_j = jax.eval_shape(lambda: {"params": params_j, "opt": state_j})
    back = JCheckpointer(tmp_path / "port").restore(4, like_j)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(
            {"params": params_j, "opt": state_j})):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    return got


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_jax_checkpoint_restores_into_port_and_back(tmp_path, kind):
    _both_ways(tmp_path, jax_get_config("qwen2-1.5b").reduced(),
               get_config("qwen2-1.5b").reduced(), kind, 1)


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "musicgen-large",
                                  "rwkv6-1.6b", "jamba-1.5-large-398b"])
def test_checkpoints_both_ways_modality_and_recurrent(tmp_path, arch):
    """The leaves training these configs adds: the vision projection (D,
    D), the codebook embed (C, V, D) and head (C, D, V), and the Mamba and
    RWKV leaves stacked with their layer dim (Jamba: its first 4 layers,
    Mamba, MoE and attention), each with its config's optimizer state."""
    cfg = _reduced(get_config(arch))
    got = _both_ways(tmp_path, _reduced(jax_get_config(arch)), cfg,
                     cfg.optimizer, 2)
    C, D, V = cfg.n_codebooks, cfg.d_model, cfg.vocab_size
    leaves = {"llama-3.2-vision-11b": {"vision_proj": (D, D)},
              "musicgen-large": {"embed": (C, V, D), "lm_head": (C, D, V)},
              "rwkv6-1.6b": {"g0.0.mixer.u": (2, cfg.rwkv_heads,
                                              cfg.rwkv_head_dim)},
              "jamba-1.5-large-398b": {"g0.0.mixer.A_log": (
                  1, cfg.d_inner, cfg.mamba_d_state)}}[arch]
    for name, shape in leaves.items():
        assert tuple(got[f"params.{name}"].shape) == shape, name


def test_bf16_on_disk_as_jax_writes_it(tmp_path):
    """JAX writes a bf16 array's raw 2-byte values under dtype "bfloat16";
    the port writes the same bytes, and reads JAX's back as bf16."""
    vals = np.array([1.0, -2.5, 3.140625, 1e-3, 65280.0], np.float32)
    JCheckpointer(tmp_path / "jax").save(1, {"w": jnp.asarray(
        vals, jnp.bfloat16)})
    Checkpointer(tmp_path / "port").save(1, {"w": torch.from_numpy(
        vals).to(torch.bfloat16)})
    files = {}
    for side in ("jax", "port"):
        d = tmp_path / side / "step_1"
        files[side] = (json.loads((d / "manifest.json").read_text()),
                       np.load(d / "shard_0.npz")["['w']"])
    assert files["jax"][0] == files["port"][0]
    assert files["jax"][1].dtype == files["port"][1].dtype
    assert files["jax"][1].tobytes() == files["port"][1].tobytes()
    got = Checkpointer(tmp_path / "jax").restore(1, {"w": torch.empty(
        5, dtype=torch.bfloat16)})["w"]
    assert torch.equal(got, torch.from_numpy(vals).to(torch.bfloat16))


# ---------------------------------------------------------------------------
# The train loop's fault tolerance
# ---------------------------------------------------------------------------
def test_train_resume_bitwise(tmp_path):
    """Mirrors tests/test_checkpoint_training.py::test_train_resume_bitwise
    (12 steps, a checkpoint every 5, a failure at step 8), with the losses
    after the resume equal bit for bit, not rounded."""
    cfg = get_config("qwen2-1.5b").reduced()
    tc = TrainConfig(steps=12, global_batch=4, seq_len=16,
                     ckpt_dir=str(tmp_path), ckpt_every=5, log_every=100,
                     ckpt_async=False)
    out1 = train(cfg, tc, device="cpu", log_fn=lambda s: None)
    shutil.rmtree(tmp_path)
    tmp_path.mkdir()
    with pytest.raises(RuntimeError, match="injected failure at step 8"):
        train(cfg, tc, fail_at_step=8, device="cpu", log_fn=lambda s: None)
    assert Checkpointer(tmp_path).all_steps() == [5]
    logs = []
    out2 = train(cfg, tc, device="cpu", log_fn=logs.append)
    assert out2["resumed_from"] == 5
    assert logs == ["[train] resumed from step 5"]
    assert out2["losses"] == out1["losses"][5:]
    for (_, a), (_, b) in zip(out1["model"].named_parameters(),
                              out2["model"].named_parameters()):
        assert torch.equal(a, b)
    assert Checkpointer(tmp_path).all_steps() == [5, 10, 12]


def test_train_resume_recurrent(tmp_path):
    """The same for reduced rwkv6, whose layers train through the WKV6
    scan: 6 steps, a checkpoint every 3, a failure at step 4; the resumed
    losses equal the uninterrupted run's bit for bit."""
    cfg = get_config("rwkv6-1.6b").reduced()
    tc = TrainConfig(steps=6, global_batch=2, seq_len=16,
                     ckpt_dir=str(tmp_path), ckpt_every=3, log_every=100,
                     ckpt_async=False)
    out1 = train(cfg, tc, device="cpu", log_fn=lambda s: None)
    shutil.rmtree(tmp_path)
    tmp_path.mkdir()
    with pytest.raises(RuntimeError, match="injected failure at step 4"):
        train(cfg, tc, fail_at_step=4, device="cpu", log_fn=lambda s: None)
    out2 = train(cfg, tc, device="cpu", log_fn=lambda s: None)
    assert out2["resumed_from"] == 3
    assert out2["losses"] == out1["losses"][3:]
    assert all(np.isfinite(out1["losses"]))

"""Checkpointing with atomic commit (port of
``repro/checkpoint/checkpoint.py``), on the reference's on-disk layout:

    <dir>/step_<N>/
        manifest.json       step, shard count, per key: shard, shape, dtype
        shard_<k>.npz       leaf arrays keyed by the JAX keystr of their
                            path, e.g. "['params']['g0'][0]['mixer']['wq']"
        _COMMITTED          written last

So a checkpoint the JAX package wrote restores here and one written here
restores there. Trees are nested dicts (keys sorted, as JAX flattens them)
and tuples or lists of tensors or arrays. The port's flat parameter names
(``g0.0.mixer.wq``) map to that structure and to keystrs in
``repro_torch.tree``.

A bfloat16 tensor goes to disk the way the JAX package writes one: its raw
2-byte values (numpy dtype ``V2``) under manifest dtype ``"bfloat16"``;
restore reads them back as bfloat16. Fault tolerance as in the reference:
a crash mid-save leaves the last committed step intact (temporary
directory, ``os.replace``, the marker written last), ``latest_step``
ignores partial directories, ``keep`` bounds the committed steps kept, and
with ``async_save`` the host copy is taken at ``save`` and the write runs
on a thread, ``wait()`` being the barrier. ``restore`` casts each leaf to
the dtype of its ``like`` leaf and puts it on that leaf's device.

Across meshes (the reference's restore-time resharding): a save from a
mesh (``save(..., shardings=, mesh=)``, every rank calling it with its
shards and the spec tree, e.g. ``build_cell``'s) gathers each leaf whole
and writes it once, from rank 0; ``restore(..., shardings=, mesh=)`` reads
whole leaves and returns this card's shard of each under the spec tree on
that mesh, which may differ from the one the checkpoint was written on (or
be none: one process restores the whole leaves).
"""
from __future__ import annotations

import concurrent.futures as cf
import json
import os
import shutil
import tempfile
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.distributed import sharding as SH
from repro_torch.tree import Path_, flatten, keystr

_MARKER = "_COMMITTED"
_MAX_SHARD_BYTES = 512 * 1024 * 1024
_BF16 = "bfloat16"



# ---------------------------------------------------------------------------
# Host copies
# ---------------------------------------------------------------------------
def _to_host(x) -> tuple[np.ndarray, str]:
    """(numpy array, manifest dtype): a copy of a tensor or array, which
    later writes to ``x`` do not reach; bfloat16 as its raw 2-byte
    values."""
    if isinstance(x, torch.Tensor):
        t = x.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2"), _BF16
        a = t.numpy()
    else:
        a = np.array(x)
    return a, str(a.dtype)


def _from_host(arr: np.ndarray, dtype: str) -> torch.Tensor:
    arr = np.asarray(arr, order="C")
    if dtype == _BF16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class Checkpointer:
    def __init__(self, directory: str | Path, *, keep: int = 3,
                 async_save: bool = False):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._pool = cf.ThreadPoolExecutor(max_workers=1) if async_save \
            else None
        self._pending: Optional[cf.Future] = None

    # -- save ----------------------------------------------------------------
    def save(self, step: int, tree: Any, shardings: Any = None,
             mesh=None) -> None:
        """Copy ``tree`` to the host now; write it now, or on the thread.
        With ``shardings`` (a spec tree matching ``tree``) and ``mesh`` (a
        ``DeviceMesh``): ``tree`` holds this card's shards; every card
        gathers each leaf whole, rank 0 writes them, and every card waits
        for the write (a collective: every rank calls it)."""
        if shardings is not None:
            lay = _layout(mesh)
            whole = [(p, SH.gather_whole(x, lay, _spec_at(shardings, p)))
                     for p, x in flatten(tree)]
            import torch.distributed as dist
            if dist.get_rank() == 0:
                self.wait()
                self._write(step, {keystr(p): _to_host(x) for p, x in whole})
            dist.barrier()
            return
        host = {keystr(p): _to_host(x) for p, x in flatten(tree)}
        if self._pool is None:
            self._write(step, host)
        else:
            self.wait()
            self._pending = self._pool.submit(self._write, step, host)

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.result()
            self._pending = None

    def close(self) -> None:
        """Finish a pending save and stop the writer thread."""
        self.wait()
        if self._pool is not None:
            self._pool.shutdown()

    def _write(self, step: int, host: dict) -> None:
        tmp = Path(tempfile.mkdtemp(prefix=f".tmp_step_{step}_",
                                    dir=self.dir))
        try:
            shards: list[dict[str, tuple[np.ndarray, str]]] = [{}]
            sizes = [0]
            for k, (a, dt) in host.items():
                if sizes[-1] + a.nbytes > _MAX_SHARD_BYTES and shards[-1]:
                    shards.append({})
                    sizes.append(0)
                shards[-1][k] = (a, dt)
                sizes[-1] += a.nbytes
            manifest = {
                "step": step,
                "n_shards": len(shards),
                "keys": {k: {"shard": si, "shape": list(a.shape),
                             "dtype": dt}
                         for si, sh in enumerate(shards)
                         for k, (a, dt) in sh.items()},
            }
            for si, sh in enumerate(shards):
                np.savez(tmp / f"shard_{si}.npz",
                         **{k: a for k, (a, _) in sh.items()})
            (tmp / "manifest.json").write_text(json.dumps(manifest))
            (tmp / _MARKER).write_text("ok")
            final = self.dir / f"step_{step}"
            if final.exists():
                shutil.rmtree(final)
            os.replace(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._gc()

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    # -- restore -------------------------------------------------------------
    def all_steps(self) -> list[int]:
        out = []
        for p in self.dir.glob("step_*"):
            if (p / _MARKER).exists():
                try:
                    out.append(int(p.name.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like: Any, shardings: Any = None,
                mesh=None) -> Any:
        """The tree of ``like`` (tensors, or anything with ``dtype`` and
        ``device``) filled from step ``step``: new tensors, each cast to
        its ``like`` leaf's dtype and put on its device. With ``shardings``
        (a spec tree matching ``like``) and ``mesh`` (a ``DeviceMesh`` or a
        ``sharding.Layout``), each leaf is this card's shard of the whole
        one the checkpoint holds."""
        lay = None if shardings is None else _layout(mesh)
        d = self.dir / f"step_{step}"
        if not (d / _MARKER).exists():
            raise FileNotFoundError(f"no committed checkpoint at {d}")
        manifest = json.loads((d / "manifest.json").read_text())
        files: dict[int, Any] = {}
        try:
            def load(k: str) -> torch.Tensor:
                info = manifest["keys"][k]
                si = info["shard"]
                if si not in files:
                    files[si] = np.load(d / f"shard_{si}.npz")
                return _from_host(files[si][k], info["dtype"])

            out = {}
            for p, leaf in flatten(like):
                t = load(keystr(p))
                if lay is not None:
                    t = SH.local_shard(t, lay, _spec_at(shardings, p),
                                       lay.coords).contiguous()
                out[p] = t.to(device=leaf.device, dtype=leaf.dtype)
        finally:
            for f in files.values():
                f.close()
        return _unflatten(like, out)


def _layout(mesh) -> SH.Layout:
    return mesh if isinstance(mesh, SH.Layout) else SH.Layout.of(mesh)


def _spec_at(shardings: Any, path: Path_) -> tuple:
    """The spec at ``path`` of a spec tree (whose leaves are tuples)."""
    node = shardings
    for p in path:
        node = node[p]
    return node


def _unflatten(like: Any, leaves: dict, path: Path_ = ()) -> Any:
    if isinstance(like, dict):
        return {k: _unflatten(v, leaves, path + (k,)) for k, v in like.items()}
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten(v, leaves, path + (i,))
                          for i, v in enumerate(like))
    return leaves[path]

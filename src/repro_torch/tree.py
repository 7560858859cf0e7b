"""Tree paths and parameter names, shared by the model, the optimizer and
the checkpoint.

Trees are nested dicts (keys sorted, as JAX flattens them) and tuples or
lists of leaves. The port's flat parameter names (``g0.0.mixer.wq``) map
to that structure and to ``jax.tree_util.keystr`` strings here and
nowhere else.
"""
from __future__ import annotations

from typing import Any, Iterator

Path_ = tuple


def path_of(name: str) -> Path_:
    """A flat port name to its tree path: ``"g0.0.mixer.wq"`` -> ``("g0", 0,
    "mixer", "wq")`` (all-digit parts index tuples)."""
    return tuple(int(p) if p.isdigit() else p for p in name.split("."))


def keystr(path: Path_) -> str:
    """``jax.tree_util.keystr`` of a path of dict keys and sequence
    indices: ``("params", "g0", 0)`` -> ``"['params']['g0'][0]"``."""
    return "".join(f"[{p}]" if isinstance(p, int) else f"[{p!r}]"
                   for p in path)


def name_of(ks: str) -> str:
    """The flat port name of a parameter's keystr: ``"['g0'][0]['wq']"`` ->
    ``"g0.0.wq"`` (the inverse of ``keystr(path_of(name))``)."""
    return ".".join(p.strip("'\"") for p in ks[1:-1].split("]["))


def flatten(tree: Any, path: Path_ = ()) -> Iterator[tuple[Path_, Any]]:
    """(path, leaf) pairs in JAX's order: dict keys sorted, sequences in
    order; anything that is not a dict, tuple or list is a leaf."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from flatten(tree[k], path + (k,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from flatten(v, path + (i,))
    else:
        yield path, tree


def nest(named: dict) -> dict:
    """Flat port names -> the JAX structure: dotted parts become nested
    dicts, and a level whose keys are all indices a tuple (a group's
    period positions)."""
    root: dict = {}
    for name, leaf in named.items():
        node = root
        *head, last = path_of(name)
        for p in head:
            node = node.setdefault(p, {})
        node[last] = leaf

    def seal(node):
        if not isinstance(node, dict):
            return node
        out = {k: seal(v) for k, v in node.items()}
        if out and all(isinstance(k, int) for k in out):
            if sorted(out) != list(range(len(out))):
                raise ValueError(f"indices {sorted(out)} are not 0..n-1")
            return tuple(out[i] for i in range(len(out)))
        return out

    return seal(root)


def named(tree: Any) -> dict:
    """The inverse of ``nest``: {dotted name: leaf}."""
    return {".".join(str(p) for p in path): leaf
            for path, leaf in flatten(tree)}

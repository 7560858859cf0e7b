"""Logical-axis sharding rules and the collectives of tensor parallelism on
a ``torch.distributed`` device mesh (port of
``repro/distributed/sharding.py``).

The rule half is the reference's, copied: ``DEFAULT_RULES``,
``ShardingRules``, ``mesh_axes_size``, ``_resolve`` (the divisibility
fallback, each mesh axis used once in a spec), ``logical_to_spec``,
``sharding_context``, ``current_mesh`` and ``current_rules``;
``tests/test_torch_sharding.py`` holds them to the originals. A spec is a
tuple with one entry per tensor dim: None, a mesh axis name, or a tuple of
names; it equals the reference's ``PartitionSpec`` entries. A mesh is a
``DeviceMesh`` (``launch/mesh.py``) or anything with a ``.shape`` mapping of
axis name to size, as the reference's ``rules_for`` reads a JAX mesh.

Eager PyTorch has no ``NamedSharding`` / ``with_sharding_constraint``. In
their place:

  * ``placements(mesh, spec)``: the ``Shard(dim)`` / ``Replicate()`` of each
    mesh dim, for a ``DTensor`` of the same layout;
  * ``local_shard(tensor, mesh, spec)``: this rank's slice of a full tensor;
    ``Layout`` does the same for a model (its rules, this rank's
    coordinates), and works without a process group (the meta device);
    a dim that concatenates equal pieces (``paired``: Mamba's ``in_proj``
    holds x_in's columns, then z's) is cut piece by piece there and
    joined back so by ``gather_whole``;
  * ``all_reduce``, ``all_gather`` and ``gather_partials`` over named mesh
    axes: explicit collectives where the reference's ``constrain`` changes
    a layout (in place, no backward: the decode path's). Local shards are
    plain tensors, so no DTensor dispatch sits on the decode step's host
    path;
  * the differentiable collectives of the train step (Megatron's pair and
    two more, ``torch.autograd.Function``s): ``copy_to`` (identity
    forward, all-reduce backward: the input of a column-parallel product),
    ``reduce_from`` (all-reduce forward, identity backward: the output of
    a row-parallel one), ``gather_from`` (all-gather forward; backward
    this card's slice where the gathered tensor feeds the same work on
    every card, else a reduce-scatter: an FSDP weight, or the
    sequence-parallel input of a column-parallel product),
    ``reduce_scatter`` (backward an all-gather) and ``split_to`` (this
    card's slice, backward an all-gather: out of a part every card
    computed whole, to this card's rows of the sequence).

Every call is counted by kind with the per-device link bytes of
``repro/launch/hlo_analysis.py::analyze_collectives`` (``collectives()``:
``per_op``, ``total_bytes``, ``count``), a backward's collective as a
forward's, and a forward recomputed under remat again; an axis of size 1
is no collective. On the meta device a call only counts, so
``FlopCounterMode`` runs a sharded step there.

Importing this module creates no process group and touches no device.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Mapping, Optional, Sequence

import torch

# Logical axis name -> mesh axes (in order of preference / outer-to-inner).
# "batch" spans the data-parallel axes (pod+data when multi-pod).
DEFAULT_RULES: dict[str, tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "seq": (),              # unsharded by default; perf flag remaps -> ("model",)
    "kv_seq": (),           # KV-cache sequence dim; perf flag remaps -> ("data",)
    "model_d": (),          # residual/embedding feature dim: replicated
    "vocab": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "head_dim": (),
    "ff": ("model",),
    "experts": ("model",),  # expert parallelism
    "expert_cap": ("pod", "data"),
    "expert_ff": ("pod", "data"),  # expert weight d_ff: FSDP-style over data
    "flat_tokens": ("pod", "data"),  # flattened (B*S)±topk token dims in MoE
    "d_inner": ("model",),  # mamba inner dim
    "rwkv_heads": ("model",),
    "conv": (),
    "state": (),
    "layers": (),           # stacked-layer leading axis
    "unsharded": (),
}


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Sharding rule table; override entries for perf experiments."""

    rules: Mapping[str, tuple[str, ...]] = dataclasses.field(
        default_factory=lambda: dict(DEFAULT_RULES)
    )

    def with_overrides(self, **overrides: tuple[str, ...]) -> "ShardingRules":
        merged = dict(self.rules)
        merged.update(overrides)
        return ShardingRules(rules=merged)


Spec = tuple    # one entry per dim: None, an axis name, or a tuple of names


def mesh_axes_size(sizes: Mapping[str, int], axes: Sequence[str]) -> int:
    total = 1
    for ax in axes:
        total *= sizes[ax]
    return total


class _PairedName(str):
    """A logical axis name whose dim holds ``pieces`` equal pieces side by
    side (``paired``)."""
    pieces: int = 1


class _PairedAxis(str):
    """A spec entry of one mesh axis over a paired dim."""
    pieces: int = 1


class _PairedAxes(tuple):
    """A spec entry of several mesh axes over a paired dim."""
    pieces: int = 1


def paired(name: str, pieces: int = 2) -> str:
    """The logical axis ``name`` over a dim that concatenates ``pieces``
    equal pieces (Mamba's ``in_proj`` (D, 2 Din): x_in's columns, then
    z's). It resolves to the same mesh axes as ``name`` (and compares equal
    to it), but a card's shard is its slice of every piece, side by side:
    ``local_shard``, ``Layout.local`` and ``gather_whole`` cut and join the
    dim viewed as (pieces, n / pieces), so a card holds x_in's and z's
    columns of the same channels."""
    out = _PairedName(name)
    out.pieces = pieces
    return out


def pieces_of(entry) -> int:
    """The pieces of a spec entry or a logical axis name (1: a plain one)."""
    return getattr(entry, "pieces", 1)


def _with_pieces(entry, pieces: int):
    if pieces == 1:
        return entry
    out = (_PairedAxis(entry) if isinstance(entry, str)
           else _PairedAxes(entry))
    out.pieces = pieces
    return out


def _resolve(
    axis_sizes: Mapping[str, int],
    logical_axes: Sequence[str | None],
    shape: Sequence[int] | None,
    rules: ShardingRules,
) -> Spec:
    spec: list[Any] = []
    used: set[str] = set()
    for i, name in enumerate(logical_axes):
        if name is None:
            spec.append(None)
            continue
        axes = tuple(
            a for a in rules.rules.get(name, ()) if a in axis_sizes and a not in used
        )
        k = pieces_of(name)        # a paired dim is cut piece by piece
        if axes and shape is not None:
            # drop leading axes until the dim divides evenly (replicate if never)
            while axes and (shape[i] == 0 or shape[i] % k or (shape[i] // k) % mesh_axes_size(axis_sizes, axes) != 0):
                axes = axes[1:]
        if not axes:
            spec.append(None)
            continue
        used.update(axes)
        spec.append(_with_pieces(axes[0] if len(axes) == 1 else axes, k))
    return tuple(spec)


def axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a ``DeviceMesh``, a ``Layout``, an object with a
    ``.shape`` mapping (a JAX mesh, a stand-in in the tests), or a
    mapping."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    if isinstance(mesh, Layout):
        return dict(mesh.sizes)
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def logical_to_spec(
    mesh,
    logical_axes: Sequence[str | None],
    shape: Sequence[int] | None = None,
    rules: ShardingRules | None = None,
) -> Spec:
    return _resolve(axis_sizes(mesh), logical_axes, shape,
                    rules or ShardingRules())


# ---------------------------------------------------------------------------
# Sharding context (installed by the launcher around a sharded step).
# ---------------------------------------------------------------------------
class _Ctx(threading.local):
    mesh: Any = None
    rules: ShardingRules | None = None


_CTX = _Ctx()


@contextlib.contextmanager
def sharding_context(mesh, rules: ShardingRules | None = None):
    prev = (_CTX.mesh, _CTX.rules)
    _CTX.mesh, _CTX.rules = mesh, rules or ShardingRules()
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules = prev


def current_mesh():
    return _CTX.mesh


def current_rules() -> ShardingRules:
    return _CTX.rules or ShardingRules()


# ---------------------------------------------------------------------------
# Local shards
# ---------------------------------------------------------------------------
def entry_axes(entry) -> tuple[str, ...]:
    """The mesh axes of one spec entry: () for None."""
    if entry is None:
        return ()
    return (str(entry),) if isinstance(entry, str) else tuple(
        str(a) for a in entry)


def coordinates(mesh) -> dict[str, int]:
    """This rank's coordinate along each axis of a ``DeviceMesh``."""
    return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))


def shard_range(entry, n: int, sizes: Mapping[str, int],
                coords: Mapping[str, int]) -> tuple[int, int]:
    """(start, length) of this rank's piece of a dim of size ``n`` sharded by
    spec entry ``entry``: the dim is cut into the product of the entry's
    axis sizes, indexed row-major over its axes (the reference's
    ``PartitionSpec`` order)."""
    idx, k = 0, 1
    for ax in entry_axes(entry):
        idx = idx * sizes[ax] + coords[ax]
        k *= sizes[ax]
    if n % k:
        raise ValueError(f"dim {n} does not divide into {k} shards")
    return idx * (n // k), n // k


def placements(mesh, spec: Spec) -> tuple:
    """The ``DTensor`` placements of ``spec`` on ``mesh``: per mesh dim,
    ``Shard(d)`` where tensor dim d's entry names the axis, else
    ``Replicate()``. A dim sharded over several axes lists them in mesh
    order, which is the reference's row-major order when the entry's axes
    are (all the rules' entries are)."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(axis_sizes(mesh))
    out = [Replicate() for _ in names]
    for dim, entry in enumerate(spec):
        for ax in entry_axes(entry):
            out[names.index(ax)] = Shard(dim)
    return tuple(out)


def cut(tensor: torch.Tensor, spec: Spec, sizes: Mapping[str, int],
        coords: Mapping[str, int]):
    """The slice of a full ``tensor`` (or numpy array) laid out by ``spec``
    that the card at ``coords`` holds: a view, but over a paired dim
    (``paired``) a copy of the card's slice of every piece."""
    out = tensor[tuple(slice(s, s + n) for s, n in (
        (0, tensor.shape[d]) if pieces_of(e) > 1 else
        shard_range(e, tensor.shape[d], sizes, coords)
        for d, e in enumerate(spec)))]
    for d, e in enumerate(spec):
        k = pieces_of(e)
        if k > 1:
            shape = tuple(out.shape)
            s, n = shard_range(e, shape[d] // k, sizes, coords)
            out = out.reshape(shape[:d] + (k, shape[d] // k) + shape[d + 1:])
            out = out[(slice(None),) * (d + 1) + (slice(s, s + n),)]
            out = out.reshape(shape[:d] + (k * n,) + shape[d + 1:])
    return out


def local_shard(tensor: torch.Tensor, mesh, spec: Spec,
                coords: Optional[Mapping[str, int]] = None) -> torch.Tensor:
    """This rank's slice (a view, but over a paired dim a copy) of a full
    ``tensor`` laid out by ``spec`` on ``mesh``; ``coords`` default to this
    process's place in a ``DeviceMesh``."""
    coords = coordinates(mesh) if coords is None else coords
    return cut(tensor, spec, axis_sizes(mesh), coords)


@dataclasses.dataclass(frozen=True)
class Layout:
    """A rank's view of a mesh under ``rules``: the axis sizes, its
    coordinates and, on a ``DeviceMesh``, the mesh for the collectives.
    ``mesh`` None (and explicit sizes and coordinates) serves the meta
    device, where a collective only counts."""

    sizes: Mapping[str, int]
    coords: Mapping[str, int]
    rules: ShardingRules
    mesh: Any = None

    @classmethod
    def of(cls, mesh, rules: Optional[ShardingRules] = None,
           coords: Optional[Mapping[str, int]] = None) -> "Layout":
        if coords is None:
            coords = coordinates(mesh)
        return cls(axis_sizes(mesh), dict(coords), rules or current_rules(),
                   mesh if hasattr(mesh, "get_group") else None)

    def with_rules(self, rules: ShardingRules) -> "Layout":
        return dataclasses.replace(self, rules=rules)

    def spec(self, axes: Sequence[str | None], shape: Sequence[int]) -> Spec:
        return _resolve(self.sizes, axes, shape, self.rules)

    def ranges(self, axes, shape) -> list[tuple[int, int]]:
        """(start, length) of this rank's piece of every dim (a paired
        dim's as if it were cut in one: its length is the card's; slice
        with ``local``)."""
        return [shard_range(e, n, self.sizes, self.coords)
                for e, n in zip(self.spec(axes, shape), shape)]

    def local_shape(self, axes, shape) -> tuple[int, ...]:
        return tuple(n for _, n in self.ranges(axes, shape))

    def local(self, tensor: torch.Tensor, axes) -> torch.Tensor:
        """This rank's slice of the full ``tensor`` (or numpy array) of
        ``axes``: a view, but over a paired dim a copy (``cut``)."""
        return cut(tensor, self.spec(axes, tensor.shape), self.sizes,
                   self.coords)

    def size(self, entry) -> int:
        return mesh_axes_size(self.sizes, entry_axes(entry))

    def index(self, entry) -> int:
        """This rank's shard index along spec entry ``entry``."""
        return shard_range(entry, self.size(entry), self.sizes,
                           self.coords)[0]


# ---------------------------------------------------------------------------
# Collectives, counted by kind (per-device link bytes as analyze_collectives)
# ---------------------------------------------------------------------------
_COUNTS: dict = {}


def reset_collectives() -> None:
    _COUNTS.clear()
    _COUNTS.update(per_op={}, calls={}, total_bytes=0, count=0)


reset_collectives()


def collectives() -> dict:
    """The collectives since ``reset_collectives``: {"per_op": {kind: link
    bytes}, "calls": {kind: calls}, "total_bytes", "count"}."""
    return {"per_op": dict(_COUNTS["per_op"]), "calls": dict(_COUNTS["calls"]),
            "total_bytes": _COUNTS["total_bytes"], "count": _COUNTS["count"]}


def _count(kind: str, nbytes: float) -> None:
    _COUNTS["per_op"][kind] = _COUNTS["per_op"].get(kind, 0) + nbytes
    _COUNTS["calls"][kind] = _COUNTS["calls"].get(kind, 0) + 1
    _COUNTS["total_bytes"] += nbytes
    _COUNTS["count"] += 1


_GROUPS: dict = {}


def group(layout: Layout, axes: tuple[str, ...]):
    """The process group of this rank's cards along ``axes`` (one axis, or
    several flattened in mesh order), looked up once a mesh."""
    key = (layout.mesh, axes)
    if key not in _GROUPS:
        _GROUPS[key] = (layout.mesh.get_group(axes[0]) if len(axes) == 1
                        else layout.mesh[axes]._flatten().get_group())
    return _GROUPS[key]


def _live(layout: Layout, entry) -> tuple[tuple[str, ...], int]:
    """The axes of ``entry`` larger than 1, and their product."""
    axes = tuple(a for a in entry_axes(entry) if layout.sizes[a] > 1)
    return axes, mesh_axes_size(layout.sizes, axes)


def all_reduce(x: torch.Tensor, layout: Layout, entry,
               op: str = "sum") -> torch.Tensor:
    """Sum (or ``op="max"``) of ``x`` over the cards along ``entry``'s axes,
    in place (ring: 2 (k - 1) / k of its bytes a card)."""
    axes, k = _live(layout, entry)
    if k == 1:
        return x
    _count("all-reduce", 2 * x.numel() * x.element_size() * (k - 1) / k)
    if x.device.type != "meta":
        import torch.distributed as dist
        dist.all_reduce(x, op=dist.ReduceOp.MAX if op == "max"
                        else dist.ReduceOp.SUM, group=group(layout, axes))
    return x


def all_gather(x: torch.Tensor, layout: Layout, entry,
               dim: int) -> torch.Tensor:
    """The cards' ``x`` along ``entry``'s axes concatenated on ``dim`` in
    shard order ((k - 1) / k of the result's bytes a card)."""
    axes, k = _live(layout, entry)
    if k == 1:
        return x
    out = gather_partials(x, layout, entry, kind="all-gather")
    return out.movedim(0, dim).flatten(dim, dim + 1)


def gather_partials(x: torch.Tensor, layout: Layout, entry, *,
                    kind: str = "all-gather") -> torch.Tensor:
    """The cards' ``x`` along ``entry``'s axes stacked on a new leading dim
    (k, *x.shape) in shard order: the decode merge's input."""
    axes, k = _live(layout, entry)
    if k == 1:
        return x[None]
    out = x.new_empty((k,) + tuple(x.shape))
    _count(kind, out.numel() * out.element_size() * (k - 1) / k)
    if x.device.type != "meta":
        import torch.distributed as dist
        # flat buffers: gloo wants the output as the input's first dim
        # times k, NCCL only its size
        dist.all_gather_into_tensor(out.view(-1), x.contiguous().view(-1),
                                    group=group(layout, axes))
    return out


def _scatter_sum(x: torch.Tensor, layout: Layout, entry,
                 dim: int) -> torch.Tensor:
    """The sum of ``x`` over the cards along ``entry``'s axes, cut on
    ``dim`` into k pieces of which this card keeps its own (a ring
    reduce-scatter: (k - 1) / k of the input's bytes a card)."""
    axes, k = _live(layout, entry)
    if k == 1:
        return x
    _count("reduce-scatter", x.numel() * x.element_size() * (k - 1) / k)
    lead = x.movedim(dim, 0)
    out = lead.new_empty((lead.shape[0] // k,) + tuple(lead.shape[1:]))
    if x.device.type != "meta":
        import torch.distributed as dist
        dist.reduce_scatter_tensor(out.view(-1),
                                   lead.contiguous().view(-1),
                                   group=group(layout, axes))
    return out.movedim(0, dim)


def _own_slice(x: torch.Tensor, layout: Layout, entry,
               dim: int) -> torch.Tensor:
    """This card's piece of ``x`` cut on ``dim`` by ``entry``'s axes."""
    start, n = shard_range(entry, x.shape[dim], layout.sizes, layout.coords)
    return x.narrow(dim, start, n)


# ---------------------------------------------------------------------------
# Differentiable collectives (the train step's)
# ---------------------------------------------------------------------------
class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, layout, entry):
        ctx.layout, ctx.entry = layout, entry
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.layout,
                          ctx.entry), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, layout, entry):
        return all_reduce(x.contiguous().clone(), layout, entry)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, layout, entry, dim, scatter):
        ctx.layout, ctx.entry, ctx.dim, ctx.scatter = layout, entry, dim, \
            scatter
        return all_gather(x, layout, entry, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.scatter:
            g = _scatter_sum(g, ctx.layout, ctx.entry, ctx.dim)
        else:
            g = _own_slice(g, ctx.layout, ctx.entry, ctx.dim)
        return g.contiguous(), None, None, None, None


class _SplitTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, layout, entry, dim):
        ctx.layout, ctx.entry, ctx.dim = layout, entry, dim
        return _own_slice(x, layout, entry, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g.contiguous(), ctx.layout, ctx.entry,
                          ctx.dim), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, layout, entry, dim):
        ctx.layout, ctx.entry, ctx.dim = layout, entry, dim
        return _scatter_sum(x, layout, entry, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g.contiguous(), ctx.layout, ctx.entry,
                          ctx.dim), None, None, None


def _trivial(layout: Optional[Layout], entry) -> bool:
    return layout is None or _live(layout, entry)[1] == 1


def copy_to(x: torch.Tensor, layout: Optional[Layout],
            entry) -> torch.Tensor:
    """Into the region sharded over ``entry``: identity forward, its
    gradient all-reduced over ``entry``'s axes (each card's part of a
    column-parallel product's input gradient summed)."""
    return x if _trivial(layout, entry) else _CopyTo.apply(x, layout, entry)


def reduce_from(x: torch.Tensor, layout: Optional[Layout],
                entry) -> torch.Tensor:
    """Out of the region: the cards' partial sums all-reduced over
    ``entry``'s axes (a new tensor), the gradient passed through."""
    if _trivial(layout, entry):
        return x
    if not (torch.is_grad_enabled() and x.requires_grad):
        return all_reduce(x, layout, entry)       # in place, no backward
    return _ReduceFrom.apply(x, layout, entry)


def gather_from(x: torch.Tensor, layout: Optional[Layout], entry, dim: int,
                *, scatter: bool = False) -> torch.Tensor:
    """The cards' ``x`` along ``entry``'s axes concatenated on ``dim``. The
    backward keeps this card's slice of the gradient where every card does
    the same work with the gathered tensor, or with ``scatter`` (the cards
    do different work with it: an FSDP weight over "data") reduce-scatters
    it, summing the cards' gradients."""
    if _trivial(layout, entry):
        return x
    return _GatherFrom.apply(x, layout, entry, dim, scatter)


def reduce_scatter(x: torch.Tensor, layout: Optional[Layout], entry,
                   dim: int) -> torch.Tensor:
    """The cards' ``x`` summed over ``entry``'s axes, this card's slice on
    ``dim``; the backward all-gathers the gradient."""
    if _trivial(layout, entry):
        return x
    return _ReduceScatter.apply(x, layout, entry, dim)


def split_to(x: torch.Tensor, layout: Optional[Layout], entry,
             dim: int) -> torch.Tensor:
    """This card's slice on ``dim`` of an ``x`` that every card along
    ``entry``'s axes holds whole; the backward all-gathers the gradient
    (the cards' slices of it, each whole on its card)."""
    if _trivial(layout, entry):
        return x
    return _SplitTo.apply(x, layout, entry, dim)


def gather_whole(x: torch.Tensor, layout: Layout, spec: Spec) -> torch.Tensor:
    """The whole tensor of which ``x`` is this card's shard under ``spec``
    (every card gets it: one all-gather per sharded dim; a checkpoint's and
    the optimizer's whole leaves)."""
    for dim, entry in enumerate(spec):
        if _live(layout, entry)[1] > 1:
            k = pieces_of(entry)      # a paired dim: gathered piece by piece
            x = x.unflatten(dim, (k, x.shape[dim] // k))
            x = all_gather(x.contiguous(), layout, entry, dim + 1)
            x = x.flatten(dim, dim + 1)
    return x

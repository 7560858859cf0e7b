"""Meshes of cards (port of ``repro/launch/mesh.py``).

Functions, not module-level constants, so importing this module creates no
process group and touches no device. A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` named ("data", "model") over
the cards of one host; it needs an initialised process group (one process
per card, ``torch.distributed.init_process_group``), as the reference's
``jax.make_mesh`` needs the JAX devices. The reference's pod meshes (16 x
16, and 2 x 16 x 16 with a "pod" axis) are TPU slices of 256 and 512 chips:
one host here has at most 4 cards, so they have no counterpart; the rules
(``distributed/sharding.py``) still name "pod" and drop it where a mesh
lacks it, as the reference's do.
"""
from __future__ import annotations


def make_mesh(n_cards: int, data: int = 1, *, device: str = "cuda"):
    """(data, n_cards // data) mesh named ("data", "model") over this
    process group's ``n_cards`` ranks; ``device="cpu"`` for gloo ranks (the
    tests). Raises without an initialised process group or when ``data``
    does not divide ``n_cards``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(torch.distributed.init_process_group)")
    if data < 1 or n_cards % data:
        raise ValueError(f"data {data} does not divide {n_cards} cards")
    if dist.get_world_size() != n_cards:
        raise ValueError(f"the process group has {dist.get_world_size()} "
                         f"ranks, the mesh {n_cards} cards")
    return init_device_mesh(device, (data, n_cards // data),
                            mesh_dim_names=("data", "model"))


def make_local_mesh(*, device: str = "cuda"):
    """A (1, 1) mesh with the axis names of ``make_mesh`` (one process)."""
    return make_mesh(1, 1, device=device)


def data_parallel_size(mesh) -> int:
    from repro_torch.distributed.sharding import axis_sizes
    sizes = axis_sizes(mesh)
    s = 1
    for ax in ("pod", "data"):
        if ax in sizes:
            s *= sizes[ax]
    return s


def model_parallel_size(mesh) -> int:
    from repro_torch.distributed.sharding import axis_sizes
    return axis_sizes(mesh).get("model", 1)

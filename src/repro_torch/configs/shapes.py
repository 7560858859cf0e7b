"""The port's copy of ``src/repro/configs/shapes.py`` (framework-free, so copied
rather than imported: the port imports nothing of ``repro``). Its code
equals the original's outside the import lines and this docstring;
``tests/test_torch_core.py`` checks that, and holds the two to the same
results. The original's docstring follows.

Assigned input-shape cases (per-arch applicability included).

LM transformer shapes are seq_len × global_batch.  ``decode_*`` / ``long_*``
lower ``serve_step`` (one new token against a seq_len KV cache); ``train_4k``
lowers ``train_step``; ``prefill_32k`` lowers the prefill step.

``long_500k`` requires sub-quadratic context handling — it is skipped for the
pure full-attention architectures (recorded in DESIGN.md §Arch-applicability)
and runs for the SSM / hybrid / sliding-window ones.
"""
from __future__ import annotations

import dataclasses

from .base import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeCase:
    name: str
    kind: str            # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeCase("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeCase("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeCase("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeCase("long_500k", "decode", 524_288, 1),
}


def list_shapes():
    return list(SHAPES)


def get_shape(name: str) -> ShapeCase:
    return SHAPES[name]


def applicable(cfg: ModelConfig, case: ShapeCase) -> tuple[bool, str]:
    """(runnable?, reason-if-not)."""
    if case.name == "long_500k" and not cfg.has_subquadratic_context:
        return False, (
            "pure full-attention arch: 500K-token decode requires "
            "sub-quadratic context (see DESIGN.md §Arch-applicability)")
    return True, ""


def cells(configs: dict[str, ModelConfig]):
    """All (arch, shape) cells incl. skipped ones, for the roofline table."""
    out = []
    for arch, cfg in configs.items():
        for case in SHAPES.values():
            ok, reason = applicable(cfg, case)
            out.append((arch, case.name, ok, reason))
    return out

"""The port's copy of ``src/repro/core/accelerators.py`` (framework-free, so copied
rather than imported: the port imports nothing of ``repro``). Its code
equals the original's outside the import lines and this docstring;
``tests/test_torch_core.py`` checks that, and holds the two to the same
results. The original's docstring follows.

Accelerator catalog: the paper's four GPUs (Table 1, exact prices/specs)
plus a TPU-fleet extension (the beyond-paper, TPU-native deployment target).

Multi-chip TPU slice entries aggregate chip specs with a tensor-parallel
efficiency factor (collective overhead across ICI).

TP-degree expansion (beyond-paper, arXiv:2502.00722 / ThunderServe-style):
``expand_tp_variants`` turns each base accelerator into a family of
(type, tp) variants — ``A10Gx2`` is two A10G chips running one
tensor-parallel engine instance.  A variant aggregates HBM capacity,
bandwidth, and FLOPs across its chips, scaled by a *per-degree* efficiency
curve (kernel imbalance + shard padding grow with the shard count), and
carries the interconnect bandwidth so the engine model can charge the
per-layer all-reduce traffic explicitly.  Availability is accounted in
*chips* of the base type: one ``A10Gx4`` instance draws 4 chips from the
same pool as four ``A10G`` instances (see the grouped chip-capacity
constraint in ``ilp.py``).

Price-tier expansion (beyond-paper, ShuntServe arXiv:2606.18600-style):
``expand_price_tiers`` gives every base accelerator that quotes a spot
rate a preemptible sibling — ``A100:spot`` is the same silicon at the
spot discount, carrying ``preemption_rate`` (expected reclaims per
instance-hour).  A spot variant keeps the base type's chip pool
(``base_name``), so physical availability caps bound on-demand + spot +
all TP variants together and tp x tier composes, while its *market pool*
(``market_pool``, ``"A100:spot"``) is a sub-pool of its own: a spot-market
stockout caps only the preemptible tier, leaving on-demand rentable for
backfill.

Region expansion (beyond-paper, ``repro.regions``): ``region_variant``
gives any entry a geo sibling — ``A100:spot@eu-west`` is the same SKU in
another cloud region, at that region's price multiplier and preemption
rate.  The region is the *outermost* pool level: a region variant's
physical chip pool is ``"A100@eu-west"`` and its spot market sub-pool
``"A100:spot@eu-west"``, so a regional stockout caps only that region's
pool.  Variant names canonically carry the region suffix *last*
(``name[xN][:spot]@region``); ``tp_variant``/``spot_variant`` insert
their markers before the ``@region`` suffix, so the expanders compose in
any order and always emit parseable names — ``split_region`` /
``is_spot_pool`` are the order-robust helpers every pool-string consumer
must use instead of raw ``endswith``/``split``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterable, Mapping, Optional


def split_region(name: str) -> tuple[str, str]:
    """Order-robust region split: ``"A100x2:spot@eu-west"`` ->
    ``("A100x2:spot", "eu-west")``; a name with no ``@`` keeps an empty
    region.  The region marker is always the *last* component of a
    canonical variant name, so a single right-partition is exact no matter
    which order the tp/tier/region expanders ran in."""
    stem, sep, region = name.rpartition("@")
    return (stem, region) if sep else (name, "")


def with_region(stem: str, region: str) -> str:
    """Attach the canonical ``@region`` suffix (no-op for empty region)."""
    return f"{stem}@{region}" if region else stem


def is_spot_pool(pool: str) -> bool:
    """Whether a *pool string* names a spot market sub-pool, robust to the
    region suffix: ``"A100:spot"`` and ``"A100:spot@eu-west"`` are spot
    pools; ``"A100@eu-west"`` is a physical pool.  Replaces naive
    ``endswith(":spot")`` checks, which break once a region is composed
    after the tier marker."""
    return split_region(pool)[0].endswith(":spot")


@dataclasses.dataclass(frozen=True)
class Accelerator:
    name: str
    mem_gb: float              # usable HBM (aggregate across chips)
    bw_gbs: float              # HBM bandwidth, GB/s (aggregate)
    flops_tf: float            # peak half-precision TFLOP/s (aggregate)
    price_hr: float            # on-demand $/h per instance
    chips: int = 1             # chips of the base type per instance
    tp_efficiency: float = 1.0  # effective fraction of aggregate peak
    max_request_tokens: Optional[int] = None  # paper: L4/A10G capped at 12k
    base_type: str = ""        # chip pool this instance draws from ("" = name)
    tp: int = 1                # tensor-parallel degree of the engine instance
    link_gbs: float = 0.0      # per-chip interconnect bandwidth (TP collectives)
    tier: str = "ondemand"     # price tier of THIS entry: "ondemand" | "spot"
    spot_price_hr: Optional[float] = None  # quoted spot $/h (on the base entry)
    preemption_rate: float = 0.0  # expected reclaims per instance-hour as spot
    region: str = ""           # cloud region this entry rents in ("" = global)

    @property
    def eff_flops(self) -> float:
        return self.flops_tf * 1e12 * self.tp_efficiency

    @property
    def eff_bw(self) -> float:
        return self.bw_gbs * 1e9 * self.tp_efficiency

    @property
    def mem_bytes(self) -> float:
        return self.mem_gb * 1e9

    @property
    def base_name(self) -> str:
        """Chip-pool key: TP variants of one base type share availability."""
        return self.base_type or self.name

    @property
    def is_spot(self) -> bool:
        return self.tier == "spot"

    @property
    def market_pool(self) -> str:
        """Market-pool key: the sub-pool a stockout of this entry's *price
        tier* caps.  On-demand variants coincide with the physical chip
        pool (``base_name``); spot variants form a ``"<base>:spot"``
        sub-pool, so a spot-market stockout never caps on-demand rentals.
        The region suffix stays outermost: a regional spot variant's
        market pool is ``"A100:spot@eu-west"``, never ``"A100@eu-west:spot"``.
        """
        if not self.is_spot:
            return self.base_name
        stem, region = split_region(self.base_name)
        return with_region(f"{stem}:spot", region)


def tp_efficiency_curve(tp: int) -> float:
    """Parallel efficiency of a tp-way tensor-parallel engine, *excluding*
    the all-reduce traffic (charged explicitly from ``link_gbs`` by the
    engine model).  Covers shard imbalance, padding, and partially-overlapped
    collectives: each doubling of the shard count loses a few percent, with
    a floor — the same shape measured for intra-node TP in vLLM/TensorRT-LLM
    scaling studies (and matching the catalog's hand-set 0.9 for x2 nodes).
    """
    if tp <= 1:
        return 1.0
    return max(0.6, 1.0 - 0.06 * math.log2(tp) - 0.04 * (tp - 1) / tp)


def tp_variant(base: Accelerator, tp: int) -> Accelerator:
    """The (base, tp) engine instance: ``tp`` chips, aggregated roofline."""
    if tp < 1:
        raise ValueError(f"tp degree must be >= 1, got {tp}")
    if tp == 1:
        # keep the catalog name so existing profiles/allocations line up
        return dataclasses.replace(base, base_type=base.base_name, tp=1)
    if base.link_gbs <= 0:
        raise ValueError(
            f"{base.name}: tp={tp} variant needs link_gbs (interconnect "
            "bandwidth for TP collectives) on the base accelerator — "
            "without it the engine model would charge comm at a bogus rate")
    stem, region = split_region(base.name)
    return Accelerator(
        name=with_region(f"{stem}x{tp}", region),
        mem_gb=base.mem_gb * tp,
        bw_gbs=base.bw_gbs * tp,
        flops_tf=base.flops_tf * tp,
        price_hr=base.price_hr * tp,
        chips=base.chips * tp,
        tp_efficiency=base.tp_efficiency * tp_efficiency_curve(tp),
        # the per-GPU request cap is KV-block pressure, which shards with TP
        max_request_tokens=(base.max_request_tokens * tp
                            if base.max_request_tokens else None),
        base_type=base.base_name,
        tp=tp,
        link_gbs=base.link_gbs,
        tier=base.tier,
        spot_price_hr=(base.spot_price_hr * tp
                       if base.spot_price_hr is not None else None),
        # any one of the tp chips being reclaimed kills the whole engine
        # instance, so exposure scales with the chip count
        preemption_rate=base.preemption_rate * tp,
        region=base.region,
    )


def spot_variant(base: Accelerator) -> Accelerator:
    """The preemptible sibling of ``base``: identical silicon billed at the
    quoted spot rate, drawing on the *same* physical chip pool but its own
    ``"<base>:spot"`` market pool."""
    if base.is_spot:
        raise ValueError(f"{base.name} is already a spot entry")
    if base.spot_price_hr is None:
        raise ValueError(
            f"{base.name}: spot variant needs spot_price_hr on the base "
            "accelerator — without a quoted rate there is no spot market")
    if not (0 < base.spot_price_hr <= base.price_hr):
        raise ValueError(
            f"{base.name}: spot_price_hr={base.spot_price_hr} must be in "
            f"(0, price_hr={base.price_hr}] — spot never costs more than "
            "on-demand")
    stem, region = split_region(base.name)
    return dataclasses.replace(
        base, name=with_region(f"{stem}:spot", region),
        price_hr=base.spot_price_hr, tier="spot", base_type=base.base_name)


def region_variant(base: Accelerator, region: str, *,
                   price_mult: float = 1.0,
                   spot_price_mult: Optional[float] = None,
                   preemption_mult: float = 1.0) -> Accelerator:
    """The same SKU rented in cloud region ``region``: identical silicon,
    the region's price multiplier(s) and spot reclaim rate.  The region
    becomes the outermost pool level — the variant draws on the
    ``"<base>@<region>"`` chip pool (and, if spot, the
    ``"<base>:spot@<region>"`` market sub-pool), so a regional stockout
    caps only that region.  Composes with ``tp_variant``/``spot_variant``
    in any order; the emitted name always carries ``@region`` last."""
    if base.region:
        raise ValueError(
            f"{base.name} is already homed in region '{base.region}'")
    if not region or "@" in region or ":" in region:
        raise ValueError(
            f"invalid region name {region!r}: must be non-empty and free "
            "of '@'/':' (they delimit variant-name components)")
    if price_mult <= 0:
        raise ValueError(f"region '{region}': price_mult must be > 0")
    sp_mult = price_mult if spot_price_mult is None else spot_price_mult
    base_stem, _ = split_region(base.base_name)
    spot = None
    if base.spot_price_hr is not None:
        spot = base.spot_price_hr * sp_mult
        # reject rather than clamp: a silent clamp would make the emitted
        # price depend on whether the tier or the region expander ran
        # first.  The on-demand sibling always carries the spot quote, so
        # catalog-level expansion surfaces this in either order.
        if not base.is_spot and spot > base.price_hr * price_mult + 1e-12:
            raise ValueError(
                f"{base.name}@{region}: regional spot price {spot:.4f} "
                f"exceeds regional on-demand {base.price_hr * price_mult:.4f}"
                " — spot never costs more than on-demand; lower "
                "spot_price_mult")
    return dataclasses.replace(
        base,
        name=with_region(base.name, region),
        price_hr=(base.price_hr * price_mult if not base.is_spot
                  else base.price_hr * sp_mult),
        spot_price_hr=spot,
        preemption_rate=base.preemption_rate * preemption_mult,
        base_type=with_region(base_stem, region),
        region=region)


def expand_price_tiers(
        catalog: dict[str, "Accelerator"]) -> dict[str, "Accelerator"]:
    """Expand every entry that quotes a spot rate into {on-demand, spot}
    siblings (entries without ``spot_price_hr`` stay on-demand only).
    Composes with ``expand_tp_variants`` in either order: ``tp_variant``
    propagates the tier fields, so ``A100x2:spot`` == ``A100:spot`` x2."""
    out: dict[str, Accelerator] = {}
    for acc in catalog.values():
        if acc.is_spot:               # already tier-expanded: keep as-is
            out[acc.name] = acc
            continue
        out[acc.name] = acc
        if acc.spot_price_hr is not None:
            v = spot_variant(acc)
            out[v.name] = v
    return out


def pool_key(key: str, gpus: Mapping[str, "Accelerator"]) -> str:
    """Resolve a cap key to the pool it binds: a key naming a spot entry
    binds that base type's *spot market* sub-pool; any other catalog entry
    binds its physical chip pool; unknown keys are their own pool.  THE
    tier-to-pool rule — autoscaler and orchestrator pool lookups delegate
    here."""
    acc = gpus.get(key)
    return acc.market_pool if acc is not None else key


def chips_by_base(counts: dict[str, int],
                  gpus: dict[str, "Accelerator"]) -> dict[str, int]:
    """Aggregate per-variant instance counts into chips drawn from each
    base-type pool (Σ_tp tp·B_{g,tp}) — the single accounting used by
    allocations, the cluster engine, and the autoscaler's stockout caps.
    Names absent from ``gpus`` count as 1-chip instances of their own pool.
    """
    out: dict[str, int] = {}
    for g, n in counts.items():
        acc = gpus.get(g)
        base = acc.base_name if acc is not None else g
        chips = acc.chips if acc is not None else 1
        out[base] = out.get(base, 0) + chips * n
    return out


def chips_by_pool(counts: dict[str, int],
                  gpus: Mapping[str, "Accelerator"]) -> dict[str, int]:
    """Chips drawn per *pool*, at both cap granularities at once: every
    instance counts into its physical base pool (all tiers — the cloud's
    silicon is finite regardless of how it is billed), and spot instances
    additionally count into their ``"<base>:spot"`` market sub-pool.
    Superset of :func:`chips_by_base`; autoscaler cap bookkeeping reads
    whichever key a stockout recorded."""
    out = chips_by_base(counts, gpus)
    for g, n in counts.items():
        acc = gpus.get(g)
        if acc is not None and acc.is_spot:
            out[acc.market_pool] = out.get(acc.market_pool, 0) + acc.chips * n
    return out


def expand_tp_variants(
    catalog: dict[str, "Accelerator"],
    degrees: Iterable[int] = (1, 2, 4, 8),
) -> dict[str, "Accelerator"]:
    """Expand every base accelerator into its (type, tp) variant family."""
    out: dict[str, Accelerator] = {}
    for acc in catalog.values():
        for d in sorted(set(degrees)):
            v = tp_variant(acc, d)
            out[v.name] = v
    return out


def _tpu(name, chips, chip_flops_tf, chip_bw, chip_mem, price_per_chip):
    eff = 1.0 if chips == 1 else max(0.75, 1.0 - 0.04 * (chips.bit_length()))
    # slices of one generation share a chip pool (v5e-1/-4/-8 compete for
    # the same chips); their ICI overhead is already folded into eff, so
    # tp stays 1 and no extra collective traffic is charged.
    return Accelerator(
        name=name, chips=chips,
        mem_gb=chip_mem * chips, bw_gbs=chip_bw * chips,
        flops_tf=chip_flops_tf * chips,
        price_hr=price_per_chip * chips, tp_efficiency=eff,
        base_type=name.split("-")[0])


# --- the paper's GPU set (Table 1) --------------------------------------
# link_gbs: per-chip interconnect for TP collectives — PCIe 4.0 x16 for the
# workstation parts, NVLink for A100/H100.
# spot_price_hr / preemption_rate: representative cloud spot quotes (~60-70%
# below on-demand) and reclaim rates — scarcer parts are reclaimed more
# often.  Only exercised when the catalog is tier-expanded.
PAPER_GPUS = {
    "L4": Accelerator("L4", mem_gb=24, bw_gbs=300, flops_tf=121,
                      price_hr=0.70, max_request_tokens=12_000,
                      link_gbs=32, spot_price_hr=0.28,
                      preemption_rate=0.05),
    "A10G": Accelerator("A10G", mem_gb=24, bw_gbs=600, flops_tf=125,
                        price_hr=1.01, max_request_tokens=12_000,
                        link_gbs=32, spot_price_hr=0.40,
                        preemption_rate=0.08),
    "A100": Accelerator("A100", mem_gb=80, bw_gbs=1935, flops_tf=312,
                        price_hr=3.67, link_gbs=600, spot_price_hr=1.47,
                        preemption_rate=0.15),
    "H100": Accelerator("H100", mem_gb=80, bw_gbs=3350, flops_tf=989,
                        price_hr=7.516, link_gbs=900, spot_price_hr=3.01,
                        preemption_rate=0.25),
}

# Multi-GPU nodes for the Llama2-70b experiment (Fig. 8)
PAPER_GPUS_70B = {
    "A100x2": Accelerator("A100x2", mem_gb=160, bw_gbs=3870, flops_tf=624,
                          price_hr=7.34, chips=2, tp_efficiency=0.9),
    "H100x2": Accelerator("H100x2", mem_gb=160, bw_gbs=6700, flops_tf=1978,
                          price_hr=15.032, chips=2, tp_efficiency=0.9),
}

# --- TPU fleet (beyond-paper; public on-demand list prices) -------------
TPU_FLEET = {
    "v5e-1": _tpu("v5e-1", 1, 197, 819, 16, 1.20),
    "v5e-4": _tpu("v5e-4", 4, 197, 819, 16, 1.20),
    "v5e-8": _tpu("v5e-8", 8, 197, 819, 16, 1.20),
    "v4-8": _tpu("v4-8", 4, 275, 1228, 32, 3.22),   # v4 "8" = 4 chips
    "v5p-8": _tpu("v5p-8", 4, 459, 2765, 95, 4.20),
}

CATALOGS = {
    "paper": PAPER_GPUS,
    "paper70b": PAPER_GPUS_70B,
    "tpu": TPU_FLEET,
    "all": {**PAPER_GPUS, **TPU_FLEET},
}


def get_catalog(name: str) -> dict[str, Accelerator]:
    return dict(CATALOGS[name])

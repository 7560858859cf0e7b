"""The numpy-only control plane, copied from ``src/repro/core/``:
accelerators, workload buckets, the engine model, the MaxTput profile, the
load balancer, the load matrix, the ILP solver with its dominance pre-pass,
the Mélange allocator and the discrete-event simulator. The port allocates
and simulates on its own; the names below are those of
``src/repro/core/__init__.py`` that the port has (the autoscaler and the
cross-check harness are not copied)."""
from .accelerators import (Accelerator, PAPER_GPUS, PAPER_GPUS_70B, TPU_FLEET,
                           chips_by_base, chips_by_pool, expand_price_tiers,
                           expand_tp_variants, get_catalog, is_spot_pool,
                           pool_key, region_variant, split_region,
                           spot_variant, tp_efficiency_curve, tp_variant,
                           with_region)
from .allocator import Allocation, FleetAllocation, Melange, MelangeFleet
from .balancer import FleetBalancer, InstanceRef, LoadBalancer
from .engine_model import DEFAULT_ENGINE, EngineModel, EngineModelParams, ModelPerf
from .dominance import DominanceReduction, dominance_mask, reduce_problem
from .ilp import (ILPProblem, ILPSolution, counts_within_caps, solve,
                  solve_brute_force, solve_incremental,
                  spot_share_by_bucket)
from .loadmatrix import (FleetProblem, availability, build_fleet_problem,
                         build_problem)
from .profiler import Profile, profile_catalog, profile_from_dryrun
from .simulator import (ClusterEngine, FleetSimResult, InstanceEngine,
                        SimRequest, SimResult, simulate, simulate_fleet)
from .workload import (Bucket, ModelSpec, Workload, bucket_grid,
                       bucket_indices, edge_bucket, make_workload,
                       sample_requests, workload_from_samples)

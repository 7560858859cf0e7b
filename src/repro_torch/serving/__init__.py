"""Serving engine over the PyTorch model, and the heterogeneous cluster."""
from .engine import EngineConfig, Request, ServingEngine
from .cluster import ClusterStats, ServingCluster
from .kv_cache import BlockManager, OutOfBlocks
from .metrics import LatencyStats

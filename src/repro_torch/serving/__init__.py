"""Serving engine over the PyTorch model."""
from .engine import EngineConfig, Request, ServingEngine
from .kv_cache import BlockManager, OutOfBlocks
from .metrics import LatencyStats

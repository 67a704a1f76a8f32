"""Rank-aware logging: `logger` plus `log_dist(ranks=...)`, filtered by the
torch.distributed rank (0 when no process group is initialised).

Counterpart of deepspeed_tpu/utils/logging.py, which filters by the JAX
process index.
"""

import logging
import os
import sys

_LOG_FORMAT = "[%(asctime)s] [%(levelname)s] [%(name)s:%(lineno)d] %(message)s"


def _create_logger(name: str = "deepspeed_tpu_torch", level=None) -> logging.Logger:
    lg = logging.getLogger(name)
    if lg.handlers:
        return lg
    lg.setLevel(os.environ.get("DS_TPU_LOG_LEVEL", "INFO").upper() if level is None else level)
    lg.propagate = False
    handler = logging.StreamHandler(stream=sys.stdout)
    handler.setFormatter(logging.Formatter(_LOG_FORMAT))
    lg.addHandler(handler)
    return lg


logger = _create_logger()


def _process_index() -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def log_dist(message: str, ranks=None, level=logging.INFO) -> None:
    """Log `message` only on the listed ranks (None / [-1] = all)."""
    my_rank = _process_index()
    if ranks is None or -1 in ranks or my_rank in ranks:
        logger.log(level, f"[Rank {my_rank}] {message}")


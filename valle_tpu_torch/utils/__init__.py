"""Host helpers of the CLIs: the port's own copies of ``str2bool`` and
``setup_logger`` (``valle_tpu/utils/common.py``, which imports jax)."""

from __future__ import annotations

import argparse
import logging
import sys
from datetime import datetime
from pathlib import Path
from typing import Optional


def str2bool(v) -> bool:
    """argparse-friendly bool parser (same contract as icefall's)."""
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("Boolean value expected.")


def setup_logger(log_filename: Optional[str] = None,
                 log_level: str = "info", use_console: bool = True,
                 rank: int = 0, world_size: int = 1) -> None:
    """Per-process logging to a file and the console (parity with
    icefall's setup_logger)."""
    if log_filename is not None:
        date_time = datetime.now().strftime("%Y-%m-%d-%H-%M-%S")
        suffix = f"-{date_time}-{rank}" if world_size > 1 else f"-{date_time}"
        log_filename = f"{log_filename}{suffix}"
        Path(log_filename).parent.mkdir(parents=True, exist_ok=True)
    level = getattr(logging, log_level.upper(), logging.INFO)
    formatter = (f"%(asctime)s %(levelname)s [%(filename)s:%(lineno)d] "
                 f"({rank}/{world_size}) %(message)s")
    logging.basicConfig(level=level, format=formatter, filename=log_filename,
                        force=True)
    if use_console:
        console = logging.StreamHandler(sys.stderr)
        console.setLevel(level)
        console.setFormatter(logging.Formatter(formatter))
        logging.getLogger("").addHandler(console)

"""Host helpers of the CLIs: the port's own copies of ``AttributeDict``,
``str2bool``, ``setup_logger`` and ``get_env_info``
(``valle_tpu/utils/common.py``, which imports jax)."""

from __future__ import annotations

import argparse
import logging
import os
import sys
from datetime import datetime
from pathlib import Path
from typing import Optional


class AttributeDict(dict):
    """dict with attribute access; the runtime 'params' bag for CLIs."""

    def __getattr__(self, key):
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __setattr__(self, key, value):
        self[key] = value

    def __delattr__(self, key):
        try:
            del self[key]
        except KeyError as e:
            raise AttributeError(key) from e


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
    icefall's setup_logger). Without a file the root handler already
    writes to stderr, so no second console handler is added (each line
    would print twice)."""
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
    if use_console and log_filename is not None:
        console = logging.StreamHandler(sys.stderr)
        console.setLevel(level)
        console.setFormatter(logging.Formatter(formatter))
        logging.getLogger("").addHandler(console)


def get_env_info() -> dict:
    """Environment snapshot persisted into checkpoints for forensics: the
    PyTorch and CUDA versions and the card the run sees."""
    import torch

    cuda = torch.cuda.is_available()
    return {
        "torch-version": torch.__version__,
        "torch-cuda-version": torch.version.cuda,
        "python-version": sys.version.split()[0],
        "device-count": torch.cuda.device_count() if cuda else 0,
        "device-name": torch.cuda.get_device_name(0) if cuda else None,
        "hostname": os.uname().nodename,
    }

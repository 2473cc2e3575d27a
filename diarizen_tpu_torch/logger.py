"""Logging set-up: console and per-experiment file handlers (port of
diarizen_tpu/logger.py). The level comes from the argument or the LOG_LEVEL
environment variable (default INFO)."""

from __future__ import annotations

import json
import logging
import os
import sys
from pathlib import Path
from typing import Optional, Union

FORMAT = "%(asctime)s [%(levelname)s] %(name)s: %(message)s"


def init_logging(exp_dir: Optional[Union[str, Path]] = None, level: Optional[str] = None,
                 filename: str = "train.log") -> logging.Logger:
    """Configure the `diarizen_tpu_torch` logger: stderr, and with `exp_dir`
    also `exp_dir/filename`. Calling it again replaces the handlers."""
    level = (level or os.environ.get("LOG_LEVEL", "INFO")).upper()
    logger = logging.getLogger("diarizen_tpu_torch")
    logger.setLevel(level)
    for handler in logger.handlers:
        handler.close()
    logger.handlers.clear()
    console = logging.StreamHandler(sys.stderr)
    console.setFormatter(logging.Formatter(FORMAT))
    logger.addHandler(console)
    if exp_dir is not None:
        exp_dir = Path(exp_dir)
        exp_dir.mkdir(parents=True, exist_ok=True)
        fh = logging.FileHandler(exp_dir / filename)
        fh.setFormatter(logging.Formatter(FORMAT))
        logger.addHandler(fh)
    logger.propagate = False
    return logger


def log_config(logger: logging.Logger, config: dict) -> None:
    logger.info("configuration:\n%s", json.dumps(config, indent=2, default=str))

"""Logging and metric loggers (``matinvent_tpu/pipeline/logger.py``).

``CSVLogger`` rewrites ``<save_dir>/<fname>.csv`` after every row, with the
columns in the order they first appear, as the JAX package's pandas logger
writes them (an empty field where a row has no value). ``PhaseTimer`` times
the phases of an RL iteration. The wandb logger is not ported.
"""
from __future__ import annotations

import csv
import logging
import math
import os
import sys
import time
from contextlib import contextmanager
from typing import Any

import numpy as np


class SeverityLevelBetween(logging.Filter):
    def __init__(self, min_level: int, max_level: int) -> None:
        super().__init__()
        self.min_level = min_level
        self.max_level = max_level

    def filter(self, record) -> bool:
        return self.min_level <= record.levelno < self.max_level


def setup_logging() -> None:
    """INFO and below to stdout, WARNING and above to stderr (level from
    ``LOGLEVEL``)."""
    root = logging.getLogger()
    target = getattr(logging, os.environ.get("LOGLEVEL", "INFO").upper())
    root.setLevel(target)
    if not root.hasHandlers():
        fmt = logging.Formatter(
            "%(asctime)s (%(levelname)s): %(message)s", datefmt="%Y-%m-%d %H:%M:%S"
        )
        out = logging.StreamHandler(sys.stdout)
        out.addFilter(SeverityLevelBetween(target, logging.WARNING))
        out.setFormatter(fmt)
        root.addHandler(out)
        err = logging.StreamHandler(sys.stderr)
        err.setLevel(logging.WARNING)
        err.setFormatter(fmt)
        root.addHandler(err)


class Logger:
    """Base metric logger with split prefixes."""

    def log(self, update_dict: dict, step: int, split: str = ""):
        assert step is not None
        if split:
            update_dict = {f"{split}/{k}": v for k, v in update_dict.items()}
        return update_dict


def _field(v: Any) -> str:
    """One CSV field: empty for a missing or NaN value, floats as repr."""
    if v is None:
        return ""
    if isinstance(v, (float, np.floating)):
        return "" if math.isnan(v) else repr(float(v))
    if isinstance(v, np.integer):
        return str(int(v))
    return str(v)


class CSVLogger(Logger):
    """Appends a row per step and rewrites ``<save_dir>/<fname>.csv``."""

    def __init__(self, save_dir: str, fname: str = "metrics"):
        self.save_dir = save_dir
        self.fname = fname
        os.makedirs(save_dir, exist_ok=True)
        self.rows: list[dict] = []
        self.columns: list[str] = []

    def log(self, update_dict: dict, step: int, split: str = "") -> None:
        row = dict(super().log(update_dict, step, split))
        row["step"] = step
        self.rows.append(row)
        self.columns.extend(k for k in row if k not in self.columns)
        with open(os.path.join(self.save_dir, f"{self.fname}.csv"), "w", newline="") as fh:
            w = csv.writer(fh)
            w.writerow(self.columns)
            for r in self.rows:
                w.writerow([_field(r.get(c)) for c in self.columns])


class PhaseTimer:
    """Wall-clock time of each phase (sample, score, finetune) of an iteration."""

    def __init__(self):
        self.times: dict[str, float] = {}

    @contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.times[f"time_{name}_s"] = time.perf_counter() - t0

    def pop(self) -> dict[str, float]:
        out, self.times = self.times, {}
        return out

"""Logging and metric loggers (``matinvent_tpu/pipeline/logger.py``).

``CSVLogger`` rewrites ``<save_dir>/<fname>.csv`` after every row, with the
columns in the order they first appear, as the JAX package's pandas logger
writes them (an empty field where a row has no value); it starts from the
rows of an existing file, so a resumed run appends to them. ``PhaseTimer``
times the phases of an RL iteration. ``WandBLogger`` logs to wandb where
that package is installed, and raises ``ImportError`` where it is not; its
``watch``, ``log_summary``, ``mark_preempting``, ``log_artifact`` and
``finish`` make the JAX package's calls, and every logger takes its
``config=`` (the base ``log_summary`` and ``finish`` do nothing).
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
    """Base metric logger with split prefixes; ``config`` is the run's
    configuration, kept for the loggers that record it."""

    def __init__(self, config=None) -> None:
        self.config = config

    def log(self, update_dict: dict, step: int, split: str = ""):
        assert step is not None
        if split:
            update_dict = {f"{split}/{k}": v for k, v in update_dict.items()}
        return update_dict

    def log_summary(self, summary_dict: dict[str, Any]) -> None:
        pass

    def finish(self) -> None:
        pass


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

    def __init__(self, save_dir: str, fname: str = "metrics", config=None, **kwargs):
        super().__init__(config)
        self.save_dir = save_dir
        self.fname = fname
        os.makedirs(save_dir, exist_ok=True)
        self.rows: list[dict] = []
        self.columns: list[str] = []
        existing = os.path.join(save_dir, f"{fname}.csv")
        if os.path.exists(existing):
            with open(existing, newline="") as fh:
                reader = csv.reader(fh)
                self.columns = next(reader, [])
                self.rows = [
                    {c: v for c, v in zip(self.columns, r) if v != ""} for r in reader
                ]

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


class WandBLogger(Logger):
    """Logs each row to a wandb run; ``wandb`` is optional and the card
    machine has none."""

    def __init__(
        self,
        name: str,
        project: str,
        entity: str | None = None,
        group: str | None = None,
        mode: str = "online",
        config=None,
        **kwargs,
    ):
        super().__init__(config)
        try:
            import wandb
        except ImportError as e:
            raise ImportError("wandb is not installed in this environment; use logger=csv") from e
        self._wandb = wandb
        wandb.init(name=name, project=project, entity=entity, group=group, mode=mode,
                   config=config, **kwargs)

    def watch(self, model, log="all", log_freq: int = 1000) -> None:
        self._wandb.watch(model, log=log, log_freq=log_freq)

    def log(self, update_dict: dict, step: int, split: str = "") -> None:
        self._wandb.log(super().log(update_dict, step, split), step=int(step))

    def log_summary(self, summary_dict: dict[str, Any]) -> None:
        for k, v in summary_dict.items():
            self._wandb.run.summary[k] = v

    def mark_preempting(self) -> None:
        self._wandb.mark_preempting()

    def log_artifact(self, name: str, type: str, file_location: str) -> None:
        art = self._wandb.Artifact(name=name, type=type)
        art.add_file(file_location)
        art.save()

    def finish(self) -> None:
        self._wandb.finish()


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

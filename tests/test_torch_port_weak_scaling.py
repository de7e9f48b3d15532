"""The port's weak-scaling harness (``matinvent_tpu_torch.experiments.weak_scaling``),
on the CPU over gloo ranks, at the reduced shapes of
``tests/test_weak_scaling.py``: per-rank batch 8, max atoms 6, T = 24, h32,
1 layer, DDPO T = 8, 2 repeats.

The tier-1 test runs 1 and 2 ranks and checks the record (its keys, the
overhead definition, finite overheads, 1.0 at one rank); it gates no
timing. The bound, JAX's 1.3x on the largest overhead over the measured
rank counts, is held by the test marked ``slow``, as JAX's is: wall-clock
times of 20-100 ms on a machine shared with other jobs vary too much for
a tier-1 gate.
"""
from __future__ import annotations

import json
import math
import os

import pytest

from matinvent_tpu_torch.experiments import weak_scaling

REDUCED = dict(per_rank_batch=8, max_atoms=6, timesteps=24, hidden=32, layers=1,
               ddpo_timesteps=8, repeats=2)


def test_harness_writes_its_record_at_one_and_two_ranks(tmp_path):
    out = tmp_path / "weak.json"
    args = ["--ranks", "1,2", "--out", str(out)] + [
        a for k, v in REDUCED.items() for a in (f"--{k.replace('_', '-')}", str(v))]
    res = weak_scaling.main(args)
    rec = json.loads(out.read_text())
    assert rec["ranks"] == [1, 2] and rec["config"] == REDUCED
    assert rec["overhead_definition"].startswith("overhead(n) = wall(n) / wall(1)")
    assert rec["bound"] == 1.3 and rec["cores"] == len(os.sched_getaffinity(0))
    for kind in ("sample", "ddpo"):
        assert set(rec[f"{kind}_s"]) == set(rec[f"{kind}_overhead"]) == {"1", "2"}
        assert all(math.isfinite(v) and v > 0 for v in rec[f"{kind}_s"].values())
        assert all(math.isfinite(v) for v in rec[f"{kind}_overhead"].values())
        assert rec[f"{kind}_overhead"]["1"] == 1.0
    assert res["sample_overhead"][2] == rec["sample_overhead"]["2"]


@pytest.mark.slow
def test_dp_weak_scaling_overhead_under_1p3():
    """The largest overhead over every measured rank count (up to 8, as
    the cores allow) stays under JAX's 1.3x; one remeasure on failure, as
    JAX's test allows."""
    for _ in range(2):
        res = weak_scaling.measure(ranks=(1, 2, 4, 8), **REDUCED)
        worst = {k: max(res[k].values()) for k in ("sample_overhead", "ddpo_overhead")}
        if all(v < weak_scaling.BOUND for v in worst.values()):
            return
    assert all(v < weak_scaling.BOUND for v in worst.values()), (
        worst, res["sample_s"], res["ddpo_s"])

"""Run state of an RL run, for resume (``matinvent_tpu/utils/checkpoint.py``).

What the JAX package's run state holds, in the port's own files under
``<save_dir>/state/``:

* ``agent_state_dict.npz``: the agent's weights;
* ``tables.npz``: the long-term memory's and the replay buffer's rows
  (structures, rewards, RL steps, the replay rows' per-crystal dicts);
* ``run_state.json``: ``step`` and ``cost``, the sampler's numpy generator
  and torch generator states, the fine-tune generator's state and the
  replay buffer's numpy generator state (torch states as base64 bytes).

There is no optimizer state: the fine-tune starts a fresh Adam each
iteration. Each file is written to a temporary name and moved into place
with ``os.replace``; ``run_state.json`` goes last, and every file carries
the step, so a state whose files disagree raises on load. The files differ
from the JAX package's (``agent_params.msgpack`` and a pickle).
"""
from __future__ import annotations

import base64
import json
import os
from typing import Any

import numpy as np
import torch

from matinvent_tpu_torch.chem.structure import Structure
from matinvent_tpu_torch.memory.table import Row, comp_keys

AGENT_FILE = "agent_state_dict.npz"
TABLES_FILE = "tables.npz"
STATE_FILE = "run_state.json"
FORMAT = 1


def generator_state(gen: torch.Generator | None) -> str | None:
    """A torch generator's state (a CPU byte tensor, also for a CUDA
    generator) as base64 text."""
    if gen is None:
        return None
    return base64.b64encode(gen.get_state().numpy().tobytes()).decode("ascii")


def set_generator_state(gen: torch.Generator, text: str) -> None:
    raw = np.frombuffer(base64.b64decode(text), dtype=np.uint8).copy()
    gen.set_state(torch.from_numpy(raw))


def _write_atomic(path: str, write) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        write(fh)
    os.replace(tmp, path)


def _pack_rows(prefix: str, rows: list[Row], out: dict[str, np.ndarray]) -> dict:
    """The rows' structures, rewards and per-row fields into ``out``; returns
    the meta data that ``_unpack_rows`` needs."""
    strucs = [r["struc"] for r in rows]
    out[f"{prefix}.lattice"] = np.array([s.lattice for s in strucs]).reshape(-1, 3, 3)
    out[f"{prefix}.num_atoms"] = np.array([s.num_atoms for s in strucs], dtype=np.int64)
    out[f"{prefix}.species"] = np.concatenate([s.species for s in strucs] or [np.zeros(0, np.int64)])
    out[f"{prefix}.frac"] = np.concatenate([s.frac_coords for s in strucs] or [np.zeros((0, 3))])
    out[f"{prefix}.reward"] = np.array([r["reward"] for r in rows], dtype=np.float64)
    meta: dict[str, Any] = {"n": len(rows), "ints": [], "data": {}}
    if rows and "RL_step" in rows[0]:
        out[f"{prefix}.RL_step"] = np.array([r["RL_step"] for r in rows], dtype=np.int64)
        meta["ints"].append("RL_step")
    if rows and "data" in rows[0]:
        for key in rows[0]["data"]:
            vals = [r["data"][key] for r in rows]
            if all(isinstance(v, int) for v in vals):
                out[f"{prefix}.data.{key}"] = np.array(vals, dtype=np.int64)
                meta["data"][key] = "int"
            else:
                arrs = [np.asarray(v) for v in vals]
                out[f"{prefix}.data.{key}.flat"] = np.concatenate([a.ravel() for a in arrs])
                out[f"{prefix}.data.{key}.shape"] = np.array([a.shape for a in arrs], dtype=np.int64)
                meta["data"][key] = "array"
    return meta


def _unpack_rows(prefix: str, meta: dict, z) -> list[Row]:
    n = meta["n"]
    counts = z[f"{prefix}.num_atoms"]
    ends = np.cumsum(counts)
    starts = ends - counts
    strucs = [
        Structure(z[f"{prefix}.lattice"][i], z[f"{prefix}.species"][a:b], z[f"{prefix}.frac"][a:b])
        for i, (a, b) in enumerate(zip(starts, ends))
    ]
    comps, ele_comb = comp_keys(strucs)
    rows = [
        dict(struc=s, comp=c, ele_comb=e, reward=float(r))
        for s, c, e, r in zip(strucs, comps, ele_comb, z[f"{prefix}.reward"])
    ]
    for key in meta["ints"]:
        for row, v in zip(rows, z[f"{prefix}.{key}"]):
            row[key] = int(v)
    if meta["data"]:
        data = [dict() for _ in range(n)]
        for key, kind in meta["data"].items():
            if kind == "int":
                for d, v in zip(data, z[f"{prefix}.data.{key}"]):
                    d[key] = int(v)
                continue
            flat, shapes = z[f"{prefix}.data.{key}.flat"], z[f"{prefix}.data.{key}.shape"]
            sizes = [int(np.prod(s)) for s in shapes]
            offsets = np.concatenate([[0], np.cumsum(sizes)])
            for i, d in enumerate(data):
                d[key] = flat[offsets[i]:offsets[i + 1]].reshape(tuple(shapes[i])).copy()
        # a replay row: its per-crystal dict first, as ReplayBuffer.extend orders it
        rows = [dict(data=d, **row) for d, row in zip(data, rows)]
    return rows


def save_run_state(
    state_dir: str,
    agent: torch.nn.Module,
    step: int,
    cost: int,
    sampler,
    finetune_generator: torch.Generator,
    ltm,
    replay=None,
) -> None:
    os.makedirs(state_dir, exist_ok=True)
    sd = {k: v.detach().cpu().numpy() for k, v in agent.state_dict().items()}
    sd["__step__"] = np.array(step)
    _write_atomic(os.path.join(state_dir, AGENT_FILE), lambda fh: np.savez(fh, **sd))
    arrays: dict[str, np.ndarray] = {"__step__": np.array(step)}
    tables = {"ltm": _pack_rows("ltm", ltm.memory, arrays)}
    if replay is not None:
        tables["replay"] = _pack_rows("replay", replay.buffer, arrays)
    _write_atomic(os.path.join(state_dir, TABLES_FILE), lambda fh: np.savez(fh, **arrays))
    host = dict(
        format=FORMAT,
        step=int(step),
        cost=int(cost),
        sampler=dict(rng=sampler._rng.bit_generator.state,
                     generator=generator_state(sampler._generator)),
        finetune_generator=generator_state(finetune_generator),
        replay_rng=None if replay is None else replay._rng.bit_generator.state,
        tables=tables,
    )
    _write_atomic(os.path.join(state_dir, STATE_FILE),
                  lambda fh: fh.write(json.dumps(host, indent=1).encode()))


def load_run_state(state_dir: str):
    """``(agent state dict of tensors, host state, {"ltm": rows, "replay":
    rows or None})``, or None when ``state_dir`` holds no run state."""
    paths = [os.path.join(state_dir, f) for f in (AGENT_FILE, TABLES_FILE, STATE_FILE)]
    if not all(os.path.exists(p) for p in paths):
        return None
    with open(paths[2]) as fh:
        host = json.load(fh)
    if host.get("format") != FORMAT:
        raise ValueError(f"{paths[2]}: unknown run-state format {host.get('format')}")
    with np.load(paths[0]) as z:
        sd = {k: torch.from_numpy(z[k]) for k in z.files if k != "__step__"}
        agent_step = int(z["__step__"])
    with np.load(paths[1]) as z:
        tables_step = int(z["__step__"])
        tables = {name: _unpack_rows(name, meta, z) for name, meta in host["tables"].items()}
    if not agent_step == tables_step == host["step"]:
        raise ValueError(
            f"run state in {state_dir} is torn: steps {agent_step}, {tables_step}, {host['step']}"
        )
    tables.setdefault("replay", None)
    return sd, host, tables

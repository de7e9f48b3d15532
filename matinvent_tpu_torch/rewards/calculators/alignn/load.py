"""Loading published ALIGNN checkpoints for the port's forward
(``matinvent_tpu/rewards/calculators/alignn/load.py``).

Both distribution formats of the published checkpoints, as the JAX package
reads them:

* the **HF folder** (``jwchen25/MatInvent`` ``prop_pred/alignn/<task>/``):
  ``best_model.pt``, a raw ``state_dict``, and ``config.json`` with a
  ``"model"`` sub-dict (the ALIGNNAtomWise config);
* the **figshare zip**: a ``.zip`` holding ``config.json`` and
  ``best_model.pt`` (or ``checkpoint_*.pt``) whose payload nests the state
  dict under ``"model"``;
* and a bare ``.pt`` with a sibling ``config.json``.

Nothing is downloaded: the paths name files already fetched. ``torch.load``
reads the payload with ``weights_only=True`` first; a payload that needs
pickled objects beyond tensors (older Lightning checkpoints) is read again
with ``weights_only=False``, as the JAX package does, which runs the
pickle's code: load only checkpoints from a source you trust. The
parameters keep their torch names (the names are the architecture's
binding, ``.model``) and go to the caller's device.

The atom input features of the published checkpoints are the 92-dim CGCNN
``atom_init.json`` table, a distributed file, not a formula: it is looked
up next to the checkpoint, one folder up, at ``$ALIGNN_ATOM_INIT``, or
beside this module; a missing table is an error, not a fallback.
"""
from __future__ import annotations

import io
import json
import os
import zipfile
from typing import Tuple

import numpy as np
import torch

from matinvent_tpu_torch.rewards.calculators.alignn.model import ALIGNNSpec, detect_norm_kind


def _torch_load_cpu(data: bytes):
    buf = io.BytesIO(data)
    try:
        return torch.load(buf, map_location="cpu", weights_only=True)
    except Exception:
        buf.seek(0)
        return torch.load(buf, map_location="cpu", weights_only=False)


def _to_state_dict(payload) -> dict:
    """Unwrap {'model': sd} / Lightning-style containers to a flat sd."""
    sd = payload
    if isinstance(sd, dict) and "model" in sd and isinstance(sd["model"], dict):
        inner = sd["model"]
        # distinguish a state_dict under 'model' from a config blob
        if any(hasattr(v, "numpy") or isinstance(v, np.ndarray) for v in inner.values()):
            sd = inner
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    out = {}
    for k, v in sd.items():
        k = k.removeprefix("module.")
        if hasattr(v, "numpy"):
            v = v.detach().cpu().numpy()
        if isinstance(v, np.ndarray) and v.dtype != object:
            out[k] = v
    return out


def find_atom_init(near: str | None = None) -> str | None:
    """Locate the CGCNN ``atom_init.json`` feature table."""
    candidates = []
    if near:
        base = near if os.path.isdir(near) else os.path.dirname(near)
        candidates.append(os.path.join(base, "atom_init.json"))
        candidates.append(os.path.join(os.path.dirname(base), "atom_init.json"))
    if os.environ.get("ALIGNN_ATOM_INIT"):
        candidates.append(os.environ["ALIGNN_ATOM_INIT"])
    candidates.append(
        os.path.join(os.path.dirname(os.path.abspath(__file__)), "atom_init.json")
    )
    for c in candidates:
        if c and os.path.exists(c):
            return c
    return None


def load_atom_table(path: str | None, n_features: int) -> np.ndarray:
    """[101, n_features] table indexed by atomic number.

    ``n_features == 1`` is the ``atom_features="atomic_number"`` mode (the
    raw Z); anything else requires the distributed embedding json
    ({"<Z>": [features...]})."""
    if n_features == 1:
        return np.arange(101, dtype=np.float32)[:, None]
    if path is None:
        raise FileNotFoundError(
            "ALIGNN checkpoints use the CGCNN atom_init.json embedding "
            "table (92-dim); place it next to the checkpoint, set "
            "$ALIGNN_ATOM_INIT, or pass atom_init= explicitly. The file "
            "ships with the cgcnn/alignn distributions the checkpoints "
            "come from."
        )
    with open(path) as fh:
        raw = json.load(fh)
    table = np.zeros((101, n_features), dtype=np.float32)
    for key, feats in raw.items():
        z = int(key)
        if 0 <= z <= 100:
            feats = np.asarray(feats, dtype=np.float32)
            if feats.shape[0] != n_features:
                raise ValueError(
                    f"atom_init.json provides {feats.shape[0]}-dim features; "
                    f"checkpoint expects {n_features}"
                )
            table[z] = feats
    return table


def load_alignn_checkpoint(
    path: str, atom_init: str | None = None, device: str | torch.device = "cpu",
) -> Tuple[dict, ALIGNNSpec, torch.Tensor]:
    """(params, spec, atom table) of an HF folder, a figshare zip or a bare
    ``.pt`` with a sibling ``config.json``: the parameters as f32 tensors
    (integer buffers as they are) and the ``[101, features]`` table, on
    ``device``."""
    if os.path.isdir(path):
        ckpt_file = None
        for name in ("best_model.pt", "last.pt", "model.pt"):
            cand = os.path.join(path, name)
            if os.path.exists(cand):
                ckpt_file = cand
                break
        if ckpt_file is None:
            pts = sorted(f for f in os.listdir(path) if f.endswith(".pt"))
            if not pts:
                raise FileNotFoundError(f"no .pt checkpoint under {path}")
            ckpt_file = os.path.join(path, pts[0])
        with open(os.path.join(path, "config.json")) as fh:
            config = json.load(fh)
        with open(ckpt_file, "rb") as fh:
            payload = _torch_load_cpu(fh.read())
    elif path.endswith(".zip"):
        zp = zipfile.ZipFile(path)
        names = zp.namelist()
        cfg_name = next(n for n in names if n.endswith("config.json"))
        ckpt_name = None
        for n in names:
            if n.endswith("best_model.pt"):
                ckpt_name = n
        if ckpt_name is None:
            for n in names:
                if "checkpoint_" in n and n.endswith(("pt", "pth")):
                    ckpt_name = n  # last one wins, like the reference loop
        if ckpt_name is None:
            raise FileNotFoundError(f"no checkpoint member inside {path}")
        config = json.loads(zp.read(cfg_name))
        payload = _torch_load_cpu(zp.read(ckpt_name))
    else:  # bare .pt + sibling config.json
        with open(os.path.join(os.path.dirname(path), "config.json")) as fh:
            config = json.load(fh)
        with open(path, "rb") as fh:
            payload = _torch_load_cpu(fh.read())

    sd = _to_state_dict(payload)
    if "fc.weight" not in sd or "atom_embedding.layer.0.weight" not in sd:
        raise ValueError(
            f"{path} does not look like an ALIGNN/ALIGNNAtomWise state dict "
            f"(missing fc/atom_embedding keys); got e.g. "
            f"{sorted(sd)[:5]}"
        )
    model_cfg = config.get("model", config)
    # options whose semantics this forward does not implement: refused
    # rather than mispredicted
    unsupported = {
        "use_cutoff_function": False,
        "zero_inflated": False,
        "extra_features": 0,
        "lg_on_fly": None,  # graph-build choice, no numeric effect
    }
    for key, ok_value in unsupported.items():
        if ok_value is None:
            continue
        if key in model_cfg and model_cfg[key] not in (ok_value, None):
            raise ValueError(
                f"checkpoint config sets {key}={model_cfg[key]}, which this "
                f"ALIGNN forward does not implement: refusing to load rather "
                f"than mispredict"
            )
    spec = ALIGNNSpec.from_model_config(model_cfg, detect_norm_kind(sd))

    # shape validation against the spec before anything silently broadcasts
    got_hidden = sd["fc.weight"].shape[1]
    if got_hidden != spec.hidden_features:
        raise ValueError(
            f"checkpoint hidden width {got_hidden} != config "
            f"hidden_features {spec.hidden_features}"
        )
    got_atom_in = sd["atom_embedding.layer.0.weight"].shape[1]
    if got_atom_in != spec.atom_input_features:
        raise ValueError(
            f"checkpoint atom_input_features {got_atom_in} != config "
            f"{spec.atom_input_features}"
        )

    dev = torch.device(device)
    params = {
        k: torch.as_tensor(v.astype(np.float32) if v.dtype.kind == "f" else v).to(dev)
        for k, v in sd.items()
    }
    table = load_atom_table(
        atom_init or find_atom_init(near=path), spec.atom_input_features
    )
    return params, spec, torch.as_tensor(table).to(dev)

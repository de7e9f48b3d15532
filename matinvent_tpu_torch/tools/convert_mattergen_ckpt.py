"""Convert MatterGen-class checkpoints between the torch container and the
native format (``tools/convert_mattergen_ckpt.py`` of the JAX package).

    # torch container (``{"state_dict", "config"}`` in ``last.ckpt``) -> native
    python -m matinvent_tpu_torch.tools.convert_mattergen_ckpt to_native \\
        in=<last.ckpt> out=<dir> [config=<config.yaml>] [hidden_dim=256 ...] [device=cpu]

    # native (``params.msgpack`` + ``config.yaml``) -> torch container
    python -m matinvent_tpu_torch.tools.convert_mattergen_ckpt to_torch \\
        in=<native_dir> out=<dir> [device=cpu]

``to_native`` takes the model config from the container's embedded
``config``, then the ``config=`` file, then the ``key=value`` overrides
(each read as YAML), in that order, keeping only ``MatterGenConfig``'s
fields. It builds the score net on the device (the card unless
``device=cpu``) as the template of the weights' names and shapes, maps the
state dict onto it (``mattergen_import``), and writes ``params.msgpack``
in flax's ``to_bytes`` layout and ``config.yaml`` with the JAX config's
fields (``fused_edge_sampling``, which the port lacks, as false). Both
packages' ``MatterGenSuite`` load the result. ``to_torch`` writes
``last.ckpt`` with ``torch.save`` and the same ``config.yaml``.

A GemNet-style state dict (the published MatterGen weights, another
architecture) raises ``ValueError``, as does a shape that differs from the
config's; the way from those weights to this network is distillation
(``python -m matinvent_tpu_torch.tools.distill_mattergen``).
"""
from __future__ import annotations

import os
import sys
from typing import Any, Mapping

import numpy as np
import torch

from matinvent_tpu_torch.device import resolve_device
from matinvent_tpu_torch.main import pop_device
from matinvent_tpu_torch.models.mattergen.diffusion import MatterGenConfig, MatterGenDiffusion
from matinvent_tpu_torch.models.suite.mattergen import params_to_jax
from matinvent_tpu_torch.models.suite.mattergen_import import (
    mattergen_params_from_state_dict,
    mattergen_state_dict_from_params,
)
from matinvent_tpu_torch.utils import msgpack
from matinvent_tpu_torch.utils.config import write_flat_yaml
from matinvent_tpu_torch.utils.yaml_io import load_yaml, read_yaml


def load_container(path: str) -> tuple[dict[str, np.ndarray], Any]:
    """(state dict as numpy arrays, embedded config or None) of a torch
    checkpoint: a ``{"state_dict", "config"}`` container or a bare state
    dict."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict) and "state_dict" in ckpt:
        sd, cfg = ckpt["state_dict"], ckpt.get("config")
    else:
        sd, cfg = ckpt, None
    sd = {k: (v.numpy() if hasattr(v, "numpy") else np.asarray(v)) for k, v in sd.items()}
    return sd, cfg


def override_value(text: str) -> Any:
    """A ``key=value`` override's value as ``yaml.safe_load`` reads it (the
    text itself where it is not YAML)."""
    try:
        return load_yaml(text)
    except ValueError:
        return text


def _plain(v: Any) -> Any:
    return [_plain(x) for x in v] if isinstance(v, (list, tuple)) else v


def config_values(config: MatterGenConfig) -> dict[str, Any]:
    """The JAX config's fields of ``config``, tuples as lists, for
    ``config.yaml`` and the container's ``config``."""
    out = {f: _plain(getattr(config, f)) for f in MatterGenConfig.__dataclass_fields__}
    out["fused_edge_sampling"] = False
    return dict(sorted(out.items()))


def _sorted_tree(node: Mapping[str, Any]) -> dict:
    """``node`` with every level's keys sorted, as JAX's tree of a dict."""
    return {k: _sorted_tree(node[k]) if isinstance(node[k], Mapping) else node[k]
            for k in sorted(node)}


def _template(config: MatterGenConfig, device) -> dict:
    model = MatterGenDiffusion(config, device=device)
    return params_to_jax(model.state_dict(), model)


def to_native(argv: list[str], device=None) -> str:
    kv = dict(a.split("=", 1) for a in argv if "=" in a)
    in_path, out_dir = kv.pop("in"), kv.pop("out")
    sd, embedded_cfg = load_container(in_path)

    cfg_kwargs: dict = {}
    if isinstance(embedded_cfg, dict):
        cfg_kwargs.update(embedded_cfg)
    cfg_file = kv.pop("config", None)
    if cfg_file:
        cfg_kwargs.update(read_yaml(cfg_file) or {})
    # CLI overrides, e.g. hidden_dim=256
    cfg_kwargs.update({k: override_value(v) for k, v in kv.items()})
    config = MatterGenConfig.from_dict(cfg_kwargs)
    params = mattergen_params_from_state_dict(sd, _template(config, resolve_device(device)))

    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "params.msgpack"), "wb") as fh:
        fh.write(msgpack.packb(_sorted_tree(params)))
    write_flat_yaml(os.path.join(out_dir, "config.yaml"), config_values(config))
    print(f"converted {in_path} -> {out_dir}/params.msgpack (+config.yaml)")
    return out_dir


def to_torch(argv: list[str], device=None) -> str:
    kv = dict(a.split("=", 1) for a in argv if "=" in a)
    in_dir, out_dir = kv["in"], kv["out"]
    config = MatterGenConfig.from_dict(read_yaml(os.path.join(in_dir, "config.yaml")))
    template = _template(config, resolve_device(device))
    with open(os.path.join(in_dir, "params.msgpack"), "rb") as fh:
        params = msgpack.restore(template, msgpack.unpackb(fh.read()))
    sd = {k: torch.from_numpy(v) for k, v in mattergen_state_dict_from_params(params).items()}
    cfg_out = config_values(config)
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, "last.ckpt")
    torch.save({"state_dict": sd, "config": cfg_out}, out_path)
    write_flat_yaml(os.path.join(out_dir, "config.yaml"), cfg_out)
    print(f"converted {in_dir} -> {out_path} (+config.yaml)")
    return out_path


def main(argv: list[str] | None = None) -> str:
    argv, device = pop_device(list(sys.argv[1:] if argv is None else argv))
    if not argv or argv[0] not in ("to_native", "to_torch"):
        raise SystemExit(__doc__)
    return (to_native if argv[0] == "to_native" else to_torch)(argv[1:], device)


if __name__ == "__main__":
    main()

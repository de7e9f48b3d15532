"""The config engine of the entry points, and the reader and writer of the
flat ``config.yaml`` that MatterGen checkpoints carry.

The engine is ``matinvent_tpu/utils/config.py``'s Hydra-style one, on the
port's own YAML reader (``utils/yaml_io.py``):

* config groups: ``defaults: [{pipeline: mat_invent}, {model: diffcsp}, ...]``
  load ``configs/<group>/<name>.yaml`` into ``cfg[group]``;
* overrides: ``group=name`` switches a group file, ``a.b.c=value`` sets a
  leaf (list indices included; the value read as YAML, ``1e-4`` as a
  float), ``+a.b=v`` adds one;
* interpolation: ``${path.to.key}`` and ``${calc:'<arith expr>'}`` (numbers
  and arithmetic only);
* instantiation: ``_target_`` nodes become objects, recursively unless
  ``_recursive_: false``. A target under ``matinvent_tpu.`` resolves to the
  same path under ``matinvent_tpu_torch.``; a target the port lacks raises
  ``NotImplementedError`` naming it and its place in the config. The run's
  device goes to every target whose constructor takes ``device``.

``matinvent_tpu/models/suite/mattergen.py`` writes a checkpoint's model
config with ``yaml.safe_dump`` as one ``key: value`` line per
``MatterGenConfig`` field. ``read_flat_yaml`` reads that file: it accepts
``key: scalar`` lines
(null, booleans, integers, floats, plain or quoted strings), ``key: []``,
and block sequences of scalars or of nested sequences under a key (the
forms ``yaml.safe_dump`` writes for ``condition_fields`` and
``condition_stats``). It raises on what it cannot represent: mappings below
the top level, block scalars, flow collections, anchors and tags.
``write_flat_yaml`` writes such a file in ``yaml.safe_dump``'s block style.
"""
from __future__ import annotations

import ast
import importlib
import inspect
import os
import re
from pathlib import Path
from typing import Any

from matinvent_tpu_torch.utils.yaml_io import dump_yaml, load_yaml, read_yaml

_INT = re.compile(r"^[-+]?(0|[1-9][0-9]*)$")
_FLOAT = re.compile(
    r"^[-+]?(\.[0-9]+|[0-9]+(\.[0-9]*)?)([eE][-+]?[0-9]+)?$"
)
_KEY = re.compile(r"^([A-Za-z_][A-Za-z0-9_]*):(?:\s+(.*))?$")


def parse_scalar(text: str) -> Any:
    """One YAML scalar as ``yaml.safe_load`` reads it, for the forms that
    ``yaml.safe_dump`` writes for a flat config."""
    s = text.strip()
    if s in ("", "~", "null", "Null", "NULL"):
        return None
    if s in ("true", "True", "TRUE"):
        return True
    if s in ("false", "False", "FALSE"):
        return False
    if s == "[]":
        return []
    if len(s) >= 2 and s[0] == s[-1] == "'":
        return s[1:-1].replace("''", "'")
    if len(s) >= 2 and s[0] == s[-1] == '"':
        return s[1:-1]
    if s[0] in "[{&*!|>" or s == "-" or s.startswith("- ") or ": " in s or s.endswith(":"):
        raise ValueError(f"not a flat scalar: {text!r}")
    if _INT.match(s):
        return int(s)
    if _FLOAT.match(s):
        return float(s)
    low = s.lower()
    if low in (".inf", "+.inf"):
        return float("inf")
    if low == "-.inf":
        return float("-inf")
    if low == ".nan":
        return float("nan")
    return s


def _parse_sequence(lines, i: int, indent: int, path) -> tuple[list, int]:
    """The block sequence whose ``- `` items start at column ``indent`` on
    ``lines[i]`` (``(lineno, column, text)`` with ``text`` from the column
    on); returns it and the index of the first line after it."""
    items = []
    while i < len(lines):
        lineno, col, text = lines[i]
        if col != indent or not (text == "-" or text.startswith("- ")):
            break
        rest = text[1:].lstrip(" ")
        if rest == "-" or rest.startswith("- "):
            # a compact nested sequence: "- - a" opens it on this line
            lines[i] = (lineno, col + len(text) - len(rest), rest)
            item, i = _parse_sequence(lines, i, lines[i][1], path)
        elif rest == "":
            nxt = lines[i + 1] if i + 1 < len(lines) else None
            if nxt is None or nxt[1] <= indent:
                raise ValueError(f"{path}:{lineno}: empty sequence item")
            item, i = _parse_sequence(lines, i + 1, nxt[1], path)
        else:
            if _KEY.match(rest):
                raise ValueError(f"{path}:{lineno}: mappings in sequences are not supported")
            try:
                item = parse_scalar(rest)
            except ValueError as err:
                raise ValueError(f"{path}:{lineno}: {err}") from None
            i += 1
        items.append(item)
    if i < len(lines) and lines[i][1] > indent:
        raise ValueError(f"{path}:{lines[i][0]}: unexpected indentation")
    return items, i


def read_flat_yaml(path: str | Path) -> dict[str, Any]:
    """``{key: value}`` of a flat YAML file whose values are scalars or
    block sequences (of scalars or nested sequences); raises
    ``ValueError`` on any other structure."""
    lines = []
    for lineno, raw in enumerate(Path(path).read_text().splitlines(), 1):
        line = raw.rstrip()
        if not line or line.lstrip().startswith("#"):
            continue
        if "\t" in line[: len(line) - len(line.lstrip())]:
            raise ValueError(f"{path}:{lineno}: tab indentation")
        col = len(line) - len(line.lstrip(" "))
        lines.append((lineno, col, line[col:]))
    out: dict[str, Any] = {}
    i = 0
    while i < len(lines):
        lineno, col, text = lines[i]
        m = _KEY.match(text)
        if col != 0 or m is None:
            raise ValueError(f"{path}:{lineno}: not a top-level 'key: value' line: {text!r}")
        key, value = m.group(1), m.group(2)
        if value is None:
            nxt = lines[i + 1] if i + 1 < len(lines) else None
            if nxt is None or not (nxt[2] == "-" or nxt[2].startswith("- ")):
                raise ValueError(
                    f"{path}:{lineno}: key {key!r} opens a nested block that is not a sequence"
                )
            out[key], i = _parse_sequence(lines, i + 1, nxt[1], path)
            continue
        try:
            out[key] = parse_scalar(value)
        except ValueError as err:
            raise ValueError(f"{path}:{lineno}: {err}") from None
        i += 1
    return out


def write_flat_yaml(path: str | Path, values: dict[str, Any]) -> None:
    """Write ``{key: scalar or (nested) sequence}`` with sorted keys, as
    ``yaml.safe_dump`` lays it out."""
    Path(path).write_text(dump_yaml({k: values[k] for k in sorted(values)}))


# ------------------------------------------------------------ config engine
_INTERP = re.compile(r"\$\{([^${}]+)\}")
JAX_PACKAGE, PORT_PACKAGE = "matinvent_tpu.", "matinvent_tpu_torch."


def _deep_merge(base: dict, override: dict) -> dict:
    out = dict(base)
    for k, v in override.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def _get_path(cfg: dict, path: str):
    node: Any = cfg
    for part in path.split("."):
        if isinstance(node, dict) and part in node:
            node = node[part]
        elif isinstance(node, list) and part.lstrip("-").isdigit():
            node = node[int(part)]
        else:
            raise KeyError(path)
    return node


def _set_path(cfg: dict, path: str, value: Any) -> None:
    parts = path.split(".")
    node = cfg
    for part in parts[:-1]:
        if isinstance(node, list) and part.lstrip("-").isdigit():
            node = node[int(part)]
        elif isinstance(node, dict):
            node = node.setdefault(part, {})
        else:
            raise KeyError(f"cannot descend into {type(node).__name__} at {part!r} ({path})")
    last = parts[-1]
    if isinstance(node, list) and last.lstrip("-").isdigit():
        node[int(last)] = value
    else:
        node[last] = value


_CALC_NODES = (
    ast.Expression, ast.BinOp, ast.UnaryOp, ast.Constant, ast.Add, ast.Sub,
    ast.Mult, ast.Div, ast.FloorDiv, ast.Mod, ast.Pow, ast.USub, ast.UAdd,
)


def _safe_calc(expr: str) -> Any:
    """The ``calc`` resolver: arithmetic on numbers only, no names or
    calls."""
    tree = ast.parse(expr, mode="eval")
    for node in ast.walk(tree):
        if not isinstance(node, _CALC_NODES):
            raise ValueError(f"disallowed expression in calc resolver: {expr!r}")
    return eval(compile(tree, "<calc>", "eval"))  # noqa: S307 - AST-validated


def _resolve_value(val: str, root: dict):
    """The interpolations of one string resolved; a string that is one
    reference keeps the referenced value's type."""
    m = _INTERP.fullmatch(val.strip())
    if m:
        return _resolve_token(m.group(1), root)
    return _INTERP.sub(lambda match: str(_resolve_token(match.group(1), root)), val)


def _resolve_token(token: str, root: dict):
    if token.startswith("calc:"):
        expr = token[len("calc:"):].strip()
        if len(expr) >= 2 and expr[0] == expr[-1] and expr[0] in "'\"":
            expr = expr[1:-1]
        expr = _INTERP.sub(lambda m: str(_resolve_token(m.group(1), root)), expr)
        return _safe_calc(expr)
    node = _get_path(root, token)
    return _resolve_value(node, root) if isinstance(node, str) and "${" in node else node


def resolve_interpolations(cfg: dict) -> dict:
    """Every ``${...}`` string of the tree resolved, to a fixed point."""

    def walk(node: Any) -> Any:
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        if isinstance(node, str) and "${" in node:
            out = _resolve_value(node, cfg)
            return walk(out) if isinstance(out, (str, dict, list)) and out != node else out
        return node

    prev, current = None, cfg
    for _ in range(10):
        current = walk(current)
        if current == prev:
            break
        prev = current
    return current


_SCI_FLOAT = re.compile(r"^[+-]?(\d+\.?\d*|\.\d+)[eE][+-]?\d+$")


def _parse_override_value(raw: str) -> Any:
    """An override's value as YAML, but an exponent without a dot
    (``1e-4``, a string to YAML 1.1) as a float, as Hydra reads it."""
    if _SCI_FLOAT.match(raw.strip()):
        return float(raw)
    try:
        return load_yaml(raw)
    except ValueError:
        return raw


def load_config(config_dir: str | Path, config_name: str = "base",
                overrides: list[str] | None = None) -> dict:
    """``<config_dir>/<config_name>.yaml`` with its ``defaults`` groups
    loaded, the overrides applied and the interpolations resolved."""
    cfg: dict = read_yaml(os.path.join(config_dir, f"{config_name}.yaml")) or {}
    group_choice: dict[str, str] = {}
    for entry in cfg.pop("defaults", []):
        if isinstance(entry, dict):
            group_choice.update({str(k): str(v) for k, v in entry.items()})

    kv_overrides: list[tuple[str, Any]] = []
    for ov in overrides or []:
        body = ov[1:] if ov.startswith("+") else ov
        if "=" not in body:
            raise ValueError(f"override must be key=value: {ov}")
        key, raw = body.split("=", 1)
        if key in group_choice or ("." not in key and os.path.isdir(os.path.join(config_dir, key))):
            group_choice[key] = raw
        else:
            kv_overrides.append((key, _parse_override_value(raw)))

    for group, name in group_choice.items():
        node = read_yaml(os.path.join(config_dir, group, f"{name}.yaml")) or {}
        cfg[group] = _deep_merge(cfg.get(group) or {}, node)
    for key, value in kv_overrides:
        _set_path(cfg, key, value)
    return resolve_interpolations(cfg)


def _strip_objects(node: Any) -> Any:
    if isinstance(node, dict):
        return {k: _strip_objects(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_strip_objects(v) for v in node]
    if isinstance(node, (str, int, float, bool)) or node is None:
        return node
    return repr(node)


def save_config(cfg: dict, path: str | Path) -> None:
    """``cfg`` as YAML that ``yaml.safe_load`` reads back to it (objects
    written as their ``repr``)."""
    Path(path).write_text(dump_yaml(_strip_objects(cfg)))


def port_target(target: str) -> str:
    """A JAX package's ``_target_`` as the port's dotted path."""
    if target.startswith(JAX_PACKAGE):
        return PORT_PACKAGE + target[len(JAX_PACKAGE):]
    return target


def port_targets(node: Any) -> Any:
    """``node`` with every ``_target_`` mapped by ``port_target``."""
    if isinstance(node, dict):
        return {k: port_target(v) if k == "_target_" and isinstance(v, str) else port_targets(v)
                for k, v in node.items()}
    if isinstance(node, list):
        return [port_targets(v) for v in node]
    return node


def locate(target: str):
    """The object at a dotted path: the longest importable module prefix,
    then attributes (so ``pkg.mod.Class.classmethod`` resolves)."""
    parts = target.split(".")
    module, split, import_err = None, 0, None
    for split in range(len(parts) - 1, 0, -1):
        try:
            module = importlib.import_module(".".join(parts[:split]))
            break
        except ImportError as exc:
            import_err = exc
    if module is None:
        raise ImportError(f"cannot locate {target!r}: {import_err}")
    obj = module
    for attr in parts[split:]:
        try:
            obj = getattr(obj, attr)
        except AttributeError as exc:
            raise ImportError(f"cannot locate {target!r}: {exc}") from exc
    return obj


def _takes_device(fn) -> bool:
    try:
        params = inspect.signature(fn).parameters
    except (TypeError, ValueError):
        return False
    p = params.get("device")
    return p is not None and p.kind in (p.POSITIONAL_OR_KEYWORD, p.KEYWORD_ONLY)


def instantiate(node: Any, device=None, _path: str = "", **extra):
    """Objects built from the ``_target_`` nodes of ``node``, recursively
    unless ``_recursive_: false``; ``device`` (when given) goes to every
    target whose constructor takes one; ``extra`` to the top node's."""
    if isinstance(node, list):
        return [instantiate(v, device, f"{_path}.{i}".lstrip(".")) for i, v in enumerate(node)]
    if not isinstance(node, dict):
        return node
    recursive = node.get("_recursive_", True)
    kwargs = {
        k: instantiate(v, device, f"{_path}.{k}".lstrip(".")) if recursive else v
        for k, v in node.items() if k not in ("_target_", "_recursive_")
    }
    kwargs.update(extra)
    if "_target_" not in node:
        return kwargs
    target = port_target(node["_target_"])
    try:
        cls = locate(target)
    except ImportError as exc:
        raise NotImplementedError(
            f"{node['_target_']!r} (config node {_path or '<root>'!r}) is not ported to "
            f"matinvent_tpu_torch: {exc}"
        ) from exc
    if device is not None and "device" not in kwargs and _takes_device(cls):
        kwargs["device"] = device
    return cls(**kwargs)

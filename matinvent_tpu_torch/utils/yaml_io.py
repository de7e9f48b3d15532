"""A YAML reader and writer for the repository's configs, without PyYAML.

``load_yaml`` reads a document to what ``yaml.safe_load`` gives for the
forms the configs under ``configs/`` and the runs' ``hparams.yaml`` use:
block mappings and sequences (sequences indented or not under their key,
compact ``- key: value`` mappings, ``- - a`` nested sequences), flow
collections on one line (``[a, b]``, ``{k: v}``, ``[]``), plain, single-
and double-quoted scalars (single-quoted ones over several lines too, as
``yaml.safe_dump`` writes a string with line breaks), literal block scalars
(``|``, ``|-``, ``|+``: a DFT job's scheduler script), and comments. Plain scalars resolve as YAML
1.1 (PyYAML's resolver) does: ``1.0e-05`` is a float but ``1e-4`` a
string, ``yes``/``on`` are booleans, ``0o17``-style octals are ``017``. It
raises ``ValueError`` on what it does not read: folded block scalars
(``>``), indentation indicators, anchors, aliases, tags, timestamps and
multi-line flows or plain scalars.

``dump_yaml`` writes nested dicts, lists and scalars in ``yaml.safe_dump``'s
block style (keys in their order), quoting a string wherever the reader
would take it for something else.
"""
from __future__ import annotations

import math
import re
from pathlib import Path
from typing import Any

_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE|on|On|ON|off|Off|OFF)$")
_FLOAT = re.compile(
    r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
    |[-+]?\.(?:inf|Inf|INF)
    |\.(?:nan|NaN|NAN))$""",
    re.X,
)
_INT = re.compile(
    r"""^(?:[-+]?0b[0-1_]+
    |[-+]?0[0-7_]+
    |[-+]?(?:0|[1-9][0-9_]*)
    |[-+]?0x[0-9a-fA-F_]+
    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""",
    re.X,
)
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP = re.compile(r"^[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?")
_ESCAPES = {
    "0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n", "v": "\v",
    "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\",
    "N": "\x85", "_": "\xa0", "L": " ", "P": " ",
}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}


def _sexagesimal(text: str, cast):
    sign = -1 if text.startswith("-") else 1
    total = 0
    for part in text.lstrip("+-").split(":"):
        total = total * 60 + cast(part)
    return sign * total


def resolve_plain(text: str) -> Any:
    """A plain scalar as YAML 1.1's resolver (PyYAML's) constructs it."""
    if _BOOL.match(text):
        return text.lower() in ("yes", "true", "on")
    if _FLOAT.match(text):
        v = text.replace("_", "").lower()
        if v.lstrip("+-") == ".inf":
            return -math.inf if v.startswith("-") else math.inf
        if v == ".nan":
            return math.nan
        if ":" in v:
            return float(_sexagesimal(v, float))
        return float(v)
    if _INT.match(text):
        v = text.replace("_", "")
        sign = -1 if v.startswith("-") else 1
        body = v.lstrip("+-")
        if body == "0":
            return 0
        if body.startswith("0b"):
            return sign * int(body[2:], 2)
        if body.startswith("0x"):
            return sign * int(body[2:], 16)
        if body.startswith("0"):
            return sign * int(body, 8)
        if ":" in body:
            return sign * _sexagesimal(body, int)
        return sign * int(body)
    if _NULL.match(text):
        return None
    if _TIMESTAMP.match(text):
        raise ValueError(f"timestamps are not supported: {text!r}")
    return text


class _Scanner:
    """A cursor over one line's text, for scalars and flow collections."""

    def __init__(self, text: str, where: str):
        self.s, self.i, self.where = text, 0, where

    def error(self, msg: str) -> ValueError:
        return ValueError(f"{self.where}: {msg}: {self.s!r}")

    def skip_space(self) -> None:
        while self.i < len(self.s) and self.s[self.i] in " \t":
            self.i += 1

    def at_end(self) -> bool:
        self.skip_space()
        return self.i >= len(self.s)

    def quoted(self) -> str:
        q = self.s[self.i]
        self.i += 1
        out = []
        while True:
            if self.i >= len(self.s):
                raise self.error("unterminated quoted scalar")
            ch = self.s[self.i]
            if q == "'" and ch == "'":
                if self.s[self.i + 1: self.i + 2] == "'":
                    out.append("'")
                    self.i += 2
                    continue
                self.i += 1
                return "".join(out)
            if q == '"' and ch == '"':
                self.i += 1
                return "".join(out)
            if q == '"' and ch == "\\":
                esc = self.s[self.i + 1: self.i + 2]
                if esc in _ESCAPES:
                    out.append(_ESCAPES[esc])
                    self.i += 2
                elif esc in _HEX_ESCAPES:
                    n = _HEX_ESCAPES[esc]
                    out.append(chr(int(self.s[self.i + 2: self.i + 2 + n], 16)))
                    self.i += 2 + n
                else:
                    raise self.error(f"unknown escape \\{esc}")
                continue
            out.append(ch)
            self.i += 1

    def plain(self, flow: bool) -> str:
        start = self.i
        while self.i < len(self.s):
            ch = self.s[self.i]
            nxt = self.s[self.i + 1: self.i + 2]
            if ch == ":" and (nxt in ("", " ", "\t") or (flow and nxt in ",[]{}")):
                break
            if ch == "#" and self.i > start and self.s[self.i - 1] in " \t":
                break
            if flow and ch in ",[]{}":
                break
            self.i += 1
        return self.s[start: self.i].rstrip(" \t")

    def node(self, flow: bool = False) -> Any:
        """A scalar or a flow collection starting at the cursor."""
        self.skip_space()
        if self.i >= len(self.s):
            return None
        ch = self.s[self.i]
        if ch == "[":
            return self.flow_sequence()
        if ch == "{":
            return self.flow_mapping()
        if ch in "'\"":
            return self.quoted()
        if ch in "&*!|>%@`":
            raise self.error(f"unsupported YAML syntax {ch!r}")
        if ch in ",]}" and flow:
            raise self.error("empty flow entry")
        return resolve_plain(self.plain(flow))

    def flow_sequence(self) -> list:
        self.i += 1
        items = []
        while True:
            self.skip_space()
            if self.i >= len(self.s):
                raise self.error("unterminated flow sequence")
            if self.s[self.i] == "]":
                self.i += 1
                return items
            items.append(self.node(flow=True))
            self.skip_space()
            if self.s[self.i: self.i + 1] == ",":
                self.i += 1
            elif self.s[self.i: self.i + 1] != "]":
                raise self.error("expected ',' or ']'")

    def flow_mapping(self) -> dict:
        self.i += 1
        out: dict = {}
        while True:
            self.skip_space()
            if self.i >= len(self.s):
                raise self.error("unterminated flow mapping")
            if self.s[self.i] == "}":
                self.i += 1
                return out
            key = self.node(flow=True)
            self.skip_space()
            value = None
            if self.s[self.i: self.i + 1] == ":":
                self.i += 1
                self.skip_space()
                if self.s[self.i: self.i + 1] not in (",", "}"):
                    value = self.node(flow=True)
            out[key] = value
            self.skip_space()
            if self.s[self.i: self.i + 1] == ",":
                self.i += 1
            elif self.s[self.i: self.i + 1] != "}":
                raise self.error("expected ',' or '}'")


def _strip_comment(text: str) -> str:
    """``text`` without a trailing comment; quotes that open a scalar (at
    the start or after ``:``/``-``/``,``/``[``/``{`` and a space) are
    skipped over."""
    i, n = 0, len(text)
    while i < n:
        ch = text[i]
        if ch in "'\"":
            before = text[:i].rstrip(" \t")
            opens = (not before or before[-1] in "[{,"
                     or (before[-1] in ":-" and i > 0 and text[i - 1] in " \t"))
            if opens:
                j = i + 1
                while j < n:
                    if text[j] == "\\" and ch == '"':
                        j += 2
                        continue
                    if text[j] == ch:
                        if ch == "'" and text[j + 1: j + 2] == "'":
                            j += 2
                            continue
                        break
                    j += 1
                i = j + 1
                continue
        if ch == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i].rstrip(" \t")
        i += 1
    return text.rstrip(" \t")


def _split_key(text: str, where: str):
    """``(key, rest)`` when ``text`` opens a mapping entry, else None."""
    sc = _Scanner(text, where)
    if text[0] in "'\"":
        key = sc.quoted()
        sc.skip_space()
        if sc.s[sc.i: sc.i + 1] != ":" or sc.s[sc.i + 1: sc.i + 2] not in ("", " ", "\t"):
            return None
        return key, text[sc.i + 1:].strip(" \t")
    if text[0] in "[{":
        return None
    m = re.search(r":(?:[ \t]|$)", text)
    if m is None:
        return None
    return resolve_plain(text[: m.start()].rstrip(" \t")), text[m.end():].strip(" \t")


def _closes(text: str) -> bool:
    """Whether the single-quoted scalar opening ``text`` ends on it."""
    j = 1
    while j < len(text):
        if text[j] == "'":
            if text[j + 1: j + 2] != "'":
                return True
            j += 1
        j += 1
    return False


def _is_item(text: str) -> bool:
    return text == "-" or text.startswith("- ") or text.startswith("-\t")


class _Parser:
    def __init__(self, text: str, name: str):
        self.name = name
        self.raw = text.splitlines()  # a literal block scalar reads these
        self.ends_with_break = text.endswith(("\n", "\r"))
        self.lines: list[list] = []  # [indent, text, lineno]
        for lineno, raw in enumerate(self.raw, 1):
            body = _strip_comment(raw)
            if not body.strip():
                continue
            stripped = body.lstrip(" ")
            if stripped.startswith("\t"):
                raise ValueError(f"{name}:{lineno}: tab indentation")
            if stripped in ("---", "..."):
                if self.lines:
                    raise ValueError(f"{name}:{lineno}: more than one document")
                continue
            if stripped.startswith("%"):
                raise ValueError(f"{name}:{lineno}: directives are not supported")
            self.lines.append([len(body) - len(stripped), stripped, lineno])

    def where(self, i: int) -> str:
        return f"{self.name}:{self.lines[i][2]}"

    def inline(self, text: str, i: int) -> Any:
        sc = _Scanner(text, self.where(i))
        value = sc.node()
        if not sc.at_end():
            raise sc.error("unexpected text after a value")
        return value

    def document(self) -> Any:
        if not self.lines:
            return None
        value, i = self.block(0, self.lines[0][0])
        if i < len(self.lines):
            raise ValueError(f"{self.where(i)}: unexpected content")
        return value

    def block(self, i: int, indent: int):
        text = self.lines[i][1]
        if _is_item(text):
            return self.sequence(i, indent)
        if _split_key(text, self.where(i)) is not None:
            return self.mapping(i, indent)
        value = self.inline(text, i)
        i += 1
        if i < len(self.lines) and self.lines[i][0] > indent:
            raise ValueError(f"{self.where(i)}: multi-line scalars are not supported")
        return value, i

    def value_after(self, i: int, indent: int, rest: str, seq_same_indent: bool):
        """The value of an entry whose line ``i`` leaves ``rest`` after its
        indicator; returns it and the next line's index."""
        if rest:
            if rest[0] == "|":
                return self.literal(i, indent, rest)
            if rest[0] == ">":
                raise ValueError(f"{self.where(i)}: folded block scalars are not supported")
            if rest[0] == "'" and not _closes(rest):
                return self.quoted_lines(i, rest)
            return self.inline(rest, i), i + 1
        nxt = i + 1
        if nxt < len(self.lines):
            col, text, _ = self.lines[nxt]
            if col > indent:
                return self.block(nxt, col)
            if seq_same_indent and col == indent and _is_item(text):
                return self.sequence(nxt, indent)
        return None, nxt

    def quoted_lines(self, i: int, rest: str):
        """A single-quoted scalar that ``rest`` opens on line ``i`` and a
        later raw line closes (``yaml.safe_dump`` writes a string with line
        breaks so): lines folded, a line break to a space, each empty line
        to a newline; returns it and the index of the next parsed line."""
        raw = self.raw[self.lines[i][2] - 1].rstrip()
        text = raw[len(raw) - len(rest) + 1:]
        row, parts, cur = self.lines[i][2] - 1, [], []
        while True:
            j = 0
            while j < len(text):
                if text[j] == "'":
                    if text[j + 1: j + 2] == "'":
                        cur.append("'")
                        j += 2
                        continue
                    tail = text[j + 1:].strip()
                    if tail and not tail.startswith("#"):
                        raise ValueError(f"{self.where(i)}: unexpected text after a value")
                    parts.append("".join(cur))
                    first, *more = parts
                    out, empties = first.rstrip(" \t"), 0
                    for k, p in enumerate(more, 1):
                        p = p.strip(" \t") if k < len(more) else p.lstrip(" \t")
                        if not p and k < len(more):
                            empties += 1
                            continue
                        out += "\n" * empties if empties else " "
                        out += p
                        empties = 0
                    nxt = i + 1
                    while nxt < len(self.lines) and self.lines[nxt][2] <= row + 1:
                        nxt += 1
                    return out, nxt
                cur.append(text[j])
                j += 1
            parts.append("".join(cur))
            cur = []
            row += 1
            if row >= len(self.raw):
                raise ValueError(f"{self.where(i)}: unterminated quoted scalar")
            text = self.raw[row]

    def literal(self, i: int, indent: int, header: str):
        """The literal block scalar opened by ``header`` on line ``i``: the
        raw lines below it indented past ``indent`` (blank lines and ``#``
        kept), less the first content line's indentation, chomped as the
        header says; returns it and the index of the next parsed line."""
        chomp = header[1:]
        if chomp not in ("", "-", "+"):
            raise ValueError(f"{self.where(i)}: block scalar header {header!r} is not supported")
        end = self.lines[i][2]  # raw index of the line after the header
        body = []
        while end < len(self.raw):
            line = self.raw[end]
            if line.strip() and len(line) - len(line.lstrip(" ")) <= indent:
                break
            body.append(line)
            end += 1
        content = [ln for ln in body if ln.strip()]
        col = len(content[0]) - len(content[0].lstrip(" ")) if content else indent + 1
        out = []
        for ln in body:
            if ln.strip() and len(ln) - len(ln.lstrip(" ")) < col:
                raise ValueError(f"{self.where(i)}: a block scalar line is indented less "
                                 "than its first line")
            out.append(ln[col:])
        # the text's last line may end without a line break
        breaks = [True] * len(out)
        if out and end == len(self.raw) and not self.ends_with_break:
            breaks[-1] = False
        core = len(out)
        while core and not out[core - 1]:
            core -= 1
        if chomp == "+":
            value = "".join(ln + "\n" * b for ln, b in zip(out, breaks))
        else:
            value = "\n".join(out[:core]) + ("\n" if core and chomp == "" and breaks[core - 1]
                                              else "")
        nxt = i + 1
        while nxt < len(self.lines) and self.lines[nxt][2] <= end:
            nxt += 1
        return value, nxt

    def mapping(self, i: int, indent: int):
        out: dict = {}
        while i < len(self.lines) and self.lines[i][0] == indent:
            split = _split_key(self.lines[i][1], self.where(i))
            if split is None:
                raise ValueError(f"{self.where(i)}: expected a 'key: value' entry")
            key, rest = split
            out[key], i = self.value_after(i, indent, rest, seq_same_indent=True)
        if i < len(self.lines) and self.lines[i][0] > indent:
            raise ValueError(f"{self.where(i)}: unexpected indentation")
        return out, i

    def sequence(self, i: int, indent: int):
        items = []
        while i < len(self.lines) and self.lines[i][0] == indent and _is_item(self.lines[i][1]):
            text = self.lines[i][1]
            rest = text[1:].lstrip(" \t")
            opens_quote = rest[:1] == "'" and not _closes(rest)
            if rest and not opens_quote and (
                    _is_item(rest) or _split_key(rest, self.where(i)) is not None):
                # a nested sequence or a compact mapping opened on this line
                col = indent + len(text) - len(rest)
                self.lines[i] = [col, rest, self.lines[i][2]]
                item, i = self.block(i, col)
            else:
                item, i = self.value_after(i, indent, rest, seq_same_indent=False)
            items.append(item)
        if i < len(self.lines) and self.lines[i][0] > indent:
            raise ValueError(f"{self.where(i)}: unexpected indentation")
        return items, i


def load_yaml(text: str, name: str = "<yaml>") -> Any:
    """One YAML document, as ``yaml.safe_load`` reads it."""
    return _Parser(text, name).document()


def read_yaml(path: str | Path) -> Any:
    return load_yaml(Path(path).read_text(), str(path))


# ------------------------------------------------------------------- writer
_PLAIN_SAFE = re.compile(r"^[^\s\-?:,\[\]{}#&*!|>'\"%@`][^\n\r\t]*$")


def _plain_ok(s: str) -> bool:
    if not s or s != s.strip() or not _PLAIN_SAFE.match(s):
        return False
    if ": " in s or " #" in s or s.endswith(":"):
        return False
    try:
        return resolve_plain(s) == s
    except ValueError:
        return False


def scalar_text(v: Any) -> str:
    """``v`` as a scalar that ``yaml.safe_load`` reads back to ``v``."""
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        text = repr(v)
        # YAML 1.1 reads an exponent without a dot as a string
        if "." not in text and "e" in text:
            text = text.replace("e", ".0e", 1)
        return text
    s = str(v)
    if _plain_ok(s):
        return s
    if all(c.isprintable() for c in s):
        return "'" + s.replace("'", "''") + "'"
    return '"' + "".join(
        c if c.isprintable() and c not in '"\\' else
        ("\\" + c if c in '"\\' else f"\\u{ord(c):04x}")
        for c in s
    ) + '"'


def _lines(node: Any, indent: int) -> list[str]:
    pad = " " * indent
    if isinstance(node, dict):
        out = []
        for k, v in node.items():
            key = scalar_text(k)
            if isinstance(v, dict) and v:
                out.append(f"{pad}{key}:")
                out.extend(_lines(v, indent + 2))
            elif isinstance(v, (list, tuple)) and v:
                out.append(f"{pad}{key}:")
                out.extend(_lines(list(v), indent))  # indentless, as safe_dump
            else:
                out.append(f"{pad}{key}: {_inline(v)}")
        return out
    out = []
    for v in node:
        if (isinstance(v, dict) or isinstance(v, (list, tuple))) and v:
            nested = _lines(v if isinstance(v, dict) else list(v), indent + 2)
            out.append(f"{pad}- {nested[0].lstrip(' ')}")
            out.extend(nested[1:])
        else:
            out.append(f"{pad}- {_inline(v)}")
    return out


def _inline(v: Any) -> str:
    if isinstance(v, dict):
        return "{}"
    if isinstance(v, (list, tuple)):
        return "[]"
    return scalar_text(v)


def dump_yaml(node: Any) -> str:
    """``node`` (dicts, lists and scalars) in block style."""
    if isinstance(node, dict) and node or isinstance(node, (list, tuple)) and node:
        return "\n".join(_lines(node if isinstance(node, dict) else list(node), 0)) + "\n"
    return _inline(node) + "\n"

"""A reader and writer for the YAML subset that the repo's configs use.

The port runs where PyYAML may be missing, so it reads ``configs/*.yaml``
and the ``config.yaml`` files that training writes with this module.  The
subset:

* block mappings, and block sequences (``- item`` and ``- key: value``
  entries), nested by indentation;
* flow sequences and flow mappings (``[256, 512]``, ``{fs: 16000, ...}``),
  which may continue over several lines;
* plain scalars, single- and double-quoted strings, ``#`` comments.

Plain scalars resolve as ``yaml.safe_load`` resolves them (YAML 1.1, with
PyYAML's quirks): ``1e-3`` is a string and ``1.0e-3`` a float, ``yes`` and
``off`` are booleans, ``0x1f`` and ``017`` are integers, ``~`` is null.
Everything outside the subset raises ``ValueError``: anchors, aliases,
tags, block scalars (``|``, ``>``), documents (``---``), complex keys and
timestamps.  :func:`dump` writes block style that both this reader and
``yaml.safe_load`` read back to the same value.
"""

from __future__ import annotations

import math
import re
from typing import Any

_BOOL = re.compile(r"""^(?:yes|Yes|YES|no|No|NO
                    |true|True|TRUE|false|False|FALSE
                    |on|On|ON|off|Off|OFF)$""", re.X)
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP = re.compile(r"^[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?")
_TRUE = {"yes", "true", "on"}


def _sexagesimal(digits: list, sign) -> Any:
    value = 0 * digits[0]
    for d in digits:
        value = value * 60 + d
    return sign * value


def resolve_scalar(text: str) -> Any:
    """A plain scalar's value, as PyYAML's SafeLoader resolves it."""
    if _NULL.match(text):
        return None
    if _BOOL.match(text):
        return text.lower() in _TRUE
    if _INT.match(text):
        v = text.replace("_", "")
        sign = -1 if v[0] == "-" else 1
        v = v[1:] if v[0] in "+-" else v
        if v == "0":
            return 0
        if v.startswith("0b"):
            return sign * int(v[2:], 2)
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        if v[0] == "0":
            return sign * int(v, 8)
        if ":" in v:
            return _sexagesimal([int(p) for p in v.split(":")], sign)
        return sign * int(v)
    if _FLOAT.match(text):
        v = text.replace("_", "").lower()
        sign = -1 if v[0] == "-" else 1
        v = v[1:] if v[0] in "+-" else v
        if v == ".inf":
            return sign * math.inf
        if v == ".nan":
            return math.nan
        if ":" in v:
            return _sexagesimal([float(p) for p in v.split(":")], sign)
        return sign * float(v)
    if _TIMESTAMP.match(text) or text in ("=", "<<"):
        raise ValueError(f"{text!r}: timestamps, merge keys and '=' are "
                         "outside the supported YAML subset")
    return text


def _unquoted(line: str):
    """(index, char) of each character of ``line`` outside quotes; a quote
    opens only at the start or after a blank or an indicator, so an
    apostrophe inside a plain word is text."""
    quote, escaped = None, False
    for i, ch in enumerate(line):
        if quote:
            if escaped:
                escaped = False
            elif quote == '"' and ch == "\\":
                escaped = True
            elif ch == quote:
                quote = None
        elif ch in "'\"" and (i == 0 or line[i - 1] in " \t[{,:-"):
            quote = ch
        else:
            yield i, ch


def _strip_comment(line: str) -> str:
    """``line`` without its comment: a ``#`` at the start or after a blank,
    outside quotes."""
    for i, ch in _unquoted(line):
        if ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def _balanced(text: str) -> bool:
    """Whether every flow collection opened in ``text`` is closed."""
    depth = 0
    for _, ch in _unquoted(text):
        depth += (ch in "[{") - (ch in "]}")
    return depth <= 0


class _Flow:
    """Recursive-descent reader of one inline value: a flow collection, a
    quoted string or a plain scalar."""

    def __init__(self, text: str, where: str):
        self.s = text
        self.i = 0
        self.where = where

    def error(self, what: str) -> ValueError:
        return ValueError(f"{self.where}: {what} in {self.s!r}")

    def skip(self):
        while self.i < len(self.s) and self.s[self.i] in " \t":
            self.i += 1

    def peek(self) -> str:
        self.skip()
        return self.s[self.i] if self.i < len(self.s) else ""

    def value(self, in_flow: bool) -> Any:
        ch = self.peek()
        if ch == "[":
            return self.sequence()
        if ch == "{":
            return self.mapping()
        if ch in ("'", '"'):
            return self.quoted()
        if ch and ch in "&*!|>%@`?":
            raise self.error(f"{ch!r} is outside the supported YAML subset")
        return resolve_scalar(self.plain(in_flow))

    def plain(self, in_flow: bool) -> str:
        start = self.i
        while self.i < len(self.s):
            ch = self.s[self.i]
            if in_flow and ch in ",[]{}":
                break
            if ch == ":" and (self.i + 1 == len(self.s)
                              or self.s[self.i + 1] in " \t,[]{}"):
                if not in_flow:
                    raise self.error("a mapping inside a plain scalar")
                break
            self.i += 1
        return self.s[start:self.i].strip()

    def quoted(self) -> str:
        q = self.s[self.i]
        self.i += 1
        out = []
        while self.i < len(self.s):
            ch = self.s[self.i]
            if q == "'" and ch == "'":
                if self.s[self.i + 1: self.i + 2] == "'":
                    out.append("'")
                    self.i += 2
                    continue
                self.i += 1
                return "".join(out)
            if q == '"' and ch == "\\":
                esc = self.s[self.i + 1: self.i + 2]
                table = {"\\": "\\", '"': '"', "n": "\n", "t": "\t",
                         "/": "/", "0": "\0"}
                if esc not in table:
                    raise self.error(f"escape \\{esc} outside the subset")
                out.append(table[esc])
                self.i += 2
                continue
            if q == '"' and ch == '"':
                self.i += 1
                return "".join(out)
            out.append(ch)
            self.i += 1
        raise self.error("an unterminated quoted string")

    def expect(self, ch: str):
        if self.peek() != ch:
            raise self.error(f"expected {ch!r}")
        self.i += 1

    def sequence(self) -> list:
        self.expect("[")
        out = []
        while self.peek() != "]":
            out.append(self.value(in_flow=True))
            if self.peek() == ",":
                self.i += 1
            elif self.peek() != "]":
                raise self.error("expected ',' or ']'")
        self.i += 1
        return out

    def mapping(self) -> dict:
        self.expect("{")
        out = {}
        while self.peek() != "}":
            key = self.value(in_flow=True)
            self.expect(":")
            out[_key(key, self.where)] = self.value(in_flow=True)
            if self.peek() == ",":
                self.i += 1
            elif self.peek() != "}":
                raise self.error("expected ',' or '}'")
        self.i += 1
        return out

    def done(self):
        if self.peek():
            raise self.error("trailing text")


def _key(key, where: str) -> str:
    if not isinstance(key, str):
        raise ValueError(f"{where}: non-string key {key!r} is outside the "
                         "supported YAML subset")
    return key


def _inline(text: str, where: str) -> Any:
    flow = _Flow(text, where)
    value = flow.value(in_flow=False)
    flow.done()
    return value


def _split_key(content: str, where: str):
    """(key, rest) of a ``key: rest`` line, or None if it is no entry."""
    flow = _Flow(content, where)
    if flow.peek() in ("[", "{"):
        return None
    if flow.peek() in ("'", '"'):
        key = flow.quoted()
    else:
        i = 0
        while i < len(content):
            if content[i] == ":" and (i + 1 == len(content)
                                      or content[i + 1] in " \t"):
                break
            i += 1
        else:
            return None
        key = resolve_scalar(content[:i].strip())
        flow.i = i
    if flow.peek() != ":":
        return None
    flow.i += 1
    return _key(key, where), content[flow.i:].strip()


class _Block:
    def __init__(self, text: str):
        self.lines = []  # (indent, content, line number)
        pending = None
        for n, raw in enumerate(text.splitlines(), 1):
            if "\t" in raw[: len(raw) - len(raw.lstrip())]:
                raise ValueError(f"line {n}: tab indentation")
            line = _strip_comment(raw)
            if not line.strip():
                continue
            if pending is not None:  # a flow collection over several lines
                pending[1] += " " + line.strip()
                if _balanced(pending[1]):
                    self.lines.append(tuple(pending))
                    pending = None
                continue
            content = line.lstrip()
            if content.startswith(("---", "...", "%")):
                raise ValueError(f"line {n}: documents and directives are "
                                 "outside the supported YAML subset")
            entry = [len(line) - len(content), content, n]
            if _balanced(content):
                self.lines.append(tuple(entry))
            else:
                pending = entry
        if pending is not None:
            raise ValueError(f"line {pending[2]}: unclosed flow collection")
        self.pos = 0

    def node(self, indent: int) -> Any:
        """The block node whose first line is at ``self.pos``, at
        ``indent``."""
        ind, content, n = self.lines[self.pos]
        if content == "-" or content.startswith("- "):
            return self.sequence(ind)
        if _split_key(content, f"line {n}") is not None:
            return self.mapping(ind)
        if self.pos + 1 < len(self.lines) \
                and self.lines[self.pos + 1][0] > indent:
            raise ValueError(f"line {n}: multi-line plain scalars are "
                             "outside the supported YAML subset")
        self.pos += 1
        return _inline(content, f"line {n}")

    def value_after(self, rest: str, indent: int, n: int,
                    seq_ok: bool) -> Any:
        """The value of an entry whose text after ``key:`` is ``rest``."""
        if rest:
            return _inline(rest, f"line {n}")
        if self.pos < len(self.lines):
            ind, content, _ = self.lines[self.pos]
            is_seq = content == "-" or content.startswith("- ")
            if ind > indent or (seq_ok and ind == indent and is_seq):
                return self.node(ind)
        return None

    def mapping(self, indent: int) -> dict:
        out = {}
        while self.pos < len(self.lines):
            ind, content, n = self.lines[self.pos]
            if ind < indent:
                break
            if ind > indent:
                raise ValueError(f"line {n}: unexpected indentation")
            kv = _split_key(content, f"line {n}")
            if kv is None:
                break
            key, rest = kv
            if key in out:
                raise ValueError(f"line {n}: duplicate key {key!r}")
            self.pos += 1
            out[key] = self.value_after(rest, indent, n, seq_ok=True)
        return out

    def sequence(self, indent: int) -> list:
        out = []
        while self.pos < len(self.lines):
            ind, content, n = self.lines[self.pos]
            if ind != indent or not (content == "-"
                                     or content.startswith("- ")):
                if ind > indent:
                    raise ValueError(f"line {n}: unexpected indentation")
                break
            item = content[1:].lstrip()
            if not item:
                self.pos += 1
                out.append(self.value_after("", indent, n, seq_ok=False))
                continue
            # "- key: value" opens a mapping at the item's column
            self.lines[self.pos] = (ind + len(content) - len(item), item, n)
            out.append(self.node(self.lines[self.pos][0]))
        return out


def load(text: str) -> Any:
    """The value of a YAML document in the subset (None when empty)."""
    block = _Block(text)
    if not block.lines:
        return None
    value = block.node(block.lines[0][0])
    if block.pos != len(block.lines):
        raise ValueError(f"line {block.lines[block.pos][2]}: unexpected "
                         "text after the document's top-level node")
    return value


def load_file(path: str) -> Any:
    with open(path, encoding="utf-8") as f:
        return load(f.read())


# -- writer ------------------------------------------------------------------

_PLAIN_SAFE = re.compile(r"^[A-Za-z0-9_./][A-Za-z0-9_./+-]*$")


def _scalar(v) -> str:
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
        text = repr(v).lower()
        if "." not in text and "e" in text:
            text = text.replace("e", ".0e", 1)
        return text
    if isinstance(v, str):
        if _PLAIN_SAFE.match(v) and resolve_scalar(v) == v:
            return v
        return "'" + v.replace("'", "''") + "'"
    raise TypeError(f"cannot write {type(v).__name__} {v!r} as YAML")


def _lines(value, indent: int) -> list[str]:
    pad = " " * indent
    out = []
    if isinstance(value, dict):
        for k, v in value.items():
            key = _scalar(_key(k, "dump"))
            if isinstance(v, dict) and v:
                out += [f"{pad}{key}:"] + _lines(v, indent + 2)
            elif isinstance(v, (list, tuple)) and v:
                out += [f"{pad}{key}:"] + _lines(v, indent)
            else:
                out.append(f"{pad}{key}: {_inline_text(v)}")
    else:
        for v in value:
            if isinstance(v, (dict, list, tuple)) and v:
                body = _lines(v, indent + 2)
                out.append(f"{pad}- {body[0].lstrip()}")
                out += body[1:]
            else:
                out.append(f"{pad}- {_inline_text(v)}")
    return out


def _inline_text(v) -> str:
    if isinstance(v, dict):
        return "{}"
    if isinstance(v, (list, tuple)):
        return "[]"
    return _scalar(v)


def dump(value: dict) -> str:
    """``value`` (a mapping of mappings, lists and scalars) as block YAML."""
    return "\n".join(_lines(value, 0)) + "\n"

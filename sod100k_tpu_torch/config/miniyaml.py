"""A reader for the subset of YAML that the reference configs use.

The machine with the card has no PyYAML, and the config layer needs only a
small part of YAML: block mappings nested by indentation, ``#`` comments,
one-line flow lists (``[0.5, 0.5]``, ``["ECSSD"]``), plain and quoted
scalars. What the reader accepts it resolves as PyYAML's ``safe_load``
does (YAML 1.1): ``1e-20`` stays a string (a YAML 1.1 float needs a dot
and a signed exponent), ``1.0e-4`` is a float, ``yes``/``on``/``True`` are
bools, ``~`` and an empty value are null, an empty document is None. It
raises ``YAMLSubsetError`` on whatever else it meets (anchors, aliases,
tags, block sequences, block and multi-line scalars, flow mappings,
document markers, and the scalars that YAML 1.1 reads as octal, hex,
sexagesimal, underscored or date values): it never guesses.
"""

from __future__ import annotations

import re
from typing import Any

# PyYAML's implicit resolvers (yaml/resolver.py, YAML 1.1): a plain scalar
# that one of them matches is not a string there
_BOOL = re.compile(r"yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF")
_NULL = re.compile(r"~|null|Null|NULL|")
_FLOAT = re.compile(r"""[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                     |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                     |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                     |[-+]?\.(?:inf|Inf|INF)
                     |\.(?:nan|NaN|NAN)""", re.X)
_INT = re.compile(r"""[-+]?0b[0-1_]+
                   |[-+]?0[0-7_]+
                   |[-+]?(?:0|[1-9][0-9_]*)
                   |[-+]?0x[0-9a-fA-F_]+
                   |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+""", re.X)
_TIMESTAMP = re.compile(r"""[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?
                         (?:(?:[Tt]|[ \t]+)[0-9][0-9]?:[0-9][0-9]
                         :[0-9][0-9](?:\.[0-9]*)?
                         (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)?""",
                        re.X)
# the forms of those that this reader converts itself
_PLAIN_INT = re.compile(r"[-+]?(?:0|[1-9][0-9]*)")
_PLAIN_FLOAT = re.compile(r"[-+]?[0-9]+\.[0-9]*(?:[eE][-+][0-9]+)?"
                          r"|\.[0-9]+(?:[eE][-+][0-9]+)?")
_INF = re.compile(r"([-+]?)\.(?:inf|Inf|INF)")
_NAN = re.compile(r"\.(?:nan|NaN|NAN)")
# a plain scalar may not start with these (YAML indicators)
_INDICATORS = set("-?:,[]{}#&*!|>'\"%@`")
_ESCAPES = {"\\": "\\", '"': '"', "/": "/", "n": "\n", "t": "\t",
            "r": "\r", "0": "\0"}


class YAMLSubsetError(ValueError):
    """Input outside the subset this reader understands."""


def resolve_plain(text: str, where: str = "") -> Any:
    """A plain scalar as PyYAML's ``safe_load`` types it, or an error for
    the YAML 1.1 types this reader does not convert."""
    if _NULL.fullmatch(text):
        return None
    if _BOOL.fullmatch(text):
        return text.lower() in ("yes", "true", "on")
    if _FLOAT.fullmatch(text):
        if _PLAIN_FLOAT.fullmatch(text):
            return float(text)
        m = _INF.fullmatch(text)
        if m:
            return float("-inf") if m.group(1) == "-" else float("inf")
        if _NAN.fullmatch(text):
            return float("nan")
        raise YAMLSubsetError(f"{where}float form {text!r} is not supported "
                              f"(underscores or base 60)")
    if _INT.fullmatch(text):
        if _PLAIN_INT.fullmatch(text):
            return int(text)
        raise YAMLSubsetError(f"{where}integer form {text!r} is not "
                              f"supported (octal, hex, binary, underscores "
                              f"or base 60)")
    if _TIMESTAMP.fullmatch(text):
        raise YAMLSubsetError(f"{where}{text!r} is a date in YAML 1.1; "
                              f"quote it for a string")
    if text in ("<<", "="):
        raise YAMLSubsetError(f"{where}{text!r} is a YAML merge or value "
                              f"key")
    return text


def _check_plain(text: str, where: str) -> None:
    if not text:
        raise YAMLSubsetError(f"{where}empty value")
    if text[0] in _INDICATORS and not (
            text[0] == "-" and len(text) > 1 and text[1] not in " \t"):
        raise YAMLSubsetError(
            f"{where}{text!r} starts with the indicator {text[0]!r} "
            f"(anchors, aliases, tags, block scalars, block sequences and "
            f"flow mappings are not supported)")
    if ": " in text or text.endswith(":") or ":\t" in text:
        raise YAMLSubsetError(f"{where}a mapping inside the value {text!r}")


class _Line:
    """A cursor over one line's text."""

    def __init__(self, text: str, where: str):
        self.text, self.pos, self.where = text, 0, where

    def peek(self) -> str:
        return self.text[self.pos] if self.pos < len(self.text) else ""

    def skip_space(self) -> None:
        while self.peek() and self.peek() in " \t":
            self.pos += 1

    def at_end(self) -> bool:
        """Only spaces or a comment are left."""
        rest = self.text[self.pos:]
        return not rest.strip() or (rest.strip().startswith("#") and (
            self.pos == 0 or rest[0] in " \t"
            or self.text[self.pos - 1] in " \t"))

    def fail(self, msg: str):
        raise YAMLSubsetError(f"{self.where}{msg}: {self.text.strip()!r}")

    def quoted(self) -> str:
        q = self.peek()
        self.pos += 1
        out = []
        while True:
            c = self.peek()
            if not c:
                self.fail("unterminated quoted scalar (multi-line scalars "
                          "are not supported)")
            self.pos += 1
            if c == q:
                if q == "'" and self.peek() == "'":
                    out.append("'")
                    self.pos += 1
                    continue
                return "".join(out)
            if c == "\\" and q == '"':
                e = self.peek()
                if e not in _ESCAPES:
                    self.fail(f"unsupported escape \\{e}")
                out.append(_ESCAPES[e])
                self.pos += 1
                continue
            out.append(c)

    def flow_list(self) -> list:
        self.pos += 1  # "["
        items = []
        while True:
            self.skip_space()
            c = self.peek()
            if not c:
                self.fail("unterminated flow list (multi-line flow "
                          "collections are not supported)")
            if c == "]":
                self.pos += 1
                return items
            if c == "[":
                items.append(self.flow_list())
            elif c in "'\"":
                items.append(self.quoted())
            else:
                start = self.pos
                while self.peek() and self.peek() not in ",]":
                    if self.peek() == "#" and self.text[self.pos - 1] in " \t":
                        self.fail("comment inside a flow list")
                    self.pos += 1
                text = self.text[start:self.pos].strip()
                if any(ch in text for ch in "[{}"):
                    self.fail("nested flow mapping or bracket in a flow list")
                _check_plain(text, self.where)
                items.append(resolve_plain(text, self.where))
            self.skip_space()
            if self.peek() == ",":
                self.pos += 1
            elif self.peek() != "]":
                self.fail("expected ',' or ']' in a flow list")

    def value(self) -> Any:
        """The rest of the line as one value: flow list, quoted or plain
        scalar (a trailing comment is dropped)."""
        self.skip_space()
        c = self.peek()
        if c in ("[", "'", '"'):
            v = self.flow_list() if c == "[" else self.quoted()
            if not self.at_end():
                self.fail("text after the value")
            return v
        rest = self.text[self.pos:]
        m = re.search(r"[ \t]#", rest)
        text = (rest[:m.start()] if m else rest).strip()
        _check_plain(text, self.where)
        return resolve_plain(text, self.where)


def _split_key(text: str, where: str) -> tuple[Any, str]:
    """'KEY: rest' -> (resolved key, rest)."""
    line = _Line(text, where)
    if line.peek() in ("'", '"'):
        key = line.quoted()
        line.skip_space()
        if line.peek() != ":":
            line.fail("expected ':' after a quoted key")
        line.pos += 1
    else:
        m = re.search(r":(?:[ \t]|$)", text)
        if m is None:
            line.fail("expected 'key: value' (block sequences and bare "
                      "scalars are not supported)")
        raw = text[:m.start()].rstrip()
        if re.search(r"[ \t]#", raw):
            line.fail("comment before ':'")
        _check_plain(raw, where)
        key = resolve_plain(raw, where)
        line.pos = m.start() + 1
    rest = text[line.pos:]
    if rest and rest[0] not in " \t":
        line.fail("expected a space after ':'")
    return key, rest


def _lines(text: str) -> list[tuple[int, int, str]]:
    out = []
    for lineno, raw in enumerate(text.splitlines(), 1):
        body = raw.rstrip()
        stripped = body.lstrip(" ")
        if not stripped or stripped.startswith("#"):
            continue
        if stripped[0] == "\t":
            raise YAMLSubsetError(f"line {lineno}: tab in indentation")
        if stripped in ("---", "...") or stripped.startswith(("--- ", "%")):
            raise YAMLSubsetError(f"line {lineno}: document markers and "
                                  f"directives are not supported")
        out.append((lineno, len(body) - len(stripped), stripped))
    return out


def _block(lines, i: int, indent: int) -> tuple[dict, int]:
    out: dict = {}
    while i < len(lines):
        lineno, ind, text = lines[i]
        if ind < indent:
            break
        where = f"line {lineno}: "
        if ind > indent:
            raise YAMLSubsetError(f"{where}unexpected indentation (multi-line "
                                  f"scalars are not supported)")
        key, rest = _split_key(text, where)
        i += 1
        line = _Line(rest, where)
        if line.at_end():
            if i < len(lines) and lines[i][1] > indent:
                value, i = _block(lines, i, lines[i][1])
            else:
                value = None
        else:
            value = line.value()
            if i < len(lines) and lines[i][1] > indent:
                raise YAMLSubsetError(
                    f"line {lines[i][0]}: continuation of the value on line "
                    f"{lineno} (multi-line scalars are not supported)")
        out[key] = value  # a repeated key keeps its last value, as PyYAML
    return out, i


def load(text: str) -> Any:
    """Parse a document of the subset: a block mapping, or None when the
    text holds only comments and blank lines."""
    lines = _lines(text)
    if not lines:
        return None
    out, i = _block(lines, 0, lines[0][1])
    if i != len(lines):
        raise YAMLSubsetError(f"line {lines[i][0]}: indentation below the "
                              f"document's first key")
    return out


def load_file(path: str) -> Any:
    with open(path) as f:
        return load(f.read())


def parse_value(text: str) -> Any:
    """One value written as on the right of ``KEY:``: a flow list, a quoted
    or a plain scalar (a command-line override's value); None when empty,
    as PyYAML reads an empty document."""
    line = _Line(text, "")
    return None if line.at_end() else line.value()

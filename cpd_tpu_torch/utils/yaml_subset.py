"""A reader for the YAML subset of the config files under ``tools/cfgs/``.

The port runs where PyYAML is not installed, so it reads its configs itself.
``load(text)`` returns what ``yaml.safe_load`` returns for the constructs
these files use:

* block maps (``KEY: value``, ``KEY:`` followed by a deeper block) and block
  lists (``- item``, ``- NAME: ...`` starting a map), a list may sit at its
  key's own indent;
* flow lists and flow maps on one line (``[a, b]``, ``{train: true}``),
  nested;
* single- and double-quoted strings (``'Vehicle:5'``, ``'1': Vehicle``; no
  escapes in double quotes);
* comments (``#`` at the start of a line or after a space);
* plain scalars resolved as YAML 1.1 resolves them: null, booleans
  (``true``, ``yes``, ``on``, ...), ints (decimal, ``0x``, ``0o``/leading 0,
  ``0b``, ``_`` separators), floats (``1.5``, ``.5``, ``1.0e-5``, ``.inf``,
  ``.nan``); everything else is a string, spaces and ``+`` included.

Anything outside the subset raises ``YAMLSubsetError`` with its line number:
anchors and aliases, tags, block scalars (``|``, ``>``), directives and
document markers, complex keys, tabs in indentation, flow collections that
span lines.
"""
from __future__ import annotations

import re
from pathlib import Path

_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_BOOL = {v: True for v in ("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON")}
_BOOL.update({v: False for v in ("no", "No", "NO", "false", "False", "FALSE", "off", "Off",
                                 "OFF")})
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                      |\.[0-9_]+(?:[eE][-+][0-9]+)?
                      |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                      |[-+]?\.(?:inf|Inf|INF)
                      |\.(?:nan|NaN|NAN))$""", re.X)
_UNSUPPORTED_START = "&*!|>%@`?"


class YAMLSubsetError(ValueError):
    """A construct outside the subset, or malformed input; names the line."""

    def __init__(self, lineno: int, message: str):
        super().__init__(f"line {lineno}: {message}")
        self.lineno = lineno


def _sexagesimal(text: str, cast):
    sign = -1 if text.startswith("-") else 1
    value = 0
    for part in text.lstrip("+-").split(":"):
        value = value * 60 + cast(part)
    return sign * value


def _int(text: str) -> int:
    text = text.replace("_", "")
    sign = -1 if text.startswith("-") else 1
    body = text.lstrip("+-")
    if ":" in body:
        return _sexagesimal(text, int)
    if body.startswith("0b"):
        return sign * int(body[2:], 2)
    if body.startswith("0x"):
        return sign * int(body[2:], 16)
    if body != "0" and body.startswith("0"):
        return sign * int(body, 8)
    return sign * int(body)


def _float(text: str) -> float:
    text = text.replace("_", "").lower()
    if text.endswith(".inf"):
        return float("-inf") if text.startswith("-") else float("inf")
    if text.endswith(".nan"):
        return float("nan")
    if ":" in text:
        return float(_sexagesimal(text, float))
    return float(text)


def resolve_plain(text: str):
    """A plain (unquoted) scalar as YAML 1.1's implicit resolvers read it."""
    if _NULL.match(text):
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.match(text):
        return _int(text)
    if _FLOAT.match(text):
        return _float(text)
    return text


def _strip_comment(line: str) -> str:
    """``line`` without a trailing comment; quotes protect a ``#``."""
    quote = None
    i = 0
    while i < len(line):
        ch = line[i]
        if quote:
            if ch == quote and quote == "'" and line[i + 1:i + 2] == "'":
                i += 1  # '' is a quote inside a single-quoted string
            elif ch == quote:
                quote = None
        elif ch in "'\"" and (i == 0 or line[i - 1] in " \t[{,:-"):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
        i += 1
    return line


class _Flow:
    """Recursive descent over one line's flow collection or scalar."""

    def __init__(self, text: str, lineno: int):
        self.text, self.pos, self.lineno = text, 0, lineno

    def error(self, message):
        raise YAMLSubsetError(self.lineno, f"{message} in {self.text.strip()!r}")

    def skip(self):
        while self.pos < len(self.text) and self.text[self.pos] in " \t":
            self.pos += 1

    def peek(self):
        self.skip()
        return self.text[self.pos] if self.pos < len(self.text) else ""

    def node(self):
        ch = self.peek()
        if not ch:
            self.error("a flow collection must close on its own line")
        if ch == "[":
            return self.seq()
        if ch == "{":
            return self.map()
        return self.scalar(in_flow=True)

    def seq(self):
        self.pos += 1
        out = []
        if self.peek() == "]":
            self.pos += 1
            return out
        while True:
            out.append(self.node())
            ch = self.peek()
            self.pos += 1
            if ch == "]":
                return out
            if ch != ",":
                self.error("expected ',' or ']'")

    def map(self):
        self.pos += 1
        out = {}
        if self.peek() == "}":
            self.pos += 1
            return out
        while True:
            key = self.scalar(in_flow=True, key=True)
            if self.peek() != ":":
                self.error("expected ':' after a flow map key")
            self.pos += 1
            out[key] = self.node() if self.peek() not in ",}" else None
            ch = self.peek()
            self.pos += 1
            if ch == "}":
                return out
            if ch != ",":
                self.error("expected ',' or '}'")

    def scalar(self, in_flow: bool, key: bool = False):
        ch = self.peek()
        if ch and ch in "'\"":
            end = self.pos + 1
            parts = []
            while True:
                j = self.text.find(ch, end)
                if j < 0:
                    self.error("unterminated quoted string")
                if ch == "'" and self.text[j + 1:j + 2] == "'":  # '' is one quote
                    parts.append(self.text[end:j + 1])
                    end = j + 2
                    continue
                parts.append(self.text[end:j])
                break
            value = "".join(parts)
            if ch == '"' and "\\" in value:
                self.error("escapes in double-quoted strings are outside the subset")
            self.pos = j + 1
            return value
        if ch and ch in _UNSUPPORTED_START + "-" and not self._plain_start():
            self.error(f"{ch!r} starts a construct outside the subset")
        stops = ",[]{}" if in_flow else ""
        start = self.pos
        while self.pos < len(self.text):
            c = self.text[self.pos]
            if c in stops or (c == ":" and (self.pos + 1 == len(self.text)
                                            or self.text[self.pos + 1] in " \t" + stops)):
                if c == ":" and not (in_flow or key):
                    self.error("a plain value may not hold ': '")
                break
            self.pos += 1
        return resolve_plain(self.text[start:self.pos].strip())

    def _plain_start(self) -> bool:
        """'-', '?', ':' start a plain scalar when a non-space follows."""
        ch, nxt = self.text[self.pos], self.text[self.pos + 1:self.pos + 2]
        return ch in "-?:" and nxt not in ("", " ", "\t")


def _value(text: str, lineno: int):
    """A value written on the same line as its key or dash."""
    parser = _Flow(text, lineno)
    # a plain scalar in block context may hold ',', '[', ']', '{' and '}'
    value = parser.node() if text[0] in "[{" else parser.scalar(in_flow=False)
    if parser.peek():
        parser.error("unexpected text after the value")
    return value


class _Block:
    def __init__(self, text: str):
        self.lines = []  # (lineno, indent, content)
        for lineno, raw in enumerate(text.splitlines(), 1):
            line = _strip_comment(raw).rstrip()
            if not line.strip():
                continue
            body = line.lstrip(" ")
            if body.startswith("\t") or "\t" in line[:len(line) - len(body)]:
                raise YAMLSubsetError(lineno, "tabs in indentation are outside the subset")
            if body.startswith(("---", "...", "%")):
                raise YAMLSubsetError(lineno, "directives and document markers are outside "
                                      "the subset")
            self.lines.append((lineno, len(line) - len(body), body))
        self.i = 0

    def parse(self):
        if not self.lines:
            return None
        lineno, indent, body = self.lines[0]
        if body[0] in "[{":  # a document that is one flow collection
            self.i = 1
            value = _value(body, lineno)
        else:
            value = self.node(indent)
        if self.i < len(self.lines):
            lineno, _, body = self.lines[self.i]
            raise YAMLSubsetError(lineno, f"unexpected indentation at {body!r}")
        return value

    def node(self, indent: int):
        _, _, body = self.lines[self.i]
        if body == "-" or body.startswith("- "):
            return self.seq(indent)
        return self.map(indent)

    def seq(self, indent: int):
        out = []
        while self.i < len(self.lines):
            lineno, ind, body = self.lines[self.i]
            if ind != indent or not (body == "-" or body.startswith("- ")):
                break
            rest = body[1:].lstrip(" ")
            if not rest:
                self.i += 1
                out.append(self.nested(indent, lineno))
            elif self._is_key(rest, lineno):
                # "- KEY: v" opens a map whose keys sit at the column of KEY
                col = ind + len(body) - len(rest)
                self.lines[self.i] = (lineno, col, rest)
                out.append(self.map(col))
            else:
                self.i += 1
                out.append(_value(rest, lineno))
        return out

    def nested(self, indent: int, lineno: int, allow_same_seq: bool = False):
        """The block under a line that ended in ':' or '-': deeper lines, or a
        list at the key's own indent; null when there is none."""
        if self.i < len(self.lines):
            _, ind, body = self.lines[self.i]
            is_seq = body == "-" or body.startswith("- ")
            if ind > indent or (allow_same_seq and ind == indent and is_seq):
                return self.node(ind)
        return None

    def _is_key(self, body: str, lineno: int) -> bool:
        if body[0] in "[{":
            return False
        parser = _Flow(body, lineno)
        try:
            parser.scalar(in_flow=False, key=True)
        except YAMLSubsetError:
            return False
        return parser.peek() == ":"

    def map(self, indent: int):
        out = {}
        while self.i < len(self.lines):
            lineno, ind, body = self.lines[self.i]
            if ind < indent:
                break
            if ind > indent:
                raise YAMLSubsetError(lineno, f"unexpected indentation at {body!r}")
            if body == "-" or body.startswith("- "):
                break
            if body[0] == "?":
                raise YAMLSubsetError(lineno, "complex keys are outside the subset")
            parser = _Flow(body, lineno)
            if body[0] in "[{":
                raise YAMLSubsetError(lineno, "flow collections as keys are outside the subset")
            key = parser.scalar(in_flow=False, key=True)
            if parser.peek() != ":":
                raise YAMLSubsetError(lineno, f"expected 'KEY: value', got {body!r}")
            parser.pos += 1
            rest = body[parser.pos:].strip()
            self.i += 1
            if rest:
                out[key] = _value(rest, lineno)
            else:
                out[key] = self.nested(indent, lineno, allow_same_seq=True)
        return out


def load(text: str):
    """Parse ``text`` (the subset above) into dicts, lists and scalars."""
    return _Block(text).parse()


def load_file(path):
    with open(Path(path)) as f:
        return load(f.read())

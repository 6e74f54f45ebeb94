"""A reader of the YAML subset the repo's config files use, resolving
scalars exactly as PyYAML's ``safe_load`` does (YAML 1.1).

The card's machine has no ``yaml``, so the port's config layer reads
``configs/bench_all.yaml`` with this module.  The subset:

* block mappings and block sequences (of mappings, scalars or flow
  collections), a sequence as a mapping's value at the key's indent or
  deeper, ``- key: value`` items that open a mapping;
* flow mappings and flow sequences (``{a: 1, b: [2, 3]}``), which may
  continue over several lines;
* full-line and trailing comments;
* plain scalars on one line, single-quoted and double-quoted scalars on
  one line.

Plain scalars resolve by PyYAML's implicit resolvers, quirks included:
``1e-3`` (no dot) is a string, ``1.0e-3`` a float, ``yes``/``no``/
``on``/``off`` are booleans, ``~`` and the empty value are null, ``1_000``
is an int, ``0o17`` a string and ``017`` octal.  Anything outside the
subset raises :class:`YamlSubsetError` naming its line: anchors and
aliases, tags, block scalars (``|``, ``>``), directives, document markers,
complex keys, multi-line plain or quoted scalars, tabs, timestamps and
merge keys.  The reader never returns a value other than ``safe_load``'s.
"""

from __future__ import annotations

import re
from typing import Any, List, Tuple

__all__ = ["YamlSubsetError", "safe_load", "load_path"]


class YamlSubsetError(ValueError):
    """The document is outside the subset (or is not valid YAML)."""


# PyYAML's implicit resolvers (``yaml/resolver.py``), keyed there by the
# value's first character; the same tests in the same order here
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
_MERGE = re.compile(r"^(?:<<)$")
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP = re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                    |[0-9][0-9][0-9][0-9] -[0-9][0-9]? -[0-9][0-9]?
                     (?:[Tt]|[ \t]+)[0-9][0-9]?
                     :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
                     (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""",
                        re.X)
_VALUE = re.compile(r"^(?:=)$")

_BOOL_VALUES = {"yes": True, "no": False, "true": True, "false": False,
                "on": True, "off": False}

#: characters that cannot start a plain scalar
_INDICATORS = set(",[]{}#&*!|>'\"%@`")
#: characters that end a plain scalar inside a flow collection
_FLOW_STOP = set(",?[]{}")
#: double-quoted escapes (PyYAML's ``ESCAPE_REPLACEMENTS`` / ``CODES``)
_ESCAPES = {"0": "\0", "a": "\x07", "b": "\x08", "t": "\x09", "\t": "\x09",
            "n": "\x0a", "v": "\x0b", "f": "\x0c", "r": "\x0d", "e": "\x1b",
            " ": " ", '"': '"', "\\": "\\", "/": "/", "N": "\x85",
            "_": "\xa0", "L": " ", "P": " "}
_CODES = {"x": 2, "u": 4, "U": 8}


def _sexagesimal(value: str, cast) -> Any:
    digits = [cast(part) for part in value.split(":")]
    digits.reverse()
    base, out = 1, 0
    for d in digits:
        out += d * base
        base *= 60
    return out


def _construct_int(value: str) -> int:
    value = value.replace("_", "")
    sign = -1 if value[0] == "-" else 1
    if value[0] in "+-":
        value = value[1:]
    if value == "0":
        return 0
    if value.startswith("0b"):
        return sign * int(value[2:], 2)
    if value.startswith("0x"):
        return sign * int(value[2:], 16)
    if value[0] == "0":
        return sign * int(value, 8)
    if ":" in value:
        return sign * _sexagesimal(value, int)
    return sign * int(value)


def _construct_float(value: str) -> float:
    value = value.replace("_", "").lower()
    sign = -1 if value[0] == "-" else 1
    if value[0] in "+-":
        value = value[1:]
    if value == ".inf":
        return sign * float("inf")
    if value == ".nan":
        return float("nan")
    if ":" in value:
        return sign * _sexagesimal(value, float)
    return sign * float(value)


def resolve_plain(text: str, lineno: int = 0) -> Any:
    """A plain scalar's value as ``safe_load`` constructs it."""
    first = text[:1]
    if first in "yYnNtTfFoO" and first and _BOOL.match(text):
        return _BOOL_VALUES[text.lower()]
    if first in "-+0123456789." and first and _FLOAT.match(text):
        return _construct_float(text)
    if first in "-+0123456789" and first and _INT.match(text):
        return _construct_int(text)
    if first == "<" and _MERGE.match(text):
        raise YamlSubsetError(f"line {lineno}: merge key '<<' is outside "
                              f"the subset")
    if first in ("~", "n", "N", "") and _NULL.match(text):
        return None
    if first in "0123456789" and first and _TIMESTAMP.match(text):
        raise YamlSubsetError(f"line {lineno}: timestamp {text!r} is "
                              f"outside the subset")
    if first == "=" and _VALUE.match(text):
        raise YamlSubsetError(f"line {lineno}: the '=' value scalar is "
                              f"outside the subset")
    return text


_EMPTY = object()  # no inline value: the node is a nested block, or null


class _Reader:
    def __init__(self, text: str):
        if text.startswith("\ufeff"):
            text = text[1:]
        text = text.replace("\r\n", "\n")
        for n, line in enumerate(text.split("\n"), start=1):
            for ch in line:
                if ch == "\t":
                    raise YamlSubsetError(f"line {n}: tabs are outside the "
                                          f"subset")
                if not (" " <= ch <= "~" or ("\xa0" <= ch <= "\ud7ff")
                        or ("\ue000" <= ch <= "\ufffd" and ch != "\ufeff")
                        or ch >= "\U00010000"):
                    raise YamlSubsetError(f"line {n}: character {ch!r} is "
                                          f"outside the subset")
        self.lines: List[str] = text.split("\n")

    # -- helpers -------------------------------------------------------------
    def err(self, li: int, what: str) -> YamlSubsetError:
        return YamlSubsetError(f"line {li + 1}: {what}")

    @staticmethod
    def _comment_at(line: str, col: int) -> bool:
        return line[col] == "#" and (col == 0 or line[col - 1] == " ")

    def _rest_is_blank(self, li: int, col: int) -> bool:
        line = self.lines[li]
        while col < len(line) and line[col] == " ":
            col += 1
        return col >= len(line) or self._comment_at(line, col)

    def _blank(self, li: int) -> bool:
        return self._rest_is_blank(li, 0)

    def _next_line(self, li: int) -> int:
        """The first line at or after ``li`` that holds a node."""
        while li < len(self.lines) and self._blank(li):
            li += 1
        return li

    def _indent(self, li: int) -> int:
        line = self.lines[li]
        return len(line) - len(line.lstrip(" "))

    def _is_entry(self, li: int, col: int) -> bool:
        line = self.lines[li]
        return line.startswith("-", col) and (
            col + 1 == len(line) or line[col + 1] == " ")

    # -- documents -----------------------------------------------------------
    def document(self) -> Any:
        for li, line in enumerate(self.lines):
            s = line.lstrip(" ")
            if s.startswith("%") and line == s:
                raise self.err(li, "directives are outside the subset")
            if line.startswith(("---", "...")) and (
                    len(line) == 3 or line[3] == " "):
                raise self.err(li, "document markers are outside the subset")
        li = self._next_line(0)
        if li >= len(self.lines):
            return None
        ind = self._indent(li)
        value, li = self.block(li, ind)
        li = self._next_line(li)
        if li < len(self.lines):
            raise self.err(li, "unexpected content after the document's "
                               "top-level node")
        return value

    # -- block nodes ---------------------------------------------------------
    def block(self, li: int, ind: int) -> Tuple[Any, int]:
        """The block node whose first line is ``li``, at indent ``ind``."""
        if self._is_entry(li, ind):
            return self.sequence(li, ind)
        key = self.key(li, ind)
        if key is not None:
            return self.mapping(li, ind)
        value, col, li2 = self.inline(li, ind, flow=False)
        if value is _EMPTY:
            raise self.err(li, "expected a node")
        nxt = self._next_line(li2 + 1)
        if nxt < len(self.lines) and self._indent(nxt) > ind:
            raise self.err(nxt, "a multi-line scalar is outside the subset")
        return value, li2 + 1

    def nested(self, li: int, ind: int, allow_seq_at: bool) -> Tuple[Any, int]:
        """The value of a key or entry whose line holds nothing after the
        indicator: a block more indented than ``ind`` (or a sequence at
        ``ind`` itself, for a key), else null."""
        nxt = self._next_line(li + 1)
        if nxt < len(self.lines):
            n_ind = self._indent(nxt)
            if n_ind > ind:
                return self.block(nxt, n_ind)
            if allow_seq_at and n_ind == ind and self._is_entry(nxt, ind):
                return self.sequence(nxt, ind)
        return None, li + 1

    def after_inline(self, li: int, ind: int) -> None:
        """An inline value must not continue on a more indented line."""
        nxt = self._next_line(li + 1)
        if nxt < len(self.lines) and self._indent(nxt) > ind:
            raise self.err(nxt, "a multi-line scalar or an over-indented "
                                "line is outside the subset")

    def sequence(self, li: int, ind: int) -> Tuple[list, int]:
        out = []
        while li < len(self.lines):
            li = self._next_line(li)
            if li >= len(self.lines):
                break
            cur = self._indent(li)
            if cur < ind:
                break
            if cur > ind:
                raise self.err(li, "bad indentation in a sequence")
            if not self._is_entry(li, ind):
                break
            line = self.lines[li]
            col = ind + 1
            while col < len(line) and line[col] == " ":
                col += 1
            if self._rest_is_blank(li, ind + 1):
                value, li = self.nested(li, ind, allow_seq_at=False)
            else:
                # the entry's content, as if it began its own line at col
                self.lines[li] = " " * col + line[col:]
                if self._is_entry(li, col) or self.key(li, col) is not None:
                    value, li = self.block(li, col)
                else:
                    value, _, end = self.inline(li, col, flow=False)
                    self.after_inline(end, ind)
                    li = end + 1
            out.append(value)
        return out, li

    def key(self, li: int, col: int):
        """``(key, col after the ':')`` if line ``li`` holds a mapping key
        at ``col``, else None."""
        line = self.lines[li]
        if col >= len(line):
            return None
        ch = line[col]
        if ch in "'\"":
            text, end = self.quoted(li, col)
            j = end
            while j < len(line) and line[j] == " ":
                j += 1
            if j < len(line) and line[j] == ":" and (
                    j + 1 == len(line) or line[j + 1] == " "):
                return text, j + 1
            return None
        if ch == "?" and (col + 1 == len(line) or line[col + 1] == " "):
            raise self.err(li, "complex keys are outside the subset")
        if ch in "[{":
            return None
        j = col
        while j < len(line):
            if line[j] == ":" and (j + 1 == len(line) or line[j + 1] == " "):
                raw = line[col:j].rstrip(" ")
                if not raw:
                    raise self.err(li, "an empty key is outside the subset")
                self.check_plain(li, raw, flow=False)
                return resolve_plain(raw, li + 1), j + 1
            if self._comment_at(line, j):
                return None
            j += 1
        return None

    def mapping(self, li: int, ind: int) -> Tuple[dict, int]:
        out: dict = {}
        while li < len(self.lines):
            li = self._next_line(li)
            if li >= len(self.lines):
                break
            cur = self._indent(li)
            if cur < ind:
                break
            if cur > ind:
                raise self.err(li, "bad indentation in a mapping")
            if self._is_entry(li, ind):
                break
            found = self.key(li, ind)
            if found is None:
                raise self.err(li, "expected a 'key: value' line")
            key, col = found
            try:
                hash(key)
            except TypeError:
                raise self.err(li, "unhashable mapping key") from None
            value, _, end = self.inline(li, col, flow=False)
            if value is _EMPTY:
                value, li = self.nested(li, ind, allow_seq_at=True)
            else:
                self.after_inline(end, ind)
                li = end + 1
            out[key] = value
        return out, li

    # -- inline nodes --------------------------------------------------------
    def inline(self, li: int, col: int, flow: bool):
        """``(value, col, line)`` of the inline node at ``col`` of line
        ``li`` (a flow collection may end on a later line), with the rest
        of its last line checked to be blank; ``_EMPTY`` when the line
        holds nothing more."""
        line = self.lines[li]
        while col < len(line) and line[col] == " ":
            col += 1
        if col >= len(line) or self._comment_at(line, col):
            return _EMPTY, col, li
        ch = line[col]
        if ch in "[{":
            value, li, col = self.flow(li, col)
        elif ch in "'\"":
            value, col = self.quoted(li, col)
        else:
            end = col
            while end < len(line) and not self._comment_at(line, end):
                if line[end] == ":" and (end + 1 == len(line)
                                         or line[end + 1] == " "):
                    raise self.err(li, "a mapping value is not allowed here")
                end += 1
            raw = line[col:end].rstrip(" ")
            self.check_plain(li, raw, flow=False)
            value, col = resolve_plain(raw, li + 1), end
        if not self._rest_is_blank(li, col):
            raise self.err(li, "unexpected text after a value")
        return value, col, li

    def check_plain(self, li: int, raw: str, flow: bool) -> None:
        if not raw:
            return
        c0 = raw[0]
        nxt = raw[1:2]
        if c0 in _INDICATORS:
            raise self.err(li, f"a scalar starting with {c0!r} is outside "
                               f"the subset")
        if c0 in "-?:" and (not nxt or nxt == " " or
                            (flow and (c0 != "-" or nxt in _FLOW_STOP))):
            raise self.err(li, f"a scalar starting with {c0!r} is outside "
                               f"the subset")

    def quoted(self, li: int, col: int) -> Tuple[str, int]:
        """A one-line quoted scalar at ``col``: ``(text, col after it)``."""
        line = self.lines[li]
        q = line[col]
        out = []
        j = col + 1
        while True:
            if j >= len(line):
                raise self.err(li, "a multi-line quoted scalar is outside "
                                   "the subset")
            ch = line[j]
            if q == "'":
                if ch == "'":
                    if line[j + 1:j + 2] == "'":
                        out.append("'")
                        j += 2
                        continue
                    return "".join(out), j + 1
                out.append(ch)
                j += 1
                continue
            if ch == '"':
                return "".join(out), j + 1
            if ch != "\\":
                out.append(ch)
                j += 1
                continue
            esc = line[j + 1:j + 2]
            if esc in _ESCAPES:
                out.append(_ESCAPES[esc])
                j += 2
            elif esc in _CODES:
                n = _CODES[esc]
                digits = line[j + 2:j + 2 + n]
                if len(digits) != n or not all(
                        d in "0123456789abcdefABCDEF" for d in digits):
                    raise self.err(li, "bad escape in a quoted scalar")
                out.append(chr(int(digits, 16)))
                j += 2 + n
            else:
                raise self.err(li, "an escape outside the subset")

    # -- flow collections ----------------------------------------------------
    def _skip(self, li: int, col: int) -> Tuple[int, int]:
        """Past spaces, comments and line ends inside a flow collection."""
        while li < len(self.lines):
            line = self.lines[li]
            while col < len(line) and line[col] == " ":
                col += 1
            if col < len(line) and not self._comment_at(line, col):
                return li, col
            li, col = li + 1, 0
        raise self.err(len(self.lines) - 1, "unterminated flow collection")

    def flow(self, li: int, col: int) -> Tuple[Any, int, int]:
        """The flow collection opening at ``col``: ``(value, line, col
        after it)``."""
        opener = self.lines[li][col]
        closer = "}" if opener == "{" else "]"
        out: Any = {} if opener == "{" else []
        li, col = self._skip(li, col + 1)
        if self.lines[li][col] == closer:
            return out, li, col + 1
        while True:
            if opener == "{":
                key, li, col = self.flow_node(li, col, key=True)
                try:
                    hash(key)
                except TypeError:
                    raise self.err(li, "unhashable mapping key") from None
                li, col = self._skip(li, col)
                line = self.lines[li]
                if line[col] == ":":
                    li, col = self._skip(li, col + 1)
                    if self.lines[li][col] in ",}":
                        value = None
                    else:
                        value, li, col = self.flow_node(li, col, key=False)
                        li, col = self._skip(li, col)
                else:
                    value = None
                out[key] = value
            else:
                value, li, col = self.flow_node(li, col, key=False)
                li, col = self._skip(li, col)
                if self.lines[li][col] == ":":
                    raise self.err(li, "a pair inside a flow sequence is "
                                       "outside the subset")
                out.append(value)
            ch = self.lines[li][col]
            if ch == closer:
                return out, li, col + 1
            if ch != ",":
                raise self.err(li, f"expected ',' or {closer!r} in a flow "
                                   f"collection")
            li, col = self._skip(li, col + 1)
            if self.lines[li][col] in ",]}":
                raise self.err(li, "an empty flow entry is outside the "
                                   "subset")

    def flow_node(self, li: int, col: int, key: bool) -> Tuple[Any, int, int]:
        line = self.lines[li]
        ch = line[col]
        if ch in "[{":
            return self.flow(li, col)
        if ch in "'\"":
            text, col = self.quoted(li, col)
            return text, li, col
        end = col
        while end < len(line):
            c = line[end]
            if c in _FLOW_STOP or self._comment_at(line, end):
                break
            if c == ":" and (end + 1 == len(line) or
                             line[end + 1] in " ,[]{}"):
                break
            if c == ":":
                raise self.err(li, "a ':' inside a flow scalar is outside "
                                   "the subset")
            end += 1
        raw = line[col:end].rstrip(" ")
        if not raw:
            raise self.err(li, "an empty flow entry is outside the subset")
        self.check_plain(li, raw, flow=True)
        if end < len(line) and line[end] in "?[{":
            raise self.err(li, f"{line[end]!r} after a flow scalar is "
                               f"outside the subset")
        if end >= len(line) or self._comment_at(line, end):
            # the scalar ends its line: a continuation would fold into it
            nli, ncol = self._skip(li + 1, 0) if li + 1 < len(self.lines) \
                else (li, end)
            if nli != li and self.lines[nli][ncol] not in ",]}:":
                raise self.err(nli, "a multi-line flow scalar is outside "
                                    "the subset")
        return resolve_plain(raw, li + 1), li, end


def safe_load(text: str) -> Any:
    """The document's value, as ``yaml.safe_load`` gives it."""
    return _Reader(text).document()


def load_path(path: str) -> Any:
    with open(path, encoding="utf-8") as f:
        return safe_load(f.read())

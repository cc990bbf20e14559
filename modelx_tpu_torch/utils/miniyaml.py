"""A reader of the subset of YAML that ``modelx.yaml`` files use.

The JAX package reads ``modelx.yaml`` with ``yaml.safe_load``; the card's
host has no pyyaml, so the port reads the file itself. The subset is what
``yaml.safe_dump`` of a model config emits and what hand-written configs
use:

- block mappings and block sequences (a sequence may sit at its key's
  indentation, as pyyaml writes it);
- flow ``[...]`` and ``{...}``, on one line or several;
- plain, single-quoted and double-quoted scalars, folded across lines as
  YAML folds them (pyyaml wraps long strings at 80 columns);
- ``null``/``~``/empty, the YAML 1.1 booleans, ints (decimal, ``0x``,
  ``0b``, leading-zero octal, ``_`` separators, base 60) and floats
  (``.inf``, ``.nan``, base 60), resolved as pyyaml's resolver does;
- ``#`` comments, a leading ``---`` and a trailing ``...``.

- ``? key`` / ``: value`` entries with a scalar key (pyyaml writes a key
  that holds a line-break character so);
- block scalars, literal ``|`` and folded ``>``, with a chomping
  indicator (``-`` strip, ``+`` keep) and an explicit indentation
  indicator, as a mapping value or a sequence item; folded and chomped as
  pyyaml's scanner folds and chomps them.

Anything else (anchors, aliases, tags, directives, collection keys, merge
keys, timestamps, several documents) raises ``ValueError``: a value
outside the subset is never read as something else.
"""

from __future__ import annotations

import math
import re

_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_BOOL = {"yes": True, "Yes": True, "YES": True, "no": False, "No": False, "NO": False,
         "true": True, "True": True, "TRUE": True, "false": False, "False": False,
         "FALSE": False, "on": True, "On": True, "ON": True, "off": False, "Off": False,
         "OFF": False}
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
_TIMESTAMP = re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                    |[0-9][0-9][0-9][0-9] -[0-9][0-9]? -[0-9][0-9]?
                     (?:[Tt]|[ \t]+)[0-9][0-9]?
                     :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
                     (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""", re.X)

_ESCAPES = {"0": "\0", "a": "\x07", "b": "\x08", "t": "\t", "\t": "\t", "n": "\n",
            "v": "\x0b", "f": "\x0c", "r": "\r", "e": "\x1b", " ": " ", '"': '"',
            "\\": "\\", "/": "/", "N": "\x85", "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}
_END = "\0 \t\n"
# YAML's printable characters (pyyaml's reader refuses any other)
_NON_PRINTABLE = re.compile("[^\x09\x0a\x0d\x20-\x7e\x85\xa0-\ud7ff\ue000-\ufffd"
                            "\U00010000-\U0010ffff]")
_UNSUPPORTED_START = {"&": "anchors", "*": "aliases", "!": "tags",
                      "|": "block scalars inside flow collections",
                      ">": "block scalars inside flow collections", "%": "directives",
                      "@": "reserved indicators", "`": "reserved indicators"}


def _resolve(text: str):
    """A plain scalar's value, as pyyaml's implicit resolvers give it."""
    if _NULL.match(text):
        return None
    if text in _BOOL:
        return _BOOL[text]
    if text[:1] in "-+0123456789." and _FLOAT.match(text):
        value = text.replace("_", "").lower()
        sign = -1.0 if value[0] == "-" else 1.0
        value = value.lstrip("+-")
        if value == ".inf":
            return sign * math.inf
        if value == ".nan":
            return math.nan
        if ":" in value:
            return sign * _base60([float(p) for p in value.split(":")])
        return sign * float(value)
    if text[:1] in "-+0123456789" and _INT.match(text):
        value = text.replace("_", "")
        sign = -1 if value[0] == "-" else 1
        value = value.lstrip("+-")
        if value == "0":
            return 0
        if value.startswith("0b"):
            return sign * int(value[2:], 2)
        if value.startswith("0x"):
            return sign * int(value[2:], 16)
        if value[0] == "0":
            return sign * int(value, 8)
        if ":" in value:
            return sign * _base60([int(p) for p in value.split(":")])
        return sign * int(value)
    if text[:1].isdigit() and _TIMESTAMP.match(text):
        raise ValueError(f"timestamps are outside the modelx.yaml subset: {text!r}")
    if text in ("<<", "="):
        raise ValueError(f"{text!r} (merge/value keys) is outside the modelx.yaml subset")
    return text


def _base60(parts):
    value, base = 0, 1
    for digit in reversed(parts):
        value += digit * base
        base *= 60
    return value


class _Parser:
    def __init__(self, text: str) -> None:
        if text.startswith("\ufeff"):
            text = text[1:]
        self.s = text.replace("\r\n", "\n").replace("\r", "\n") + "\0"
        self.pos = 0

    # -- position helpers -------------------------------------------------------

    def error(self, what: str) -> ValueError:
        line = self.s.count("\n", 0, self.pos) + 1
        return ValueError(f"modelx.yaml line {line}: {what}")

    def peek(self, k: int = 0) -> str:
        return self.s[min(self.pos + k, len(self.s) - 1)]

    def column(self) -> int:
        return self.pos - (self.s.rfind("\n", 0, self.pos) + 1)

    def skip_spaces(self) -> None:
        while self.peek() == " ":
            self.pos += 1
        if self.peek() == "\t":
            raise self.error("tabs are outside the modelx.yaml subset")

    def skip_comment(self) -> None:
        if self.peek() == "#":
            while self.peek() not in "\n\0":
                self.pos += 1

    def end_line(self) -> None:
        """Past trailing spaces and a comment to the next line, or fail."""
        self.skip_spaces()
        self.skip_comment()
        if self.peek() == "\n":
            self.pos += 1
        elif self.peek() != "\0":
            raise self.error(f"unexpected {self.peek()!r}")

    def next_content(self) -> int:
        """Skip blank and comment lines; the column of the next content
        character (at ``self.pos``), or -1 at the end of the text."""
        while True:
            self.skip_spaces()
            self.skip_comment()
            if self.peek() == "\n":
                self.pos += 1
            elif self.peek() == "\0":
                return -1
            else:
                return self.column()

    def at_marker(self, marker: str) -> bool:
        return (self.column() == 0 and self.s.startswith(marker, self.pos)
                and self.peek(3) in _END)

    # -- documents --------------------------------------------------------------

    def document(self):
        col = self.next_content()
        if col == 0 and self.at_marker("---"):
            self.pos += 3
            self.end_line()
            col = self.next_content()
        value = None if col < 0 or self.at_marker("...") else self.block_node(-1)
        col = self.next_content()
        if col == 0 and self.at_marker("..."):
            self.pos += 3
            self.end_line()
            col = self.next_content()
        if col >= 0:
            raise self.error("more than one document, or content after the document")
        return value

    def block_node(self, parent: int):
        """The node at ``self.pos`` (its first character), inside a block
        whose indentation is ``parent``."""
        col = self.column()
        if self.at_marker("---") or self.at_marker("..."):
            raise self.error("document markers inside a document")
        if self.peek() == "-" and self.peek(1) in _END:
            return self.block_sequence(col)
        if self.is_mapping_key() or self.is_complex_key():
            return self.block_mapping(col)
        value = self.inline_value(parent)
        self.end_line()
        return value

    def is_mapping_key(self) -> bool:
        """Does a ``key:`` start at ``self.pos`` (on this line)?"""
        save = self.pos
        try:
            self.scalar_key()
            self.skip_spaces()
            return self.peek() == ":" and self.peek(1) in _END
        except ValueError:
            return False
        finally:
            self.pos = save

    def is_complex_key(self) -> bool:
        return self.peek() == "?" and self.peek(1) in _END

    def block_mapping(self, indent: int) -> dict:
        out: dict = {}
        while True:
            if self.is_complex_key():
                # "? key" then ": value" (pyyaml writes a key with a line
                # break character so); only a scalar key is in the subset
                self.pos += 1
                self.skip_spaces()
                if self.peek() in "[{":
                    raise self.error("collection keys are outside the modelx.yaml subset")
                key = self.inline_value(indent)
                self.end_line()
                if self.next_content() != indent:
                    raise self.error("expected ': value' after a '?' key")
                complex_key = True
            else:
                key = self.scalar_key()
                complex_key = False
            self.skip_spaces()
            if self.peek() != ":":
                raise self.error("expected ':' after a mapping key")
            self.pos += 1
            self.skip_spaces()
            if self.peek() in "#\n\0":
                self.end_line()
                col = self.next_content()
                if col > indent:
                    out[key] = self.block_node(indent)
                elif col == indent and self.peek() == "-" and self.peek(1) in _END:
                    out[key] = self.block_sequence(indent)
                else:
                    out[key] = None
            elif complex_key:  # ": - item" or ": key: value" start a block
                out[key] = self.block_node(indent)
            else:
                out[key] = self.inline_value(indent)
                self.end_line()
            col = self.next_content()
            if col < indent:
                return out
            if col > indent:
                raise self.error("bad indentation of a mapping entry")
            if self.at_marker("---") or self.at_marker("..."):
                return out

    def block_sequence(self, indent: int) -> list:
        out: list = []
        while True:
            self.pos += 1  # the "-"
            self.skip_spaces()
            if self.peek() in "#\n\0":
                self.end_line()
                col = self.next_content()
                out.append(self.block_node(indent) if col > indent else None)
            else:
                out.append(self.block_node(indent))
            col = self.next_content()
            if col < indent or (col == indent and not (self.peek() == "-"
                                                       and self.peek(1) in _END)):
                return out
            if col > indent:
                raise self.error("bad indentation of a sequence entry")

    # -- scalars and flow collections ---------------------------------------------

    def scalar_key(self):
        c = self.peek()
        if c in "'\"":
            return self.quoted()
        if c in "[{":
            raise self.error("flow collections as keys are outside the modelx.yaml subset")
        text = self.plain(flow=False, parent=None)
        return _resolve(text)

    def inline_value(self, parent: int):
        c = self.peek()
        if c in "'\"":
            return self.quoted()
        if c in "[{":
            return self.flow()
        if c in "|>":
            return self.block_scalar(parent)
        return _resolve(self.plain(flow=False, parent=parent))

    def block_scalar(self, parent: int) -> str:
        """A literal ``|`` or folded ``>`` scalar in a block whose
        indentation is ``parent``, scanned as pyyaml's
        ``scan_block_scalar``. Leaves ``self.pos`` on the line break before
        the first line it did not take (the caller's ``end_line`` steps
        over it), or at the end of the text."""
        folded = self.peek() == ">"
        self.pos += 1
        chomping = increment = None  # clip; the indentation auto-detected
        for _ in range(2):
            c = self.peek()
            if c in "+-" and chomping is None:
                chomping = c == "+"
            elif c in "0123456789" and increment is None:
                if c == "0":
                    raise self.error("the indentation indicator must be 1-9")
                increment = int(c)
            else:
                break
            self.pos += 1
        if self.peek() not in _END:
            raise self.error(f"expected a chomping or indentation indicator, found "
                             f"{self.peek()!r}")
        self.end_line()
        min_indent = max(parent + 1, 1)
        if increment is None:
            breaks, max_indent = [], 0
            while self.peek() in " \n":
                if self.peek() == "\n":
                    breaks.append("\n")
                    self.pos += 1
                else:
                    self.pos += 1
                    max_indent = max(max_indent, self.column())
            indent = max(min_indent, max_indent)
        else:
            indent = min_indent + increment - 1
            breaks = self.block_breaks(indent)
        chunks: list[str] = []
        line_break = ""
        while self.column() == indent and self.peek() != "\0":
            chunks += breaks
            leading_non_space = self.peek() not in " \t"
            end = self.s.find("\n", self.pos)
            end = len(self.s) - 1 if end < 0 else end
            chunks.append(self.s[self.pos:end])
            self.pos = end
            line_break = ""
            if self.peek() == "\n":
                line_break = "\n"
                self.pos += 1
            breaks = self.block_breaks(indent)
            if self.column() != indent or self.peek() == "\0":
                break
            if folded and line_break and leading_non_space and self.peek() not in " \t":
                if not breaks:
                    chunks.append(" ")
            else:
                chunks.append(line_break)
        if chomping is not False:
            chunks.append(line_break)
        if chomping is True:
            chunks += breaks
        if self.peek() != "\0":
            self.pos = self.s.rfind("\n", 0, self.pos)
        return "".join(chunks)

    def block_breaks(self, indent: int) -> list[str]:
        """Inside a block scalar: the indentation up to ``indent`` and the
        blank lines after a line, one ``\\n`` each."""
        out = []
        while self.column() < indent and self.peek() == " ":
            self.pos += 1
        while self.peek() == "\n":
            out.append("\n")
            self.pos += 1
            while self.column() < indent and self.peek() == " ":
                self.pos += 1
        return out

    def check_plain_start(self, flow: bool) -> None:
        c = self.peek()
        if c in _UNSUPPORTED_START:
            raise self.error(f"{_UNSUPPORTED_START[c]} are outside the modelx.yaml subset")
        if c in "-:?" and self.peek(1) in _END + (",[]{}" if flow else ""):
            raise self.error(f"unexpected {c!r}")
        if c in ",[]{}#":
            raise self.error(f"unexpected {c!r}")

    def plain_stop(self, flow: bool) -> bool:
        c, n = self.peek(), self.peek(1)
        return (c in _END or (c == ":" and (n in _END or (flow and n in ",[]{}")))
                or (flow and c in ",?[]{}"))

    def plain(self, flow: bool, parent: int | None) -> str:
        """A plain scalar, folded as pyyaml's scanner folds it. ``parent``
        None scans one line (a key); else the scalar continues on lines
        indented deeper than ``parent`` (any line, in a flow collection).
        Stops after its last character: trailing spaces, comments and
        line breaks are left to the caller."""
        self.check_plain_start(flow)
        chunks: list[str] = []
        spaces = ""
        while True:
            if self.peek() == "#":
                break
            start = self.pos
            while not self.plain_stop(flow):
                self.pos += 1
            if self.pos == start:
                break
            chunks += [spaces, self.s[start:self.pos]]
            end = self.pos
            spaces = self.plain_spaces(parent)
            if (not spaces or self.peek() == "#"
                    or (not flow and parent is not None and self.column() <= parent)):
                break
        self.pos = end if chunks else self.pos
        return "".join(chunks)

    def plain_spaces(self, parent: int | None) -> str:
        """The folded white space after a plain chunk: the spaces, or for a
        line break " " (one break) or a newline per blank line."""
        start = self.pos
        while self.peek() == " ":
            self.pos += 1
        if self.peek() == "\t":
            raise self.error("tabs are outside the modelx.yaml subset")
        if self.peek() != "\n":
            return self.s[start:self.pos]
        if parent is None:
            return ""
        self.pos += 1
        breaks = 0
        while True:
            if self.at_line_marker() and self.column() == 0:
                return ""
            while self.peek() == " ":
                self.pos += 1
            if self.peek() != "\n":
                return "\n" * breaks if breaks else " "
            breaks += 1
            self.pos += 1

    def at_line_marker(self) -> bool:
        line = self.s.rfind("\n", 0, self.pos) + 1
        return (self.s.startswith(("---", "..."), line)
                and self.s[line + 3] in _END)

    def quoted(self) -> str:
        q = self.peek()
        double = q == '"'
        self.pos += 1
        chunks: list[str] = []
        while True:
            c = self.peek()
            if c == "\0":
                raise self.error("unterminated quoted scalar")
            if c == q:
                if not double and self.peek(1) == "'":
                    chunks.append("'")
                    self.pos += 2
                    continue
                self.pos += 1
                return "".join(chunks)
            if double and c == "\\":
                e = self.peek(1)
                if e in _ESCAPES:
                    chunks.append(_ESCAPES[e])
                    self.pos += 2
                elif e in _HEX_ESCAPES:
                    n = _HEX_ESCAPES[e]
                    digits = self.s[self.pos + 2:self.pos + 2 + n]
                    if len(digits) != n or not all(d in "0123456789abcdefABCDEF" for d in digits):
                        raise self.error(f"bad escape \\{e}{digits}")
                    chunks.append(chr(int(digits, 16)))
                    self.pos += 2 + n
                elif e == "\n":
                    self.pos += 2
                    chunks.extend(self.quoted_breaks())
                else:
                    raise self.error(f"unknown escape \\{e}")
                continue
            if c in " \t":
                start = self.pos
                while self.peek() in " \t":
                    self.pos += 1
                if self.peek() != "\n":
                    chunks.append(self.s[start:self.pos])
                continue
            if c == "\n":
                self.pos += 1
                breaks = self.quoted_breaks()
                chunks.extend(breaks if breaks else [" "])
                continue
            chunks.append(c)
            self.pos += 1

    def quoted_breaks(self) -> list[str]:
        """Inside a quoted scalar after a line break: skip the next lines'
        indentation, one ``\\n`` per blank line."""
        out = []
        while True:
            if self.at_line_marker() and self.column() == 0:
                raise self.error("document marker inside a quoted scalar")
            while self.peek() in " \t":
                self.pos += 1
            if self.peek() != "\n":
                return out
            out.append("\n")
            self.pos += 1

    def flow_space(self) -> None:
        while True:
            c = self.peek()
            if c in " \t\n":
                self.pos += 1
            elif c == "#" and self.s[self.pos - 1] in " \t\n":
                self.skip_comment()
            else:
                return

    def flow_node(self):
        c = self.peek()
        if c in "'\"":
            return self.quoted()
        if c in "[{":
            return self.flow()
        return _resolve(self.plain(flow=True, parent=-1))

    def flow(self):
        opening = self.peek()
        closing = "]" if opening == "[" else "}"
        self.pos += 1
        out: list | dict = [] if opening == "[" else {}
        while True:
            self.flow_space()
            if self.peek() == closing:
                self.pos += 1
                return out
            if self.peek() == "\0":
                raise self.error(f"unterminated flow collection, expected {closing!r}")
            item = self.flow_node()
            self.flow_space()
            if self.peek() == ":":
                if isinstance(out, list):
                    raise self.error("mappings inside a flow sequence are outside the "
                                     "modelx.yaml subset")
                self.pos += 1
                self.flow_space()
                value = None if self.peek() in ",}" else self.flow_node()
                out[item] = value
                self.flow_space()
            elif isinstance(out, dict):
                out[item] = None
            else:
                out.append(item)
            if self.peek() == ",":
                self.pos += 1
            elif self.peek() != closing:
                raise self.error(f"expected ',' or {closing!r} in a flow collection")


def loads(text: str | bytes):
    """Parse one YAML document of the subset; ``ValueError`` outside it."""
    if isinstance(text, bytes):
        try:
            text = text.decode("utf-8")
        except UnicodeDecodeError as e:
            raise ValueError(f"modelx.yaml is not UTF-8: {e}") from None
    bad = _NON_PRINTABLE.search(text) or re.search("[\x85\u2028\u2029]", text)
    if bad:
        raise ValueError(f"modelx.yaml: character U+{ord(bad.group()):04X} is outside the "
                         "subset (non-printable, or a Unicode line break)")
    return _Parser(text).document()


# -- writing -------------------------------------------------------------------

# a string pyyaml writes plain when the resolver would read it back as a
# string: no indicator first, no ": " or " #", no edge spaces
_PLAIN_CHARS = re.compile(r"[A-Za-z0-9_./@=,+()%$^~<;'\"\\ -]*\Z")
_FIRST_INDICATORS = set("-?:,[]{}#&*!|>'\"%@`")
_WIDTH = 80  # pyyaml folds longer lines of spaced text; the subset refuses them


def _dump_scalar(value) -> str:
    if value is None:
        return "null"
    if value is True or value is False:
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        if value != value:
            return ".nan"
        if value in (math.inf, -math.inf):
            return ".inf" if value > 0 else "-.inf"
        text = repr(value).lower()
        if "." not in text and "e" in text:
            text = text.replace("e", ".0e", 1)
        return text
    if isinstance(value, dict) and not value:
        return "{}"
    if isinstance(value, list) and not value:
        return "[]"
    if not isinstance(value, str):
        raise ValueError(f"cannot write {type(value).__name__} values")
    if "\n" in value or _NON_PRINTABLE.search(value) or not value.isascii():
        raise ValueError(f"{value!r} is outside the written subset (line breaks, non-ASCII)")
    if " " in value and len(value) > _WIDTH // 2:
        raise ValueError(f"{value!r} is outside the written subset (a long spaced string)")
    try:
        plain = isinstance(_resolve(value), str)
    except ValueError:
        plain = False  # a timestamp or another type the reader refuses
    first = value[:1]
    if (not plain or not value or not _PLAIN_CHARS.match(value)
            or value != value.strip() or ": " in value or " #" in value
            or value.endswith(":")
            or (first in _FIRST_INDICATORS and not (first == "-" and value[1:2] not in ("", " ")))):
        return "'" + value.replace("'", "''") + "'"
    return value


def _block(value) -> bool:
    return isinstance(value, (dict, list)) and bool(value)


def _dump_lines(obj, indent: int) -> list[str]:
    pad = " " * indent
    out: list[str] = []
    if isinstance(obj, dict):
        for key, value in obj.items():
            key = _dump_scalar(key)
            if _block(value):
                out.append(f"{pad}{key}:")
                # a sequence under a key sits at the key's indentation
                out += _dump_lines(value, indent if isinstance(value, list) else indent + 2)
            else:
                out.append(f"{pad}{key}: {_dump_scalar(value)}")
        return out
    for item in obj:
        if _block(item):
            sub = _dump_lines(item, indent + 2)
            out.append(f"{pad}- {sub[0][indent + 2:]}")
            out += sub[1:]
        else:
            out.append(f"{pad}- {_dump_scalar(item)}")
    return out


def dumps(obj) -> str:
    """A mapping or sequence of strings, numbers, booleans and nulls as
    block YAML, byte for byte as ``yaml.safe_dump(obj, sort_keys=False)``
    writes it, for the subset this module writes: ASCII strings without
    line breaks, short enough that pyyaml does not fold them. Anything
    else raises ``ValueError``."""
    if not _block(obj):
        raise ValueError("the document must be a non-empty mapping or sequence")
    return "\n".join(_dump_lines(obj, 0)) + "\n"

"""The YAML that a run's config.yml holds, without PyYAML.

`dump` writes what ``yaml.safe_dump(tree, sort_keys=False)`` writes for a
tree of str-keyed dicts whose leaves are None, bool, int, float, str or
lists of those: 2-space block mappings, block sequences ``- item`` at their
key's indentation, ``[]`` for an empty list, YAML 1.1 scalars, strings plain
where that reads back as the same string and quoted otherwise. `load` reads
that subset back, plus flow sequences of scalars (``[16, 12]``), comments
and blank lines; anything else raises ValueError. `parse_scalar` resolves
one scalar as ``yaml.safe_load`` does under YAML 1.1: ``1e-3`` without a dot
is a string, ``on``/``off``/``yes``/``no`` are booleans, ``0x1f`` is 31.
"""

from __future__ import annotations

import math
import re

_BOOL = {v: b for b, vs in ((True, "yes Yes YES true True TRUE on On ON"),
                            (False, "no No NO false False FALSE off Off OFF"))
         for v in vs.split()}
_NULL = {"", "~", "null", "Null", "NULL"}
_INT = re.compile(r"""[-+]?(?:0b[01_]+|0x[0-9a-fA-F_]+|0[0-7_]+|0|[1-9][0-9_]*)
                      |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+""", re.X)
_FLOAT = re.compile(r"""[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                        |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                        |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                        |[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN)""", re.X)
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t",
            "n": "\n", "v": "\v", "f": "\f", "r": "\r", "e": "\x1b",
            " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
            "_": "\xa0", "L": " ", "P": " "}
_HEX = {"x": 2, "u": 4, "U": 8}


def _sexagesimal(text: str, cast):
    sign = -1 if text[0] == "-" else 1
    value = 0
    for part in text.lstrip("+-").split(":"):
        value = value * 60 + cast(part)
    return sign * value


def _resolve_plain(text: str):
    """A plain scalar under YAML 1.1 (PyYAML's resolver and constructors)."""
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.fullmatch(text):
        t = text.replace("_", "")
        if ":" in t:
            return _sexagesimal(t, int)
        sign = -1 if t[0] == "-" else 1
        t = t.lstrip("+-")
        if t.startswith("0b"):
            return sign * int(t[2:], 2)
        if t.startswith("0x"):
            return sign * int(t[2:], 16)
        if len(t) > 1 and t[0] == "0":
            return sign * int(t, 8)
        return sign * int(t)
    if _FLOAT.fullmatch(text):
        t = text.replace("_", "").lower()
        if t.endswith(".inf"):
            return -math.inf if t[0] == "-" else math.inf
        if t.endswith(".nan"):
            return math.nan
        if ":" in t:
            return float(_sexagesimal(t, float))
        return float(t)
    return text


def _unquote(text: str) -> str:
    q, body = text[0], text[1:-1]
    if len(text) < 2 or text[-1] != q:
        raise ValueError(f"unterminated quoted scalar {text!r}")
    if q == "'":
        return body.replace("''", "'")
    out, i = [], 0
    while i < len(body):
        c = body[i]
        if c != "\\":
            out.append(c)
            i += 1
            continue
        e = body[i + 1]
        if e in _HEX:
            n = _HEX[e]
            out.append(chr(int(body[i + 2:i + 2 + n], 16)))
            i += 2 + n
        elif e in _ESCAPES:
            out.append(_ESCAPES[e])
            i += 2
        else:
            raise ValueError(f"unknown escape \\{e} in {text!r}")
    return "".join(out)


def _split_flow(body: str) -> list:
    """The items of a flow sequence's body, split at commas outside quotes."""
    items, cur, quote = [], [], None
    for c in body:
        if quote:
            cur.append(c)
            if c == quote:
                quote = None
        elif c in "'\"":
            quote = c
            cur.append(c)
        elif c == ",":
            items.append("".join(cur))
            cur = []
        else:
            cur.append(c)
    items.append("".join(cur))
    if items[-1].strip() == "":
        items.pop()  # a trailing comma
    return items


def parse_scalar(text: str):
    """One value as ``yaml.safe_load(text)`` gives it for a scalar or a flow
    sequence of scalars (lists come back as lists)."""
    text = text.strip()
    if text.startswith("["):
        if not text.endswith("]"):
            raise ValueError(f"unterminated flow sequence {text!r}")
        return [parse_scalar(item) for item in _split_flow(text[1:-1])]
    if text[:1] in ("'", '"'):
        return _unquote(text)
    if text[:1] in ("{", "&", "*", "!", "|", ">", "%", "@", "`"):
        raise ValueError(f"unsupported YAML value {text!r}")
    return _resolve_plain(text)


def _strip_comment(line: str) -> str:
    """The line without a trailing `` #`` comment (outside quotes)."""
    quote = None
    for i, c in enumerate(line):
        if quote:
            if c == quote:
                quote = None
        elif c in "'\"":
            quote = c
        elif c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def _key_value(line: str):
    """(key, rest) of a ``key: rest`` line; the key may be quoted."""
    if line[:1] in ("'", '"'):
        end = line.index(line[0], 1)
        key, rest = _unquote(line[:end + 1]), line[end + 1:]
        if not rest.startswith(":"):
            raise ValueError(f"expected ':' after key in {line!r}")
        return key, rest[1:].strip()
    m = re.match(r"(.*?):(?:\s+|$)(.*)", line)
    if not m:
        raise ValueError(f"expected 'key: value', got {line!r}")
    return m.group(1), m.group(2)


def load(text: str):
    """The tree of a block-style document (see the module docstring)."""
    lines = []
    for n, raw in enumerate(text.splitlines(), 1):
        if raw.strip() in ("", "---", "...") or raw.lstrip().startswith("#"):
            continue
        if "\t" in raw[:len(raw) - len(raw.lstrip())]:
            raise ValueError(f"line {n}: tab in indentation")
        lines.append((len(raw) - len(raw.lstrip(" ")), _strip_comment(raw.strip()), n))
    if not lines:
        return None
    tree, i = _block(lines, 0, lines[0][0])
    if i != len(lines):
        raise ValueError(f"line {lines[i][2]}: unexpected indentation")
    return tree


def _block(lines, i, indent):
    if lines[i][1].startswith("- ") or lines[i][1] == "-":
        return _sequence(lines, i, indent)
    out = {}
    while i < len(lines) and lines[i][0] == indent:
        _, line, n = lines[i]
        if line.startswith("- ") or line == "-":
            raise ValueError(f"line {n}: a sequence item inside a mapping")
        key, rest = _key_value(line)
        if key in out:
            raise ValueError(f"line {n}: duplicate key {key!r}")
        i += 1
        if rest:
            out[key] = parse_scalar(rest)
        elif i < len(lines) and (lines[i][0] > indent or (
                lines[i][0] == indent and lines[i][1].startswith("-"))):
            out[key], i = _block(lines, i, lines[i][0])
        else:
            out[key] = None
    if i < len(lines) and lines[i][0] > indent:
        raise ValueError(f"line {lines[i][2]}: unexpected indentation")
    return out, i


def _sequence(lines, i, indent):
    out = []
    while i < len(lines) and lines[i][0] == indent and (
            lines[i][1].startswith("- ") or lines[i][1] == "-"):
        item = lines[i][1][1:].strip()
        if re.match(r"[^'\"\[].*?:(\s|$)", item):
            raise ValueError(f"line {lines[i][2]}: mappings in sequences are "
                             "not supported")
        out.append(parse_scalar(item))
        i += 1
    return out, i


# ------------------------------------------------------------------ writing
def _format_float(x: float) -> str:
    if x != x:
        return ".nan"
    if math.isinf(x):
        return ".inf" if x > 0 else "-.inf"
    text = repr(x).lower()
    if "." not in text and "e" in text:
        text = text.replace("e", ".0e", 1)
    return text


def _escape(c: str) -> str:
    """One character inside a double-quoted scalar, as PyYAML writes it."""
    if c in '"\\':
        return "\\" + c
    if c.isascii() and c.isprintable():
        return c
    named = {"\t": "t", "\n": "n", "\r": "r", "\0": "0"}.get(c)
    if named:
        return "\\" + named
    code = ord(c)
    return (f"\\x{code:02X}" if code < 0x100 else f"\\u{code:04X}"
            if code < 0x10000 else f"\\U{code:08X}")


def _format_str(s: str) -> str:
    if any(not (c.isascii() and c.isprintable()) for c in s):
        return '"' + "".join(_escape(c) for c in s) + '"'
    plain = (s != "" and s == s.strip()
             and not (s[0] in "#,[]{}&*!|>'\"%@`"
                      or (s[0] in "-?:" and (len(s) == 1 or s[1] == " ")))
             and ": " not in s and " #" not in s and not s.endswith(":")
             and isinstance(_resolve_plain(s), str))
    return s if plain else "'" + s.replace("'", "''") + "'"


def _format_scalar(v) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        return _format_float(v)
    if isinstance(v, str):
        return _format_str(v)
    raise TypeError(f"cannot write {type(v).__name__} {v!r} as YAML")


def dump(tree: dict) -> str:
    """The document ``yaml.safe_dump(tree, sort_keys=False)`` writes."""
    lines = []

    def mapping(d: dict, indent: int):
        pad = " " * indent
        for key, v in d.items():
            k = _format_str(str(key))
            if isinstance(v, dict) and v:
                lines.append(f"{pad}{k}:")
                mapping(v, indent + 2)
            elif isinstance(v, (list, tuple)) and v:
                lines.append(f"{pad}{k}:")
                lines.extend(f"{pad}- {_format_scalar(x)}" for x in v)
            elif isinstance(v, (list, tuple)):
                lines.append(f"{pad}{k}: []")
            else:
                lines.append(f"{pad}{k}: {_format_scalar(v)}")

    mapping(tree, 0)
    return "\n".join(lines) + "\n"

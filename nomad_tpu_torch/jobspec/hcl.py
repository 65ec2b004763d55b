"""Minimal HCL parser — the subset job specs use.

Supports: ``key = value`` attributes (strings, numbers, bools, lists,
maps, heredocs), labeled blocks (``job "name" { ... }``), nested blocks,
``#``/``//`` line comments and ``/* */`` block comments. Interpolation
sequences (``${...}``) are preserved verbatim inside strings — constraint
targets rely on that. Duration strings ("30s", "5m", "1h") are left as
strings; the schema layer converts them.

This is a from-scratch recursive-descent parser for OUR dialect, not a port
of HashiCorp's HCL — it covers what the reference's jobspec tests exercise.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Tuple


class HCLParseError(ValueError):
    def __init__(self, msg: str, line: int):
        super().__init__(f"line {line}: {msg}")
        self.line = line


_TOKEN_RE = re.compile(
    r"""
    (?P<ws>[ \t\r]+)
  | (?P<comment>\#[^\n]*|//[^\n]*)
  | (?P<block_comment>/\*.*?\*/)
  | (?P<heredoc><<-?(?P<tag>[A-Za-z_][A-Za-z0-9_]*)\n(?P<body>.*?)\n\s*(?P=tag))
  | (?P<string>"(?:\\.|\$\{[^}]*\}|[^"\\])*")
  | (?P<number>-?\d+(?:\.\d+)?(?![A-Za-z_]))
  | (?P<ident>[A-Za-z_][A-Za-z0-9_.\-]*)
  | (?P<punct>[{}\[\],=:\n])
    """,
    re.VERBOSE | re.DOTALL,
)

_ESCAPES = {"n": "\n", "t": "\t", '"': '"', "\\": "\\"}


class _Lexer:
    def __init__(self, src: str):
        self.tokens: List[Tuple[str, Any, int]] = []
        line = 1
        pos = 0
        while pos < len(src):
            mo = _TOKEN_RE.match(src, pos)
            if mo is None:
                raise HCLParseError(f"unexpected character {src[pos]!r}", line)
            kind = mo.lastgroup
            text = mo.group(0)
            if kind == "ws":
                pass
            elif kind in ("comment", "block_comment"):
                line += text.count("\n")
            elif kind == "heredoc":
                self.tokens.append(("string", mo.group("body"), line))
                line += text.count("\n")
            elif kind == "string":
                self.tokens.append(("string", _unquote(text), line))
            elif kind == "number":
                num = float(text) if "." in text else int(text)
                self.tokens.append(("number", num, line))
            elif kind == "ident":
                self.tokens.append(("ident", text, line))
            elif kind == "punct":
                if text == "\n":
                    self.tokens.append(("newline", "\n", line))
                    line += 1
                else:
                    self.tokens.append((text, text, line))
            # `heredoc` handled above; `punct` covers the rest
            pos = mo.end()
        self.tokens.append(("eof", None, line))
        self.i = 0

    def peek(self) -> Tuple[str, Any, int]:
        return self.tokens[self.i]

    def next(self) -> Tuple[str, Any, int]:
        tok = self.tokens[self.i]
        self.i += 1
        return tok

    def skip_newlines(self) -> None:
        while self.tokens[self.i][0] == "newline":
            self.i += 1


def _unquote(text: str) -> str:
    body = text[1:-1]
    out = []
    i = 0
    while i < len(body):
        ch = body[i]
        if ch == "\\" and i + 1 < len(body):
            out.append(_ESCAPES.get(body[i + 1], body[i + 1]))
            i += 2
        else:
            out.append(ch)
            i += 1
    return "".join(out)


_BOOLS = {"true": True, "false": False, "null": None}


def parse_hcl(src: str) -> Dict[str, Any]:
    """Parse HCL into nested dicts. Blocks become
    ``{type: {label: body}}`` when labeled (repeated labels become lists),
    ``{type: body}`` (or list of bodies) when bare. Attributes map directly.
    """
    lx = _Lexer(src)
    return _parse_body(lx, top=True)


def _parse_body(lx: _Lexer, top: bool = False) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    while True:
        lx.skip_newlines()
        kind, value, line = lx.peek()
        if kind == "eof":
            if not top:
                raise HCLParseError("unexpected EOF in block", line)
            return out
        if kind == "}":
            lx.next()
            return out
        if kind not in ("ident", "string"):
            raise HCLParseError(f"expected identifier, got {value!r}", line)
        lx.next()
        name = value
        kind2, value2, line2 = lx.peek()
        if kind2 == "=":
            lx.next()
            out[name] = _parse_value(lx)
        elif kind2 in ("string", "ident") or kind2 == "{":
            # Block, possibly labeled: job "x" { } / config { }
            labels = []
            while True:
                k, v, ln = lx.peek()
                if k in ("string", "ident"):
                    labels.append(v)
                    lx.next()
                elif k == "{":
                    lx.next()
                    break
                else:
                    raise HCLParseError(
                        f"expected block label or '{{', got {v!r}", ln
                    )
            body = _parse_body(lx)
            _insert_block(out, name, labels, body, line)
        else:
            raise HCLParseError(
                f"expected '=' or block after {name!r}, got {value2!r}", line2
            )


def _insert_block(out, name, labels, body, line) -> None:
    if not labels:
        existing = out.get(name)
        if existing is None:
            out[name] = body
        elif isinstance(existing, list):
            existing.append(body)
        else:
            out[name] = [existing, body]
        return
    slot = out.setdefault(name, {})
    if not isinstance(slot, dict):
        raise HCLParseError(f"mixing labeled and bare {name!r} blocks", line)
    for label in labels[:-1]:
        slot = slot.setdefault(label, {})
    leaf = slot.get(labels[-1])
    if leaf is None:
        slot[labels[-1]] = body
    elif isinstance(leaf, list):
        leaf.append(body)
    else:
        slot[labels[-1]] = [leaf, body]


def _parse_value(lx: _Lexer) -> Any:
    lx.skip_newlines()
    kind, value, line = lx.next()
    if kind in ("string", "number"):
        return value
    if kind == "ident":
        if value in _BOOLS:
            return _BOOLS[value]
        return value  # bare identifier (e.g. enum-ish values)
    if kind == "[":
        items: List[Any] = []
        while True:
            lx.skip_newlines()
            if lx.peek()[0] == "]":
                lx.next()
                return items
            items.append(_parse_value(lx))
            lx.skip_newlines()
            if lx.peek()[0] == ",":
                lx.next()
    if kind == "{":
        obj: Dict[str, Any] = {}
        while True:
            lx.skip_newlines()
            k, v, ln = lx.next()
            if k == "}":
                return obj
            if k == ",":
                continue
            if k not in ("ident", "string"):
                raise HCLParseError(f"bad map key {v!r}", ln)
            sep, sv, sl = lx.next()
            if sep not in ("=", ":"):
                raise HCLParseError(f"expected '=' or ':', got {sv!r}", sl)
            obj[v] = _parse_value(lx)
    raise HCLParseError(f"unexpected value token {value!r}", line)

"""Minimal HOCON-compatible config parser.

The reference drives every workload from pyhocon HOCON files with a literal
``CASE_NAME`` string substitution (reference: exp_runner.py:28-33,
fitting_single.py:25-29).  This module provides the same consumer API
without the pyhocon dependency: nested sections with ``{}``, ``key = value``
or ``key : value`` or ``key value`` (object values), ``[]`` lists with
comma/newline separators, ``#``/``//`` comments, bare or quoted strings,
bools, ints, floats.

Only the HOCON subset actually exercised by the reference configs
(confs/*.conf, fit_confs/*.conf) is supported; substitutions (${...}) and
includes are not.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional


class ConfigTree(dict):
    """A dict with dotted-path access, mirroring the pyhocon interface the
    reference uses: ``conf['model.sdf_network']``, ``conf.get_string(...)``,
    ``conf.get_int/get_float/get_bool/get_list`` (exp_runner.py:37-50)."""

    def __getitem__(self, key: str) -> Any:
        node: Any = self
        for part in key.split("."):
            if not isinstance(node, dict) or part not in node:
                raise KeyError(key)
            node = dict.__getitem__(node, part)
        return node

    def get(self, key: str, default: Any = None) -> Any:  # type: ignore[override]
        try:
            return self[key]
        except KeyError:
            return default

    def get_string(self, key: str, default: Optional[str] = None) -> str:
        v = self.get(key, default)
        if v is None:
            raise KeyError(key)
        return str(v)

    def get_int(self, key: str, default: Optional[int] = None) -> int:
        v = self.get(key, default)
        if v is None:
            raise KeyError(key)
        return int(v)

    def get_float(self, key: str, default: Optional[float] = None) -> float:
        v = self.get(key, default)
        if v is None:
            raise KeyError(key)
        return float(v)

    def get_bool(self, key: str, default: Optional[bool] = None) -> bool:
        v = self.get(key, default)
        if v is None:
            raise KeyError(key)
        if isinstance(v, str):
            return v.lower() in ("true", "yes", "on", "1")
        return bool(v)

    def get_list(self, key: str, default: Optional[List[Any]] = None) -> List[Any]:
        v = self.get(key, default)
        if v is None:
            raise KeyError(key)
        return list(v)

    def as_plain_dict(self) -> Dict[str, Any]:
        def conv(node: Any) -> Any:
            if isinstance(node, dict):
                return {k: conv(v) for k, v in node.items()}
            if isinstance(node, list):
                return [conv(v) for v in node]
            return node

        return conv(self)


class _Tokenizer:
    def __init__(self, text: str):
        self.text = text
        self.pos = 0
        self.n = len(text)

    def _skip_ws_and_comments(self, skip_newlines: bool = True) -> None:
        while self.pos < self.n:
            c = self.text[self.pos]
            if c in " \t\r" or (skip_newlines and c == "\n"):
                self.pos += 1
            elif c == "#" or self.text.startswith("//", self.pos):
                while self.pos < self.n and self.text[self.pos] != "\n":
                    self.pos += 1
            else:
                return

    def peek(self) -> Optional[str]:
        self._skip_ws_and_comments()
        if self.pos >= self.n:
            return None
        return self.text[self.pos]

    def peek_same_line(self) -> Optional[str]:
        """Peek without skipping newlines (newline is a value separator)."""
        self._skip_ws_and_comments(skip_newlines=False)
        if self.pos >= self.n:
            return None
        return self.text[self.pos]

    def take(self) -> str:
        c = self.peek()
        assert c is not None, "unexpected end of input"
        self.pos += 1
        return c

    def take_quoted(self) -> str:
        quote = self.take()
        out = []
        while self.pos < self.n:
            c = self.text[self.pos]
            self.pos += 1
            if c == "\\" and self.pos < self.n:
                out.append(self.text[self.pos])
                self.pos += 1
            elif c == quote:
                return "".join(out)
            else:
                out.append(c)
        raise ValueError("unterminated string literal")

    def take_bare(self, stop: str) -> str:
        out = []
        while self.pos < self.n:
            c = self.text[self.pos]
            if c in stop or c in "\n#":
                break
            if self.text.startswith("//", self.pos):
                break
            out.append(c)
            self.pos += 1
        return "".join(out).strip()


def _coerce(raw: str) -> Any:
    low = raw.lower()
    if low == "true":
        return True
    if low == "false":
        return False
    if low in ("null", "none"):
        return None
    try:
        return int(raw)
    except ValueError:
        pass
    try:
        return float(raw)
    except ValueError:
        pass
    return raw


def _parse_value(tok: _Tokenizer) -> Any:
    c = tok.peek()
    if c == "{":
        return _parse_object(tok)
    if c == "[":
        return _parse_list(tok)
    if c in ("'", '"'):
        return tok.take_quoted()
    raw = tok.take_bare(stop=",]}=")
    return _coerce(raw)


def _parse_list(tok: _Tokenizer) -> List[Any]:
    assert tok.take() == "["
    items: List[Any] = []
    while True:
        c = tok.peek()
        if c is None:
            raise ValueError("unterminated list")
        if c == "]":
            tok.take()
            return items
        if c == ",":
            tok.take()
            continue
        items.append(_parse_value(tok))


def _parse_key(tok: _Tokenizer) -> str:
    c = tok.peek()
    if c in ("'", '"'):
        return tok.take_quoted()
    return tok.take_bare(stop="=:{ \t")


def _parse_object(tok: _Tokenizer, top_level: bool = False) -> ConfigTree:
    if not top_level:
        assert tok.take() == "{"
    tree = ConfigTree()
    while True:
        c = tok.peek()
        if c is None:
            if top_level:
                return tree
            raise ValueError("unterminated object")
        if c == "}":
            tok.take()
            if top_level:
                raise ValueError("unexpected '}' at top level")
            return tree
        if c == ",":
            tok.take()
            continue
        key = _parse_key(tok)
        if not key:
            raise ValueError(f"empty key near position {tok.pos}")
        sep = tok.peek_same_line()
        if sep in ("=", ":"):
            tok.take()
            value = _parse_value(tok)
        elif tok.peek() == "{":
            value = _parse_object(tok)
        else:
            raise ValueError(f"expected '=', ':' or '{{' after key {key!r}")
        # Dotted keys create nested trees (HOCON path expressions).
        node = tree
        parts = key.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, ConfigTree())
        leaf = parts[-1]
        if isinstance(value, ConfigTree) and isinstance(node.get(leaf), ConfigTree):
            node[leaf].update(value)  # HOCON object merge semantics
        else:
            dict.__setitem__(node, leaf, value)


def parse_string(text: str) -> ConfigTree:
    """Parse HOCON text into a ConfigTree."""
    tok = _Tokenizer(text)
    return _parse_object(tok, top_level=True)


def load_config(path: str, case: str = "") -> ConfigTree:
    """Load a .conf file, substituting the literal CASE_NAME like the
    reference drivers do (exp_runner.py:28-33)."""
    with open(path, "r") as f:
        text = f.read()
    if case:
        text = text.replace("CASE_NAME", case)
    return parse_string(text)

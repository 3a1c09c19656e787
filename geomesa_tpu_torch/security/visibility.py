"""Visibility expression parsing and evaluation, and the authorization
providers.

Port of ``geomesa_tpu/security/visibility.py``, whole.

Grammar (VisibilityEvaluator.scala:21-50):
    expr   := term ('|' term)*        -- OR
    term   := factor ('&' factor)*    -- AND
    factor := label | '(' expr ')'
    label  := [A-Za-z0-9_.:/-]+ | '"' escaped '"'
An empty expression is visible to everyone. Mixing & and | at one level
without parentheses is rejected, as in Accumulo.
"""

from __future__ import annotations

import re
from typing import Dict, FrozenSet, List, Optional, Sequence

import numpy as np


class VisibilityError(ValueError):
    pass


_LABEL = re.compile(r"[A-Za-z0-9_.:/\-]+")


class _Node:
    def evaluate(self, auths: FrozenSet[str]) -> bool:
        raise NotImplementedError


class _Label(_Node):
    def __init__(self, name: str):
        self.name = name

    def evaluate(self, auths):
        return self.name in auths


class _And(_Node):
    def __init__(self, children: List[_Node]):
        self.children = children

    def evaluate(self, auths):
        return all(c.evaluate(auths) for c in self.children)


class _Or(_Node):
    def __init__(self, children: List[_Node]):
        self.children = children

    def evaluate(self, auths):
        return any(c.evaluate(auths) for c in self.children)


class VisibilityEvaluator:
    """Parses visibility expressions; caches by expression text."""

    _cache: Dict[str, _Node] = {}

    @classmethod
    def parse(cls, expression: str) -> Optional[_Node]:
        if not expression:
            return None
        node = cls._cache.get(expression)
        if node is None:
            node = _Parser(expression).parse()
            if len(cls._cache) > 10_000:
                cls._cache.clear()
            cls._cache[expression] = node
        return node

    @classmethod
    def evaluate(cls, expression: str, auths: Sequence[str]) -> bool:
        node = cls.parse(expression)
        if node is None:
            return True
        return node.evaluate(frozenset(auths))


class _Parser:
    def __init__(self, text: str):
        self.text = text
        self.pos = 0

    def parse(self) -> _Node:
        node = self._expr()
        if self.pos != len(self.text):
            raise VisibilityError(f"trailing input at {self.pos}: {self.text!r}")
        return node

    def _expr(self) -> _Node:
        first = self._term()
        kind = None
        children = [first]
        while self.pos < len(self.text) and self.text[self.pos] in "&|":
            op = self.text[self.pos]
            if kind is None:
                kind = op
            elif op != kind:
                raise VisibilityError(
                    f"mixed & and | without parentheses: {self.text!r}"
                )
            self.pos += 1
            children.append(self._term())
        if kind == "|":
            return _Or(children)
        if kind == "&":
            return _And(children)
        return first

    def _term(self) -> _Node:
        if self.pos >= len(self.text):
            raise VisibilityError(f"unexpected end: {self.text!r}")
        c = self.text[self.pos]
        if c == "(":
            self.pos += 1
            node = self._expr()
            if self.pos >= len(self.text) or self.text[self.pos] != ")":
                raise VisibilityError(f"unbalanced parens: {self.text!r}")
            self.pos += 1
            return node
        if c == '"':
            # scan with backslash escapes (\" and \\), as Accumulo accepts
            chars = []
            i = self.pos + 1
            while i < len(self.text):
                ch = self.text[i]
                if ch == "\\" and i + 1 < len(self.text):
                    chars.append(self.text[i + 1])
                    i += 2
                    continue
                if ch == '"':
                    self.pos = i + 1
                    return _Label("".join(chars))
                chars.append(ch)
                i += 1
            raise VisibilityError(f"unterminated quote: {self.text!r}")
        m = _LABEL.match(self.text, self.pos)
        if not m:
            raise VisibilityError(f"bad token at {self.pos}: {self.text!r}")
        self.pos = m.end()
        return _Label(m.group(0))


class AuthorizationsProvider:
    """SPI: authorizations for the current context
    (security/AuthorizationsProvider.java)."""

    def get_authorizations(self) -> List[str]:
        raise NotImplementedError


class DefaultAuthorizationsProvider(AuthorizationsProvider):
    def __init__(self, auths: Sequence[str] = ()):
        self._auths = list(auths)

    def get_authorizations(self) -> List[str]:
        return list(self._auths)


def visibility_mask(vis_column: np.ndarray, auths: Sequence[str]) -> np.ndarray:
    """Row mask for a ``__vis__`` object column: each distinct expression
    is parsed and evaluated once, then the verdicts map onto the rows."""
    auth_set = frozenset(auths)
    values = np.asarray(vis_column, dtype=object).tolist()
    verdict: Dict[object, bool] = {}
    for expr in set(values):
        if expr is None or expr == "":
            verdict[expr] = True
        else:
            node = VisibilityEvaluator.parse(str(expr))
            verdict[expr] = node.evaluate(auth_set) if node is not None else True
    return np.fromiter(map(verdict.__getitem__, values), dtype=bool, count=len(values))

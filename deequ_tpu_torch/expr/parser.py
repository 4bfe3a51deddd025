"""Tokenizer + Pratt parser for the SQL-subset predicate language."""

from __future__ import annotations

import re
from typing import List, Optional

from deequ_tpu_torch.expr.ast import (
    Between,
    BinaryOp,
    ColumnRef,
    Expr,
    FnCall,
    InList,
    IsNull,
    Like,
    Lit,
    UnaryOp,
)


class ExprSyntaxError(ValueError):
    pass


_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+)
  | (?P<number>\d+\.\d*(?:[eE][+-]?\d+)?|\.\d+(?:[eE][+-]?\d+)?|\d+(?:[eE][+-]?\d+)?)
  | (?P<string>'(?:[^'\\]|\\.)*'|"(?:[^"\\]|\\.)*")
  | (?P<bquote>`[^`]+`)
  | (?P<name>[A-Za-z_][A-Za-z0-9_.]*)
  | (?P<op><=|>=|!=|<>|==|=|<|>|\+|-|\*|/|%|\(|\)|,)
""",
    re.VERBOSE,
)

_KEYWORDS = {
    "and", "or", "not", "is", "null", "in", "between", "like", "rlike",
    "true", "false", "coalesce", "abs", "length",
}


class Token:
    __slots__ = ("kind", "text")

    def __init__(self, kind: str, text: str):
        self.kind = kind
        self.text = text

    def __repr__(self):
        return f"Token({self.kind},{self.text!r})"


def _tokenize(src: str) -> List[Token]:
    out: List[Token] = []
    pos = 0
    while pos < len(src):
        m = _TOKEN_RE.match(src, pos)
        if not m:
            raise ExprSyntaxError(f"unexpected character at {pos}: {src[pos:pos+10]!r}")
        pos = m.end()
        kind = m.lastgroup
        if kind == "ws":
            continue
        text = m.group()
        if kind == "name" and text.lower() in _KEYWORDS:
            out.append(Token("kw", text.lower()))
        elif kind == "bquote":
            out.append(Token("name", text[1:-1]))
        else:
            out.append(Token(kind, text))
    out.append(Token("eof", ""))
    return out


def _unquote(s: str) -> str:
    body = s[1:-1]
    return re.sub(r"\\(.)", r"\1", body)


class _Parser:
    def __init__(self, tokens: List[Token]):
        self.toks = tokens
        self.i = 0

    def peek(self) -> Token:
        return self.toks[self.i]

    def next(self) -> Token:
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, kind: str, text: Optional[str] = None) -> Token:
        t = self.next()
        if t.kind != kind or (text is not None and t.text != text):
            raise ExprSyntaxError(f"expected {text or kind}, got {t.text!r}")
        return t

    def accept_kw(self, word: str) -> bool:
        if self.peek().kind == "kw" and self.peek().text == word:
            self.next()
            return True
        return False

    # precedence climbing: or < and < not < predicate < add < mul < unary
    def parse(self) -> Expr:
        e = self.parse_or()
        if self.peek().kind != "eof":
            raise ExprSyntaxError(f"trailing input: {self.peek().text!r}")
        return e

    def parse_or(self) -> Expr:
        left = self.parse_and()
        while self.accept_kw("or"):
            left = BinaryOp("or", left, self.parse_and())
        return left

    def parse_and(self) -> Expr:
        left = self.parse_not()
        while self.accept_kw("and"):
            left = BinaryOp("and", left, self.parse_not())
        return left

    def parse_not(self) -> Expr:
        if self.accept_kw("not"):
            return UnaryOp("not", self.parse_not())
        return self.parse_predicate()

    def parse_predicate(self) -> Expr:
        left = self.parse_additive()
        t = self.peek()
        if t.kind == "op" and t.text in ("=", "==", "!=", "<>", "<", "<=", ">", ">="):
            self.next()
            op = {"==": "=", "<>": "!="}.get(t.text, t.text)
            return BinaryOp(op, left, self.parse_additive())
        if t.kind == "kw":
            negated = False
            if t.text == "is":
                self.next()
                negated = self.accept_kw("not")
                self.expect("kw", "null")
                return IsNull(left, negated)
            if t.text == "not":
                self.next()
                negated = True
                t = self.peek()
            if self.accept_kw("in"):
                self.expect("op", "(")
                options = [self._literal_value()]
                while self.peek().text == ",":
                    self.next()
                    options.append(self._literal_value())
                self.expect("op", ")")
                return InList(left, tuple(options), negated)
            if self.accept_kw("between"):
                low = self.parse_additive()
                self.expect("kw", "and")
                high = self.parse_additive()
                return Between(left, low, high, negated)
            if self.accept_kw("like"):
                pat = self.expect("string")
                return Like(left, _unquote(pat.text), negated, regex=False)
            if self.accept_kw("rlike"):
                pat = self.expect("string")
                return Like(left, _unquote(pat.text), negated, regex=True)
            if negated:
                raise ExprSyntaxError("dangling NOT before predicate")
        return left

    def _literal_value(self):
        t = self.next()
        if t.kind == "number":
            text = t.text
            return float(text) if any(c in text for c in ".eE") else int(text)
        if t.kind == "string":
            return _unquote(t.text)
        if t.kind == "kw" and t.text in ("true", "false"):
            return t.text == "true"
        if t.kind == "kw" and t.text == "null":
            return None
        if t.kind == "op" and t.text == "-":
            v = self._literal_value()
            return -v
        raise ExprSyntaxError(f"expected literal, got {t.text!r}")

    def parse_additive(self) -> Expr:
        left = self.parse_multiplicative()
        while self.peek().kind == "op" and self.peek().text in ("+", "-"):
            op = self.next().text
            left = BinaryOp(op, left, self.parse_multiplicative())
        return left

    def parse_multiplicative(self) -> Expr:
        left = self.parse_unary()
        while self.peek().kind == "op" and self.peek().text in ("*", "/", "%"):
            op = self.next().text
            left = BinaryOp(op, left, self.parse_unary())
        return left

    def parse_unary(self) -> Expr:
        if self.peek().kind == "op" and self.peek().text == "-":
            self.next()
            return UnaryOp("neg", self.parse_unary())
        return self.parse_primary()

    def parse_primary(self) -> Expr:
        t = self.next()
        if t.kind == "number":
            text = t.text
            return Lit(float(text) if any(c in text for c in ".eE") else int(text))
        if t.kind == "string":
            return Lit(_unquote(t.text))
        if t.kind == "kw" and t.text in ("true", "false"):
            return Lit(t.text == "true")
        if t.kind == "kw" and t.text == "null":
            return Lit(None)
        if t.kind == "kw" and t.text in ("coalesce", "abs", "length"):
            self.expect("op", "(")
            args = [self.parse_or()]
            while self.peek().text == ",":
                self.next()
                args.append(self.parse_or())
            self.expect("op", ")")
            return FnCall(t.text, tuple(args))
        if t.kind == "name":
            return ColumnRef(t.text)
        if t.kind == "op" and t.text == "(":
            e = self.parse_or()
            self.expect("op", ")")
            return e
        raise ExprSyntaxError(f"unexpected token {t.text!r}")


def parse_expression(src: str) -> Expr:
    """Parse a SQL-subset expression string into an AST."""
    return _Parser(_tokenize(src)).parse()

"""AST for the SQL-subset predicate language.

The reference accepts Spark SQL strings for ``where`` filters and
``Check.satisfies`` predicates (checks/Check.scala:594-604). Per SURVEY.md
§7.3 we implement the used subset as a small expression language instead of
embedding a SQL engine: comparisons, boolean ops (3-valued logic), IS NULL,
IN, (NOT) LIKE, BETWEEN, arithmetic, COALESCE.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple, Union

Literal = Union[float, int, str, bool, None]


class Expr:
    def columns(self) -> set:
        """Set of column names referenced by this expression."""
        out = set()
        for child in getattr(self, "_children", ()):  # set by subclasses
            out |= child.columns()
        return out


@dataclass
class ColumnRef(Expr):
    name: str

    def columns(self) -> set:
        return {self.name}


@dataclass
class Lit(Expr):
    value: Literal


@dataclass
class UnaryOp(Expr):
    op: str  # 'not' | 'neg'
    operand: Expr

    @property
    def _children(self):
        return (self.operand,)


@dataclass
class BinaryOp(Expr):
    op: str  # '+','-','*','/','%','=','!=','<','<=','>','>=','and','or'
    left: Expr
    right: Expr

    @property
    def _children(self):
        return (self.left, self.right)


@dataclass
class IsNull(Expr):
    operand: Expr
    negated: bool = False

    @property
    def _children(self):
        return (self.operand,)


@dataclass
class InList(Expr):
    operand: Expr
    options: Tuple[Literal, ...]
    negated: bool = False

    @property
    def _children(self):
        return (self.operand,)


@dataclass
class Between(Expr):
    operand: Expr
    low: Expr
    high: Expr
    negated: bool = False

    @property
    def _children(self):
        return (self.operand, self.low, self.high)


@dataclass
class Like(Expr):
    operand: Expr
    pattern: str  # SQL LIKE pattern with % and _
    negated: bool = False
    regex: bool = False  # True for RLIKE (full regex find)

    @property
    def _children(self):
        return (self.operand,)


@dataclass
class FnCall(Expr):
    name: str  # 'coalesce', 'abs', 'length'
    args: Tuple[Expr, ...]

    @property
    def _children(self):
        return tuple(self.args)

"""Evaluator for the SQL-subset expression AST, on torch tensors.

Evaluates over one chunk's device tensors with SQL three-valued logic
(nulls propagate; AND/OR use Kleene logic; WHERE treats null as false —
matching the reference's Spark SQL semantics for ``where`` and
``satisfies``). The counterpart of ``deequ_tpu/expr/eval.py``.

String predicates never touch the device as strings: each is computed on
the host as an O(cardinality) boolean lookup table over the column's
dictionary (``_str_lut_bool``), moved to the card once per dictionary
(``ops/lut_cache.py``), and gathered there by code.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

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
from deequ_tpu_torch.ops.lut_cache import dictionary_lut_device


class ExprEvalError(ValueError):
    pass


@dataclass
class Val:
    """A typed intermediate value.

    kind 'num'/'bool': data is a tensor (or Python scalar), mask is a bool
    tensor, a Python bool, or None (None = all valid). kind 'str': either
    a scalar Python string (data=str), or a dictionary-encoded column
    (data=int32 codes tensor, dictionary=np array, luts=the scan's device
    lookup tables over that dictionary). kind 'null': SQL NULL. Numeric
    column data is float64.
    """

    kind: str
    data: Any = None
    mask: Any = None
    dictionary: Optional[np.ndarray] = None
    luts: Optional[Dict[str, Any]] = None

    def lut(self, key: str):
        """A device lookup table over this string column's dictionary,
        built once per scan from a ScanOp's ``luts``."""
        if not self.luts or key not in self.luts:
            raise ExprEvalError(f"no lookup table {key!r} on this column")
        return self.luts[key]


def _and_masks(*masks):
    out = None
    for m in masks:
        if m is None:
            continue
        out = m if out is None else (out & m)
    return out


def _not(x):
    """Logical NOT of a bool tensor or a Python bool."""
    return (not x) if isinstance(x, bool) else ~x


def _where(cond, a, b):
    if isinstance(cond, bool):
        return a if cond else b
    return torch.where(cond, a, b)


def _like_to_regex(pattern: str) -> str:
    out = []
    for ch in pattern:
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(re.escape(ch))
    return "^" + "".join(out) + "$"


class EvalContext:
    """Resolves column references to Vals for one chunk. Dictionary lookup
    tables come from ``ops/lut_cache.py``: each is built and moved to the
    device once per dictionary, kind and device, not once per scan."""

    def __init__(self, columns: Dict[str, Val], device):
        self.columns = columns
        self.device = device

    def get(self, name: str) -> Val:
        if name not in self.columns:
            raise ExprEvalError(f"unknown column: {name}")
        return self.columns[name]

    def dictionary_lut(self, col: Val, kind: str, build) -> torch.Tensor:
        return dictionary_lut_device(col.dictionary, kind, build, self.device)


def _str_lut_bool(
    ctx: EvalContext, col: Val, fn: Callable[[str], bool], kind: str
) -> Val:
    """Apply a per-distinct-value predicate as a device lookup table."""

    def build(dictionary):
        lut = np.array([bool(fn(v)) for v in dictionary], dtype=np.bool_)
        return lut if len(lut) else np.zeros(1, dtype=np.bool_)

    lut = ctx.dictionary_lut(col, f"pred:{kind}", build)
    codes = col.data
    vals = lut[codes.clamp(min=0).long()]
    return Val("bool", vals, codes >= 0)


def _str_col_as_num(ctx: EvalContext, col: Val) -> Val:
    """Cast a string column to numeric via the dictionary (unparsable ->
    null)."""

    def build(dictionary):
        lut = np.zeros((2, max(len(dictionary), 1)), dtype=np.float64)
        for i, v in enumerate(dictionary):
            try:
                lut[0, i] = float(v)
                lut[1, i] = 1.0
            except (TypeError, ValueError):
                pass
        return lut

    pair = ctx.dictionary_lut(col, "strtonum", build)
    safe = col.data.clamp(min=0).long()
    mask = (col.data >= 0) & (pair[1][safe] > 0)
    return Val("num", pair[0][safe], mask)


def eval_expression(expr: Expr, ctx: EvalContext) -> Val:
    if isinstance(expr, Lit):
        v = expr.value
        if v is None:
            return Val("null")
        if isinstance(v, bool):
            return Val("bool", v, None)
        if isinstance(v, (int, float)):
            return Val("num", float(v), None)
        return Val("str", v, None)

    if isinstance(expr, ColumnRef):
        return ctx.get(expr.name)

    if isinstance(expr, UnaryOp):
        operand = eval_expression(expr.operand, ctx)
        if expr.op == "neg":
            operand = _coerce_num(ctx, operand)
            return Val("num", -operand.data, operand.mask)
        if expr.op == "not":
            operand = _coerce_bool(operand)
            return Val("bool", _not(operand.data), operand.mask)
        raise ExprEvalError(f"unknown unary op {expr.op}")

    if isinstance(expr, BinaryOp):
        return _eval_binary(expr, ctx)

    if isinstance(expr, IsNull):
        operand = eval_expression(expr.operand, ctx)
        if operand.kind == "null":
            return Val("bool", not expr.negated, None)
        if operand.kind == "str" and operand.dictionary is not None:
            is_null = operand.data < 0
        elif operand.mask is None:
            is_null = False
        else:
            is_null = _not(operand.mask)
        if expr.negated:
            is_null = _not(is_null)
        return Val("bool", is_null, None)

    if isinstance(expr, InList):
        operand = eval_expression(expr.operand, ctx)
        if operand.kind == "str" and operand.dictionary is not None:
            opts = {str(o) for o in expr.options if o is not None}
            res = _str_lut_bool(
                ctx, operand, lambda s: s in opts,
                kind=f"inlist:{sorted(opts)!r}",
            )
        else:
            operand = _coerce_num(ctx, operand)
            hit = None
            for o in expr.options:
                if o is None:
                    continue
                eq = operand.data == float(o)
                hit = eq if hit is None else (hit | eq)
            if hit is None:
                hit = False
            res = Val("bool", hit, operand.mask)
        if expr.negated:
            return Val("bool", _not(res.data), res.mask)
        return res

    if isinstance(expr, Between):
        operand = _coerce_num(ctx, eval_expression(expr.operand, ctx))
        low = _coerce_num(ctx, eval_expression(expr.low, ctx))
        high = _coerce_num(ctx, eval_expression(expr.high, ctx))
        val = (operand.data >= low.data) & (operand.data <= high.data)
        mask = _and_masks(operand.mask, low.mask, high.mask)
        if expr.negated:
            val = _not(val)
        return Val("bool", val, mask)

    if isinstance(expr, Like):
        operand = eval_expression(expr.operand, ctx)
        if operand.kind != "str" or operand.dictionary is None:
            raise ExprEvalError("LIKE requires a string column")
        if expr.regex:
            rx = re.compile(expr.pattern)
            res = _str_lut_bool(
                ctx, operand, lambda s: rx.search(s) is not None,
                kind=f"rlike:{expr.pattern}",
            )
        else:
            rx = re.compile(_like_to_regex(expr.pattern), re.DOTALL)
            res = _str_lut_bool(
                ctx, operand, lambda s: rx.match(s) is not None,
                kind=f"like:{expr.pattern}",
            )
        if expr.negated:
            return Val("bool", _not(res.data), res.mask)
        return res

    if isinstance(expr, FnCall):
        return _eval_fn(expr, ctx)

    raise ExprEvalError(f"unsupported expression node {type(expr).__name__}")


def _coerce_num(ctx: EvalContext, v: Val) -> Val:
    if v.kind == "num":
        return v
    if v.kind == "bool":
        if isinstance(v.data, bool):
            return Val("num", float(v.data), v.mask)
        return Val("num", v.data.to(torch.float64), v.mask)
    if v.kind == "str" and v.dictionary is not None:
        return _str_col_as_num(ctx, v)
    if v.kind == "str":
        try:
            return Val("num", float(v.data), None)
        except ValueError:
            raise ExprEvalError(f"cannot cast string literal {v.data!r} to number")
    if v.kind == "null":
        return Val("num", 0.0, False)
    raise ExprEvalError(f"cannot coerce {v.kind} to numeric")


def _coerce_bool(v: Val) -> Val:
    if v.kind == "bool":
        return v
    if v.kind == "null":
        return Val("bool", False, False)
    raise ExprEvalError(f"cannot coerce {v.kind} to boolean")


def _str_cols_cmp(ctx: EvalContext, a: Val, b: Val, op: str) -> Val:
    """Compare two dictionary-encoded string columns by mapping both
    dictionaries to ranks in their sorted union (host, O(cardinality)); the
    device compares int ranks, which preserves string ordering exactly."""
    dict_a = a.dictionary.astype(str)
    dict_b = b.dictionary.astype(str)
    union = np.unique(np.concatenate([dict_a, dict_b]))
    rank_a = np.searchsorted(union, dict_a).astype(np.int64)
    rank_b = np.searchsorted(union, dict_b).astype(np.int64)
    if len(rank_a) == 0:
        rank_a = np.zeros(1, dtype=np.int64)
    if len(rank_b) == 0:
        rank_b = np.zeros(1, dtype=np.int64)
    ra = torch.as_tensor(rank_a, device=ctx.device)[a.data.clamp(min=0).long()]
    rb = torch.as_tensor(rank_b, device=ctx.device)[b.data.clamp(min=0).long()]
    mask = (a.data >= 0) & (b.data >= 0)
    return Val("bool", _COMPARE[op](ra, rb), mask)


_COMPARE = {
    "=": lambda x, y: x == y,
    "!=": lambda x, y: x != y,
    "<": lambda x, y: x < y,
    "<=": lambda x, y: x <= y,
    ">": lambda x, y: x > y,
    ">=": lambda x, y: x >= y,
}


def _is_str_col(v: Val) -> bool:
    return v.kind == "str" and v.dictionary is not None


def _is_str_lit(v: Val) -> bool:
    return v.kind == "str" and v.dictionary is None


def _eval_binary(expr: BinaryOp, ctx: EvalContext) -> Val:
    op = expr.op

    if op in ("and", "or"):
        a = _coerce_bool(eval_expression(expr.left, ctx))
        b = _coerce_bool(eval_expression(expr.right, ctx))
        am = a.mask if a.mask is not None else True
        bm = b.mask if b.mask is not None else True
        av, bv = a.data, b.data
        if op == "and":
            known_true = am & av & bm & bv
            known_false = (am & _not(av)) | (bm & _not(bv))
        else:
            known_true = (am & av) | (bm & bv)
            known_false = am & _not(av) & bm & _not(bv)
        mask = known_true | known_false
        if mask is True:
            mask = None
        return Val("bool", known_true, mask)

    a = eval_expression(expr.left, ctx)
    b = eval_expression(expr.right, ctx)

    if op in ("=", "!="):
        # string comparisons via dictionary lookup tables
        if _is_str_col(a) and _is_str_col(b):
            res = _str_cols_cmp(ctx, a, b, "=")
        elif _is_str_col(a) and _is_str_lit(b):
            res = _str_lut_bool(
                ctx, a, lambda s, t=b.data: s == t,
                kind=f"eq:{b.data!r}",
            )
        elif _is_str_col(b) and _is_str_lit(a):
            res = _str_lut_bool(
                ctx, b, lambda s, t=a.data: s == t,
                kind=f"eq:{a.data!r}",
            )
        else:
            an = _coerce_num(ctx, a)
            bn = _coerce_num(ctx, b)
            res = Val("bool", an.data == bn.data, _and_masks(an.mask, bn.mask))
        if op == "!=":
            return Val("bool", _not(res.data), res.mask)
        return res

    if op in ("<", "<=", ">", ">="):
        if _is_str_col(a) and _is_str_col(b):
            return _str_cols_cmp(ctx, a, b, op)
        if _is_str_col(a) and _is_str_lit(b):
            t = b.data
            fns = {"<": lambda s: s < t, "<=": lambda s: s <= t,
                   ">": lambda s: s > t, ">=": lambda s: s >= t}
            return _str_lut_bool(
                ctx, a, fns[op], kind=f"cmp{op}:{t!r}"
            )
        an = _coerce_num(ctx, a)
        bn = _coerce_num(ctx, b)
        return Val(
            "bool", _COMPARE[op](an.data, bn.data), _and_masks(an.mask, bn.mask)
        )

    # arithmetic
    an = _coerce_num(ctx, a)
    bn = _coerce_num(ctx, b)
    mask = _and_masks(an.mask, bn.mask)
    if op == "+":
        return Val("num", an.data + bn.data, mask)
    if op == "-":
        return Val("num", an.data - bn.data, mask)
    if op == "*":
        return Val("num", an.data * bn.data, mask)
    if op in ("/", "%"):
        nonzero = bn.data != 0
        safe = _where(nonzero, bn.data, 1.0)
        out = an.data / safe if op == "/" else an.data % safe
        return Val("num", out, _and_masks(mask, nonzero))
    raise ExprEvalError(f"unknown binary op {op}")


def _eval_fn(expr: FnCall, ctx: EvalContext) -> Val:
    if expr.name == "coalesce":
        vals = [
            _coerce_num(ctx, eval_expression(arg, ctx)) for arg in expr.args
        ]
        out = None
        out_mask = None
        for v in reversed(vals):
            if out is None:
                out, out_mask = v.data, v.mask
            else:
                vm = v.mask if v.mask is not None else True
                out = _where(vm, v.data, out)
                out_mask = vm | (out_mask if out_mask is not None else True)
        if out_mask is True:
            out_mask = None
        return Val("num", out, out_mask)
    if expr.name == "abs":
        v = _coerce_num(ctx, eval_expression(expr.args[0], ctx))
        return Val("num", abs(v.data), v.mask)
    if expr.name == "length":
        v = eval_expression(expr.args[0], ctx)
        if v.kind != "str" or v.dictionary is None:
            raise ExprEvalError("length() requires a string column")
        lut = ctx.dictionary_lut(
            v, "len",
            lambda d: np.array([len(s) for s in d], dtype=np.float64)
            if len(d)
            else np.zeros(1),
        )
        return Val("num", lut[v.data.clamp(min=0).long()], v.data >= 0)
    raise ExprEvalError(f"unknown function {expr.name}")


def predicate_row_mask(val: Val, n: int, device) -> torch.Tensor:
    """WHERE semantics: null -> false. Returns a boolean row mask tensor."""
    v = _coerce_bool(val)
    data = v.data
    if isinstance(data, bool):
        data = torch.full((n,), data, dtype=torch.bool, device=device)
    if v.mask is None or v.mask is True:
        return data
    m = v.mask
    if isinstance(m, bool):
        m = torch.full((n,), m, dtype=torch.bool, device=device)
    return data & m


def compile_predicate(src_or_expr):
    """Compile a predicate for evaluation inside a fused scan.

    Returns ``(fn, columns)``: ``columns`` is the set of column names the
    predicate needs, and ``fn(chunk_vals, n, device) -> bool row-mask``
    where ``chunk_vals`` maps column name -> Val built from that chunk's
    device tensors. Dictionary lookup tables are built on the host at the
    first chunk that needs them and kept on the device
    (``ops/lut_cache.py``).
    """
    from deequ_tpu_torch.expr.parser import parse_expression

    expr = src_or_expr if isinstance(src_or_expr, Expr) else parse_expression(src_or_expr)
    cols = expr.columns()

    def fn(chunk_vals: Dict[str, Val], n: int, device):
        ctx = EvalContext(chunk_vals, device)
        return predicate_row_mask(eval_expression(expr, ctx), n, device)

    return fn, cols

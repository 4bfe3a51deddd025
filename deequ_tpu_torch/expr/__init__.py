from deequ_tpu_torch.expr.eval import compile_predicate, eval_expression
from deequ_tpu_torch.expr.parser import parse_expression

__all__ = ["parse_expression", "compile_predicate", "eval_expression"]

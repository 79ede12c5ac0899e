"""Affine-stencil extraction.

A stage whose expression is an affine combination of field accesses,

    out[x] = bias + sum_f sum_o  c_{f,o} * f[x + o],

has a coefficient map ``{(field, offsets): c, ("const",): bias}``.  The
adjoint builder (grad.py) transposes chains of such stages, and the Krylov
solvers (solve.py) use it to check that a chain is a linear operator.
"""
from __future__ import annotations

from typing import Dict, Optional

from .. import ir


class NotLinear(Exception):
    pass


def _combine(a: Dict, b: Dict, sign: float) -> Dict:
    out = dict(a)
    for k, v in b.items():
        out[k] = out.get(k, 0.0) + sign * v
    return out


def _scale(a: Dict, s: float) -> Dict:
    return {k: v * s for k, v in a.items()}


def _linear_expr(expr: ir.Expr, env: Dict[str, Dict]) -> Dict:
    """Coefficient map {('const',): bias, (field, offsets): coeff}."""
    if isinstance(expr, ir.Const):
        return {("const",): float(expr.value)}
    if isinstance(expr, ir.Ref):
        if expr.name not in env:
            raise NotLinear("unknown temporary")
        return env[expr.name]
    if isinstance(expr, ir.Access):
        return {(expr.field, expr.offsets): 1.0}
    if isinstance(expr, ir.UnaryOp):
        return _scale(_linear_expr(expr.operand, env), -1.0)
    if isinstance(expr, ir.BinOp):
        if expr.op == "add":
            return _combine(_linear_expr(expr.left, env),
                            _linear_expr(expr.right, env), 1.0)
        if expr.op == "sub":
            return _combine(_linear_expr(expr.left, env),
                            _linear_expr(expr.right, env), -1.0)
        if expr.op in ("mult", "div"):
            left = _linear_expr(expr.left, env)
            right = _linear_expr(expr.right, env)
            lconst = set(left) <= {("const",)}
            rconst = set(right) <= {("const",)}
            if expr.op == "mult":
                if lconst:
                    return _scale(right, left.get(("const",), 0.0))
                if rconst:
                    return _scale(left, right.get(("const",), 0.0))
                raise NotLinear("product of two field terms")
            if rconst:
                d = right.get(("const",), 0.0)
                if d == 0.0:
                    raise NotLinear("division by zero constant")
                return _scale(left, 1.0 / d)
            raise NotLinear("division by a field term")
    raise NotLinear(f"non-affine node {type(expr).__name__}")


def extract_linear(kspec: ir.KernelSpec) -> Optional[Dict]:
    """Affine coefficient map of a kernel, or None if not affine."""
    env: Dict[str, Dict] = {}
    try:
        for stmt in kspec.statements:
            env[stmt.lhs] = _linear_expr(stmt.rhs, env)
    except NotLinear:
        return None
    return env[kspec.output_statement.lhs]

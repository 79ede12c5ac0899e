"""Whole-domain chain interpreter — the framework's numerical oracle.

Evaluates every kernel of a program over the full (padded 3-D) domain in
topological order, with exact boundary-condition semantics matching the
reference's CPU backend (/root/reference/stencilflow/stencil/cpu.py:58-102):

* an access ``f[x + o]`` is out-of-bounds iff for some spanned dim ``d``,
  ``x_d + o_d`` falls outside ``[0, D_d)``;
* ``constant`` BC: OOB reads yield the configured value;
* ``copy`` BC: OOB reads yield the field's center value ``f[x]``;
* ``shrink`` BC: OOB reads yield JUNK_VAL (caller prunes the halo).

The same code path runs under numpy (bit-exact CPU oracle, float64 capable)
and under jax.numpy (jit-able; the XLA backend wraps this with ``jax.jit`` so
the whole chain fuses into one compiled program).  This is the
re-think of ``generate_reference`` (sdfg_generator.py:580-677): instead of
generating a loop-nest SDFG, the interpreter IS the reference program, traced
by JAX when performance matters.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from . import ir
from .config import JUNK_VAL
from .frontend.chain import ChainGraph

_BINOPS = {
    "add": lambda a, b: a + b,
    "sub": lambda a, b: a - b,
    "mult": lambda a, b: a * b,
    "div": lambda a, b: a / b,
}

_CMPOPS = {
    "lt": lambda a, b: a < b,
    "le": lambda a, b: a <= b,
    "gt": lambda a, b: a > b,
    "ge": lambda a, b: a >= b,
    "eq": lambda a, b: a == b,
    "ne": lambda a, b: a != b,
}


def _call_table(xp):
    return {
        "sin": xp.sin, "cos": xp.cos, "tan": xp.tan,
        "sinh": xp.sinh, "cosh": xp.cosh, "tanh": xp.tanh,
        "sqrt": xp.sqrt, "exp": xp.exp, "log": xp.log,
        "abs": xp.abs,
        "min": xp.minimum, "max": xp.maximum,
    }


# Narrow-float emulation under jnp: XLA elides f32->bf16->f32 convert
# round-trips (excess precision — CLAUDE.md), so a bf16 intermediate in a
# fused jit would flow at f32 precision where the numpy oracle rounds
# every op.  reduce_precision is NOT elided; apply it to any op result
# whose dtype is a narrow float so the jitted chain bit-matches numpy.
_NARROW_RP = {"bfloat16": (8, 7), "float16": (5, 10)}


def _round_narrow(xp, v):
    if xp is np:
        return v
    rp = _NARROW_RP.get(getattr(getattr(v, "dtype", None), "name", None))
    if rp is None:
        return v
    from jax import lax
    return lax.reduce_precision(v, *rp)


def _match_mixed(a, b):
    """Mixed int x float promotion — the framework's defined semantics
    (spec'd round 5, ADVICE r4): a STRONG integer/bool operand meeting a
    STRONG floating operand converts to that float dtype before the op,
    i.e. JAX's no-f64 lattice (int32 * float32 computes in float32).
    numpy's NEP 50 would widen int32/int64 x float32 to float64 — a
    compute dtype the JAX engines do not use with x64 off, so the jnp engines
    could never match the oracle bit-exactly on such programs.  Weak
    python scalars are untouched (NEP 50 already agrees with JAX there);
    float x float and int x int keep numpy semantics."""
    da = getattr(a, "dtype", None)
    db = getattr(b, "dtype", None)
    if da is None or db is None:
        return a, b
    from .dtypes import is_floating
    da, db = np.dtype(da), np.dtype(db)
    fa, fb = is_floating(da), is_floating(db)
    if fa and not fb and db.kind in "iub":
        return a, b.astype(da)
    if fb and not fa and da.kind in "iub":
        return a.astype(db), b
    return a, b


def _broadcast_to_domain(xp, arr, dim_mask, dimensions):
    """Expand a (possibly lower-dimensional) field to the full 3-D domain."""
    arr = xp.asarray(arr)
    if all(dim_mask):
        return arr.reshape(dimensions)
    shape = tuple(d if m else 1 for d, m in zip(dimensions, dim_mask))
    return xp.broadcast_to(arr.reshape(shape), tuple(dimensions))


def _oob_mask(xp, offsets, dimensions):
    """Boolean mask of positions whose shifted read falls outside the domain
    (reference: cpu.py:71-78 — OOB iff p < -o or p >= D - o per dim)."""
    mask = None
    for d, o in enumerate(offsets):
        if o is None or o == 0:
            continue
        idx_shape = [1, 1, 1]
        idx_shape[d] = dimensions[d]
        idx = xp.arange(dimensions[d]).reshape(idx_shape)
        m = (idx < -o) if o < 0 else (idx >= dimensions[d] - o)
        mask = m if mask is None else (mask | m)
    if mask is None:
        return None
    return xp.broadcast_to(mask, tuple(dimensions))


def _shifted(xp, arr3, offsets, fill):
    """result[x] = arr3[x + o], OOB positions = fill."""
    if all(o is None or o == 0 for o in offsets):
        return arr3
    pads = []
    slices = []
    for d, o in enumerate(offsets):
        o = 0 if o is None else o
        if o >= 0:
            pads.append((0, o))
            slices.append(slice(o, o + arr3.shape[d]))
        else:
            pads.append((-o, 0))
            slices.append(slice(0, arr3.shape[d]))
    padded = xp.pad(arr3, pads, mode="constant", constant_values=fill)
    return padded[tuple(slices)]


def read_access(xp, arr3, offsets, bc: ir.BoundaryCondition, dimensions):
    """Materialize one relative access over the whole domain with its BC."""
    if bc is None or bc.kind == ir.BCKind.CONSTANT:
        fill = bc.value if bc is not None else 0.0
        return _shifted(xp, arr3, offsets, fill)
    if bc.kind == ir.BCKind.SHRINK:
        return _shifted(xp, arr3, offsets, JUNK_VAL)
    if bc.kind == ir.BCKind.COPY:
        shifted = _shifted(xp, arr3, offsets, 0.0)
        mask = _oob_mask(xp, offsets, dimensions)
        if mask is None:
            return shifted
        return xp.where(mask, arr3, shifted)
    raise ValueError(f"unknown boundary condition {bc!r}")


class ChainInterpreter:
    """Evaluates a parsed program end-to-end over full arrays."""

    def __init__(self, program: ir.Program,
                 graph: Optional[ChainGraph] = None, xp=np):
        self.program = program
        self.graph = graph or ChainGraph.build(program)
        self.xp = xp
        self.calls = _call_table(xp)
        self._kdtype: Optional[np.dtype] = None

    # -- expression evaluation ------------------------------------------------
    def _eval(self, expr: ir.Expr, fields: Dict[str, Any],
              env: Dict[str, Any], bcs: Dict[str, ir.BoundaryCondition]):
        xp = self.xp
        if isinstance(expr, ir.Const):
            # Float consts are PINNED to a floating kernel's dtype in
            # every engine: under numpy a bare python float is a strong
            # f64 (NEP 50) that would widen the op; under jnp a weak
            # const DEMOTES against a narrower neighbor (weak f32 + bf16
            # -> bf16 in JAX's lattice, where the oracle computes f32).
            # A strong numpy scalar of the kernel dtype gives the same
            # bits as a weak const in uniform kernels and oracle-exact
            # promotion in mixed ones.
            if isinstance(expr.value, float) and self._kdtype is not None:
                return self._kdtype.type(expr.value)
            return expr.value
        if isinstance(expr, ir.Ref):
            return env[expr.name]
        if isinstance(expr, ir.Access):
            arr3 = fields[expr.field]
            return read_access(xp, arr3, expr.offsets, bcs.get(expr.field),
                               self.program.dimensions)
        if isinstance(expr, ir.BinOp):
            return _round_narrow(xp, _BINOPS[expr.op](*_match_mixed(
                self._eval(expr.left, fields, env, bcs),
                self._eval(expr.right, fields, env, bcs))))
        if isinstance(expr, ir.UnaryOp):
            return -self._eval(expr.operand, fields, env, bcs)
        if isinstance(expr, ir.Compare):
            return _CMPOPS[expr.op](*_match_mixed(
                self._eval(expr.left, fields, env, bcs),
                self._eval(expr.right, fields, env, bcs)))
        if isinstance(expr, ir.BoolOp):
            vals = [self._eval(o, fields, env, bcs) for o in expr.operands]
            acc = vals[0]
            for v in vals[1:]:
                acc = (acc & v) if expr.op == "and" else (acc | v)
            return acc
        if isinstance(expr, ir.Select):
            t, f = _match_mixed(
                self._eval(expr.if_true, fields, env, bcs),
                self._eval(expr.if_false, fields, env, bcs))
            return _round_narrow(xp, xp.where(
                self._eval(expr.cond, fields, env, bcs), t, f))
        if isinstance(expr, ir.Call):
            args = [self._eval(a, fields, env, bcs) for a in expr.args]
            if len(args) == 2:   # min/max: binary ufunc-shaped sites
                args = _match_mixed(*args)
            return _round_narrow(xp, self.calls[expr.fn](*args))
        raise TypeError(f"unknown expression node {type(expr)}")

    # -- kernel & chain evaluation ---------------------------------------------
    def eval_kernel(self, kname: str, fields: Dict[str, Any]):
        from .dtypes import is_floating
        kspec = self.program.kernels[kname]
        dt = np.dtype(kspec.dtype)
        # is_floating, not kind == "f": ml_dtypes bfloat16 has kind "V",
        # and an unpinned python-float const promotes a bf16 chain to
        # float32 under numpy (jnp keeps consts weak -> per-op bf16).
        # In NON-floating kernels float consts pin to float32 — the
        # framework's defined semantics: numpy would otherwise
        # materialize a weak const STRONG float64 inside np.where /
        # np.minimum, forcing f64 compute the JAX engines do not
        # use with x64 off, so f32 is the spec and every engine implements it.
        self._kdtype = dt if is_floating(dt) else np.dtype(np.float32)
        env: Dict[str, Any] = {}
        for stmt in kspec.statements:
            env[stmt.lhs] = self._eval(stmt.rhs, fields, env,
                                       kspec.boundary_conditions)
        result = env[kspec.output_statement.lhs]
        result = self.xp.asarray(result)
        if result.shape != tuple(self.program.dimensions):
            result = self.xp.broadcast_to(result,
                                          tuple(self.program.dimensions))
        if (self.xp is not np and dt.name in _NARROW_RP
                and result.dtype.kind != "b" and result.dtype != dt):
            # the output cast itself must round (XLA elides the
            # f32->bf16->f32 pair a downstream kernel would form)
            from jax import lax
            if result.dtype.kind in "iu":
                result = result.astype(np.float32)
            result = lax.reduce_precision(result, *_NARROW_RP[dt.name])
        return result.astype(kspec.dtype)

    def __call__(self, inputs: Dict[str, Any],
                 keep_intermediates: bool = False) -> Dict[str, Any]:
        """Run the whole chain; returns outputs (or all kernel results)."""
        xp = self.xp
        fields: Dict[str, Any] = {}
        for iname, spec in self.program.inputs.items():
            if spec.is_scalar:
                fields[iname] = xp.asarray(inputs[iname])
            else:
                fields[iname] = _broadcast_to_domain(
                    xp, inputs[iname], spec.dim_mask,
                    self.program.dimensions)
        for kname in self.graph.kernel_order:
            fields[kname] = self.eval_kernel(kname, fields)
        if keep_intermediates:
            return {k: fields[k] for k in self.program.kernels}
        raw = self.program.raw_dimensions
        return {
            out: fields[out].reshape(raw) for out in self.program.outputs
        }


def run_interpreter(program: ir.Program, inputs: Dict[str, Any],
                    xp=np) -> Dict[str, Any]:
    return ChainInterpreter(program, xp=xp)(inputs)

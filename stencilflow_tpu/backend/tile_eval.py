"""Shared halo-tile evaluator: runs a whole stencil chain on one widened tile.

The replacement for the reference's streaming pipeline semantics
(/root/reference/stencilflow/stencil/intel_fpga.py:107-543): instead of
skewing element streams in *time* through line buffers and delay FIFOs, we
widen tiles in *space* by the chain's cumulative halo and evaluate every
kernel over the whole widened tile.  Out-of-tile reads use circular rolls
whose wrapped values only ever land in the tile's invalid margin (which
shrinks by each stage's radius and never reaches the core, by construction of
the halo budget), and out-of-*domain* reads are fixed up with
boundary-condition masks over global coordinates.

The same function body serves every execution path:

* the single-tile XLA backend (the whole padded domain as one "tile"),
* the shard_map domain-decomposition path (one tile per device, halos
  exchanged with ``ppermute``),
* the pipeline-split segments and the out-of-core chunk bodies.

Everything here is shape-static, data-independent control flow — jit safe.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import jax.numpy as jnp
import numpy as np
from jax import lax

from .. import ir
from ..dtypes import is_floating
from ..config import JUNK_VAL
from ..frontend.chain import ChainGraph

Vec3 = Tuple[int, int, int]


def _roll(arr, shift: int, axis: int):
    """Static circular shift; result[x] = arr[x + shift]."""
    if shift == 0:
        return arr
    return jnp.roll(arr, -shift, axis=axis)


def _global_oob_mask(offsets: ir.Offsets, tile_shape: Sequence[int],
                     origin: Sequence[Any], halo: Vec3,
                     dimensions: Vec3, cache: Optional[dict] = None):
    """Mask of widened-tile positions whose shifted read leaves the domain.

    Global coordinate of widened-tile cell x in dim d is
    ``origin[d] + x_d - halo[d]``; the read targets global + offset.
    ``origin`` entries may be traced scalars (shard or chunk offsets).
    Matches the reference's OOB rule (stencil/cpu.py:71-78).

    Masks depend only on (offsets, tile_shape), which deep chains repeat
    every stage — ``cache`` memoizes them within one tile evaluation.
    """
    key = (tuple(offsets), tuple(tile_shape))
    if cache is not None and key in cache:
        return cache[key]
    mask = None
    for d, o in enumerate(offsets):
        if o is None:
            continue  # unspanned dim
        if (o == 0 and isinstance(origin[d], (int, np.integer))
                and origin[d] - halo[d] == 0
                and tile_shape[d] == dimensions[d]):
            # statically in-bounds: an unshifted read of a tile that spans
            # the whole domain at origin 0 — skip the (all-false) mask and
            # its where entirely
            continue
        idx = lax.broadcasted_iota(jnp.int32, tuple(tile_shape), d)
        g = idx + (origin[d] - halo[d] + o)
        m = (g < 0) | (g >= dimensions[d])
        mask = m if mask is None else (mask | m)
    if cache is not None:
        cache[key] = mask
    return mask


def read_access_tile(buf, offsets: ir.Offsets,
                     bc: Optional[ir.BoundaryCondition],
                     origin: Sequence[Any], halo: Vec3, dimensions: Vec3,
                     cache: Optional[dict] = None):
    """Materialize ``field[x + o]`` over a widened tile with its BC applied
    (a copy BC reads the unshifted ``buf``, the evaluation point)."""
    shifted = buf
    for d, o in enumerate(offsets):
        if o is None or o == 0:
            continue
        shifted = _roll(shifted, o, d)
    mask = _global_oob_mask(offsets, buf.shape, origin, halo, dimensions,
                            cache)
    if mask is None:
        return shifted
    if bc is None or bc.kind == ir.BCKind.CONSTANT:
        fill = jnp.asarray(bc.value if bc is not None else 0.0, buf.dtype)
        return jnp.where(mask, fill, shifted)
    if bc.kind == ir.BCKind.COPY:
        return jnp.where(mask, buf, shifted)
    if bc.kind == ir.BCKind.SHRINK:
        return jnp.where(mask, jnp.asarray(JUNK_VAL, buf.dtype), shifted)
    raise ValueError(f"unknown boundary condition {bc!r}")


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

_CALLS: Dict[str, Callable] = {
    "sin": jnp.sin, "cos": jnp.cos, "tan": jnp.tan,
    "sinh": jnp.sinh, "cosh": jnp.cosh, "tanh": jnp.tanh,
    "sqrt": jnp.sqrt, "exp": jnp.exp, "log": jnp.log,
    "abs": jnp.abs, "min": jnp.minimum, "max": jnp.maximum,
}


def const_dtype_of(kspec: ir.KernelSpec):
    """Pin dtype for a kernel's float constants: the kernel dtype when it
    is floating, else float32.  Matches the oracle's pinning
    (interpreter.py eval_kernel): a weak jnp const DEMOTES against a
    narrower neighbor (weak f32 + bf16 -> bf16 in JAX's lattice, where
    numpy computes f32), and in non-floating kernels an unpinned numpy
    const would materialize strong float64 — which the JAX engines do not
    compute with x64 off — so f32 is the defined semantics there."""
    dt = np.dtype(kspec.dtype)
    return dt if is_floating(dt) else np.dtype(np.float32)


def _eval_expr(expr: ir.Expr, fields: Dict[str, Any], env: Dict[str, Any],
               bcs: Dict[str, ir.BoundaryCondition],
               origin, halo, dimensions, cache=None, const_dtype=None):
    """Tile-read strategy over the shared walker (eval_expr_generic)."""
    def read_fn(field, offsets):
        buf = fields[field]
        if not hasattr(buf, "shape") or buf.ndim == 0:  # scalar input
            return buf
        return read_access_tile(buf, offsets, bcs.get(field),
                                origin, halo, dimensions, cache)
    return eval_expr_generic(expr, env, read_fn, const_dtype)


def last_use_map(program: ir.Program, order, keep) -> Dict[str, int]:
    """Death schedule: field -> index of its last consuming kernel in
    ``order`` (``keep`` names pinned past the end)."""
    last_use: Dict[str, int] = {}
    for idx, kname in enumerate(order):
        for f in program.kernels[kname].accesses():
            last_use[f] = idx
    for n in keep:
        last_use[n] = len(order)
    return last_use


def eval_expr_generic(expr: ir.Expr, env: Dict[str, Any], read_fn,
                      const_dtype=None):
    """Expression walker parameterized by the field-read strategy.

    ``read_fn(field, offsets)`` materializes an Access; Refs resolve through
    ``env``.  ``const_dtype`` pins float constants to the kernel dtype
    (strong numpy scalar — see const_dtype_of).
    """
    if isinstance(expr, ir.Const):
        if const_dtype is not None and isinstance(expr.value, float):
            return const_dtype.type(expr.value)
        return expr.value
    if isinstance(expr, ir.Ref):
        return env[expr.name]
    if isinstance(expr, ir.Access):
        return read_fn(expr.field, expr.offsets)
    rec = lambda e: eval_expr_generic(e, env, read_fn, const_dtype)
    # Mixed int x float sites apply the framework's JAX-lattice
    # promotion spec (interpreter._match_mixed) EXPLICITLY: without it,
    # jnp itself only implements that lattice when jax_enable_x64 is
    # off — under x64 (the CPU test configuration) jnp reverts to
    # numpy's int32 x float32 -> float64, splitting the engines
    # (ADVICE r4 medium).  The explicit cast is a no-op where jnp's
    # implicit promotion already lands on the float dtype.
    from ..interpreter import _match_mixed
    if isinstance(expr, ir.BinOp):
        return _BINOPS[expr.op](*_match_mixed(rec(expr.left),
                                              rec(expr.right)))
    if isinstance(expr, ir.UnaryOp):
        return -rec(expr.operand)
    if isinstance(expr, ir.Compare):
        return _CMPOPS[expr.op](*_match_mixed(rec(expr.left),
                                              rec(expr.right)))
    if isinstance(expr, ir.BoolOp):
        vals = [rec(o) for o in expr.operands]
        acc = vals[0]
        for v in vals[1:]:
            acc = (acc & v) if expr.op == "and" else (acc | v)
        return acc
    if isinstance(expr, ir.Select):
        t, f = _match_mixed(rec(expr.if_true), rec(expr.if_false))
        return jnp.where(rec(expr.cond), t, f)
    if isinstance(expr, ir.Call):
        args = [rec(a) for a in expr.args]
        if len(args) == 2:   # min/max: binary ufunc-shaped sites
            args = _match_mixed(*args)
        return _CALLS[expr.fn](*args)
    raise TypeError(f"unknown expression node {type(expr)}")


def broadcast_input_tile(arr, dim_mask: Tuple[bool, bool, bool],
                         tile_shape: Vec3):
    """Expand a lower-dimensional input's tile slice to the full widened-tile
    shape (size-1 in unspanned dims, broadcast)."""
    arr = jnp.asarray(arr)
    if arr.ndim == 0:
        return arr
    shape = tuple(t if m else 1 for t, m in zip(tile_shape, dim_mask))
    return jnp.broadcast_to(arr.reshape(shape), tuple(tile_shape))


def evaluate_chain_tile(program: ir.Program, graph: ChainGraph,
                        tile_fields: Dict[str, Any],
                        origin: Sequence[Any], halo: Vec3,
                        keep: Optional[Sequence[str]] = None,
                        core_shape: Optional[Sequence[int]] = None
                        ) -> Dict[str, Any]:
    """Evaluate every kernel of ``program`` over one widened tile.

    ``tile_fields`` maps each program input to its widened-tile array (full
    widened shape for 3-D fields, spanned-dims-only widened slices for
    lower-dimensional fields, 0-d for scalars).  ``origin`` is the global
    element offset of the tile *core*; entries may be traced.  Returns kernel
    results at the widened tile shape (caller slices out the core); ``keep``
    restricts which kernel results are returned (default: program outputs).
    ``core_shape`` is the tile core's extent per dim (default: the whole
    domain); it sizes the tile in dims that no input spans.
    """
    dims = program.dimensions
    tile_shape = None
    fields: Dict[str, Any] = {}
    for iname, spec in program.inputs.items():
        arr = tile_fields[iname]
        if spec.is_scalar:
            fields[iname] = jnp.asarray(arr)
            continue
        if all(spec.dim_mask):
            arr = jnp.asarray(arr)
            tile_shape = arr.shape
            fields[iname] = arr
        else:
            fields[iname] = arr  # broadcast once tile_shape is known
    if tile_shape is None:
        # No full-rank input: derive the widened shape by combining every
        # spanned input (elementwise max — a lower-rank input must not
        # shadow a higher-rank one); a dim spanned by NO input still has
        # full-extent kernel fields, so it takes the widened core extent,
        # not 1
        guess = [0, 0, 0]
        spanned = [False, False, False]
        for iname, spec in program.inputs.items():
            if spec.is_scalar or all(spec.dim_mask):
                continue
            arr = jnp.asarray(tile_fields[iname])
            it = iter(arr.shape)
            for d, m in enumerate(spec.dim_mask):
                if m:
                    guess[d] = max(guess[d], next(it))
                    spanned[d] = True
        if not any(spanned):
            raise ValueError("program has no array inputs")
        core = tuple(core_shape) if core_shape is not None else dims
        for d in range(3):
            if not spanned[d]:
                guess[d] = (core[d] + 2 * halo[d]) if dims[d] > 1 else 1
        tile_shape = tuple(guess)
    for iname, spec in program.inputs.items():
        if not spec.is_scalar and not all(spec.dim_mask):
            fields[iname] = broadcast_input_tile(
                fields[iname], spec.dim_mask, tile_shape)
    # Precomputed upstream-kernel tiles (pipeline-split segments pass these).
    for name, arr in tile_fields.items():
        if name not in fields:
            fields[name] = jnp.asarray(arr)

    # Death schedule: drop a field's tile after its last consumer so the
    # compiler can reuse the buffer (bounds live memory on deep chains).
    names = list(keep) if keep is not None else list(program.outputs)
    order = graph.kernel_order
    last_use = last_use_map(program, order, names)

    out: Dict[str, Any] = {}
    mask_cache: Dict[Any, Any] = {}
    for idx, kname in enumerate(order):
        kspec = program.kernels[kname]
        env: Dict[str, Any] = {}
        cdt = const_dtype_of(kspec)
        for stmt in kspec.statements:
            env[stmt.lhs] = _eval_expr(stmt.rhs, fields, env,
                                       kspec.boundary_conditions,
                                       origin, halo, dims, mask_cache,
                                       cdt)
        result = env[kspec.output_statement.lhs]
        result = jnp.asarray(result)
        if result.shape != tuple(tile_shape):
            result = jnp.broadcast_to(result, tuple(tile_shape))
        fields[kname] = result.astype(kspec.dtype)
        for f in [f for f, last in last_use.items() if last == idx]:
            if f in fields and f not in names:
                del fields[f]

    return {n: fields[n] for n in names}

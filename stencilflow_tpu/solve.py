"""Matrix-free Krylov solvers over stencil-chain operators.

An affine chain ``fn(x) = A x + c`` (constant coefficients, constant BCs;
``c`` collects bias terms, boundary constants, and any other inputs'
contributions) is a matrix-free linear operator: one application = one
fused chain evaluation.  That unlocks IMPLICIT solvers the reference's
feed-forward pipelines cannot express — e.g. backward-Euler diffusion
``(I - dt·L) x_{t+1} = x_t`` solved by conjugate gradients (with the
transpose via :func:`stencilflow_tpu.grad.adjoint_program` when the
operator is not symmetric).

``c`` is measured once as ``fn(0)`` and moved to the right-hand side, so
the returned ``x`` satisfies the PROGRAM's equation ``fn(x) = rhs``
exactly (not just the homogeneous part).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

from . import ir


def _validate_affine(program: ir.Program, field: str, out: str):
    from .backend.linear import extract_linear
    for kname, kspec in program.kernels.items():
        if extract_linear(kspec) is None:
            raise ValueError(
                f"kernel {kname!r} is not affine with constant "
                "coefficients; Krylov solvers need a linear operator")
        for bc in kspec.boundary_conditions.values():
            if bc.kind != ir.BCKind.CONSTANT:
                raise ValueError(
                    f"kernel {kname!r} has a non-constant boundary "
                    "condition")
    if field not in program.inputs:
        raise ValueError(f"{field!r} is not a program input")
    spec = program.inputs[field]
    if spec.is_scalar or any(
            program.dimensions[d] > 1 and not spec.dim_mask[d]
            for d in range(3)):
        raise ValueError(f"solve field {field!r} must be a full-rank "
                         "array input")
    if out not in program.outputs:
        raise ValueError(f"{out!r} is not a program output")
    return spec


def _affine_op(program: ir.Program, field: str, out: str):
    """``(op, offset)`` for the chain's affine map restricted to
    ``field`` → ``out``: ``op(x) = A x`` (traced-safe) and the concrete
    offset ``c = fn(0)`` with every other input at its declared data.
    Validates affinity/BCs/rank like adjoint_program."""
    import jax.numpy as jnp

    from .backend import compile_chain_best
    from .data import load_input_arrays

    spec = _validate_affine(program, field, out)
    fn, _b = compile_chain_best(program)
    shape = tuple(spec.shape(program.dimensions))
    # every other input pinned at its declared data: its contribution
    # lands in the affine offset and is subtracted with it
    rest = {n: jnp.asarray(v)
            for n, v in load_input_arrays(program).items() if n != field}

    def full(x):
        return fn({field: x.reshape(shape), **rest})[out].reshape(
            x.shape)

    # measured eagerly (never under a trace): c = fn(0)
    zero = jnp.zeros(shape, jnp.dtype(spec.dtype))
    offset = full(zero)

    def op(x):
        return full(x) - offset.reshape(x.shape)

    return op, offset


def _affine_op_chunked(program: ir.Program, field: str, out: str,
                       chunks: int):
    """Out-of-core variant of :func:`_affine_op`: one operator
    application = one i-chunked sweep (outofcore.py) over host-resident
    numpy state.  CG vectors live in host memory; only one chunk (+halo)
    is ever device-resident."""
    import numpy as np

    from .data import load_input_arrays
    from .outofcore import compile_chunked_chain, run_chunked

    spec = _validate_affine(program, field, out)
    compiled = compile_chunked_chain(program, chunks)
    shape = tuple(spec.shape(program.dimensions))
    rest = {n: np.asarray(v)
            for n, v in load_input_arrays(program).items() if n != field}

    def full(x):
        got = run_chunked(program, {field: np.asarray(x).reshape(shape),
                                    **rest}, chunks, compiled=compiled)
        return got[out].reshape(np.shape(x))

    offset = full(np.zeros(shape, np.dtype(spec.dtype)))

    def op(x):
        return full(x) - offset.reshape(np.shape(x))

    return op, offset


def _hdot(a, b) -> float:
    """f64-accumulated dot over host arrays, in slabs (no 2x f64 temp)."""
    import numpy as np
    a = np.asarray(a).ravel()
    b = np.asarray(b).ravel()
    total = 0.0
    step = 1 << 22
    for s in range(0, a.size, step):
        total += float(np.dot(a[s:s + step].astype(np.float64),
                              b[s:s + step].astype(np.float64)))
    return total


def _make_cg_run_host(op: Callable, tol: float, maxiter: int) -> Callable:
    """Textbook CG with host-resident vectors (the out-of-core path);
    dot products accumulate in f64."""
    import numpy as np

    def run(x, b):
        x = np.array(x, copy=True)
        atol2 = float(tol) ** 2 * _hdot(b, b)
        r = b - op(x)
        p = np.array(r, copy=True)
        rs = _hdot(r, r)
        k = 0
        while rs > atol2 and k < maxiter:
            ap = op(p)
            alpha = rs / _hdot(p, ap)
            x += (alpha * p).astype(x.dtype, copy=False)
            r -= (alpha * ap).astype(r.dtype, copy=False)
            rs_new = _hdot(r, r)
            p = r + np.asarray(rs_new / rs, p.dtype) * p
            rs = rs_new
            k += 1
        return x, rs, k

    return run


def _make_cg_run(op: Callable, tol: float, maxiter: int) -> Callable:
    """Jitted textbook CG on ``op`` (must be SPD), iterations on device.
    Built ONCE per solver so repeated solves reuse the compilation."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    def dot(a, b):
        # full-precision inner products: a float32 dot may otherwise run
        # in TF32 on the GPU's tensor cores (10-bit mantissa)
        return jnp.vdot(a, b, precision=lax.Precision.HIGHEST).real

    def body(state):
        x, r, p, rs, k = state
        ap = op(p)
        alpha = rs / dot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = dot(r, r)
        p = r + (rs_new / rs) * p
        return x, r, p, rs_new, k + 1

    @jax.jit
    def run(x, b):
        atol2 = jnp.asarray(tol, b.dtype) ** 2 * dot(b, b)

        def cond(state):
            _x, _r, _p, rs, k = state
            return (rs > atol2) & (k < maxiter)

        r = b - op(x)
        rs = dot(r, r)
        state = lax.while_loop(cond, body, (x, r, r, rs, 0))
        return state[0], state[3], state[4]

    return run


def make_solver(program: ir.Program,
                field: Optional[str] = None, out: Optional[str] = None,
                method: str = "cg",
                tol: float = 1e-6, maxiter: int = 1000,
                host_chunks: int = 0) -> Callable:
    """Compile a reusable solver ``solver(rhs, x0=None) -> (x, info)`` for
    the program's equation ``fn(x) = rhs`` (``fn`` restricted to input
    ``field`` and output ``out``; defaults: the sole input/output).

    ``method="cg"`` needs the linear part symmetric positive definite
    (e.g. ``y = x - dt·laplacian(x)``); ``method="cgnr"`` handles general
    affine chains via CG on the normal equations, with the transposed
    chain from :func:`stencilflow_tpu.grad.adjoint_program` — both
    operators run as fused chains, iterations on device.

    ``host_chunks`` > 1: implicit solves on domains larger than device
    memory — each operator application streams the domain in i-chunks
    (outofcore.py), CG vectors stay in host memory, and dot products
    accumulate in f64.

    ``info["residual"]`` is always the true relative residual
    ``|fn(x) - rhs| / |rhs|`` (one extra operator application).
    Compilation happens once here — reuse the solver across time steps.
    """
    host = bool(host_chunks and host_chunks > 1)
    import numpy as np
    if not host:
        import jax
        import jax.numpy as jnp

    field = field or next(iter(program.inputs))
    out = out or program.outputs[0]
    if host:
        op, offset = _affine_op_chunked(program, field, out, host_chunks)
    else:
        op, offset = _affine_op(program, field, out)

    if method == "cg":
        normal = op
        project = None
    elif method == "cgnr":
        from .grad import adjoint_program
        adj, cot = adjoint_program(program, wrt=[field])
        if host:
            op_t, _zero = _affine_op_chunked(adj, cot[out],
                                             f"adj_{field}", host_chunks)
        else:
            op_t, _zero = _affine_op(adj, cot[out], f"adj_{field}")

        def normal(v):
            return op_t(op(v).reshape(v.shape)).reshape(v.shape)

        project = op_t
    else:
        raise ValueError(f"unknown method {method!r} (cg | cgnr)")

    if host:
        run = _make_cg_run_host(normal, tol, maxiter)

        def _residual(x, b, rhs):
            d = op(x) - b
            return (np.sqrt(_hdot(d, d))
                    / max(np.sqrt(_hdot(rhs, rhs)), 1e-30))

        def solver(rhs, x0=None):
            rhs = np.asarray(rhs)
            b = rhs - offset.reshape(rhs.shape)
            b_sys = (project(b).reshape(b.shape)
                     if project is not None else b)
            x = (np.zeros_like(b_sys) if x0 is None
                 else np.array(x0, copy=True))
            x, _rs, k = run(x, b_sys)
            return x, {"iterations": int(k),
                       "residual": float(_residual(x, b, rhs))}

        return solver

    run = _make_cg_run(normal, tol, maxiter)

    @jax.jit
    def _residual(x, b, rhs):
        # |op(x) - b| == |fn(x) - rhs| (b = rhs - offset), but normalize by
        # the ORIGINAL rhs: with a nonzero affine offset |b| can differ from
        # |rhs| by an unbounded factor and misreport convergence.
        return (jnp.linalg.norm(op(x) - b) /
                jnp.maximum(jnp.linalg.norm(rhs), 1e-30))

    def solver(rhs, x0=None):
        rhs = jnp.asarray(rhs)
        b = rhs - offset.reshape(jnp.shape(rhs))
        b_sys = project(b).reshape(b.shape) if project is not None else b
        x = jnp.zeros_like(b_sys) if x0 is None else jnp.asarray(x0)
        x, _rs, k = run(x, b_sys)
        return x, {"iterations": int(k),
                   "residual": float(_residual(x, b, rhs))}

    return solver


def solve_cg(program: ir.Program, rhs: Any, **kw) -> Tuple[Any, Dict]:
    """One-shot :func:`make_solver`(method="cg") — see there.  For
    repeated solves (implicit time-stepping) build the solver once."""
    kw.setdefault("method", "cg")
    if kw["method"] != "cg":
        raise ValueError("solve_cg is CG; call solve_cgnr or "
                         "make_solver(method=...) instead")
    return make_solver(program, **kw)(rhs)


def solve_cgnr(program: ir.Program, rhs: Any, **kw) -> Tuple[Any, Dict]:
    """One-shot :func:`make_solver`(method="cgnr") — see there."""
    kw.setdefault("method", "cgnr")
    if kw["method"] != "cgnr":
        raise ValueError("solve_cgnr is CGNR; call solve_cg or "
                         "make_solver(method=...) instead")
    return make_solver(program, **kw)(rhs)

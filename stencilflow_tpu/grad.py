"""Differentiable chain evaluation — adjoints of stencil programs.

A capability the reference cannot offer: its pipelines are generated
OpenCL/HLS (sdfg_generator.py) with no derivative story.  Here the fused-XLA
tile evaluator (backend/xla.py) is pure JAX, so any stencil chain — linear
or not (ternaries, min/max, limiters differentiate as subgradients) — is
reverse-mode differentiable end to end.  The adjoint of a stencil chain is
itself a chain of (transposed) stencils, and XLA fuses the backward pass
the same way it fuses the forward one.

Use cases: PDE-constrained optimization, data assimilation (4D-Var),
sensitivity analysis of initial conditions / coefficient fields.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Tuple

from . import ir
from .frontend.analysis import ChainAnalysis


def value_and_grad(program: ir.Program,
                   loss: Optional[Callable[[Dict[str, Any]], Any]] = None,
                   wrt: Optional[Sequence[str]] = None,
                   analysis: Optional[ChainAnalysis] = None,
                   mesh=None, dim_axes: Optional[Sequence] = None,
                   jit: bool = True) -> Callable:
    """Build ``f(inputs) -> (value, grads)`` for a scalar loss of the
    chain's outputs.

    ``loss``: callable mapping the outputs dict to a scalar (default: sum
    of every output).  ``wrt``: input names to differentiate with respect
    to (default: every non-scalar floating-point input).  ``grads`` is a
    dict over ``wrt``.  The returned function is jit-compiled and itself
    further differentiable (higher-order derivatives work).

    Multi-device: pass ``mesh`` + ``dim_axes`` — the forward pass is the
    shard_map domain decomposition and JAX transposes the halo exchange
    (``ppermute``) in the backward pass, so gradients stay sharded exactly
    like the primals.  The decomposition plan is attached as ``f.plan`` —
    commit inputs with ``f.plan.input_shardings()`` to avoid a reshard on
    entry.
    """
    import jax
    import jax.numpy as jnp

    from .dtypes import is_floating

    plan = None
    if mesh is not None:
        from .parallel.domain import compile_sharded_chain
        if dim_axes is None:
            raise ValueError("mesh requires dim_axes, e.g. "
                             "(None, 'x', 'y')")
        fn, plan = compile_sharded_chain(program, mesh, dim_axes,
                                         analysis)
    else:
        from .backend.xla import compile_chain
        fn = compile_chain(program, analysis)
    if wrt is None:
        wrt = [n for n, s in program.inputs.items()
               if not s.is_scalar and is_floating(s.dtype)]
    unknown = [n for n in wrt if n not in program.inputs]
    if unknown:
        raise ValueError(f"wrt names {unknown} are not program inputs "
                         f"(inputs: {list(program.inputs)})")
    if loss is None:
        def loss(outputs):
            return sum(jnp.sum(v) for v in outputs.values())

    def f(inputs: Dict[str, Any]):
        diff = {n: inputs[n] for n in wrt}
        rest = {n: v for n, v in inputs.items() if n not in diff}

        def scalar(d):
            return loss(fn({**rest, **d}))

        return jax.value_and_grad(scalar)(diff)

    # NB: the backends' forward fns are themselves jitted; jit=False only
    # removes the outer wrapper (the forward still traces), it is not an
    # eager escape hatch
    out = jax.jit(f) if jit else f
    out.plan = plan
    return out


def grad(program: ir.Program, **kw) -> Callable:
    """``f(inputs) -> grads`` (see :func:`value_and_grad`)."""
    vg = value_and_grad(program, **kw)

    def f(inputs):
        return vg(inputs)[1]

    f.plan = vg.plan
    return f


def fast_value_and_grad(program: ir.Program,
                        loss: Optional[Callable] = None,
                        wrt: Optional[Sequence[str]] = None,
                        mesh=None, dim_axes: Optional[Sequence] = None,
                        host_chunks: int = 0) -> Callable:
    """``f(inputs) -> (value, grads)`` with the backward pass as a
    compiled stencil chain of its own (affine chains only — see
    :func:`adjoint_program` for the requirements; :func:`value_and_grad`
    is the general path).

    The chain runs forward as one fused program, the loss cotangent
    ``dL/dy`` is formed by (cheap, elementwise) autodiff of ``loss`` over
    the outputs, and the gradient is the transposed chain applied to that
    cotangent — no autodiff through the forward chain.

    Multi-device: pass ``mesh`` + ``dim_axes`` — BOTH passes become
    shard_map domain decompositions.  The forward plan is attached as
    ``f.plan``.

    ``host_chunks`` > 1: gradients over domains larger than device
    memory — forward chain, loss cotangent, and adjoint chain all run
    in i-chunked sweeps (outofcore.py) over host-resident arrays.
    The loss must be ADDITIVE over elements (sum / MSE / any
    per-element reduction): it is evaluated per i-chunk and summed.
    """
    import jax
    import jax.numpy as jnp

    from .dtypes import is_floating

    if wrt is None:
        wrt = [n for n, s in program.inputs.items()
               if not s.is_scalar and is_floating(s.dtype)]
    if loss is None:
        def loss(outputs):
            return sum(jnp.sum(v) for v in outputs.values())

    adj, cot = adjoint_program(program, wrt)
    plan = None
    if host_chunks and host_chunks > 1:
        if mesh is not None:
            raise ValueError("host_chunks is incompatible with mesh")
        return _fast_vag_chunked(program, adj, cot, loss, wrt,
                                 host_chunks)
    if mesh is not None:
        from .parallel.domain import compile_sharded_chain
        if dim_axes is None:
            raise ValueError("mesh requires dim_axes, e.g. "
                             "(None, 'x', 'y')")
        fwd, plan = compile_sharded_chain(program, mesh, dim_axes)
        bwd, _bplan = compile_sharded_chain(adj, mesh, dim_axes)
    else:
        from .backend import compile_chain_best
        fwd, _b = compile_chain_best(program)
        bwd, _b2 = compile_chain_best(adj)

    # copy-BC transposes add embedded 1-D OOB-indicator inputs; load them
    # once (they are compile-time constants of the adjoint program)
    from .data import load_input_arrays
    cot_names = set(cot.values())
    extra_adj = {n: jnp.asarray(v) for n, v in
                 load_input_arrays(adj).items() if n not in cot_names}

    @jax.jit
    def f(inputs: Dict[str, Any]):
        outputs = fwd(inputs)
        val, ct = jax.value_and_grad(loss)(outputs)
        adj_in = {cot[o]: ct[o].reshape(tuple(adj.dimensions))
                  for o in program.outputs}
        adj_out = bwd({**adj_in, **extra_adj})
        grads = {n: adj_out[f"adj_{n}"].reshape(jnp.shape(inputs[n]))
                 for n in wrt}
        return val, grads

    f.plan = plan
    return f


def _fast_vag_chunked(program: ir.Program, adj: ir.Program,
                      cot: Dict[str, str], loss: Callable,
                      wrt: Sequence[str], chunks: int):
    """Out-of-core fast_value_and_grad: chunked forward sweep, per-chunk
    loss cotangent (additive losses), chunked adjoint sweep."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from .data import load_input_arrays
    from .outofcore import compile_chunked_chain, run_chunked

    fwd_c = compile_chunked_chain(program, chunks)
    bwd_c = compile_chunked_chain(adj, chunks)
    cot_names = set(cot.values())
    extra_adj = {n: np.asarray(v) for n, v in
                 load_input_arrays(adj).items() if n not in cot_names}
    loss_grad = jax.jit(jax.value_and_grad(loss))
    Ic = fwd_c[1].block

    def f(inputs: Dict[str, Any]):
        outputs = run_chunked(program, inputs, chunks, compiled=fwd_c)
        val = 0.0
        ct = {o: np.empty_like(outputs[o]) for o in program.outputs}
        for c in range(chunks):
            sl = slice(c * Ic, (c + 1) * Ic)
            chunk_out = {o: jnp.asarray(outputs[o][sl])
                         for o in program.outputs}
            v, g = loss_grad(chunk_out)
            val += float(v)
            for o in program.outputs:
                ct[o][sl] = np.asarray(g[o])
        adj_in = {cot[o]: ct[o] for o in program.outputs}
        adj_out = run_chunked(adj, {**adj_in, **extra_adj}, chunks,
                              compiled=bwd_c)
        grads = {n: adj_out[f"adj_{n}"].reshape(np.shape(inputs[n]))
                 for n in wrt}
        return val, grads

    f.plan = None
    return f


def adjoint_program(program: ir.Program,
                    wrt: Optional[Sequence[str]] = None
                    ) -> Tuple[ir.Program, Dict[str, str]]:
    """Transpose an affine chain into another stencil *program*.

    The adjoint of a linear stencil chain is itself a chain of transposed
    stencils: if ``y = Σ_o c_o · x[t+o]`` then ``x̄ = Σ_o c_o · ȳ[t−o]``.
    This builds that chain in the same dialect, so the backward pass
    compiles and runs like any forward chain — without autodiff through
    the tile evaluator (:func:`value_and_grad`), which remains the fully
    general path (non-affine programs, custom losses fused with the
    forward).

    Returns ``(adjoint, cotangents)`` where ``adjoint`` is a Program
    whose inputs are one cotangent field per primal output (named by the
    ``cotangents`` dict, default data ``constant:1.0`` = the adjoint of
    a sum loss) and whose outputs are ``adj_<name>`` for every ``wrt``
    input.  Requirements (raises ``ValueError`` otherwise): every kernel
    affine with constant coefficients, every boundary condition
    ``constant`` (the transpose of a constant-BC read is a zero-BC
    read), and every ``wrt`` input full-rank.
    """
    import numpy as np

    from .backend.linear import extract_linear
    from .dtypes import dtype_to_str, is_floating

    if wrt is None:
        wrt = [n for n, s in program.inputs.items()
               if not s.is_scalar and is_floating(s.dtype)]
    for n in wrt:
        if n not in program.inputs:
            raise ValueError(f"wrt name {n!r} is not a program input")
        mask = program.inputs[n].dim_mask
        if any(program.dimensions[d] > 1 and not mask[d]
               for d in range(3)):
            raise ValueError(f"wrt input {n!r} must span every non-unit "
                             "dim (broadcast adjoints need a reduction, "
                             "not a stencil)")

    analysis = ChainAnalysis.run(program)
    order = analysis.graph.kernel_order

    def adj_name(f: str) -> str:
        return f"adj_{f}"

    cot = {o: f"ct_{o}" for o in program.outputs}

    # kernels whose value transitively reaches a program output; a dead
    # kernel's cotangent is identically zero, so its consumers' terms (and
    # its own adjoint kernel) are skipped rather than referencing an
    # undefined adj_<dead> field
    live = set(program.outputs)
    for kname in reversed(order):
        if any(c in live for c in analysis.graph.consumers(kname)):
            live.add(kname)

    # only LIVE kernels must be affine/shrink-free: a dead diagnostic
    # kernel (e.g. a min/max monitor feeding no output) never enters the
    # transposed chain, so it cannot block the fast adjoint
    coeffs: Dict[str, Dict] = {}
    for kname, kspec in program.kernels.items():
        if kname not in live:
            continue
        c = extract_linear(kspec)
        if c is None:
            raise ValueError(
                f"kernel {kname!r} is not affine with constant "
                "coefficients; use value_and_grad for the general path")
        for bc in kspec.boundary_conditions.values():
            if bc.kind == ir.BCKind.SHRINK:
                raise ValueError(
                    f"kernel {kname!r} has a shrink boundary condition; "
                    "its junk halo has no meaningful adjoint")
        coeffs[kname] = c

    def idx(offsets) -> str:
        its = ("i", "j", "k")
        parts = []
        for it, o in zip(its, offsets):
            o = -(o or 0)   # transposed read
            parts.append(it if o == 0 else
                         (f"{it}+{o}" if o > 0 else f"{it}-{-o}"))
        return "[" + ", ".join(parts) + "]"

    # 1-D out-of-bounds indicator inputs for copy-BC boundary terms,
    # registered on demand: ind[x_d] = 1 iff x_d + o leaves dim d.  The
    # union over dims factorizes through these per-dim masks, so the
    # position-dependent transpose of an edge-clamp read stays inside the
    # dialect (lower-rank inputs with input_dims).
    mask_inputs: Dict[str, Dict] = {}
    mask_dtype = dtype_to_str(max(
        (np.dtype(k.dtype) for k in program.kernels.values()),
        key=lambda d: d.itemsize))

    def oob_mask_name(d: int, o: int) -> str:
        name = f"oob_{'ijk'[d]}_{'m' if o < 0 else 'p'}{abs(o)}"
        if name not in mask_inputs:
            D = program.dimensions[d]
            data = [1.0 if (x + o < 0 or x + o >= D) else 0.0
                    for x in range(D)]
            mask_inputs[name] = {"data": data, "data_type": mask_dtype,
                                 "input_dims": ["ijk"[d]]}
        return name

    def oob_expr(offsets) -> str:
        """Indicator that the forward read at +offsets left the domain."""
        factors = [f"{oob_mask_name(d, o)}[{'ijk'[d]}]"
                   for d, o in enumerate(offsets) if o]
        if len(factors) == 1:
            return factors[0]
        return "(1.0 - " + " * ".join(f"(1.0 - {m})"
                                      for m in factors) + ")"

    # per field: terms contributed by each consumer's adjoint
    def consumer_terms(f: str):
        terms = []
        reads = set()
        for c in analysis.graph.consumers(f):
            if c not in program.kernels or c not in live:
                continue
            src = (cot[c] if (c in cot and
                              not any(k in program.kernels and k in live
                                      for k in
                                      analysis.graph.consumers(c)))
                   else adj_name(c))
            bc = program.kernels[c].boundary_conditions.get(f)
            for key, w in coeffs[c].items():
                if key == ("const",) or key[0] != f or w == 0.0:
                    continue
                terms.append(f"{w!r} * {src}{idx(key[1])}")
                reads.add(src)
                # transpose of a copy-BC (edge-clamp-to-center) read: the
                # OOB positions scattered their weight onto their own
                # center, so the adjoint adds w * oob_o(x) * cot[x]
                if bc is not None and bc.kind == ir.BCKind.COPY and \
                        any(o for o in key[1] if o):
                    offs = tuple(o or 0 for o in key[1])
                    terms.append(
                        f"{w!r} * {oob_expr(offs)} * {src}[i, j, k]")
        return terms, reads

    kernels: Dict[str, Dict] = {}
    # adjoints of intermediate kernels (reverse topological order)
    for kname in reversed(order):
        if kname not in live:
            continue   # dead kernel: cotangent identically zero
        consumed = any(c in program.kernels and c in live
                       for c in analysis.graph.consumers(kname))
        if not consumed:
            continue   # pure output: its adjoint IS the cotangent input
        terms, reads = consumer_terms(kname)
        if kname in cot:   # output consumed by later kernels too
            terms = [f"{cot[kname]}[i, j, k]"] + terms
            reads.add(cot[kname])
        dtype = program.kernels[kname].dtype
        kernels[adj_name(kname)] = {
            "computation_string":
                # all-zero coefficients leave no terms: the adjoint is 0
                f"{adj_name(kname)} = " + (" + ".join(terms) or "0.0"),
            "boundary_conditions": {
                r: {"type": "constant", "value": 0.0} for r in reads},
            "data_type": dtype_to_str(dtype),
        }
    # adjoints of the wrt inputs
    for n in wrt:
        terms, reads = consumer_terms(n)
        dtype = program.inputs[n].dtype
        kernels[adj_name(n)] = {
            "computation_string":
                # unread or zero-coefficient input: the gradient is 0
                f"{adj_name(n)} = " + (" + ".join(terms) or "0.0"),
            "boundary_conditions": {
                r: {"type": "constant", "value": 0.0} for r in reads},
            "data_type": dtype_to_str(np.dtype(dtype)),
        }

    spec = {
        "inputs": {
            **{cot[o]: {"data": "constant:1.0",
                        "data_type": dtype_to_str(
                            program.kernels[o].dtype)}
               for o in program.outputs},
            **mask_inputs,
        },
        "outputs": [adj_name(n) for n in wrt],
        # padded 3-D dims: the adjoint strings use full [i, j, k] indices
        "dimensions": list(program.dimensions),
        "program": kernels,
    }
    if program.vectorization > 1:
        spec["vectorization"] = program.vectorization
    from .frontend.parser import parse_program
    return (parse_program(spec, name=f"{program.name}_adjoint"),
            dict(cot))

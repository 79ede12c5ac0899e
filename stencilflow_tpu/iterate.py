"""Iterative solver driver: time-step a stencil chain with checkpoints.

The reference has no iterative state (each run is one pass of the chain;
deep time-stepping is expressed by unrolling, e.g. jacobi3d_*_8itr).  For
production solvers this module provides the missing driver:

* ``make_step`` compiles one chain evaluation (single- or multi-device,
  or out of core) into a state-update ``{field: arr} -> {field: arr}``
  by feeding designated outputs back into inputs;
* ``iterate`` runs N steps with the loop ON DEVICE (``lax.fori_loop`` over
  chunks — no per-step dispatch), periodically checkpointing state to
  ``.npz`` files and resuming from the latest checkpoint after a failure —
  the checkpoint/resume subsystem the reference lacks (SURVEY.md §5).

Multi-device: pass a ``mesh`` + ``dim_axes``; the step is the shard_map
domain-decomposed evaluation (one cumulative-halo exchange per step) and
state stays device-resident and sharded between steps.
"""
from __future__ import annotations

import glob
import os
import re
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np

from . import ir
from .frontend.analysis import ChainAnalysis


class IterateError(ValueError):
    pass


def _default_feed(program: ir.Program) -> Dict[str, str]:
    """Map the unique full-domain input to the unique output (only
    full-domain inputs are feedable; lower-rank coefficient arrays and
    scalars are carried unchanged)."""
    raw = tuple(program.raw_dimensions)
    feedable = [
        n for n, s in program.inputs.items()
        if not s.is_scalar and tuple(s.shape(program.dimensions)) == raw
    ]
    if len(feedable) == 1 and len(program.outputs) == 1:
        return {feedable[0]: program.outputs[0]}
    raise IterateError(
        "ambiguous feedback: pass feed={input_name: output_name}")


def compose_iterations(program: ir.Program, n: int,
                       feed: Optional[Dict[str, str]] = None
                       ) -> ir.Program:
    """Fuse ``n`` time steps of a chain into one deeper chain program.

    Iteration ``t``'s kernels are cloned as ``<name>__it<t>`` with fed
    inputs rewired to the previous iteration's outputs; the final
    iteration's outputs keep their original names, so the fused program
    has the same external interface (inputs, outputs, BCs) as applying
    the original ``n`` times.  This is how the reference's ``*_8itr``
    fixtures are written by hand — fusing multiplies arithmetic
    intensity by ``n``, turning HBM-bound shallow stencils compute-bound
    (one input read + one output write for the whole fused step).
    """
    import dataclasses as dc
    if n < 1:
        raise IterateError("compose_iterations needs n >= 1")
    feed = feed or _default_feed(program)
    for iname, oname in feed.items():
        if iname not in program.inputs or oname not in program.outputs:
            raise IterateError(f"bad feed entry {iname!r} <- {oname!r}")
    if n == 1:
        return program

    def clone_name(k: str, t: int) -> str:
        if t == n - 1 and k in program.outputs:
            return k
        return f"{k}__it{t}"

    kernels: Dict[str, ir.KernelSpec] = {}
    for t in range(n):
        ren = {k: clone_name(k, t) for k in program.kernels}
        if t > 0:
            for iname, oname in feed.items():
                ren[iname] = clone_name(oname, t - 1)
        for k, spec in program.kernels.items():
            stmts = [dc.replace(s, rhs=ir.rename_fields(s.rhs, ren))
                     for s in spec.statements]
            bcs = {ren.get(f, f): bc
                   for f, bc in spec.boundary_conditions.items()}
            name = clone_name(k, t)
            kernels[name] = dc.replace(spec, name=name, statements=stmts,
                                       boundary_conditions=bcs)
    # prune clones not reachable from the final outputs: subtrees feeding
    # only non-fed outputs of intermediate iterations are dead (their
    # results are superseded, never emitted)
    live = set(program.outputs)
    frontier = list(program.outputs)
    while frontier:
        k = frontier.pop()
        if k not in kernels:
            continue
        for f in kernels[k].accesses():
            if f not in live:
                live.add(f)
                frontier.append(f)
    kernels = {k: v for k, v in kernels.items() if k in live}
    return dc.replace(program, name=f"{program.name}_x{n}",
                      kernels=kernels)


def make_step(program: ir.Program,
              feed: Optional[Dict[str, str]] = None,
              mesh=None, dim_axes: Optional[Sequence] = None,
              analysis: Optional[ChainAnalysis] = None,
              host_chunks: int = 0
              ) -> Tuple[Callable, Dict[str, str]]:
    """Compile one time step.  Returns ``(step, feed)`` where
    ``step(state_dict) -> state_dict`` carries every program input; fed
    inputs are replaced by the designated outputs each call.

    ``host_chunks`` > 1 builds a *host-level* step: state stays in host
    numpy/memmap arrays and each step streams the domain through the
    device in i-chunks (outofcore.py) — time-stepping domains larger
    than HBM.  Combine with ``fuse`` (via ``iterate``) to amortize the
    host<->device traffic over several time steps per pass."""
    feed = feed or _default_feed(program)
    for iname, oname in feed.items():
        if iname not in program.inputs or oname not in program.outputs:
            raise IterateError(f"bad feed entry {iname!r} <- {oname!r}")
        spec = program.inputs[iname]
        in_shape = spec.shape(program.dimensions)
        if tuple(in_shape) != tuple(program.raw_dimensions):
            raise IterateError(
                f"fed input {iname!r} must span the full domain")

    analysis = analysis or ChainAnalysis.run(program)
    if host_chunks and host_chunks > 1:
        if mesh is not None:
            raise IterateError("host_chunks is incompatible with mesh")
        from .outofcore import compile_chunked_chain, run_chunked
        compiled = compile_chunked_chain(program, host_chunks, analysis)

        def step(state: Dict[str, Any]) -> Dict[str, Any]:
            out = run_chunked(program, state, host_chunks,
                              analysis=analysis, compiled=compiled)
            new_state = dict(state)
            for iname, oname in feed.items():
                new_state[iname] = out[oname]
            return new_state

        return step, feed
    if mesh is not None:
        if dim_axes is None:
            raise IterateError("mesh requires dim_axes, e.g. "
                               "(None, 'x', 'y')")
        from .parallel.domain import compile_sharded_chain
        fn, _plan = compile_sharded_chain(program, mesh, dim_axes,
                                          analysis)
    else:
        from .backend import compile_chain_best
        fn, _name = compile_chain_best(program, analysis)

    def step(state: Dict[str, Any]) -> Dict[str, Any]:
        out = fn(state)
        new_state = dict(state)
        for iname, oname in feed.items():
            new_state[iname] = out[oname]
        return new_state

    return step, feed


def _latest_checkpoint(ckpt_dir: str) -> Optional[Tuple[int, str]]:
    best = None
    for path in glob.glob(os.path.join(ckpt_dir, "step_*.npz")):
        m = re.search(r"step_(\d+)\.npz$", path)
        if m:
            k = int(m.group(1))
            if best is None or k > best[0]:
                best = (k, path)
    return best


def iterate(program: ir.Program, inputs: Dict[str, Any], steps: int,
            feed: Optional[Dict[str, str]] = None,
            mesh=None, dim_axes: Optional[Sequence] = None,
            chunk: int = 16,
            fuse: int = 1,
            host_chunks: int = 0,
            checkpoint_every: int = 0,
            checkpoint_dir: Optional[str] = None,
            checkpoint_format: str = "npz",
            resume: bool = True) -> Dict[str, np.ndarray]:
    """Run ``steps`` chain evaluations with output→input feedback.

    The loop runs on device in chunks (one dispatch per ``chunk`` steps);
    with ``checkpoint_every`` > 0, state is persisted to
    ``checkpoint_dir`` at that cadence and — when ``resume`` — execution
    continues from the newest checkpoint found.  ``checkpoint_format``:
    ``"npz"`` gathers state to one host file per checkpoint (atomic
    rename); ``"orbax"`` writes device-sharded checkpoints
    asynchronously (saves overlap the next chunk's compute; sharded
    state never gathers to one host) — the production choice for
    mesh-sharded runs.

    ``fuse`` > 1 composes that many time steps into one deeper chain
    (``compose_iterations``) before compiling — HBM-bound shallow
    stencils become compute-bound, one input read + one output write per
    ``fuse`` steps.  ``steps`` and ``checkpoint_every`` keep their
    original-step units and must be multiples of ``fuse``.
    """
    import jax
    import jax.numpy as jnp
    from jax import lax

    if fuse < 1:
        raise IterateError(f"fuse must be >= 1, got {fuse}")
    if chunk < 1:
        raise IterateError(f"chunk must be >= 1, got {chunk}")
    scale = fuse
    if scale > 1:
        if steps % scale:
            raise IterateError(f"steps ({steps}) must be a multiple of "
                               f"fuse ({scale})")
        if checkpoint_every and checkpoint_every % scale:
            raise IterateError("checkpoint_every must be a multiple of "
                               "fuse")
        feed = feed or _default_feed(program)
        program = compose_iterations(program, scale, feed)
    steps_f = steps // scale
    ckpt_f = checkpoint_every // scale if checkpoint_every else 0

    analysis = ChainAnalysis.run(program)
    host_mode = bool(host_chunks and host_chunks > 1)
    step, feed = make_step(program, feed, mesh, dim_axes, analysis,
                           host_chunks=host_chunks)

    start = 0
    shardings: Dict[str, Any] = {}
    if mesh is not None:
        from .parallel.domain import DomainDecomposition
        dplan = DomainDecomposition.plan(program, mesh, dim_axes, analysis)
        shardings = dplan.input_shardings()

    def place(k, v):
        if host_mode:
            return np.asarray(v) if getattr(v, "ndim", 0) > 0 else v
        v = jnp.asarray(v)
        return jax.device_put(v, shardings[k]) if k in shardings else v

    state = {k: place(k, v) for k, v in inputs.items()}
    manager = None
    if ckpt_f > 0:
        if not checkpoint_dir:
            raise IterateError("checkpoint_every requires checkpoint_dir")
        if checkpoint_format not in ("npz", "orbax"):
            raise IterateError(
                f"unknown checkpoint_format: {checkpoint_format!r}")
        os.makedirs(checkpoint_dir, exist_ok=True)
        if checkpoint_format == "orbax":
            try:
                import orbax.checkpoint as ocp
            except ImportError as exc:
                raise IterateError(
                    "checkpoint_format='orbax' needs the orbax-checkpoint "
                    "package, which is not installed; use 'npz'") from exc
            manager = ocp.CheckpointManager(
                os.path.abspath(checkpoint_dir),
                options=ocp.CheckpointManagerOptions(
                    enable_async_checkpointing=True))
        if resume:
            if manager is not None:
                latest = manager.latest_step()
                latest = (latest, f"step {latest}") \
                    if latest is not None else None
            else:
                latest = _latest_checkpoint(checkpoint_dir)
            if latest is not None:
                start_orig, path = latest
                if start_orig > steps:
                    raise IterateError(
                        f"checkpoint {path} is at step {start_orig}, "
                        f"beyond the requested {steps}; pass resume=False "
                        "or a fresh checkpoint_dir")
                if start_orig % scale:
                    raise IterateError(
                        f"checkpoint {path} at step {start_orig} does not "
                        f"align with fuse={scale}")
                start = start_orig // scale
                if manager is not None:
                    state = manager.restore(
                        start_orig, args=ocp.args.StandardRestore(state))
                else:
                    data = np.load(path)
                    state = {k: place(k, data[k]) for k in state}
        # checkpoints must land on chunk boundaries
        chunk = min(chunk, ckpt_f)

    if host_mode:
        # state lives on host: plain Python loop, one chunked device
        # sweep per (fused) step
        def run_chunk(state, n):
            for _ in range(int(n)):
                state = step(state)
            return state
    else:
        @jax.jit
        def run_chunk(state, n):
            # two steps per fori iteration, an odd remainder under a cond
            # (whether the unroll still saves a carry copy on the GPU is
            # not measured)
            state = lax.fori_loop(0, n // 2,
                                  lambda _i, s: step(step(s)), state)
            return lax.cond(n % 2 == 1, step, lambda s: s, state)

    done = start
    try:
        while done < steps_f:
            n = min(chunk, steps_f - done)
            if ckpt_f > 0:
                n = min(n, ckpt_f - done % ckpt_f or ckpt_f)
            state = run_chunk(state, n)
            done += n
            if ckpt_f > 0 and (done % ckpt_f == 0 or done >= steps_f):
                if manager is not None:
                    # async: the save overlaps the next chunk's compute;
                    # orbax finalizes atomically per step directory
                    manager.save(done * scale,
                                 args=ocp.args.StandardSave(state))
                else:
                    jax.block_until_ready(state)
                    final = os.path.join(checkpoint_dir,
                                         f"step_{done * scale}.npz")
                    tmp = final + ".tmp.npz"
                    np.savez(tmp, **{k: np.asarray(v)
                                     for k, v in state.items()})
                    os.replace(tmp, final)  # atomic: a crash never
                    #               corrupts the newest resumable one
    finally:
        if manager is not None:
            # finalize pending async saves even when the loop raises, so
            # the newest checkpoint directory is complete and resumable
            manager.wait_until_finished()
            manager.close()

    return {k: np.asarray(v) for k, v in state.items()}

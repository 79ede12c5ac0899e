"""End-to-end driver: parse → analyze → (simulate) → compile → execute →
verify → save.

Parity with the reference's orchestration
(/root/reference/stencilflow/run_program.py:19-250): same flags and flow.
Both modes run the same fused-XLA program: ``emulation`` on JAX's default
device (the CPU under ``JAX_PLATFORMS=cpu``), ``hardware`` on the GPU and
fails when there is none — neither falls back to the other.
``compare_to_reference`` checks
against the whole-domain interpreter oracle (the CPU reference SDFG's role),
``run_simulation`` cross-checks the cycle-accurate dataflow simulator, both
under the halo-pruned relative-tolerance discipline
(run_program.py:203-250, helper.py:261-276).
"""
from __future__ import annotations

import dataclasses
import functools
import os
import time
from typing import Any, Dict, Optional

import numpy as np

from . import ir
from .config import VERIFY_RTOL
from .data import (arrays_are_equal, load_input_arrays, prune_halo,
                   save_output_arrays)
from .frontend.analysis import ChainAnalysis
from .frontend.parser import parse_program
from .interpreter import run_interpreter


class VerificationError(RuntimeError):
    pass


@dataclasses.dataclass
class RunResult:
    program: ir.Program
    outputs: Dict[str, np.ndarray]
    backend: str
    verified_against_reference: Optional[bool] = None
    verified_against_simulation: Optional[bool] = None
    simulation_cycles: Optional[int] = None
    wall_time_s: Optional[float] = None
    results_dir: Optional[str] = None
    analysis: Optional[ChainAnalysis] = None   # reusable by callers


def run_program(stencil_file, mode: str = "emulation",
                run_simulation: bool = False,
                compare_to_reference: bool = False,
                generate_input: bool = False,
                synthetic_reads: bool = False,
                input_directory: Optional[str] = None,
                skip_execution: bool = False,
                halo: int = 0,
                repetitions: int = 1,
                backend: str = "auto",
                host_chunks: int = 0,
                save_results: bool = True,
                results_base: str = "results",
                seed: int = 0,
                print_result: bool = False,
                log_level: int = 1,
                profile_dir: Optional[str] = None,
                raise_on_mismatch: bool = True,
                tolerance: Optional[float] = None) -> RunResult:
    """Run one stencil program end to end.  ``stencil_file`` may be a path,
    a JSON dict, or an already-parsed Program.  ``backend``: ``auto`` or
    ``xla`` (the fused-XLA chain) or ``interpreter`` (the numpy oracle
    itself).  ``tolerance`` overrides the relative verification tolerance
    (default: config.VERIFY_RTOL)."""
    if mode not in ("emulation", "hardware"):
        raise ValueError(f"unknown mode {mode!r} (emulation | hardware)")
    if mode == "hardware" and not skip_execution:
        from .device import require_gpu
        require_gpu()
    from .utils.log import LogLevel, log
    if isinstance(stencil_file, ir.Program):
        program = stencil_file
    else:
        program = parse_program(stencil_file)
    analysis = ChainAnalysis.run(program)
    log(LogLevel.BASIC, log_level,
        f"[{program.name}] {len(program.kernels)} kernels, "
        f"dims {list(program.raw_dimensions)}, "
        f"critical path {analysis.critical_path_cycles} cycles")
    if int(log_level) >= int(LogLevel.MODERATE):
        from .report import Report
        print(Report.build(program, analysis).full_dump())

    if generate_input or synthetic_reads:
        # generate_input: replace file-backed inputs with constant data
        # (reference: run_program.py:142-148); synthetic_reads: replace ALL
        # inputs for pure-compute benchmarking (sdfg_generator.py:284-385).
        # Rebind a modified copy — callers may pass an already-parsed
        # Program and reuse it afterwards
        import dataclasses as _dc
        new_inputs = dict(program.inputs)
        for name, spec in program.inputs.items():
            file_backed = (isinstance(spec.data, str) and
                           not spec.data.startswith(("constant:",
                                                     "random:")))
            if synthetic_reads or file_backed:
                new_inputs[name] = _dc.replace(spec, data="constant:1.0")
        program = _dc.replace(program, inputs=new_inputs)
    inputs = load_input_arrays(program, prefix=input_directory, seed=seed)

    sim_outputs = None
    sim_cycles = None
    if run_simulation:
        from .sim import simulate
        sim_res = simulate(program, inputs, analysis=analysis)
        sim_outputs = sim_res.outputs
        sim_cycles = sim_res.cycles

    result = RunResult(program=program, outputs={}, backend="none",
                       simulation_cycles=sim_cycles, analysis=analysis)

    if skip_execution:
        if sim_outputs is not None:
            result.outputs = sim_outputs
            result.backend = "simulator"
    else:
        import jax
        import jax.numpy as jnp
        # persistent compile cache — the analogue of the reference's
        # -use-cached-sdfg / .dacecache reuse (run_program.py:69-88)
        from .device import enable_compile_cache
        enable_compile_cache()
        if host_chunks and host_chunks > 1:
            # out-of-core: inputs stay host-resident, i-chunks stream
            # through one compiled kernel (outofcore.py)
            from .outofcore import compile_chunked_chain, run_chunked
            compiled = compile_chunked_chain(program, host_chunks, analysis)
            fn = functools.partial(run_chunked, program,
                                   chunks=host_chunks, analysis=analysis,
                                   compiled=compiled)
            bname = (f"outofcore[{compiled[1].backend}"
                     f" x{host_chunks} chunks]")
        elif backend in ("auto", "xla"):
            from .backend import compile_chain_best
            fn, bname = compile_chain_best(program, analysis)
        elif backend == "interpreter":
            fn, bname = (lambda xs: run_interpreter(program, xs),
                         "interpreter")
        else:
            raise ValueError(f"unknown backend: {backend}")

        if host_chunks and host_chunks > 1:
            dev_inputs = inputs   # host-resident by design
        else:
            dev_inputs = {k: jnp.asarray(v) if not np.isscalar(v) and
                          getattr(v, "ndim", 0) > 0 else v
                          for k, v in inputs.items()}
        # warm up: compile outside the timed region
        jax.block_until_ready(fn(dev_inputs))
        import contextlib
        ctx = contextlib.nullcontext()
        if profile_dir:
            ctx = jax.profiler.trace(profile_dir)
        with ctx:
            t0 = time.perf_counter()
            for _ in range(max(1, repetitions)):
                out = fn(dev_inputs)
            outputs = {k: np.asarray(v) for k, v in out.items()}
            result.wall_time_s = (time.perf_counter() - t0) \
                / max(1, repetitions)
        if profile_dir:
            print(f"profiler trace written to {profile_dir}/ "
                  "(view with TensorBoard or xprof)")
        result.outputs = outputs
        result.backend = bname

    if save_results and result.outputs:
        results_dir = os.path.join(results_base, program.name)
        save_output_arrays(result.outputs, results_dir)
        result.results_dir = results_dir

    # -- verification ---------------------------------------------------------
    raw = program.raw_dimensions

    verify_rtol = tolerance if tolerance is not None else VERIFY_RTOL

    def check(kind: str, expected: Dict[str, Any]) -> bool:
        ok = True
        for o in program.outputs:
            got = prune_halo(result.outputs[o], raw, halo)
            exp = prune_halo(np.asarray(expected[o]), raw, halo)
            if not arrays_are_equal(exp, got, verify_rtol):
                ok = False
                diff = np.max(np.abs(exp.astype(np.float64) -
                                     got.astype(np.float64)))
                msg = (f"{kind} mismatch on output '{o}' "
                       f"(max abs diff {diff:.3e}, halo={halo})")
                if raise_on_mismatch:
                    raise VerificationError(msg)
                print(msg)
        return ok

    if compare_to_reference and result.outputs:
        ref = run_interpreter(program, inputs)
        result.verified_against_reference = check("reference", ref)
    if sim_outputs is not None and result.outputs and not skip_execution:
        result.verified_against_simulation = check("simulation", sim_outputs)

    if print_result:
        for o, arr in result.outputs.items():
            print(f"{o} =\n{arr}")

    return result

#!/usr/bin/env python
"""Proof that the stencil chain runs on the GPU, checked against the oracle.

    python chip_smoke.py           # one card: phases 1-4
    python chip_smoke.py --four    # four cards: the multi-device paths only

Every phase prints one JSON line; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
Any failure raises, so the script exits non-zero and prints no ``ok``
line.  It exits non-zero on a machine whose JAX finds no GPU, and when the
repository is not beside it.  One process drives every card.

Phases (one card):
  1. device: platform check, the card's name and power limit from
     nvidia-smi (a child process that stays off JAX), the compile-cache
     directory;
  2. main path: jacobi3d 512^3 x 8 stages through
     ``driver.run_program(mode="hardware", compare_to_reference=True)``;
  3. every workload bench.py defines, at its GPU size, 8 stages each;
  4. the other user paths: iterate (fuse=8), the CG solver, the adjoint
     against autodiff, and the out-of-core driver run.

Tolerance: float32 chains are held to ``config.VERIFY_RTOL`` (1e-5,
relative, ``data.arrays_are_equal`` — the driver's own check).  XLA may
contract multiply-adds into FMAs (XLA:CPU does), so results can differ
from numpy in the last bits; the relative-only comparator then needs
outputs away from zero, so every workload's inputs are drawn from
``random:1,2``.  Each phase prints its worst relative error.  The CG
solve must reach a true relative residual of at most 10x its stopping
tolerance (the recurrence residual and the true one part in float32).
"""
import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402

STAGES = 8
SEED_DATA = "random:1,2"
TIMED_CALLS = 5
CG_TOL = 1e-6


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def require(cond, what):
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def workloads():
    """bench.py's five workloads at their GPU sizes, 8 stages each."""
    from stencilflow_tpu.synthesize import synthesize_stencil

    def spec(shape, dims, **kw):
        return synthesize_stencil(num_stages=STAGES, dimensions=dims,
                                  shape=shape, seed_data=SEED_DATA, **kw)
    return {
        "jacobi3d_512": spec("diffusion", (512,) * 3),
        "jacobi2d_8192": spec("diffusion", (8192,) * 2),
        "box_r2_128": spec("box", (128,) * 3, extent=2),
        "hotspot_256": spec("hotspot", (256,) * 3),
        "hdiff_256": spec("hdiff", (256,) * 3),
    }


def peak_bytes(device):
    return int(device.memory_stats()["peak_bytes_in_use"])


def time_calls(fn, args):
    """Compile seconds and seconds per call (TIMED_CALLS calls after a
    warm-up, ending in block_until_ready)."""
    import jax
    t0 = time.perf_counter()
    compiled = fn.lower(*args).compile()
    compile_s = time.perf_counter() - t0
    jax.block_until_ready(compiled(*args))
    t0 = time.perf_counter()
    for _ in range(TIMED_CALLS):
        out = compiled(*args)
    jax.block_until_ready(out)
    return compile_s, (time.perf_counter() - t0) / TIMED_CALLS, out


def worst_error(program, ref, got):
    from stencilflow_tpu.data import max_relative_error
    return max(max_relative_error(ref[o], np.asarray(got[o]))
               for o in program.outputs)


def run_workload(name, program, device):
    """Compile, time and check one program on the fused-XLA path."""
    import jax.numpy as jnp

    import stencilflow_tpu as sft
    from stencilflow_tpu.backend import compile_chain_best
    from stencilflow_tpu.config import VERIFY_RTOL

    fn, backend = compile_chain_best(program)
    require(backend == "xla", f"{name}: backend {backend}")
    inputs = sft.load_input_arrays(program, seed=0)
    dev_in = {k: jnp.asarray(v) for k, v in inputs.items()}
    compile_s, per_call, out = time_calls(fn, (dev_in,))
    ref = sft.run_interpreter(program, inputs)
    err = worst_error(program, ref, out)
    emit("workload", name=name, backend=backend,
         dims=list(program.raw_dimensions), stages=len(program.kernels),
         compile_s=compile_s, s_per_application=per_call,
         peak_bytes_in_use=peak_bytes(device), max_rel_err=err,
         rtol=VERIFY_RTOL)
    require(err <= VERIFY_RTOL, f"{name}: relative error {err:.3e}")
    return inputs, ref


def phase_device(count):
    import jax

    from stencilflow_tpu.device import enable_compile_cache, require_gpu
    info = require_gpu()
    require(info.count == count,
            f"{count} GPU(s) expected, JAX sees {info.count}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    for line in smi.splitlines():
        print(line, flush=True)
    cache = enable_compile_cache()
    emit("device", platform=info.platform, kind=info.kind,
         count=info.count, nvidia_smi=smi.splitlines(),
         compile_cache=cache, jax=jax.__version__)
    return info


def phase_main_path(device):
    import stencilflow_tpu as sft
    from stencilflow_tpu.driver import run_program

    spec = workloads()["jacobi3d_512"]
    program = sft.parse_program(spec, name="jacobi3d_512_8itr")
    t0 = time.perf_counter()
    res = run_program(program, mode="hardware", compare_to_reference=True,
                      save_results=False, log_level=0)
    run_s = time.perf_counter() - t0
    require(res.backend == "xla", f"main path backend {res.backend}")
    require(res.verified_against_reference, "main path vs oracle")
    emit("main_path", backend=res.backend, run_program_s=run_s,
         verified_against_reference=res.verified_against_reference)
    # the same program timed and its worst error printed (and reused as
    # phase 3's jacobi3d cell)
    return run_workload("jacobi3d_512", program, device)


def phase_other_paths(device, flagship_inputs, flagship_ref):
    import jax.numpy as jnp

    import stencilflow_tpu as sft
    from stencilflow_tpu.config import VERIFY_RTOL
    from stencilflow_tpu.data import arrays_are_equal, max_relative_error
    from stencilflow_tpu.driver import run_program
    from stencilflow_tpu.synthesize import synthesize_stencil

    # iterate: 16 steps of a one-stage jacobi, fused 8 per compiled chain,
    # against the 16-stage unrolled chain's oracle
    one = sft.parse_program(synthesize_stencil(
        num_stages=1, dimensions=(256,) * 3, shape="diffusion",
        seed_data=SEED_DATA), name="jacobi3d_256_step")
    unrolled = sft.parse_program(synthesize_stencil(
        num_stages=16, dimensions=(256,) * 3, shape="diffusion",
        seed_data=SEED_DATA), name="jacobi3d_256_16itr")
    inputs = sft.load_input_arrays(one, seed=0)
    t0 = time.perf_counter()
    state = sft.iterate(one, inputs, steps=16, fuse=8)
    it_s = time.perf_counter() - t0
    ref = np.asarray(sft.run_interpreter(unrolled, inputs)["s15"])
    err = max_relative_error(ref, state["a"])
    emit("iterate", steps=16, fuse=8, dims=[256] * 3, seconds=it_s,
         peak_bytes_in_use=peak_bytes(device), max_rel_err=err,
         rtol=VERIFY_RTOL)
    require(err <= VERIFY_RTOL, f"iterate: relative error {err:.3e}")

    # CG on examples/implicit_diffusion.py's backward-Euler operator
    n, dt = 96, 10.0
    implicit = sft.parse_program({
        "inputs": {"x": {"data": "constant:0.0", "data_type": "float32"}},
        "outputs": ["y"], "dimensions": [n, n],
        "program": {"y": {
            "computation_string":
                f"y = x[j, k] - {dt} * (x[j-1, k] + x[j+1, k] + "
                f"x[j, k-1] + x[j, k+1] - 4.0 * x[j, k])",
            "boundary_conditions": {
                "x": {"type": "constant", "value": 0.0}},
            "data_type": "float32"}}}, name="be_diffusion")
    rhs = np.random.default_rng(0).random((n, n)).astype(np.float32)
    t0 = time.perf_counter()
    solver = sft.make_solver(implicit, tol=CG_TOL, maxiter=1000)
    x, info = solver(rhs)
    cg_s = time.perf_counter() - t0
    y = np.asarray(sft.run_interpreter(implicit, {"x": np.asarray(x)})["y"],
                   np.float64)
    oracle_res = float(np.linalg.norm(y - rhs) / np.linalg.norm(rhs))
    emit("solve_cg", dims=[n, n], tol=CG_TOL, iterations=info["iterations"],
         true_residual=info["residual"], oracle_residual=oracle_res,
         seconds=cg_s)
    require(info["iterations"] < 1000, "CG did not converge")
    require(info["residual"] <= 10 * CG_TOL and oracle_res <= 10 * CG_TOL,
            f"CG residual {info['residual']:.2e} / {oracle_res:.2e}")

    # adjoint chain against autodiff through the fused chain
    p = sft.parse_program(synthesize_stencil(
        num_stages=STAGES, dimensions=(256,) * 3, shape="diffusion",
        seed_data=SEED_DATA), name="jacobi3d_256_8itr")
    dev_in = {k: jnp.asarray(v)
              for k, v in sft.load_input_arrays(p, seed=0).items()}
    t0 = time.perf_counter()
    v_ad, g_ad = sft.value_and_grad(p)(dev_in)
    g_ad = np.asarray(g_ad["a"])
    ad_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    v_fast, g_fast = sft.fast_value_and_grad(p)(dev_in)
    g_fast = np.asarray(g_fast["a"])
    fast_s = time.perf_counter() - t0
    err = max_relative_error(g_ad, g_fast)
    verr = max_relative_error(float(v_ad), float(v_fast))
    emit("adjoint", dims=[256] * 3, stages=STAGES,
         value_and_grad_s=ad_s, fast_value_and_grad_s=fast_s,
         max_rel_err_grad=err, rel_err_value=verr,
         peak_bytes_in_use=peak_bytes(device), rtol=VERIFY_RTOL)
    require(err <= VERIFY_RTOL and verr <= VERIFY_RTOL,
            f"adjoint vs autodiff: {err:.3e} / {verr:.3e}")

    # out of core: the flagship through 4 host chunks
    spec = workloads()["jacobi3d_512"]
    program = sft.parse_program(spec, name="jacobi3d_512_8itr")
    t0 = time.perf_counter()
    res = run_program(program, mode="hardware", host_chunks=4,
                      compare_to_reference=True, save_results=False,
                      log_level=0)
    oc_s = time.perf_counter() - t0
    out = program.outputs[0]
    err = max_relative_error(flagship_ref[out], res.outputs[out])
    emit("outofcore", backend=res.backend, chunks=4,
         run_program_s=oc_s, s_per_run=res.wall_time_s,
         verified_against_reference=res.verified_against_reference,
         max_rel_err=err, peak_bytes_in_use=peak_bytes(device))
    require(res.verified_against_reference and
            arrays_are_equal(flagship_ref[out], res.outputs[out]),
            "out-of-core vs oracle")


def phase_four(devices):
    """The multi-device paths on four cards: domain decomposition over a
    2x2 mesh and a 4-way i split (each with and without comm_overlap) and
    the 4-segment pipeline.  The cards are joined all to all by NVLink, so
    the meshes follow the algorithm, not a wiring topology."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    import stencilflow_tpu as sft
    from stencilflow_tpu.backend import compile_chain
    from stencilflow_tpu.config import VERIFY_RTOL
    from stencilflow_tpu.data import max_relative_error
    from stencilflow_tpu.parallel.domain import (compile_sharded_chain,
                                                 place_global_inputs)
    from stencilflow_tpu.parallel.pipeline import compile_pipeline_split

    program = sft.parse_program(workloads()["jacobi3d_512"],
                                name="jacobi3d_512_8itr")
    out = program.outputs[0]
    inputs = sft.load_input_arrays(program, seed=0)
    ref = np.asarray(sft.run_interpreter(program, inputs)[out])
    single_in = {k: jax.device_put(jnp.asarray(v), devices[0])
                 for k, v in inputs.items()}
    compile_s, per_call, got = time_calls(compile_chain(program),
                                          (single_in,))
    single = np.asarray(got[out])
    err = max_relative_error(ref, single)
    emit("single_card", compile_s=compile_s, s_per_application=per_call,
         max_rel_err=err)
    require(err <= VERIFY_RTOL, f"single card: {err:.3e}")
    del single_in, got

    legs = []
    mesh2 = Mesh(np.array(devices).reshape(2, 2), ("x", "y"))
    mesh1 = Mesh(np.array(devices), ("x",))
    for label, mesh, axes in (("domain_2x2_jk", mesh2, (None, "x", "y")),
                              ("domain_4_i", mesh1, ("x", None, None))):
        for overlap in (False, True):
            fn, plan = compile_sharded_chain(program, mesh, axes,
                                             comm_overlap=overlap)
            legs.append((f"{label}{'_overlap' if overlap else ''}", fn,
                         place_global_inputs(program, plan, inputs)))
    pmesh = Mesh(np.array(devices), ("p",))
    fn, _plan = compile_pipeline_split(program, pmesh, "p")
    legs.append(("pipeline_4", fn, {k: jnp.asarray(v)
                                    for k, v in inputs.items()}))
    for label, fn, args in legs:
        compile_s, per_call, got = time_calls(fn, (args,))
        got = np.asarray(got[out])
        err = max_relative_error(ref, got)
        vs_single = max_relative_error(single, got)
        emit("multi_card", path=label, compile_s=compile_s,
             s_per_application=per_call, max_rel_err=err,
             max_rel_err_vs_single=vs_single,
             peak_bytes_in_use=[peak_bytes(d) for d in devices])
        require(err <= VERIFY_RTOL and vs_single <= VERIFY_RTOL,
                f"{label}: {err:.3e} vs oracle, {vs_single:.3e} vs single")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the multi-device paths, on four cards")
    args = ap.parse_args()

    import jax
    count = 4 if args.four else 1
    info = phase_device(count)
    devices = jax.devices()
    if args.four:
        phase_four(devices)
    else:
        import stencilflow_tpu as sft
        inputs, ref = phase_main_path(devices[0])
        for name, spec in workloads().items():
            if name != "jacobi3d_512":
                run_workload(name, sft.parse_program(spec, name=name),
                             devices[0])
        phase_other_paths(devices[0], inputs, ref)
    print(json.dumps({"ok": True, "device": {
        "platform": info.platform, "kind": info.kind,
        "count": info.count}}), flush=True)


if __name__ == "__main__":
    main()

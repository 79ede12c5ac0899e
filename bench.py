#!/usr/bin/env python
"""Headline benchmark: one stencil workload, GCell/s on one GPU.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "GCell/s", "vs_baseline": N, ...}

``vs_baseline`` is the fraction of the device's analytic roofline achieved:
the larger of the memory floor (every input + output moved once, the
reference's minimum-communication-volume model,
/root/reference/stencilflow/kernel_chain_graph.py:749-768) and the compute
floor (op count at the float32 rate), both at the running device's
published peaks (``device.PEAKS``; an unknown device is an error).  The
record names the platform, device kind and device count it ran on.

Timing: the chain is applied in a data-dependent on-device loop (output
feeds input) and two loop lengths are differenced, cancelling dispatch and
transfer overheads.  Exits non-zero when JAX finds no GPU.
"""
import argparse
import json
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=None,
                    help="domain edge (defaults: jacobi 512, jacobi2d "
                         "8192, box 128, hotspot 256, hdiff 256)")
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--backend", default="auto", choices=["auto", "xla"],
                    help="both: the fused-XLA chain")
    ap.add_argument("--sessions", type=int, default=3,
                    help="measurement sessions: repeat the whole"
                         " differenced-loop protocol N times and report"
                         " the MEDIAN with the observed spread")
    ap.add_argument("--session-gap", type=float, default=0.0,
                    help="seconds to sleep between sessions")
    ap.add_argument("--append-log", default=None,
                    help="append the JSON record (plus a timestamp) to"
                         " this file")
    ap.add_argument("--workload", default="jacobi",
                    choices=["jacobi", "jacobi2d", "box", "hotspot",
                             "hdiff"],
                    help="jacobi: headline 6-point chain; jacobi2d: the"
                         " reference's canonical 2-D workload at large"
                         " size; box: wide-footprint radius-2 chain;"
                         " hotspot: the reference's Hotspot3D synthetic"
                         " (scalar coefficients, mixed-rank inputs);"
                         " hdiff: COSMO-style horizontal diffusion"
                         " (flux-limited, forks/joins/ternaries)")
    args = ap.parse_args()

    import jax
    from stencilflow_tpu.device import (enable_compile_cache, peaks_for,
                                        require_gpu)

    info = require_gpu()
    peaks = peaks_for(info.kind)
    enable_compile_cache()

    import stencilflow_tpu as sft
    from stencilflow_tpu.backend import compile_chain_best
    from stencilflow_tpu.report import Report
    from stencilflow_tpu.synthesize import jacobi, synthesize_stencil

    if args.workload == "jacobi2d":
        size = args.size or 8192
        spec = jacobi(2, size, iterations=args.iters)
    elif args.workload == "jacobi":
        size = args.size or 512
        spec = jacobi(3, size, iterations=args.iters)
    else:
        size = args.size or {"box": 128, "hotspot": 256,
                             "hdiff": 256}[args.workload]
        extra = {"extent": 2} if args.workload == "box" else {}
        spec = synthesize_stencil(num_stages=args.iters,
                                  dimensions=(size,) * 3,
                                  shape=args.workload, **extra)
    tag = (args.workload if args.workload.endswith("2d")
           else f"{args.workload}3d")
    program = sft.parse_program(spec,
                                name=f"{tag}_{size}_{args.iters}itr")
    fn, backend = compile_chain_best(program)

    inputs = sft.load_input_arrays(program, seed=0)
    in_name = next(iter(program.inputs))
    out_name = program.outputs[0]
    a = jax.numpy.asarray(inputs[in_name])
    rest = {k: jax.numpy.asarray(v) for k, v in inputs.items()
            if k != in_name}

    # two chain applications per loop iteration (the second output can
    # take the freed carry buffer; whether that matters on the GPU is not
    # measured)
    @jax.jit
    def loop(r):
        def body(_, x):
            y = fn({in_name: x, **rest})[out_name]
            return fn({in_name: y, **rest})[out_name]
        return jax.lax.fori_loop(0, r, body, a).sum()

    def timed(reps: int, trials: int) -> float:
        np.asarray(loop(reps))  # warm up (compile shared across reps)
        best = float("inf")
        for _ in range(trials):
            t0 = time.perf_counter()
            np.asarray(loop(reps))
            best = min(best, time.perf_counter() - t0)
        return best

    # loop lengths scale inversely with domain size so the differenced
    # on-device time stays well above dispatch jitter
    cells = float(np.prod(program.dimensions))
    big = int(min(1920, max(15, round(15 * (512**3 / cells)))))
    small, trials = max(3, big // 5), 5

    dts = []
    for s in range(args.sessions):
        if s and args.session_gap:
            time.sleep(args.session_gap)
        dts.append((timed(big, trials) - timed(small, trials))
                   / (2 * (big - small)))
    dt = float(np.median(dts))
    gcell_s = cells / dt / 1e9

    report = Report.build(program, hw=peaks)
    rank = len(program.raw_dimensions)
    record = {
        "metric": f"{tag}_{size}^{rank}_{args.iters}itr_{backend}_"
                  f"{info.platform}_vs_{report.bound()}",
        "value": round(gcell_s, 3),
        "unit": "GCell/s",
        "vs_baseline": round(report.roofline_time_s() / dt, 4),
        "bounds": {k: round(v, 4)
                   for k, v in report.bound_fractions(dt).items()},
        "device": {"platform": info.platform, "kind": info.kind,
                   "count": info.count},
    }
    if args.sessions > 1:
        vals = sorted(cells / d / 1e9 for d in dts)
        record["sessions"] = args.sessions
        record["session_values"] = [round(v, 3) for v in vals]
        record["spread_pct"] = round(
            100.0 * (vals[-1] - vals[0]) / gcell_s, 1)
    print(json.dumps(record))
    if args.append_log:
        record["ts"] = time.strftime("%Y-%m-%dT%H:%M:%S")
        with open(args.append_log, "a") as f:
            f.write(json.dumps(record) + "\n")


if __name__ == "__main__":
    main()

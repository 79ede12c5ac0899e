#!/usr/bin/env python
"""End-to-end walkthrough of the framework's surfaces.

Run with JAX_PLATFORMS=cpu for a hardware-free demo, or on a GPU host.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import stencilflow_tpu as sft
from stencilflow_tpu.backend import compile_chain_best
from stencilflow_tpu.optimizer import Optimizer
from stencilflow_tpu.report import Report
from stencilflow_tpu.sim import simulate

HERE = os.path.dirname(os.path.abspath(__file__))


def main():
    # 1. parse a program from the JSON dialect
    program = sft.parse_program(
        os.path.join(HERE, "jacobi3d_32x32x32_8itr.json"))
    inputs = sft.load_input_arrays(program, seed=0)

    # 2. static analysis + analytic report
    print(Report.build(program), "\n")

    # 3. the whole-domain oracle
    oracle = sft.run_interpreter(program, inputs)

    # 4. cycle-accurate dataflow simulation (C++ core), proving buffer sizes
    res = simulate(program, inputs)
    out_name = program.outputs[0]
    assert np.array_equal(res.outputs[out_name], np.asarray(oracle[out_name]))
    print(f"simulated {res.cycles} cycles for {program.total_elements} "
          "elements; buffer bounds held\n")

    # 5. the compiled path: the whole chain as one fused XLA program
    fn, backend = compile_chain_best(program)
    out = fn(inputs)
    err = np.abs(np.asarray(out[out_name]) -
                 np.asarray(oracle[out_name])).max()
    print(f"backend '{backend}': max abs error vs oracle = {err}\n")

    # 6. fast/slow memory placement of the stream buffers
    opt = Optimizer(program)
    opt.optimize_to_ratio(1.0)
    print(opt.summary())

    # 7. the traced-Python frontend
    def model(a):
        b = 0.25 * (a[0, -1, 0] + a[0, 1, 0] + a[0, 0, -1] + a[0, 0, 1])
        return {"b": b}

    traced = sft.trace_program(model, dimensions=(64, 64),
                               inputs={"a": np.float32}, name="traced_demo")
    print(f"\ntraced program: kernels={list(traced.kernels)}")

    # 8. projected multi-device scaling (halo exchange vs compute, at the
    #    published H100 peaks)
    s = Report.build(program).mesh_scaling({"x": 2, "y": 2})
    print(f"\n2x2 mesh: {s['scaled_gcell_s']:.1f} GCell/s projected, "
          f"efficiency {s['parallel_efficiency']:.2f} "
          f"(exchange {s['link_bytes_per_device']/2**10:.0f} KiB/device/step)")

    # 9. time-stepping with temporal fusion (iterate.py; add
    #    checkpoint_every/checkpoint_dir for crash-resumable runs)
    state = sft.iterate(program, inputs, steps=8, fuse=4)
    total = float(np.asarray(state["a"]).sum())
    print(f"iterated 8 steps (fuse=4): state sum={total:.3f}")

    # 10. adjoints: gradient of a loss on the outputs w.r.t. any input
    val, grads = sft.value_and_grad(program)(
        {k: np.asarray(v) for k, v in inputs.items()})
    print(f"d(sum outputs)/d a: interior value "
          f"{float(np.asarray(grads['a'])[16, 16, 16]):.3f} (exact 1.0)")

    # 11. out-of-core: domains larger than device memory stream in
    #     i-chunks from host arrays/memmaps (run/iterate/solve/grad all
    #     take host_chunks=; report suggests the chunk count)
    oc = sft.run_chunked(program, inputs, chunks=2)
    err = float(np.abs(oc[program.outputs[0]]
                       - np.asarray(oracle[program.outputs[0]])).max())
    print(f"out-of-core 2-chunk sweep: max abs error vs oracle = {err}")


if __name__ == "__main__":
    main()

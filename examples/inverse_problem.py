#!/usr/bin/env python
"""Inverse problem: recover an initial condition through the solver.

Given only the OUTPUT of an 8-step diffusion chain applied to an unknown
initial field, reconstruct that field by gradient descent through the
whole chain (``sft.value_and_grad`` + optax Adam) — 4D-Var-style data
assimilation in ~30 lines, impossible with the reference's generated
OpenCL/HLS pipelines.

Run with JAX_PLATFORMS=cpu for a hardware-free demo.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import stencilflow_tpu as sft
from stencilflow_tpu.synthesize import jacobi

N, STEPS = 48, 8


def main():
    import jax.numpy as jnp
    import optax

    program = sft.parse_program(jacobi(2, N, iterations=STEPS),
                                name="inverse")
    out_name = program.outputs[0]

    # ground truth: two gaussian bumps; observed = chain(truth)
    y, x = np.mgrid[:N, :N]
    truth = (np.exp(-((y - 14) ** 2 + (x - 14) ** 2) / 18.0)
             + 0.7 * np.exp(-((y - 33) ** 2 + (x - 30) ** 2) / 30.0)
             ).astype(np.float32)
    observed = jnp.asarray(
        sft.run_interpreter(program, {"a": truth})[out_name])

    # the backward pass is the compiled adjoint chain (sft.value_and_grad
    # is the general fallback for non-affine programs)
    f = sft.fast_value_and_grad(
        program, loss=lambda o: ((o[out_name] - observed) ** 2).mean())

    opt = optax.adam(0.05)
    a = jnp.zeros((N, N), jnp.float32)
    state = opt.init(a)
    for i in range(300):
        val, grads = f({"a": a})
        updates, state = opt.update(grads["a"], state)
        a = optax.apply_updates(a, updates)
        if i % 100 == 0:
            print(f"iter {i}: data misfit {float(val):.3e}")

    err = float(np.abs(np.asarray(a) - truth).max())
    corr = float(np.corrcoef(np.asarray(a).ravel(), truth.ravel())[0, 1])
    print(f"recovered initial condition: max|err|={err:.3f}, "
          f"correlation {corr:.4f}")
    assert corr > 0.98
    print("OK")


if __name__ == "__main__":
    main()

#!/usr/bin/env python
"""Implicit (backward-Euler) diffusion: stable far beyond the explicit limit.

Explicit 2-D diffusion requires ``dt <= dx²/4``; backward Euler
``(I - dt·L) x⁺ = x`` is unconditionally stable but needs a solve per
step.  ``sft.make_solver`` compiles the chain once as a matrix-free CG
operator (iterations on device) — here one step at
40x the explicit limit, where the explicit scheme detonates.

Run with JAX_PLATFORMS=cpu for a hardware-free demo.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import stencilflow_tpu as sft

N, DT = 96, 10.0      # dx = 1: explicit limit is dt = 0.25


def main():
    implicit = sft.parse_program({
        "inputs": {"x": {"data": "constant:0.0", "data_type": "float32"}},
        "outputs": ["y"], "dimensions": [N, N],
        "program": {"y": {
            "computation_string":
                f"y = x[j, k] - {DT} * (x[j-1, k] + x[j+1, k] + "
                f"x[j, k-1] + x[j, k+1] - 4.0 * x[j, k])",
            "boundary_conditions": {
                "x": {"type": "constant", "value": 0.0}},
            "data_type": "float32"}}}, name="be_diffusion")

    explicit = sft.parse_program({
        "inputs": {"x": {"data": "constant:0.0", "data_type": "float32"}},
        "outputs": ["y"], "dimensions": [N, N],
        "program": {"y": {
            "computation_string":
                f"y = x[j, k] + {DT} * (x[j-1, k] + x[j+1, k] + "
                f"x[j, k-1] + x[j, k+1] - 4.0 * x[j, k])",
            "boundary_conditions": {
                "x": {"type": "constant", "value": 0.0}},
            "data_type": "float32"}}}, name="fe_diffusion")

    y, x = np.mgrid[:N, :N]
    state = (np.exp(-((y - N / 2) ** 2 + (x - N / 2) ** 2) / 40.0)
             + 1e-3 * np.random.default_rng(0).random((N, N))
             ).astype(np.float32)   # noise seeds the unstable modes

    solver = sft.make_solver(implicit, tol=1e-6)
    s_im = state
    for step in range(5):
        s_im, info = solver(s_im)
    s_im = np.asarray(s_im)
    print(f"implicit, dt=40x explicit limit, 5 steps: max={s_im.max():.4f} "
          f"(CG {info['iterations']} iters/step, residual "
          f"{info['residual']:.1e})")

    s_ex = state
    for step in range(5):
        s_ex = np.asarray(
            sft.run_interpreter(explicit, {"x": s_ex})["y"])
    print(f"explicit at the same dt: max={np.abs(s_ex).max():.3e} "
          "(unstable, as the CFL bound predicts)")

    assert np.isfinite(s_im).all() and s_im.max() < state.max()
    assert np.abs(s_ex).max() > 1e3
    print("OK")


if __name__ == "__main__":
    main()

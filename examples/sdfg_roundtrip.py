#!/usr/bin/env python
"""COSMO-style ingestion walkthrough: SDFG file -> dialect -> gradient.

The reference imports weather-model SDFGs (DaCe programs with repeated
field writes) into its JSON dialect and runs them on FPGAs.  This
example round-trips the same path on JAX:

1. a serialized DaCe SDFG (JSON on disk, Stencil library nodes across
   nested states, the diffusion field written twice) is imported WITHOUT
   a dace dependency (``sdfg_to_program`` — SSA-versioning the repeated
   writes, reference sdfg_to_stencilflow.py:590-632);
2. the program is canonicalized and verified against the oracle on the
   fused-XLA backend;
3. because the chain is affine, its exact adjoint is built as another
   dialect program and checked against ``jax.grad``.

Runs on JAX's default device (JAX_PLATFORMS=cpu for a hardware-free
demo).
"""
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import stencilflow_tpu as sft
from stencilflow_tpu.frontend.sdfg_import import sdfg_to_program

SHAPE = [8, 32, 32]
FULL = [True, True, True]


def stencil_node(label, accesses, out, bcs, code):
    return {"type": "LibraryNode",
            "classpath": "stencilflow.stencil.stencil.Stencil",
            "attributes": {"label": label, "shape": SHAPE,
                           "accesses": accesses,
                           "output_fields": {out: None},
                           "boundary_conditions": bcs,
                           "code": {"string_data": code,
                                    "language": "Python"}}}


def build_sdfg():
    lap = stencil_node(
        "lap",
        {"u": [FULL, [[0, -1, 0], [0, 1, 0], [0, 0, -1], [0, 0, 1],
                      [0, 0, 0]]]},
        "lap", {"u": {"btype": "constant", "value": 0.0}},
        "lap = u[0,-1,0] + u[0,1,0] + u[0,0,-1] + u[0,0,1] "
        "- 4.0*u[0,0,0]")
    step1 = stencil_node(
        "d_step1",
        {"u": [FULL, [[0, 0, 0]]], "lap": [FULL, [[0, 0, 0]]]},
        "d", {"u": {"btype": "constant", "value": 0.0},
              "lap": {"btype": "constant", "value": 0.0}},
        "d = u[0,0,0] + 0.12 * lap[0,0,0]")
    step2 = stencil_node(   # writes d AGAIN: SSA-versioned on import
        "d_step2",
        {"d": [FULL, [[0, -1, 0], [0, 1, 0], [0, 0, -1], [0, 0, 1],
                      [0, 0, 0]]]},
        "d", {"d": {"btype": "constant", "value": 0.0}},
        "d = d[0,0,0] + 0.12 * (d[0,-1,0] + d[0,1,0] + d[0,0,-1] "
        "+ d[0,0,1] - 4.0*d[0,0,0])")
    return {"type": "SDFG",
            "attributes": {"name": "cosmo_diffusion", "_arrays": {
                "u": {"attributes": {"dtype": "float32",
                                     "shape": SHAPE}}}},
            "nodes": [
                {"type": "SDFGState", "nodes": [lap]},
                {"type": "SDFGState", "nodes": [
                    {"type": "NestedSDFG", "attributes": {"sdfg": {
                        "type": "SDFG", "attributes": {},
                        "nodes": [{"type": "SDFGState",
                                   "nodes": [step1]}]}}}]},
                {"type": "SDFGState", "nodes": [step2]},
            ]}


def main():
    with tempfile.NamedTemporaryFile("w", suffix=".sdfg",
                                     delete=False) as f:
        json.dump(build_sdfg(), f)
        path = f.name

    program = sdfg_to_program(path, input_data="random:-1,1")
    print(f"imported {program.name}: kernels {list(program.kernels)}, "
          f"outputs {program.outputs}")
    assert list(program.kernels) == ["lap", "d__1", "d"]

    inputs = sft.load_input_arrays(program, seed=0)
    oracle = sft.run_interpreter(program, inputs)

    import jax
    from stencilflow_tpu.backend.xla import run_chain
    got = run_chain(program, inputs)
    err = float(np.max(np.abs(np.asarray(got["d"])
                              - np.asarray(oracle["d"]))))
    print(f"fused-XLA backend vs oracle: max |diff| = {err:.2e}")
    assert err < 1e-5

    # exact adjoint as a dialect program, checked against autodiff
    import jax.numpy as jnp
    adj, cot = sft.adjoint_program(program)
    g_fast = np.asarray(run_chain(adj, sft.load_input_arrays(adj))["adj_u"])
    from stencilflow_tpu.backend.xla import compile_chain
    fn = compile_chain(program)
    u = jnp.asarray(inputs["u"])
    g_ad = np.asarray(jax.grad(lambda x: fn({"u": x})["d"].sum())(u))
    gerr = float(np.max(np.abs(g_fast.reshape(g_ad.shape) - g_ad)))
    print(f"adjoint program vs jax.grad: max |diff| = {gerr:.2e}")
    assert gerr < 1e-5
    print("OK")
    os.unlink(path)


if __name__ == "__main__":
    main()

"""COSMO-style horizontal diffusion — the multi-operator import target named
in the reference paper (the reference reaches it through its SDFG importer,
/root/reference/stencilflow/sdfg_to_stencilflow.py:522).  Exercises the full
block per stage: lap → flux-limited flx/fly (multi-statement kernels with
temporaries, compares, ternaries) → weighted output, across every engine.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

import stencilflow_tpu as sft
from stencilflow_tpu.backend.xla import compile_chain
from stencilflow_tpu.sim import simulate
from stencilflow_tpu.synthesize import synthesize_stencil


def _program(dims=(6, 16, 16), stages=2):
    return sft.parse_program(
        synthesize_stencil(num_stages=stages, dimensions=dims,
                           shape="hdiff"),
        name=f"hdiff_{len(dims)}d_{stages}")


def _oracle(program, inputs):
    return {k: np.asarray(v)
            for k, v in sft.run_interpreter(program, inputs).items()}


def test_limiters_active():
    """The random seed must actually exercise both ternary branches."""
    p = _program(stages=1)
    inputs = sft.load_input_arrays(p, seed=0)
    a = inputs["a"]
    lap = (4.0 * a
           - np.roll(a, 1, 1) - np.roll(a, -1, 1)
           - np.roll(a, 1, 2) - np.roll(a, -1, 2))
    d = np.roll(lap, -1, 1) - lap
    limited = d * (np.roll(a, -1, 1) - a) > 0
    assert 0 < limited.mean() < 1


@pytest.mark.parametrize("dims", [(6, 16, 16), (16, 16)])
def test_stream_matches_oracle(dims):
    p = _program(dims=dims)
    inputs = sft.load_input_arrays(p, seed=0)
    ref = _oracle(p, inputs)
    fn = compile_chain(p)
    out = fn({k: jnp.asarray(v) for k, v in inputs.items()})
    for k in ref:
        np.testing.assert_allclose(np.asarray(out[k]), ref[k],
                                   rtol=1e-5, atol=1e-6)


def test_simulator_matches_oracle():
    p = _program(dims=(4, 8, 8), stages=1)
    inputs = sft.load_input_arrays(p, seed=0)
    ref = _oracle(p, inputs)
    res = simulate(p, inputs)
    for k in ref:
        np.testing.assert_allclose(res.outputs[k], ref[k],
                                   rtol=1e-6, atol=1e-7)


def test_domain_decomposition():
    from stencilflow_tpu.parallel.domain import compile_sharded_chain
    p = _program(dims=(4, 16, 16))
    inputs = sft.load_input_arrays(p, seed=0)
    ref = _oracle(p, inputs)
    devs = np.array(jax.devices()[:4]).reshape(2, 2)
    mesh = Mesh(devs, ("x", "y"))
    fn, plan = compile_sharded_chain(p, mesh, (None, "x", "y"))
    sh = plan.input_shardings()
    dev_in = {n: jax.device_put(jnp.asarray(v), sh[n])
              for n, v in inputs.items()}
    out = fn(dev_in)
    for k in ref:
        np.testing.assert_allclose(np.asarray(out[k]), ref[k],
                                   rtol=1e-5, atol=1e-6)

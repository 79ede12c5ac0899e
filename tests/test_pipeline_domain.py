"""Pipeline x domain composition (parallel/pipeline.py domain_axes):
wavefront pipeline over mesh axis "p" with each segment's domain sharded
over further axes — per-segment j/k halos gathered from domain
neighbors, O(N/(S*X)) per-device buffers (VERDICT r4 #4).

Runs on the virtual 8-device CPU mesh (conftest).
"""
import numpy as np
import pytest

import stencilflow_tpu as sft
from stencilflow_tpu.synthesize import jacobi, synthesize_stencil


def _oracle(program, inputs):
    return {k: np.asarray(v)
            for k, v in sft.run_interpreter(program, inputs).items()}


def _run(program, inputs, mesh_shape, axes, domain_axes, **kw):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding
    from stencilflow_tpu.parallel.pipeline import compile_pipeline_split
    devs = np.array(jax.devices()[:int(np.prod(mesh_shape))])
    mesh = Mesh(devs.reshape(mesh_shape), axes)
    fn, _plan = compile_pipeline_split(program, mesh, axes[0],
                                       domain_axes=domain_axes,
                                       **kw)
    specs = compile_pipeline_split.last_config["in_specs"]
    dev_in = {}
    for n, v in inputs.items():
        spec = program.inputs[n]
        arr = jnp.asarray(v)
        if not spec.is_scalar:
            spanned = [d for d in range(3) if spec.dim_mask[d]]
            arr = arr.reshape(tuple(program.dimensions[d]
                                    for d in spanned))
        dev_in[n] = jax.device_put(arr, NamedSharding(mesh, specs[n]))
    return {k: np.asarray(v) for k, v in fn(dev_in).items()}


class TestPipelineDomainComposition:

    @pytest.mark.parametrize("daxes", [{1: "x"}, {2: "x"}])
    def test_2x4_jacobi_deep_halo(self, daxes):
        """2 segments x 4-way domain; chain halo (8) exceeds the local
        extent (4), exercising the multi-hop domain gather."""
        p = sft.parse_program(jacobi(3, 16, iterations=8), name="pdc_j")
        inputs = sft.load_input_arrays(p, seed=5)
        ref = _oracle(p, inputs)
        got = _run(p, inputs, (2, 4), ("p", "x"), daxes)
        o = p.outputs[0]
        np.testing.assert_array_equal(
            got[o].reshape(ref[o].shape), ref[o])

    def test_2x2x2_both_dims(self):
        """3-axis mesh: pipeline x (j over x) x (k over y)."""
        p = sft.parse_program(jacobi(3, 16, iterations=4), name="pdc_3ax")
        inputs = sft.load_input_arrays(p, seed=6)
        ref = _oracle(p, inputs)
        got = _run(p, inputs, (2, 2, 2), ("p", "x", "y"),
                   {1: "x", 2: "y"})
        o = p.outputs[0]
        np.testing.assert_array_equal(
            got[o].reshape(ref[o].shape), ref[o])

    def test_4x2_mixed_rank_inputs(self):
        """hotspot: scalar coefficients + static planes + copy BC, with
        the domain-sharded dim slicing replicated non-i inputs."""
        p = sft.parse_program(synthesize_stencil(
            num_stages=4, dimensions=(8, 16, 16), shape="hotspot"),
            name="pdc_hot")
        inputs = sft.load_input_arrays(p, seed=7)
        ref = _oracle(p, inputs)
        got = _run(p, inputs, (4, 2), ("p", "x"), {1: "x"})
        for o in p.outputs:
            np.testing.assert_allclose(got[o].reshape(ref[o].shape),
                                       ref[o], rtol=3e-5, atol=1e-6)

    def test_gates(self):
        import jax
        from jax.sharding import Mesh
        from stencilflow_tpu.parallel.pipeline import \
            compile_pipeline_split
        p = sft.parse_program(jacobi(3, 16, iterations=4), name="pdc_g")
        mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4),
                    ("p", "x"))
        with pytest.raises(ValueError, match="divisible"):
            compile_pipeline_split(
                sft.parse_program(jacobi(3, 18, iterations=4),
                                  name="pdc_nd"),
                mesh, "p", domain_axes={1: "x"})
        with pytest.raises(ValueError, match="pipeline axis"):
            compile_pipeline_split(p, mesh, "p", domain_axes={1: "p"})
        with pytest.raises(ValueError, match="1 .j. or 2"):
            compile_pipeline_split(p, mesh, "p", domain_axes={0: "x"})
        with pytest.raises(ValueError, match="sharded"):
            compile_pipeline_split(p, mesh, "p", domain_axes={1: "x"},
                                   io="replicated")

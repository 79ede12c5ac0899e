"""Comm/compute-overlapped domain decomposition (comm_overlap=True).

The overlapped body evaluates the block interior with no data dependency
on the halo ppermutes and stitches boundary strips computed from the
widened array — it must be bit-identical to the blocking body (same
evaluator, same BC masks), for every BC and sharding layout.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

import stencilflow_tpu as sft
from stencilflow_tpu.parallel.domain import (compile_sharded_chain,
                                             run_sharded_chain)
from stencilflow_tpu.synthesize import jacobi, synthesize_stencil


def _oracle(program, inputs):
    return {k: np.asarray(v)
            for k, v in sft.run_interpreter(program, inputs).items()}


def _jacobi3d(size=16, iters=2, boundary="constant"):
    return sft.parse_program(
        jacobi(3, size, iterations=iters, boundary=boundary),
        name=f"ov_j3d_{size}_{iters}_{boundary}")


class TestTileBodyOverlap:
    @pytest.mark.parametrize("boundary", ["constant", "copy", "shrink"])
    def test_jk_sharded_2d_mesh(self, boundary):
        p = _jacobi3d(size=16, iters=2, boundary=boundary)
        inputs = sft.load_input_arrays(p, seed=71)
        ref = _oracle(p, inputs)["s1"]
        mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("x", "y"))
        out = run_sharded_chain(p, mesh, (None, "x", "y"), inputs,
                                comm_overlap=True)
        assert compile_sharded_chain.last_config["comm_overlap"]
        np.testing.assert_allclose(out["s1"], ref, rtol=1e-6)

    def test_deep_halo_i_sharded(self):
        # cumulative halo 3 (three stages), 4-way i sharding: block 8 > 2*3
        p = _jacobi3d(size=32, iters=3)
        inputs = sft.load_input_arrays(p, seed=72)
        ref = _oracle(p, inputs)["s2"]
        mesh = Mesh(np.array(jax.devices()[:4]), ("x",))
        out = run_sharded_chain(p, mesh, ("x", None, None), inputs,
                                comm_overlap=True)
        np.testing.assert_allclose(out["s2"], ref, rtol=1e-6)

    def test_mixed_rank_inputs(self):
        # a 1-D (k-only) coefficient input must broadcast identically in
        # the interior pass and the strips
        rng = np.random.default_rng(73)
        a = rng.random((8, 12, 16)).astype(np.float32)
        row = rng.random((16,)).astype(np.float32)
        p = sft.parse_program({
            "inputs": {
                "a": {"data": a, "data_type": "float32"},
                "row": {"data": row, "data_type": "float32",
                        "input_dims": ["k"]},
            },
            "outputs": ["s1"],
            "dimensions": [8, 12, 16],
            "program": {
                "s0": {"computation_string":
                       "s0 = 0.25*(a[i,j,k-1] + a[i,j,k+1] "
                       "+ a[i,j-1,k] + a[i,j+1,k]) + row[k]",
                       "boundary_conditions":
                       {"a": {"type": "constant", "value": 0.0},
                        "row": {"type": "constant", "value": 0.0}},
                       "data_type": "float32"},
                "s1": {"computation_string":
                       "s1 = 0.5*(s0[i,j-1,k] + s0[i,j+1,k])",
                       "boundary_conditions":
                       {"s0": {"type": "constant", "value": 0.0}},
                       "data_type": "float32"},
            },
        }, name="ov_mixed_rank")
        inputs = {"a": a, "row": row}
        ref = _oracle(p, inputs)["s1"]
        mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("x", "y"))
        out = run_sharded_chain(p, mesh, (None, "x", "y"), inputs,
                                comm_overlap=True)
        np.testing.assert_allclose(out["s1"], ref, rtol=1e-6)

    def test_no_exchange_is_a_noop(self):
        # single-device mesh: no halo to hide; flag downgrades cleanly
        p = _jacobi3d(size=8, iters=2)
        inputs = sft.load_input_arrays(p, seed=74)
        ref = _oracle(p, inputs)["s1"]
        mesh = Mesh(np.array(jax.devices()[:1]), ("x",))
        out = run_sharded_chain(p, mesh, ("x", None, None), inputs,
                                comm_overlap=True)
        assert not compile_sharded_chain.last_config["comm_overlap"]
        np.testing.assert_allclose(out["s1"], ref, rtol=1e-6)

    def test_thin_block_strips_cover_everything(self):
        # h <= B < 2h: the interior is empty and the two strips overlap;
        # the overlapped body must still be exact (h=2, B=3 per shard)
        p = _jacobi3d(size=12, iters=2)
        inputs = sft.load_input_arrays(p, seed=75)
        ref = _oracle(p, inputs)["s1"]
        mesh = Mesh(np.array(jax.devices()[:4]), ("x",))
        out = run_sharded_chain(p, mesh, ("x", None, None), inputs,
                                comm_overlap=True)
        np.testing.assert_allclose(out["s1"], ref, rtol=1e-6)


class TestIShardedOverlap:
    @pytest.mark.parametrize("boundary", ["constant", "copy", "shrink"])
    def test_i_sharded_diffusion(self, boundary):
        spec = synthesize_stencil(num_stages=2, dimensions=(16, 8, 32),
                                  shape="diffusion", boundary=boundary)
        p = sft.parse_program(spec, name=f"ov_ishard_{boundary}")
        inputs = sft.load_input_arrays(p, seed=81)
        out_name = p.outputs[0]
        ref = _oracle(p, inputs)[out_name]
        mesh = Mesh(np.array(jax.devices()[:2]), ("x",))
        fn, plan = compile_sharded_chain(p, mesh, ("x", None, None),
                                         comm_overlap=True)
        cfg = compile_sharded_chain.last_config
        assert cfg["comm_overlap"], cfg
        sh = plan.input_shardings()
        dev_in = {n: jax.device_put(jnp.asarray(v), sh[n])
                  for n, v in inputs.items()}
        out = np.asarray(fn(dev_in)[out_name])
        np.testing.assert_allclose(out, ref, rtol=1e-6)

    def test_constant_stage_backward_reach_i_sharded(self):
        """A constant (input-less) stage read at backward i-offsets: its
        reach appears on NO input path, so the exchange/widening halo
        must come from stage_halo too (chain_halo fix, fuzz seed 91005
        — the un-widened shard read unevaluated ring planes at the
        seam).  Overlap on and off must match the oracle exactly."""
        spec = {
            "inputs": {"a": {"data": "random:-1,1",
                             "data_type": "float32"}},
            "outputs": ["s1"], "dimensions": [16, 8, 16],
            "program": {
                "s0": {"computation_string": "s0 = -0.748",
                       "boundary_conditions": {}, "data_type": "float32"},
                "s1": {"computation_string":
                       "s1 = s0[i+2,j,k] + s0[i-2,j,k] + a[i,j,k]",
                       "boundary_conditions":
                       {"s0": {"type": "constant", "value": 0.5},
                        "a": {"type": "constant", "value": 0.0}},
                       "data_type": "float32"}}}
        p = sft.parse_program(spec, name="const_ireach")
        inputs = sft.load_input_arrays(p, seed=5)
        ref = _oracle(p, inputs)["s1"]
        mesh = Mesh(np.array(jax.devices()[:2]), ("x",))
        for ov in (False, True):
            fn, plan = compile_sharded_chain(
                p, mesh, ("x", None, None), comm_overlap=ov)
            sh = plan.input_shardings()
            dev_in = {n: jax.device_put(jnp.asarray(v), sh[n])
                      for n, v in inputs.items()}
            out = np.asarray(fn(dev_in)["s1"])
            assert np.isfinite(out).all(), ov
            np.testing.assert_allclose(out, ref, rtol=1e-6,
                                       err_msg=f"overlap={ov}")

    def test_i_sharded_deep_chain(self):
        # 4 stages -> halo 4; blocks of 16 planes leave an 8-plane interior
        p = _jacobi3d(size=32, iters=4)
        inputs = sft.load_input_arrays(p, seed=82)
        ref = _oracle(p, inputs)["s3"]
        mesh = Mesh(np.array(jax.devices()[:2]), ("x",))
        fn, plan = compile_sharded_chain(p, mesh, ("x", None, None),
                                         comm_overlap=True)
        sh = plan.input_shardings()
        dev_in = {n: jax.device_put(jnp.asarray(v), sh[n])
                  for n, v in inputs.items()}
        out = np.asarray(fn(dev_in)["s3"])
        np.testing.assert_allclose(out, ref, rtol=1e-6)

"""Iterative solver driver tests: unrolled-vs-iterated equivalence,
checkpoint/resume, and multi-chip iteration."""
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

import stencilflow_tpu as sft
from stencilflow_tpu.iterate import IterateError, iterate
from stencilflow_tpu.synthesize import jacobi


def _one_step_program(size=16, dims=2):
    return sft.parse_program(jacobi(dims, size, iterations=1),
                             name=f"step{dims}d")


class TestComposeIterations:
    def test_fused_equals_unrolled(self):
        """compose_iterations(p, 4) == the hand-unrolled 4-step fixture."""
        from stencilflow_tpu.iterate import compose_iterations
        p1 = _one_step_program()
        p4 = sft.parse_program(jacobi(2, 16, iterations=4), name="unroll4")
        fused = compose_iterations(p1, 4)
        assert len(fused.kernels) == 4
        assert fused.outputs == p1.outputs
        inputs = sft.load_input_arrays(p1, seed=5)
        ref = np.asarray(sft.run_interpreter(p4, inputs)["s3"])
        got = np.asarray(sft.run_interpreter(fused, inputs)[
            fused.outputs[0]])
        np.testing.assert_allclose(got, ref, rtol=1e-6)

    def test_iterate_with_fuse(self):
        p1 = _one_step_program()
        inputs = sft.load_input_arrays(p1, seed=6)
        plain = iterate(p1, inputs, steps=6, chunk=3)
        fused = iterate(p1, inputs, steps=6, fuse=3)
        np.testing.assert_allclose(fused["a"], plain["a"], rtol=1e-5,
                                   atol=1e-7)

    def test_fuse_divisibility_errors(self):
        p1 = _one_step_program()
        inputs = sft.load_input_arrays(p1, seed=7)
        with pytest.raises(IterateError, match="multiple of"):
            iterate(p1, inputs, steps=5, fuse=3)
        with pytest.raises(IterateError, match="fuse must be"):
            iterate(p1, inputs, steps=6, fuse=0)

    def test_compose_prunes_dead_side_outputs(self):
        # a non-fed side output's intermediate clones are dead and pruned
        from stencilflow_tpu.iterate import compose_iterations
        spec = {
            "inputs": {"a": {"data": "constant:1.0",
                             "data_type": "float32"}},
            "outputs": ["o1", "o2"],
            "dimensions": [8, 8],
            "program": {
                "o1": {"computation_string":
                       "o1 = 0.5 * (a[i-1,j] + a[i+1,j])",
                       "boundary_conditions": {
                           "a": {"type": "constant", "value": 0}},
                       "data_type": "float32"},
                "o2": {"computation_string": "o2 = 2.0 * a[i,j]",
                       "boundary_conditions": {},
                       "data_type": "float32"},
            },
        }
        p = sft.parse_program(spec, name="side")
        fused = compose_iterations(p, 4, feed={"a": "o1"})
        # 4 o1 clones + only the FINAL o2 (intermediate o2 clones pruned)
        assert len(fused.kernels) == 5, sorted(fused.kernels)
        assert set(p.outputs) <= set(fused.kernels)

    def test_fused_checkpoint_units(self, tmp_path):
        # checkpoints are named in ORIGINAL step units regardless of fuse
        p1 = _one_step_program()
        inputs = sft.load_input_arrays(p1, seed=8)
        iterate(p1, inputs, steps=8, fuse=2,
                checkpoint_every=4, checkpoint_dir=str(tmp_path))
        assert (tmp_path / "step_4.npz").exists()
        assert (tmp_path / "step_8.npz").exists()

    def test_fused_multi_stage_chain(self):
        # fusing a 2-stage chain: clones + reconvergence-free rewiring
        from stencilflow_tpu.iterate import compose_iterations
        p2 = sft.parse_program(jacobi(3, 8, iterations=2), name="two")
        fused = compose_iterations(p2, 3, feed={"a": "s1"})
        assert len(fused.kernels) == 6
        inputs = sft.load_input_arrays(p2, seed=9)
        got = np.asarray(sft.run_interpreter(fused, inputs)[
            fused.outputs[0]])
        state = iterate(p2, inputs, steps=3, feed={"a": "s1"},
                        chunk=1)
        np.testing.assert_allclose(got, state["a"], rtol=1e-5, atol=1e-7)


class TestIterate:
    def test_matches_unrolled_chain(self):
        """N iterations of a 1-step program == the N-step unrolled chain."""
        p1 = _one_step_program()
        p4 = sft.parse_program(jacobi(2, 16, iterations=4), name="unroll4")
        inputs = sft.load_input_arrays(p1, seed=1)
        ref = np.asarray(sft.run_interpreter(p4, inputs)["s3"])
        state = iterate(p1, inputs, steps=4, chunk=2)
        np.testing.assert_allclose(state["a"], ref, rtol=1e-5, atol=1e-7)

    def test_checkpoint_and_resume(self, tmp_path):
        p1 = _one_step_program()
        inputs = sft.load_input_arrays(p1, seed=2)
        ckpt = str(tmp_path / "ck")
        full = iterate(p1, inputs, steps=6, chunk=2,
                       checkpoint_every=2, checkpoint_dir=ckpt)
        # checkpoints written at steps 2, 4, 6
        names = sorted(os.listdir(ckpt))
        assert "step_2.npz" in names and "step_6.npz" in names

        # delete the last checkpoint; resume continues from step 4
        os.remove(os.path.join(ckpt, "step_6.npz"))
        resumed = iterate(p1, inputs, steps=6, chunk=2,
                          checkpoint_every=2, checkpoint_dir=ckpt)
        np.testing.assert_array_equal(full["a"], resumed["a"])

    def test_multi_feed_coupled_system(self):
        """Three coupled fields fed back at once (shallow-water style);
        fused and unfused stepping agree with oracle stepping."""
        import importlib.util
        spec = importlib.util.spec_from_file_location(
            "swe", os.path.join(os.path.dirname(__file__), "..",
                                "examples", "shallow_water.py"))
        swe = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(swe)
        p = swe.build_program()
        inputs = sft.load_input_arrays(p)
        feed = {"h": "h1", "u": "u1", "v": "v1"}
        ref = {k: np.asarray(v) for k, v in inputs.items()}
        for _ in range(8):
            out = sft.run_interpreter(p, {**inputs,
                                          **{k: ref[k] for k in feed}})
            ref = {k: np.asarray(out[o]) for k, o in feed.items()}
        for fuse in (1, 4):
            state = iterate(p, inputs, steps=8, feed=feed, fuse=fuse,
                            chunk=2)
            for k in feed:
                np.testing.assert_allclose(state[k], ref[k],
                                           rtol=1e-5, atol=1e-6,
                                           err_msg=f"{k} fuse={fuse}")

    def test_nonlinear_coupled_system(self):
        """Gray–Scott reaction–diffusion (examples/gray_scott.py at small
        size): a NONLINEAR two-field feed (u·v² cross-field product) with
        copy (zero-flux) BCs; fused and unfused stepping agree with
        oracle stepping."""
        import importlib.util
        spec = importlib.util.spec_from_file_location(
            "gs", os.path.join(os.path.dirname(__file__), "..",
                               "examples", "gray_scott.py"))
        gs = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(gs)
        p = gs.build_program(n=24)
        inputs = sft.load_input_arrays(p)
        feed = {"u": "u1", "v": "v1"}
        ref = {k: np.asarray(v) for k, v in inputs.items()}
        for _ in range(8):
            out = sft.run_interpreter(p, ref)
            ref = {k: np.asarray(out[o]) for k, o in feed.items()}
        for fuse in (1, 4):
            state = iterate(p, inputs, steps=8, feed=feed, fuse=fuse,
                            chunk=2)
            for k in feed:
                np.testing.assert_allclose(state[k], ref[k],
                                           rtol=1e-5, atol=1e-6,
                                           err_msg=f"{k} fuse={fuse}")

    def test_orbax_checkpoint_and_resume(self, tmp_path):
        """The orbax format: async device-sharded checkpoints; resume
        from the newest step matches the uninterrupted run."""
        p1 = _one_step_program()
        inputs = sft.load_input_arrays(p1, seed=7)
        ckpt = str(tmp_path / "ock")
        full = iterate(p1, inputs, steps=6, chunk=2,
                       checkpoint_every=2, checkpoint_dir=ckpt,
                       checkpoint_format="orbax")
        import shutil
        assert sorted(int(d) for d in os.listdir(ckpt)
                      if d.isdigit()) == [2, 4, 6]
        shutil.rmtree(os.path.join(ckpt, "6"))
        resumed = iterate(p1, inputs, steps=6, chunk=2,
                          checkpoint_every=2, checkpoint_dir=ckpt,
                          checkpoint_format="orbax")
        np.testing.assert_array_equal(full["a"], resumed["a"])

    def test_orbax_sharded_checkpoint(self, tmp_path):
        """Sharded state checkpoints and restores with its sharding."""
        p1 = _one_step_program(size=16, dims=3)
        inputs = sft.load_input_arrays(p1, seed=8)
        mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("x", "y"))
        ckpt = str(tmp_path / "osh")
        kw = dict(steps=4, mesh=mesh, dim_axes=(None, "x", "y"), chunk=2,
                  checkpoint_every=2, checkpoint_dir=ckpt,
                  checkpoint_format="orbax")
        full = iterate(p1, inputs, **kw)
        import shutil
        shutil.rmtree(os.path.join(ckpt, "4"))
        resumed = iterate(p1, inputs, **kw)
        np.testing.assert_allclose(full["a"], resumed["a"],
                                   rtol=1e-6, atol=1e-7)
        expect = iterate(p1, inputs, steps=4, mesh=mesh,
                         dim_axes=(None, "x", "y"), chunk=2)
        np.testing.assert_allclose(resumed["a"], expect["a"],
                                   rtol=1e-6, atol=1e-7)

    def test_resume_ignores_inputs(self, tmp_path):
        """After a checkpoint exists, fresh inputs are ignored (state
        restores from disk)."""
        p1 = _one_step_program()
        inputs = sft.load_input_arrays(p1, seed=3)
        ckpt = str(tmp_path / "ck2")
        iterate(p1, inputs, steps=4, 
                checkpoint_every=4, checkpoint_dir=ckpt)
        junk = {"a": np.zeros_like(inputs["a"])}
        resumed = iterate(p1, junk, steps=4, 
                          checkpoint_every=4, checkpoint_dir=ckpt)
        expect = iterate(p1, inputs, steps=4)
        np.testing.assert_array_equal(resumed["a"], expect["a"])

    def test_multichip_iterate(self):
        p1 = _one_step_program(size=16, dims=3)
        inputs = sft.load_input_arrays(p1, seed=4)
        mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("x", "y"))
        state = iterate(p1, inputs, steps=3, mesh=mesh,
                        dim_axes=(None, "x", "y"), chunk=3)
        p3 = sft.parse_program(jacobi(3, 16, iterations=3), name="u3")
        ref = np.asarray(sft.run_interpreter(p3, inputs)["s2"])
        np.testing.assert_allclose(state["a"], ref, rtol=1e-5, atol=1e-7)

    def test_ambiguous_feed_raises(self):
        rng = np.random.default_rng(5)
        p = sft.parse_program({
            "inputs": {"a": {"data": rng.random((4, 4)),
                             "data_type": "float32"},
                       "b": {"data": rng.random((4, 4)),
                             "data_type": "float32"}},
            "outputs": ["c"], "dimensions": [4, 4],
            "program": {"c": {
                "computation_string": "c = a[j,k] + b[j,k]",
                "boundary_conditions": {
                    "a": {"type": "constant", "value": 0},
                    "b": {"type": "constant", "value": 0}},
                "data_type": "float32"}},
        }, name="amb")
        with pytest.raises(IterateError):
            iterate(p, sft.load_input_arrays(p), steps=1)

    def test_wave_time_reversal(self):
        """Leapfrog wave stepping (two time levels via multi-feed) is
        exactly invertible: T forward steps then T-1 steps on the
        swapped state refocus onto the initial pulse to roundoff
        (examples/wave_propagation.py at small size)."""
        import importlib.util
        spec = importlib.util.spec_from_file_location(
            "wave", os.path.join(os.path.dirname(__file__), "..",
                                 "examples", "wave_propagation.py"))
        wave = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(wave)
        p = wave.build_program(n=32, r2=0.4)
        inputs = sft.load_input_arrays(p)
        p0 = np.asarray(inputs["p"])
        fwd = iterate(p, inputs, steps=24, feed=wave.FEED, fuse=4,
                      chunk=2)
        rec = iterate(p, {"p": np.asarray(fwd["pm"]),
                          "pm": np.asarray(fwd["p"])},
                      steps=23, feed=wave.FEED, chunk=4)
        np.testing.assert_allclose(np.asarray(rec["p"]), p0,
                                   rtol=0, atol=1e-5)

    def test_cli_iterate(self, tmp_path, capsys):
        import json
        from stencilflow_tpu.cli import main as cli_main
        spec = jacobi(2, 8, iterations=1)
        path = tmp_path / "p.json"
        path.write_text(json.dumps(spec, default=str))
        rc = cli_main(["iterate", str(path), "--steps", "3",
                       "--output-dir", str(tmp_path / "out")])
        assert rc == 0
        assert (tmp_path / "out" / "a.dat").exists()


def test_chunk_must_be_positive():
    from stencilflow_tpu.iterate import IterateError
    p1 = _one_step_program()
    inputs = sft.load_input_arrays(p1, seed=0)
    with pytest.raises(IterateError, match="chunk"):
        iterate(p1, inputs, steps=4, chunk=0)

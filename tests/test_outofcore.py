"""Out-of-core host-chunked execution (outofcore.py): i-chunks with the
chain's cumulative halo stream through one origin-parameterized kernel;
results must match the whole-domain oracle exactly.

These tests cover the fused-XLA chunk body, memmapped inputs/outputs,
DAG programs with lower-dimensional inputs, and the error surface.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import stencilflow_tpu as sft
from stencilflow_tpu.outofcore import compile_chunked_chain, run_chunked
from stencilflow_tpu.synthesize import jacobi, synthesize_stencil


def _oracle(p, inputs):
    return {k: np.asarray(v, dtype=np.float64)
            for k, v in sft.run_interpreter(p, inputs).items()}


class TestChunkedMatchesOracle:
    @pytest.mark.parametrize("chunks", [1, 2, 4])
    def test_jacobi3d_xla_body(self, chunks):
        p = sft.parse_program(jacobi(3, 16, iterations=3), name="oc3")
        inputs = sft.load_input_arrays(p, seed=1)
        ref = _oracle(p, inputs)
        got = run_chunked(p, inputs, chunks)
        for o in p.outputs:
            np.testing.assert_allclose(got[o], ref[o], rtol=2e-5,
                                       atol=1e-6)

    @pytest.mark.parametrize("chunks", [2, 4])
    def test_jacobi3d_stream_body_interpret(self, chunks):
        p = sft.parse_program(jacobi(3, 16, iterations=2), name="ocs")
        inputs = sft.load_input_arrays(p, seed=2)
        ref = _oracle(p, inputs)
        got = run_chunked(p, inputs, chunks)
        for o in p.outputs:
            np.testing.assert_allclose(got[o], ref[o], rtol=2e-5,
                                       atol=1e-6)

    @pytest.mark.parametrize("boundary", ["constant", "shrink"])
    def test_stream_body_shift_fill_k256(self, boundary):
        """A wide plane (K = 256) chunked along i: the i-OOB fill at
        chunk seams must match the oracle."""
        spec = synthesize_stencil(num_stages=2, dimensions=(8, 8, 256),
                                  shape="diffusion", boundary=boundary)
        p = sft.parse_program(spec, name=f"ocshift_{boundary}")
        inputs = sft.load_input_arrays(p, seed=7)
        ref = _oracle(p, inputs)
        got = run_chunked(p, inputs, 2)
        for o in p.outputs:
            np.testing.assert_allclose(got[o], ref[o], rtol=2e-5,
                                       atol=1e-6)

    def test_dag_with_lower_dim_inputs(self):
        """hdiff-style DAG (forks/joins, multi-statement kernels) plus a
        k-spanning and a scalar input exercise the host-slab logic for
        non-i-spanning fields."""
        spec = synthesize_stencil(num_stages=2, dimensions=(8, 12, 16),
                                  shape="hdiff")
        p = sft.parse_program(spec, name="ochd")
        inputs = sft.load_input_arrays(p, seed=3)
        ref = _oracle(p, inputs)
        got = run_chunked(p, inputs, 4)
        for o in p.outputs:
            np.testing.assert_allclose(got[o], ref[o], rtol=2e-5,
                                       atol=1e-6)

    def test_copy_bc(self):
        spec = jacobi(3, 8, iterations=2)
        for k in spec["program"].values():
            for bc in k["boundary_conditions"].values():
                bc["type"] = "copy"
        p = sft.parse_program(spec, name="occ")
        inputs = sft.load_input_arrays(p, seed=4)
        ref = _oracle(p, inputs)
        got = run_chunked(p, inputs, 2)
        np.testing.assert_allclose(got[p.outputs[0]], ref[p.outputs[0]],
                                   rtol=2e-5, atol=1e-6)


class TestMemmap:
    def test_memmap_in_and_out(self, tmp_path):
        """Inputs from np.memmap, outputs into caller-provided memmaps —
        the working set never needs to exist in RAM."""
        p = sft.parse_program(jacobi(3, 16, iterations=2), name="ocm")
        inputs = sft.load_input_arrays(p, seed=5)
        ref = _oracle(p, inputs)
        name = next(iter(p.inputs))
        mm_in = np.memmap(tmp_path / "in.dat", dtype=np.float32,
                          mode="w+", shape=inputs[name].shape)
        mm_in[:] = inputs[name]
        mm_in.flush()
        out_name = p.outputs[0]
        mm_out = np.memmap(tmp_path / "out.dat", dtype=np.float32,
                           mode="w+", shape=tuple(p.raw_dimensions))
        got = run_chunked(p, {**inputs, name: mm_in}, 4,
                          out={out_name: mm_out})
        assert got[out_name] is mm_out
        np.testing.assert_allclose(np.asarray(mm_out), ref[out_name],
                                   rtol=2e-5, atol=1e-6)

    def test_out_shape_mismatch_raises(self):
        p = sft.parse_program(jacobi(3, 8, iterations=1), name="ocbad")
        inputs = sft.load_input_arrays(p, seed=0)
        with pytest.raises(ValueError, match="shape"):
            run_chunked(p, inputs, 2,
                        out={p.outputs[0]: np.empty((4, 4, 4),
                                                    np.float32)})


class TestErrors:
    def test_chunks_must_divide(self):
        p = sft.parse_program(jacobi(3, 8, iterations=1), name="ocd")
        with pytest.raises(ValueError, match="divide"):
            compile_chunked_chain(p, 3)

    def test_halo_vs_block(self):
        p = sft.parse_program(jacobi(3, 8, iterations=8), name="och")
        with pytest.raises(ValueError, match="halo"):
            compile_chunked_chain(p, 8)  # halo 8 >= block 1

    def test_2d_program_rejected(self):
        p = sft.parse_program(jacobi(2, 8, iterations=1), name="oc2")
        with pytest.raises(ValueError, match="i axis|i extent"):
            compile_chunked_chain(p, 2)

    def test_compiled_chunk_mismatch(self):
        p = sft.parse_program(jacobi(3, 8, iterations=1), name="occm")
        inputs = sft.load_input_arrays(p, seed=0)
        compiled = compile_chunked_chain(p, 2)
        with pytest.raises(ValueError, match="chunks"):
            run_chunked(p, inputs, 4, compiled=compiled)


def test_cli_host_chunks(tmp_path):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    prog_path = tmp_path / "p.json"
    prog_path.write_text(json.dumps(jacobi(3, 8, iterations=2)))
    out = subprocess.run(
        [sys.executable, "-m", "stencilflow_tpu.cli", "run",
         str(prog_path), "emulation", "--host-chunks", "2",
         "--compare-to-reference"],
        capture_output=True, text=True, cwd=repo, env=env)
    assert out.returncode == 0, out.stderr
    assert "outofcore[" in out.stdout
    assert "verified against reference: OK" in out.stdout


class TestIterateHostChunks:
    def test_matches_unrolled_chain(self):
        """4 out-of-core time steps == the 4-step unrolled chain."""
        from stencilflow_tpu.iterate import iterate
        p1 = sft.parse_program(jacobi(3, 8, iterations=1), name="oci1")
        p4 = sft.parse_program(jacobi(3, 8, iterations=4), name="oci4")
        inputs = sft.load_input_arrays(p1, seed=6)
        ref = np.asarray(sft.run_interpreter(p4, inputs)[p4.outputs[0]])
        state = iterate(p1, inputs, steps=4, host_chunks=2)
        assert isinstance(state["a"], np.ndarray)
        np.testing.assert_allclose(state["a"], ref, rtol=1e-5, atol=1e-7)

    def test_fused_host_chunks(self):
        """fuse=2 composes with out-of-core stepping (2 sweeps, each a
        2-step-deep chain with the doubled halo)."""
        from stencilflow_tpu.iterate import iterate
        p1 = sft.parse_program(jacobi(3, 8, iterations=1), name="ocf1")
        p4 = sft.parse_program(jacobi(3, 8, iterations=4), name="ocf4")
        inputs = sft.load_input_arrays(p1, seed=7)
        ref = np.asarray(sft.run_interpreter(p4, inputs)[p4.outputs[0]])
        state = iterate(p1, inputs, steps=4, fuse=2, host_chunks=2)
        np.testing.assert_allclose(state["a"], ref, rtol=1e-5, atol=1e-7)

    def test_checkpoint_resume_host_mode(self, tmp_path):
        from stencilflow_tpu.iterate import iterate
        p1 = sft.parse_program(jacobi(3, 8, iterations=1), name="ocr1")
        inputs = sft.load_input_arrays(p1, seed=8)
        ckpt = str(tmp_path / "ck")
        full = iterate(p1, inputs, steps=6, host_chunks=2,
                       checkpoint_every=2, checkpoint_dir=ckpt)
        os.remove(os.path.join(ckpt, "step_6.npz"))
        resumed = iterate(p1, inputs, steps=6, host_chunks=2,
                          checkpoint_every=2, checkpoint_dir=ckpt)
        np.testing.assert_array_equal(full["a"], resumed["a"])

    def test_mesh_conflict_raises(self):
        from stencilflow_tpu.iterate import IterateError, make_step
        p1 = sft.parse_program(jacobi(3, 8, iterations=1), name="ocx")
        with pytest.raises(IterateError, match="incompatible"):
            make_step(p1, mesh=object(), dim_axes=(None, "x", None),
                      host_chunks=2)


def test_report_out_of_core_advisory():
    """report flags domains whose in-core footprint exceeds device memory and
    suggests a host-chunk count; small domains report 1."""
    from stencilflow_tpu.report import Report
    small = sft.parse_program(jacobi(3, 16, iterations=2), name="rsm")
    assert Report.build(small).suggested_host_chunks() == 1
    big = sft.parse_program(jacobi(3, 2048, iterations=2), name="rbg")
    rep = Report.build(big)
    n = rep.suggested_host_chunks()
    assert n > 1 and 2048 % n == 0
    assert rep.hbm_footprint_bytes() / n <= 0.75 * rep.hw.hbm_bytes
    assert "out-of-core advised" in str(rep)
    assert "suggested_host_chunks" in rep.as_dict()


REF_STENCILS = "/root/reference/test/stencils"


@pytest.mark.skipif(not os.path.isdir(REF_STENCILS),
                    reason="reference fixtures unavailable")
def test_reference_fixtures_chunked():
    """Every chunkable upstream fixture (rank-3 raw domain, i divisible)
    through run_chunked(2) vs the oracle — the reference-compat sweep
    extended to out-of-core execution (shrink-BC programs compared with
    halo pruning like the driver)."""
    import glob

    from stencilflow_tpu.backend.xla import chain_halo
    from stencilflow_tpu.data import arrays_are_equal, prune_halo
    from stencilflow_tpu.frontend.analysis import ChainAnalysis
    from stencilflow_tpu.ir import BCKind

    ran = 0
    for path in sorted(glob.glob(os.path.join(REF_STENCILS, "*.json"))):
        p = sft.parse_program(path)
        I = p.dimensions[0]
        analysis = ChainAnalysis.run(p)
        h = chain_halo(analysis)[0]
        if len(p.raw_dimensions) < 3 or I % 2 or h >= I // 2:
            continue
        if p.total_elements > 200_000:
            continue
        inputs = sft.load_input_arrays(p, prefix=REF_STENCILS, seed=0)
        ref = sft.run_interpreter(p, inputs)
        got = run_chunked(p, inputs, 2, analysis=analysis)
        shrink = any(bc.kind == BCKind.SHRINK
                     for k in p.kernels.values()
                     for bc in k.boundary_conditions.values())
        halo = max(chain_halo(analysis)) if shrink else 0
        for o in p.outputs:
            exp = prune_halo(np.asarray(ref[o]), p.raw_dimensions, halo)
            g = prune_halo(got[o], p.raw_dimensions, halo)
            assert arrays_are_equal(exp, g), (path, o)
        ran += 1
    assert ran >= 4, f"only {ran} fixtures were chunkable"


def test_adjoint_program_composes_with_chunking():
    """The transposed (adjoint) chain is itself a dialect program, so it
    runs out-of-core unchanged — backward passes over domains larger
    than HBM."""
    from stencilflow_tpu.grad import adjoint_program
    p = sft.parse_program(jacobi(3, 8, iterations=2), name="ocadj")
    adj, _meta = adjoint_program(p)
    inputs = sft.load_input_arrays(adj, seed=9)
    ref = _oracle(adj, inputs)
    got = run_chunked(adj, inputs, 2)
    for o in adj.outputs:
        np.testing.assert_allclose(got[o], ref[o], rtol=2e-5, atol=1e-6)


def test_cli_host_chunks_bad_count_exits_cleanly(tmp_path):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    prog_path = tmp_path / "p.json"
    prog_path.write_text(json.dumps(jacobi(3, 8, iterations=1)))
    out = subprocess.run(
        [sys.executable, "-m", "stencilflow_tpu.cli", "run",
         str(prog_path), "emulation", "--host-chunks", "3"],
        capture_output=True, text=True, cwd=repo, env=env)
    assert out.returncode == 2
    assert "error:" in out.stderr and "divide" in out.stderr


def test_orbax_checkpoint_resume_host_mode(tmp_path):
    """orbax checkpointing composes with out-of-core stepping: host
    numpy state saves/restores and resume continues bit-identically."""
    import shutil

    from stencilflow_tpu.iterate import iterate
    p = sft.parse_program(jacobi(3, 8, iterations=1), name="ocorbax")
    inputs = sft.load_input_arrays(p, seed=11)
    ck = str(tmp_path / "ck")
    full = iterate(p, inputs, steps=6, host_chunks=2,
                   checkpoint_every=2, checkpoint_dir=ck,
                   checkpoint_format="orbax")
    shutil.rmtree(tmp_path / "ck" / "6")
    resumed = iterate(p, inputs, steps=6, host_chunks=2,
                      checkpoint_every=2, checkpoint_dir=ck,
                      checkpoint_format="orbax")
    np.testing.assert_array_equal(full["a"], resumed["a"])

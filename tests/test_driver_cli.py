"""End-to-end driver + CLI tests (reference: test_stencilflow.py's
ProgramTest, run through our run_program with compare_to_reference)."""
import json
import os

import numpy as np
import pytest

import stencilflow_tpu as sft
from stencilflow_tpu.cli import main as cli_main
from stencilflow_tpu.driver import VerificationError, run_program
from stencilflow_tpu.synthesize import jacobi, synthesize_stencil


@pytest.fixture
def j2d_file(tmp_path):
    spec = jacobi(2, 16, iterations=2)
    path = tmp_path / "jacobi2d.json"
    path.write_text(json.dumps(spec, default=str))
    return str(path)


class TestDriver:
    def test_emulation_with_all_checks(self, j2d_file, tmp_path):
        res = run_program(j2d_file, "emulation", run_simulation=True,
                          compare_to_reference=True,
                          results_base=str(tmp_path / "results"))
        assert res.verified_against_reference
        assert res.verified_against_simulation
        assert res.simulation_cycles > 0
        assert os.path.isfile(
            os.path.join(res.results_dir, "s1.dat"))

    def test_shrink_with_halo(self, tmp_path):
        spec = jacobi(2, 16, iterations=2, boundary="shrink")
        res = run_program(spec, "emulation", compare_to_reference=True,
                          halo=2, save_results=False)
        assert res.verified_against_reference

    @pytest.mark.parametrize("backend,name", [
        ("auto", "xla"), ("xla", "xla"), ("interpreter", "interpreter")])
    def test_backends_through_driver(self, backend, name):
        spec = jacobi(3, 8, iterations=2)
        res = run_program(spec, "emulation", backend=backend,
                          compare_to_reference=True, save_results=False)
        assert res.backend == name
        assert res.verified_against_reference

    @pytest.mark.parametrize("kw,match", [
        ({"backend": "stream"}, "unknown backend"),
        ({"mode": "simulation"}, "unknown mode")])
    def test_unknown_backend_or_mode_raises(self, kw, match):
        with pytest.raises(ValueError, match=match):
            run_program(jacobi(2, 8, iterations=1), save_results=False,
                        **kw)

    def test_hardware_mode_needs_gpu(self):
        """hardware mode never falls back to the CPU."""
        from stencilflow_tpu.device import NoGPUError
        with pytest.raises(NoGPUError, match="no GPU"):
            run_program(jacobi(2, 8, iterations=1), "hardware",
                        save_results=False)

    def test_cli_hardware_mode_exits_2_without_gpu(self, j2d_file,
                                                   capsys):
        assert cli_main(["run", j2d_file, "hardware"]) == 2
        assert "needs a GPU" in capsys.readouterr().err

    def test_skip_execution_returns_sim(self):
        spec = jacobi(2, 8, iterations=1)
        res = run_program(spec, run_simulation=True, skip_execution=True,
                          save_results=False)
        assert res.backend == "simulator"
        assert res.outputs

    def test_mismatch_raises(self, monkeypatch):
        spec = jacobi(2, 8, iterations=1)
        import stencilflow_tpu.driver as drv
        orig = drv.run_interpreter

        def corrupted(program, inputs):
            out = orig(program, inputs)
            return {k: np.asarray(v) + 1.0 for k, v in out.items()}

        monkeypatch.setattr(drv, "run_interpreter", corrupted)
        with pytest.raises(VerificationError):
            run_program(spec, compare_to_reference=True, save_results=False)

    def test_varying_dimensionality_program(self, tmp_path):
        """0d/1d/2d/3d mixed inputs in one kernel (reference:
        varying_dimensionality.json)."""
        rng = np.random.default_rng(0)
        d3 = rng.random((4, 6, 8)).astype(np.float32)
        d2 = rng.random((6, 8)).astype(np.float32)
        d1 = rng.random((8,)).astype(np.float32)
        spec = {
            "inputs": {
                "a3": {"data": d3, "data_type": "float32"},
                "a2": {"data": d2, "data_type": "float32",
                       "input_dims": ["j", "k"]},
                "a1": {"data": d1, "data_type": "float32",
                       "input_dims": ["k"]},
                "a0": {"data": 3.25, "data_type": "float32",
                       "input_dims": []},
            },
            "outputs": ["b"],
            "dimensions": [4, 6, 8],
            "program": {"b": {
                "computation_string":
                    "b = a3[i,j,k] + a2[j,k] + a1[k] + a0",
                "boundary_conditions": {
                    "a3": {"type": "constant", "value": 0.0},
                    "a2": {"type": "constant", "value": 0.0},
                    "a1": {"type": "constant", "value": 0.0}},
                "data_type": "float32"}},
        }
        res = run_program(spec, "emulation", compare_to_reference=True,
                          run_simulation=True, save_results=False)
        assert res.verified_against_reference
        assert res.verified_against_simulation


class TestCLI:
    def test_run_command(self, j2d_file, tmp_path, capsys):
        os.chdir(tmp_path)
        rc = cli_main(["run", j2d_file, "emulation",
                       "--compare-to-reference", "--run-simulation"])
        assert rc == 0
        out = capsys.readouterr().out
        assert "verified against reference: OK" in out
        assert "verified against simulation: OK" in out

    def test_report_json(self, j2d_file, capsys):
        rc = cli_main(["report", j2d_file, "--json"])
        assert rc == 0
        d = json.loads(capsys.readouterr().out)
        assert d["kernels"] == 2

    def test_synthesize_roundtrip(self, tmp_path, capsys):
        out = str(tmp_path / "synth.json")
        rc = cli_main(["synthesize", "-o", out, "--num-stages", "3",
                       "--dimensions", "8", "8", "--shape", "cross",
                       "--fork-frequency", "2"])
        assert rc == 0
        p = sft.parse_program(out)
        assert len(p.kernels) >= 3

    def test_simulate_command(self, j2d_file, capsys):
        rc = cli_main(["simulate", j2d_file])
        assert rc == 0
        assert "cycles:" in capsys.readouterr().out

    def test_partition_command(self, j2d_file, capsys):
        rc = cli_main(["partition", j2d_file, "--devices", "2",
                       "--enumerate-cuts"])
        assert rc == 0
        out = capsys.readouterr().out
        assert "device 0" in out and "device 1" in out

    def test_adjoint_command_roundtrip(self, j2d_file, tmp_path, capsys):
        """cli adjoint emits a dialect program whose run matches the
        adjoint built in-process."""
        out = str(tmp_path / "adj.json")
        rc = cli_main(["adjoint", j2d_file, "-o", out])
        assert rc == 0
        assert "cotangent" in capsys.readouterr().out
        import numpy as np
        from stencilflow_tpu.grad import adjoint_program
        p = sft.parse_program(j2d_file)
        adj_direct, _ = adjoint_program(p)
        p2 = sft.parse_program(out)
        r1 = sft.run_interpreter(adj_direct,
                                 sft.load_input_arrays(adj_direct))
        r2 = sft.run_interpreter(p2, sft.load_input_arrays(p2))
        for k in r1:
            np.testing.assert_array_equal(np.asarray(r1[k]),
                                          np.asarray(r2[k]))

    def test_run_distributed_domain(self, j2d_file, capsys):
        rc = cli_main(["run-distributed", j2d_file, "--devices", "4",
                       "--compare-to-reference"])
        assert rc == 0
        assert "OK" in capsys.readouterr().out

    def test_run_distributed_domain_comm_overlap(self, j2d_file,
                                                  capsys):
        rc = cli_main(["run-distributed", j2d_file, "--devices", "4",
                       "--comm-overlap", "--compare-to-reference"])
        assert rc == 0
        assert "OK" in capsys.readouterr().out

    def test_comm_overlap_rejected_in_pipeline_mode(self, j2d_file,
                                                    capsys):
        rc = cli_main(["run-distributed", j2d_file, "--devices", "2",
                       "--parallel-mode", "pipeline", "--comm-overlap"])
        assert rc == 2
        assert "domain mode only" in capsys.readouterr().err

    def test_run_distributed_pipeline(self, j2d_file, capsys):
        rc = cli_main(["run-distributed", j2d_file, "--devices", "2",
                       "--parallel-mode", "pipeline",
                       "--compare-to-reference"])
        assert rc == 0
        assert "OK" in capsys.readouterr().out


class TestCLIMore:
    def test_compile_command(self, j2d_file, tmp_path, capsys):
        out = str(tmp_path / "art.stablehlo.txt")
        rc = cli_main(["compile", j2d_file, "-o", out])
        assert rc == 0
        text = open(out).read()
        assert "module" in text and len(text) > 1000

    def test_canonicalize_command(self, j2d_file, tmp_path):
        out = str(tmp_path / "canon.json")
        rc = cli_main(["canonicalize", j2d_file, "-o", out])
        assert rc == 0
        p2 = sft.parse_program(out)
        assert len(p2.kernels) == 2

    def test_report_verbose(self, j2d_file, capsys):
        rc = cli_main(["report", j2d_file, "--verbose"])
        assert rc == 0
        out = capsys.readouterr().out
        assert "line-buffer" in out and "critical path" in out
        # the remaining reference report() field set
        # (kernel_chain_graph.py:640-719): input-path delays, buffer
        # total, both kernel-string forms, optimizer placement demo
        assert "input path delays" in out
        assert "total buffer size" in out
        assert "relative:" in out and "[0, " in out
        assert "optimizer demo" in out and "-> fast" in out


class TestOptimizer:
    def test_strategies(self):
        from stencilflow_tpu.optimizer import Optimizer
        p = sft.parse_program(jacobi(3, 16, iterations=4), name="opt")
        opt = Optimizer(p)
        total = opt.fast_bytes()
        assert total > 0 and opt.slow_bytes() == 0

        # reference metric (optimizer.py:130-168): spill while
        # fast_bytes / remaining-candidate comm volume > ratio
        r0 = total / (opt._remaining_comm_volume() + 1e-10)
        opt.optimize_to_ratio(r0 / 2)
        assert opt.slow_bytes() > 0
        assert (opt.fast_bytes()
                <= r0 / 2 * (opt._remaining_comm_volume() + 1e-10))
        opt.optimize_to_ratio(2 * r0)   # already satisfied: no spills
        assert opt.slow_bytes() == 0

        opt.minimize_comm_vol(total // 2, slow_memory_bound=total)
        assert opt.fast_bytes() <= total // 2

        opt.minimize_fast_mem(comm_volume_bound=10**12)
        assert opt.fast_bytes() < total

        opt.reset()
        assert opt.slow_bytes() == 0

    def test_unreachable_bound_raises(self):
        from stencilflow_tpu.optimizer import Optimizer, OptimizerError
        p = sft.parse_program(jacobi(2, 8, iterations=1), name="opt2")
        opt = Optimizer(p)
        with pytest.raises(OptimizerError):
            opt.minimize_comm_vol(0, slow_memory_bound=1)


class TestDriverReviewRegressions:
    def test_prune_halo_rejects_empty_interior(self):
        from stencilflow_tpu.data import prune_halo
        with pytest.raises(ValueError, match="interior"):
            prune_halo(np.zeros((4, 4, 4)), (4, 4, 4), 2)

    def test_run_program_does_not_mutate_caller_program(self, tmp_path):
        from stencilflow_tpu.driver import run_program
        p = sft.parse_program(jacobi(2, 8, iterations=1), name="nomut")
        before = p.inputs["a"].data
        run_program(p, synthetic_reads=True, save_results=False)
        assert p.inputs["a"].data == before

    def test_box_chain_verifies_at_default_tolerance(self):
        """A wide radius-2 box chain through the fused-XLA path verifies
        at config.VERIFY_RTOL.  Positive data keeps outputs away from
        zero (the comparator is relative-only, like the reference's)."""
        from stencilflow_tpu.driver import run_program
        spec = synthesize_stencil(num_stages=2, dimensions=(4, 16, 16),
                                  shape="box", extent=2,
                                  seed_data="random:1,2")
        p = sft.parse_program(spec, name="boxverify")
        res = run_program(p, mode="emulation", compare_to_reference=True,
                          save_results=False)
        assert res.backend == "xla"
        assert res.verified_against_reference

    def test_explicit_tolerance_overrides_default(self, monkeypatch):
        """A 1e-6 relative deviation passes the default 1e-5 and fails an
        explicit tolerance of 1e-7."""
        import stencilflow_tpu.driver as drv
        from stencilflow_tpu.driver import VerificationError, run_program
        spec = synthesize_stencil(num_stages=2, dimensions=(4, 16, 16),
                                  shape="box", extent=2,
                                  seed_data="random:1,2")
        p = sft.parse_program(spec, name="tolverify")
        orig = drv.run_interpreter

        def nudged(program, inputs):
            return {k: np.asarray(v) * (1 + 1e-6)
                    for k, v in orig(program, inputs).items()}

        monkeypatch.setattr(drv, "run_interpreter", nudged)
        res = run_program(p, compare_to_reference=True, save_results=False)
        assert res.verified_against_reference
        with pytest.raises(VerificationError):
            run_program(p, tolerance=1e-7, compare_to_reference=True,
                        save_results=False)

    def test_scalar_file_input_loads_zero_d(self, tmp_path):
        from stencilflow_tpu.data import load_array
        from stencilflow_tpu.ir import InputSpec
        path = tmp_path / "c.dat"
        np.asarray([2.5], dtype=np.float32).tofile(path)
        spec = InputSpec("c", np.dtype(np.float32),
                         (False, False, False), str(path))
        arr = load_array(spec, (4, 4, 4))
        assert arr.ndim == 0 and float(arr) == 2.5
        np.asarray([1.0, 2.0], dtype=np.float32).tofile(path)
        with pytest.raises(ValueError):
            load_array(spec, (4, 4, 4))

    def test_synthesize_validation(self):
        with pytest.raises(ValueError, match="dimensions"):
            synthesize_stencil(shape="hotspot", dimensions=(64,))
        with pytest.raises(ValueError, match="extent"):
            synthesize_stencil(shape="diffusion", extent=3)

    def test_lower_rank_inputs_full_3d_domain(self):
        """A genuine 3-D program whose inputs are all (j,k)-rank must
        evaluate the full i extent through the tile evaluator."""
        spec = {
            "inputs": {"c": {"data": "random:1,2", "data_type": "float32",
                             "input_dims": ["j", "k"]}},
            "outputs": ["s1"],
            "dimensions": [6, 8, 8],
            "program": {
                "s0": {"computation_string": "s0 = c[j,k] * 2.0",
                       "boundary_conditions":
                       {"c": {"type": "constant", "value": 0.0}},
                       "data_type": "float32"},
                "s1": {"computation_string":
                       "s1 = s0[i-1,j,k] + s0[i+1,j,k]",
                       "boundary_conditions":
                       {"s0": {"type": "constant", "value": 0.0}},
                       "data_type": "float32"},
            },
        }
        p = sft.parse_program(spec, name="jkonly")
        inputs = sft.load_input_arrays(p, seed=0)
        ref = np.asarray(sft.run_interpreter(p, inputs)["s1"])
        assert ref.shape == (6, 8, 8)
        from stencilflow_tpu.backend.xla import run_chain
        got = run_chain(p, inputs)["s1"]
        np.testing.assert_allclose(got, ref, rtol=2e-5, atol=1e-6)

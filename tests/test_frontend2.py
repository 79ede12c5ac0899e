"""Frontend #2 tests: canonicalization passes and the traced-Python
importer (the reference's sdfg_to_stencilflow roles,
sdfg_to_stencilflow.py:267-332,522-767)."""
import os

import numpy as np
import pytest

import stencilflow_tpu as sft
from stencilflow_tpu import ir
from stencilflow_tpu.frontend.canonicalize import (
    canonicalize, predicate_min_max, remove_dead_kernels,
    specialize_constants, version_program)
from stencilflow_tpu.frontend.parser import parse_computation, parse_program
from stencilflow_tpu.frontend.trace import (TraceError, maximum,
                                            trace_program)


def _kernel(name, computation, fields, dtype="float32", bc_value=0.0):
    masks = {f: (True, True, True) for f in fields}
    stmts = parse_computation(name, computation, masks, {}, {})
    bcs = {f: ir.BoundaryCondition(ir.BCKind.CONSTANT, bc_value)
           for f in fields}
    return ir.KernelSpec(name, stmts, np.dtype(dtype), bcs, computation)


class TestVersioning:
    def test_iterative_updates_get_versions(self):
        """b = f(a); b = f(b); b = f(b) — SSA-ize like the reference's
        importer (__1-style, last write keeps the name)."""
        ops = [
            ("b", _kernel("b", "b = a[i,j,k] + 1.0", ["a"])),
            ("b", _kernel("b", "b = b[i,j,k] * 2.0", ["b"])),
            ("b", _kernel("b", "b = b[i,j,k-1] + b[i,j,k]", ["b"])),
        ]
        kernels = version_program(ops, outputs=["b"])
        assert list(kernels) == ["b__1", "b__2", "b"]
        # middle version reads the first
        reads = kernels["b__2"].accesses()
        assert list(reads) == ["b__1"]
        assert list(kernels["b"].accesses()) == ["b__2"]

    def test_runs_end_to_end(self):
        rng = np.random.default_rng(0)
        a = rng.random((4, 8)).astype(np.float32)
        ops = [
            ("b", _kernel("b", "b = a[j,k] + 1.0", ["a"])),
            ("b", _kernel("b", "b = b[j,k] * 2.0", ["b"])),
        ]
        kernels = version_program(
            [(t, _pad2d(k)) for t, k in ops], outputs=["b"])
        program = ir.Program(
            name="ver", dimensions=(1, 4, 8), raw_dimensions=(4, 8),
            inputs={"a": ir.InputSpec("a", np.dtype(np.float32),
                                      (False, True, True), a)},
            outputs=["b"], kernels=kernels)
        out = sft.run_interpreter(program, {"a": a})["b"]
        np.testing.assert_allclose(out, (a + 1.0) * 2.0, rtol=1e-6)


def _pad2d(kspec):
    """Re-parse a 2-D kernel with j,k masks (helper for version tests)."""
    masks = {f: (False, True, True) for f in kspec.accesses()}
    masks.update({kspec.name: (False, True, True)})
    stmts = parse_computation(kspec.name, kspec.source,
                              {f: (False, True, True)
                               for f in list(kspec.boundary_conditions) +
                               [kspec.name, "b"]}, {}, {})
    return ir.KernelSpec(kspec.name, stmts, kspec.dtype,
                         kspec.boundary_conditions, kspec.source)


class TestPasses:
    def _program(self):
        return sft.parse_program({
            "inputs": {"a": {"data": "constant:2.0",
                             "data_type": "float32"},
                       "c": {"data": 3.0, "data_type": "float32",
                             "input_dims": []}},
            "outputs": ["out"],
            "dimensions": [4, 4],
            "program": {
                "dead": {"computation_string": "dead = a[j,k] * 5.0",
                         "boundary_conditions": {
                             "a": {"type": "constant", "value": 0}},
                         "data_type": "float32"},
                "out": {"computation_string":
                        "out = max(a[j,k], c) + min(a[j,k-1], 1.0)",
                        "boundary_conditions": {
                            "a": {"type": "constant", "value": 0}},
                        "data_type": "float32"},
            },
        }, name="passes")

    def test_remove_dead(self):
        p = remove_dead_kernels(self._program())
        assert "dead" not in p.kernels and "out" in p.kernels

    def test_specialize_constants(self):
        p = specialize_constants(self._program())
        assert "c" not in p.inputs
        consts = [n for k in p.kernels.values() for s in k.statements
                  for n in ir.walk(s.rhs) if isinstance(n, ir.Const)]
        assert any(c.value == 3.0 for c in consts)

    def test_predicate_min_max_preserves_semantics(self):
        p0 = self._program()
        p1 = predicate_min_max(p0)
        sel = [n for k in p1.kernels.values() for s in k.statements
               for n in ir.walk(s.rhs) if isinstance(n, ir.Select)]
        assert len(sel) >= 2
        inputs = sft.load_input_arrays(p0)
        o0 = sft.run_interpreter(p0, inputs)["out"]
        o1 = sft.run_interpreter(p1, inputs)["out"]
        np.testing.assert_array_equal(np.asarray(o0), np.asarray(o1))

    def test_canonicalize_pipeline(self):
        p = canonicalize(self._program(), min_max_to_select=True)
        assert "dead" not in p.kernels


class TestTracedFrontend:
    def test_jacobi2d_chain_matches_json(self):
        rng = np.random.default_rng(1)
        a = rng.random((16, 16)).astype(np.float32)

        def model(av):
            b = 0.25 * (av[0, -1, 0] + av[0, 1, 0] +
                        av[0, 0, -1] + av[0, 0, 1])
            c = 0.25 * (b[0, -1, 0] + b[0, 1, 0] +
                        b[0, 0, -1] + b[0, 0, 1])
            return {"c": c}

        p = trace_program(model, dimensions=(16, 16),
                          inputs={"a": np.float32}, name="tj2")
        out = sft.run_interpreter(p, {"a": a})["c"]

        json_p = sft.parse_program(
            sft_jacobi_dict(), name="jj2")
        ref = sft.run_interpreter(json_p, {"a": a})["s1"]
        np.testing.assert_allclose(out, np.asarray(ref), rtol=1e-6)

    def test_scalar_and_lower_dim_inputs(self):
        rng = np.random.default_rng(2)
        a = rng.random((4, 8)).astype(np.float32)
        row = rng.random((8,)).astype(np.float32)

        def model(av, rv, cv):
            u = av[0, 0, 1] * cv + rv[0, 0, 0]
            return {"u": u}

        p = trace_program(
            model, dimensions=(4, 8),
            inputs={"a": np.float32,
                    "row": {"dtype": np.float32, "dims": ["k"]},
                    "c": {"dtype": np.float32, "dims": []}},
            name="lowdim")
        out = np.asarray(sft.run_interpreter(
            p, {"a": a, "row": row, "c": np.float32(2.0)})["u"])
        expected = np.zeros_like(a)
        expected[:, :-1] = a[:, 1:] * 2.0
        expected += row
        np.testing.assert_allclose(out, expected, rtol=1e-6)

    def test_predicates_and_calls(self):
        a = np.linspace(0, 1, 64, dtype=np.float32).reshape(8, 8)

        def model(av):
            center = av[0, 0, 0]
            return {"o": (center > 0.5).where(maximum(center, 0.75),
                                              -center)}

        p = trace_program(model, dimensions=(8, 8),
                          inputs={"a": np.float32})
        out = np.asarray(sft.run_interpreter(p, {"a": a})["o"])
        exp = np.where(a > 0.5, np.maximum(a, 0.75), -a)
        np.testing.assert_allclose(out, exp, rtol=1e-6)

    def test_offset_on_unspanned_dim_raises(self):
        def model(rv):
            return {"o": rv[0, 1, 0]}

        with pytest.raises(TraceError):
            trace_program(model, dimensions=(4, 4),
                          inputs={"row": {"dtype": np.float32,
                                          "dims": ["k"]}})

    def test_traced_program_runs_on_backends(self):
        rng = np.random.default_rng(3)
        a = rng.random((8, 8, 8)).astype(np.float32)

        def model(av):
            b = (av[-1, 0, 0] + av[1, 0, 0] + av[0, 0, 0]) / 3.0
            return {"b": b}

        p = trace_program(model, dimensions=(8, 8, 8),
                          inputs={"a": np.float32})
        from stencilflow_tpu.backend.xla import run_chain
        ref = np.asarray(sft.run_interpreter(p, {"a": a})["b"])
        out = run_chain(p, {"a": a})["b"]
        np.testing.assert_allclose(out, ref, rtol=1e-6)
        from stencilflow_tpu.sim import simulate
        res = simulate(p, {"a": a})
        np.testing.assert_array_equal(res.outputs["b"], ref)


class TestExport:
    def test_roundtrip_json_fixture(self):
        """parse -> export -> parse reproduces identical results."""
        from stencilflow_tpu.frontend.export import program_to_json
        spec = sft_jacobi_dict()
        p = sft.parse_program(spec, name="rt")
        inputs = sft.load_input_arrays(p, seed=1)
        ref = sft.run_interpreter(p, inputs)
        p2 = sft.parse_program(program_to_json(p), name="rt2")
        out = sft.run_interpreter(p2, inputs)
        np.testing.assert_array_equal(np.asarray(ref["s1"]),
                                      np.asarray(out["s1"]))

    def test_traced_program_exports(self):
        from stencilflow_tpu.frontend.export import program_to_json
        rng = np.random.default_rng(4)
        a = rng.random((8, 8)).astype(np.float32)

        def model(av):
            b = 0.25 * (av[0, -1, 0] + av[0, 1, 0] +
                        av[0, 0, -1] + av[0, 0, 1])
            return {"b": b}

        p = trace_program(model, dimensions=(8, 8),
                          inputs={"a": np.float32}, name="texp")
        spec = program_to_json(p)
        p2 = sft.parse_program(spec, name="texp2")
        ref = sft.run_interpreter(p, {"a": a})["b"]
        out = sft.run_interpreter(p2, {"a": a})["b"]
        np.testing.assert_array_equal(np.asarray(ref), np.asarray(out))

    def test_multistatement_and_ternary_roundtrip(self):
        from stencilflow_tpu.frontend.export import program_to_json
        rng = np.random.default_rng(5)
        a = rng.random((6, 6)).astype(np.float32)
        p = sft.parse_program({
            "inputs": {"a": {"data": a, "data_type": "float32"}},
            "outputs": ["b"], "dimensions": [6, 6],
            "program": {"b": {
                "computation_string":
                    "t = a[j,k] * 2.0; b = t if a[j,k-1] > 0.5 "
                    "else min(t, 0.25)",
                "boundary_conditions": {
                    "a": {"type": "copy", "value": 0.0}},
                "data_type": "float32"}},
        }, name="ms")
        p2 = sft.parse_program(program_to_json(p), name="ms2")
        ref = sft.run_interpreter(p, {"a": a})["b"]
        out = sft.run_interpreter(p2, {"a": a})["b"]
        np.testing.assert_array_equal(np.asarray(ref), np.asarray(out))


def sft_jacobi_dict():
    from stencilflow_tpu.synthesize import jacobi
    return jacobi(2, 16, iterations=2)


class TestOpListFrontend:
    """program_from_op_list drives version_program (VERDICT r1 #7): a
    COSMO-style op list with repeated writes enters the dialect."""

    OPS = [
        ("lap", "lap = a[i,j-1,k] + a[i,j+1,k] + a[i,j,k-1] + "
                "a[i,j,k+1] - 4.0*a[i,j,k]",
         {"a": {"type": "constant", "value": 0.0}}),
        ("b", "b = a[i,j,k] + 0.1 * lap[i,j,k]", {}),
        ("b", "b = b[i,j,k] + 0.1 * (b[i,j-1,k] + b[i,j+1,k] "
              "- 2.0*b[i,j,k])",
         {"b": {"type": "constant", "value": 0.0}}),
        ("b", "b = b[i,j,k] * 0.5 + lap[i,j,k+1] * 0.25",
         {"lap": {"type": "constant", "value": 0.0}}),
    ]
    INPUTS = {"a": {"data": "random:-1,1", "data_type": "float32"}}

    def _program(self, name="oplist1"):
        return sft.program_from_op_list(self.OPS, (4, 8, 8), self.INPUTS,
                                        outputs=["b"], name=name)

    def test_ssa_versioning_and_oracle(self):
        p = self._program()
        assert list(p.kernels) == ["lap", "b__1", "b__2", "b"]
        ins = sft.load_input_arrays(p, seed=0)
        out = sft.run_interpreter(p, ins)
        # equivalent hand-written SSA program
        spec = {
            "inputs": self.INPUTS, "outputs": ["b"],
            "dimensions": [4, 8, 8],
            "program": {
                "lap": {"computation_string": self.OPS[0][1],
                        "boundary_conditions": self.OPS[0][2],
                        "data_type": "float32"},
                "v1": {"computation_string":
                       "v1 = a[i,j,k] + 0.1 * lap[i,j,k]",
                       "boundary_conditions": {}, "data_type": "float32"},
                "v2": {"computation_string":
                       "v2 = v1[i,j,k] + 0.1 * (v1[i,j-1,k] + "
                       "v1[i,j+1,k] - 2.0*v1[i,j,k])",
                       "boundary_conditions": {
                           "v1": {"type": "constant", "value": 0.0}},
                       "data_type": "float32"},
                "b": {"computation_string":
                      "b = v2[i,j,k] * 0.5 + lap[i,j,k+1] * 0.25",
                      "boundary_conditions": {
                          "lap": {"type": "constant", "value": 0.0}},
                      "data_type": "float32"}}}
        p2 = sft.parse_program(spec, name="handssa")
        out2 = sft.run_interpreter(p2, sft.load_input_arrays(p2, seed=0))
        np.testing.assert_array_equal(np.asarray(out["b"]),
                                      np.asarray(out2["b"]))

    def test_round_trip_through_cli_canonicalize(self, tmp_path):
        import json
        import subprocess
        import sys

        p = self._program("oplist_rt")
        ins = sft.load_input_arrays(p, seed=0)
        ref = sft.run_interpreter(p, ins)
        src = tmp_path / "oplist.json"
        dst = tmp_path / "canon.json"
        src.write_text(json.dumps(sft.program_to_json(p)))
        r = subprocess.run(
            [sys.executable, "-m", "stencilflow_tpu.cli", "canonicalize",
             str(src), "-o", str(dst)],
            capture_output=True, text=True,
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(
                __file__))),
            env={**os.environ, "JAX_PLATFORMS": "cpu"})
        assert r.returncode == 0, r.stderr
        p3 = sft.parse_program(str(dst))
        out3 = sft.run_interpreter(p3, sft.load_input_arrays(p3, seed=0))
        np.testing.assert_array_equal(np.asarray(ref["b"]),
                                      np.asarray(out3["b"]))

    def test_backends_accept_oplist_program(self):
        from stencilflow_tpu.backend.xla import run_chain
        from stencilflow_tpu.sim.native import NativeSimulator
        p = self._program("oplist_be")
        ins = sft.load_input_arrays(p, seed=0)
        ref = sft.run_interpreter(p, ins)
        got = run_chain(p, ins)
        np.testing.assert_allclose(np.asarray(got["b"]),
                                   np.asarray(ref["b"]),
                                   rtol=3e-6, atol=1e-7)
        sim = NativeSimulator(p).run(ins)
        np.testing.assert_allclose(sim.outputs["b"], np.asarray(ref["b"]),
                                   rtol=3e-6, atol=1e-7)

    def test_rejections(self):
        with pytest.raises(ValueError, match="collide with input"):
            sft.program_from_op_list(
                [("a", "a = a[i,j,k] + 1.0", {})], (4, 8, 8),
                self.INPUTS, outputs=["a"])
        with pytest.raises(ValueError, match="never written"):
            sft.program_from_op_list(self.OPS, (4, 8, 8), self.INPUTS,
                                     outputs=["zzz"])


class TestNestDimension:
    """nest_dimension = the reference's NestK (stencil/nestk.py:41-176):
    collapse a vertical loop of 2-D stencils into the 3-D domain."""

    def test_per_level_equivalence(self):
        from stencilflow_tpu.synthesize import jacobi
        p2 = sft.parse_program(jacobi(2, 16, iterations=2), name="nk")
        p3 = sft.nest_dimension(p2, extent=6)
        assert p3.dimensions == (6, 16, 16)
        assert p3.raw_dimensions == (6, 16, 16)
        rng = np.random.default_rng(0)
        stack = rng.random((6, 16, 16)).astype(np.float32)
        out3 = sft.run_interpreter(p3, {"a": stack})
        o = p3.outputs[0]
        per = np.stack([
            np.asarray(sft.run_interpreter(p2, {"a": stack[i]})[o])
            for i in range(6)])
        np.testing.assert_array_equal(per, np.asarray(out3[o]))

    def test_loop_invariant_inputs_stay_broadcast(self):
        p2 = sft.parse_program({
            "inputs": {"a": {"data": "random:0,1", "data_type": "float32"},
                       "w": {"data": "random:0,1",
                             "data_type": "float32"}},
            "outputs": ["b"], "dimensions": [12, 12],
            "program": {"b": {
                "computation_string": "b = a[j-1,k]*w[j,k] + a[j,k+1]",
                "boundary_conditions": {
                    "a": {"type": "constant", "value": 0.5},
                    "w": {"type": "constant", "value": 0.0}},
                "data_type": "float32"}}}, name="nk2")
        p3 = sft.nest_dimension(p2, 4, inputs_spanning=["a"])
        assert p3.inputs["a"].dim_mask == (True, True, True)
        assert p3.inputs["w"].dim_mask == (False, True, True)
        rng = np.random.default_rng(1)
        a4 = rng.random((4, 12, 12)).astype(np.float32)
        w = rng.random((12, 12)).astype(np.float32)
        out = sft.run_interpreter(p3, {"a": a4, "w": w})
        per = np.stack([
            np.asarray(sft.run_interpreter(p2, {"a": a4[i], "w": w})["b"])
            for i in range(4)])
        np.testing.assert_array_equal(per, np.asarray(out["b"]))

    def test_rejections(self):
        from stencilflow_tpu.synthesize import jacobi
        p3 = sft.parse_program(jacobi(3, 8, iterations=1), name="nk3")
        with pytest.raises(ValueError, match="2-D program"):
            sft.nest_dimension(p3, 4)
        p2 = sft.parse_program(jacobi(2, 8, iterations=1), name="nk4")
        with pytest.raises(ValueError, match="unknown input"):
            sft.nest_dimension(p2, 4, inputs_spanning=["zzz"])


class TestFrontendReviewRegressions:
    """Round-2 review: loud failures instead of silent mistraces."""

    def test_traced_truthiness_raises(self):
        from stencilflow_tpu.frontend.trace import TraceError, trace_program

        def bad(a):
            x = a[0, 0, 1]
            return x if (a[0, 0, 0] > x) else a[0, 0, 0]  # py control flow

        with pytest.raises(TraceError, match="control flow"):
            trace_program(bad, dimensions=(4, 4), inputs={"a": np.float32})

        def bad_min(a):
            return min(a[0, 0, 0], a[0, 0, 1])   # builtin min calls bool()

        with pytest.raises(TraceError, match="control flow"):
            trace_program(bad_min, dimensions=(4, 4),
                          inputs={"a": np.float32})

    def test_traced_output_name_collisions(self):
        from stencilflow_tpu.frontend.trace import TraceError, trace_program

        def shadows_input(a):
            return {"a": a[0, 0, 0] * 2.0}

        with pytest.raises(TraceError, match="collides"):
            trace_program(shadows_input, dimensions=(4, 4),
                          inputs={"a": np.float32})

    def test_traced_dimensions_rank_checked(self):
        from stencilflow_tpu.frontend.trace import TraceError, trace_program
        with pytest.raises(TraceError, match="1-3"):
            trace_program(lambda a: a[0, 0, 0] + 1.0,
                          dimensions=(2, 4, 4, 4),
                          inputs={"a": np.float32})

    def test_offset_read_of_temporary_rejected(self):
        from stencilflow_tpu.frontend.parser import StencilSyntaxError
        spec = {
            "inputs": {"a": {"data": "constant:1.0",
                             "data_type": "float32"}},
            "outputs": ["o"],
            "dimensions": [4, 4, 4],
            "program": {"o": {
                "computation_string":
                    "t = a[i,j,k] * 2.0; o = t[i, j+1, k]",
                "boundary_conditions":
                {"a": {"type": "constant", "value": 0.0}},
                "data_type": "float32"}},
        }
        with pytest.raises(StencilSyntaxError, match="temporar"):
            sft.parse_program(spec, name="offtmp")
        # center subscript of a temporary == its bare-name value
        spec["program"]["o"]["computation_string"] = \
            "t = a[i,j,k] * 2.0; o = t[i, j, k] + t"
        p = sft.parse_program(spec, name="ctrtmp")
        out = sft.run_interpreter(p, sft.load_input_arrays(p, seed=0))
        np.testing.assert_allclose(np.asarray(out["o"]), 4.0)

    def test_typoed_iterator_in_offset_form_rejected(self):
        from stencilflow_tpu.frontend.parser import StencilSyntaxError
        spec = {
            "inputs": {"a": {"data": "constant:1.0",
                             "data_type": "float32"}},
            "outputs": ["o"],
            "dimensions": [4, 4, 4],
            "program": {"o": {
                "computation_string": "o = a[ii+1, j, k]",
                "boundary_conditions":
                {"a": {"type": "constant", "value": 0.0}},
                "data_type": "float32"}},
        }
        with pytest.raises(StencilSyntaxError, match="iterator"):
            sft.parse_program(spec, name="typo")
        spec["program"]["o"]["computation_string"] = "o = a[i+1.5, j, k]"
        with pytest.raises(StencilSyntaxError, match="integer"):
            sft.parse_program(spec, name="floatoff")

    def test_op_list_read_before_write_rejected(self):
        from stencilflow_tpu.frontend.canonicalize import program_from_op_list
        inputs = {"inp": {"data": "constant:1.0", "data_type": "float32"}}
        with pytest.raises(ValueError, match="before any write"):
            program_from_op_list(
                [("a", "a = b[i,j,k] * 2.0",
                  {"b": {"type": "constant", "value": 0.0}}),
                 ("b", "b = inp[i,j,k]",
                  {"inp": {"type": "constant", "value": 0.0}})],
                inputs=inputs, outputs=["a"], dimensions=[4, 4, 4],
                name="rbw")
        with pytest.raises(ValueError, match="before any write"):
            program_from_op_list(
                [("a", "a = missing[i,j,k]",
                  {"missing": {"type": "constant", "value": 0.0}})],
                inputs=inputs, outputs=["a"], dimensions=[4, 4, 4],
                name="missingread")
        with pytest.raises(ValueError, match="vectorization"):
            program_from_op_list(
                [("a", "a = inp[i,j,k]",
                  {"inp": {"type": "constant", "value": 0.0}})],
                inputs=inputs, outputs=["a"], dimensions=[4, 4, 10],
                vectorization=3, name="badvec")

    def test_specialize_constants_collision_rejected(self):
        from stencilflow_tpu.frontend.canonicalize import specialize_constants
        spec = {
            "inputs": {"c": {"data": "constant:1.0",
                             "data_type": "float32"}},
            "outputs": ["o"],
            "dimensions": [4, 4, 4],
            "constants": {"c": 3.0},
            "program": {"o": {
                "computation_string": "o = c[i, j+1, k]",
                "boundary_conditions":
                {"c": {"type": "constant", "value": 0.0}},
                "data_type": "float32"}},
        }
        p = sft.parse_program(spec, name="cclash")
        with pytest.raises(ValueError, match="collide"):
            specialize_constants(p)


class TestFinalReviewRegressions:
    def test_access_to_later_assigned_name_is_validated(self):
        """An Access naming a later-assigned lhs is a real field read:
        it must surface in accesses() so _validate rejects the undefined
        field (previously silently hidden)."""
        spec = {
            "inputs": {"a": {"data": "constant:1.0",
                             "data_type": "float32"}},
            "outputs": ["c"],
            "dimensions": [4, 4, 4],
            "program": {"c": {
                "computation_string": "c = t[i,j,k] + 1.0; t = 0.0",
                "boundary_conditions":
                {"a": {"type": "constant", "value": 0.0}},
                "data_type": "float32"}},
        }
        with pytest.raises(ValueError, match="undefined field 't'"):
            sft.parse_program(spec, name="fwdread")

    def test_export_rebases_relative_data_paths(self, tmp_path):
        """Exported programs must load their file-backed inputs from any
        cwd: relative paths are rebased against the source program's
        directory."""
        import json as _json

        data = np.arange(8, dtype=np.float32)
        (tmp_path / "a.dat").write_bytes(data.tobytes())
        prog = {
            "inputs": {"a": {"data": "a.dat", "data_type": "float32",
                             "input_dims": ["k"]}},
            "outputs": ["o"],
            "dimensions": [4, 4, 8],
            "program": {"o": {
                "computation_string": "o = a[k] * 2.0",
                "boundary_conditions":
                {"a": {"type": "constant", "value": 0.0}},
                "data_type": "float32"}},
        }
        src = tmp_path / "p.json"
        src.write_text(_json.dumps(prog))
        p = sft.parse_program(str(src))
        out = sft.program_to_json(p, embed_data=False)
        assert os.path.isabs(out["inputs"]["a"]["data"])
        # the exported JSON loads from a DIFFERENT directory
        dst = tmp_path / "sub" / "exported.json"
        dst.parent.mkdir()
        dst.write_text(_json.dumps(out, default=str))
        p2 = sft.parse_program(str(dst))
        arrs = sft.load_input_arrays(p2)
        np.testing.assert_array_equal(arrs["a"], data)

    def test_bounded_queue_reference_order(self):
        """Dequeue/import/export order mirrors the reference layout
        exactly (enqueue appendleft / dequeue pop-right)."""
        from stencilflow_tpu.sim.bounded_queue import BoundedQueue
        q = BoundedQueue("q", 5, [1, 2, 3])
        assert q.dequeue() == 3          # data[-1] leaves first
        q2 = BoundedQueue("q2", 3, [4, 5])
        assert q2.export_data() == [5, 4]
        assert q2.try_peek_last() == 5

    def test_parse_mesh_rejects_zero(self, capsys):
        from stencilflow_tpu.cli import _parse_mesh
        assert _parse_mesh("x=0,y=2") is None
        assert _parse_mesh("x=2,y=2") == {"x": 2, "y": 2}

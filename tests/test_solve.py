"""Matrix-free Krylov solvers (solve.py): the chain as a linear operator.

CG on an SPD implicit-diffusion operator and CGNR (via the transposed
chain) on a nonsymmetric upwind operator, checked against dense numpy
solves; the affine offset (nonzero boundary constants, extra source
inputs) moves to the right-hand side so the returned x satisfies the
PROGRAM's equation fn(x) = rhs; non-affine programs are rejected.
"""
import itertools

import numpy as np
import pytest

import stencilflow_tpu as sft
from stencilflow_tpu.solve import make_solver, solve_cg, solve_cgnr

N, DT = 10, 0.3


def _implicit_program(bc_value=0.0, source=False):
    inputs = {"x": {"data": "constant:0.0", "data_type": "float32"}}
    extra = ""
    if source:
        inputs["s"] = {"data": "random:0,1", "data_type": "float32"}
        extra = " + 0.1 * s[j, k]"
    return sft.parse_program({
        "inputs": inputs,
        "outputs": ["y"], "dimensions": [N, N],
        "program": {"y": {
            "computation_string":
                f"y = x[j, k] - {DT} * (x[j-1, k] + x[j+1, k] + "
                f"x[j, k-1] + x[j, k+1] - 4.0 * x[j, k]){extra}",
            "boundary_conditions": {
                f: {"type": "constant", "value": bc_value}
                for f in inputs},
            "data_type": "float32"}}},
        name=f"impl_{bc_value}_{source}")


def _dense_operator():
    A = np.zeros((N * N, N * N), np.float32)
    for j, k in itertools.product(range(N), range(N)):
        r = j * N + k
        A[r, r] = 1 + 4 * DT
        for dj, dk in ((-1, 0), (1, 0), (0, -1), (0, 1)):
            jj, kk = j + dj, k + dk
            if 0 <= jj < N and 0 <= kk < N:
                A[r, jj * N + kk] = -DT
    return A


@pytest.mark.parametrize("bc_value,source", [(0.0, False), (2.5, False),
                                             (0.0, True)])
def test_cg_solves_the_program_equation(bc_value, source):
    """fn(x) == rhs exactly: boundary constants and extra source inputs
    fold into the affine offset and move to the right-hand side."""
    p = _implicit_program(bc_value, source)
    b = np.random.default_rng(0).random((N, N)).astype(np.float32)
    x, info = solve_cg(p, b, tol=1e-6)
    assert info["iterations"] < 100
    assert info["residual"] < 1e-5
    # the program's own evaluation of x reproduces rhs
    inputs = {**sft.load_input_arrays(p), "x": np.asarray(x)}
    y = np.asarray(sft.run_interpreter(p, inputs)["y"])
    np.testing.assert_allclose(y, b, rtol=2e-4, atol=2e-5)
    # dense cross-check: A x = b - c
    zero_in = {**sft.load_input_arrays(p), "x": np.zeros((N, N),
                                                         np.float32)}
    c = np.asarray(sft.run_interpreter(p, zero_in)["y"])
    x_ref = np.linalg.solve(_dense_operator(),
                            (b - c).ravel()).reshape(N, N)
    np.testing.assert_allclose(np.asarray(x), x_ref, rtol=2e-4,
                               atol=3e-5)


def test_residual_normalized_by_original_rhs():
    """info['residual'] must be |fn(x)-rhs|/|rhs| — normalized by the
    ORIGINAL rhs even with a large affine offset (bias + nonzero BCs),
    where |rhs - offset| can differ from |rhs| by a large factor."""
    p = _implicit_program(bc_value=2.0, source=True)
    rhs = np.full((N, N), 5.0, np.float32)
    x, info = solve_cg(p, rhs, tol=1e-8, maxiter=500)
    inputs = {**sft.load_input_arrays(p), "x": np.asarray(x)}
    y = np.asarray(sft.run_interpreter(p, inputs)["y"])
    true_rel = np.linalg.norm(y - rhs) / np.linalg.norm(rhs)
    assert info["residual"] == pytest.approx(true_rel, rel=0.05, abs=1e-7)


def test_cgnr_nonsymmetric():
    p = sft.parse_program({
        "inputs": {"x": {"data": "constant:0.0", "data_type": "float32"}},
        "outputs": ["y"], "dimensions": [N, N],
        "program": {"y": {
            "computation_string":
                "y = x[j, k] - 0.4 * (x[j, k] - x[j, k-1])",
            "boundary_conditions": {
                "x": {"type": "constant", "value": 0.0}},
            "data_type": "float32"}}}, name="upwind")
    b = np.random.default_rng(1).random((N, N)).astype(np.float32)
    x, info = solve_cgnr(p, b, tol=1e-6, maxiter=3000)
    assert info["residual"] < 1e-4   # TRUE residual |Ax-b|/|b|
    A = np.eye(N * N, dtype=np.float32) * 0.6
    for j, k in itertools.product(range(N), range(N)):
        if k > 0:
            A[j * N + k, j * N + k - 1] = 0.4
    x_ref = np.linalg.solve(A, b.ravel()).reshape(N, N)
    np.testing.assert_allclose(np.asarray(x), x_ref, rtol=1e-3,
                               atol=1e-3)


def test_make_solver_reuse_time_stepping():
    """One compiled solver drives many implicit time steps; diffusion
    with zero BCs decays monotonically."""
    p = _implicit_program()
    solver = make_solver(p, tol=1e-6)
    state = np.random.default_rng(2).random((N, N)).astype(np.float32)
    norms = [float(np.linalg.norm(state))]
    for _ in range(3):
        state, info = solver(state)
        assert info["residual"] < 1e-5
        norms.append(float(np.linalg.norm(np.asarray(state))))
    assert norms[0] > norms[1] > norms[2] > norms[3]


def test_rejections():
    from stencilflow_tpu.synthesize import synthesize_stencil
    p = sft.parse_program(
        synthesize_stencil(num_stages=1, dimensions=(4, 8, 8),
                           shape="hdiff"), name="slv_nl")
    with pytest.raises(ValueError, match="not affine"):
        solve_cg(p, np.zeros((4, 8, 8), np.float32), field="a")
    p2 = _implicit_program()
    with pytest.raises(ValueError, match="unknown method"):
        make_solver(p2, method="qmr")


class TestOutOfCoreSolver:
    @staticmethod
    def _impl3d(nonsym=False):
        if nonsym:
            comp = ("y = x[i,j,k] - 0.1 * (x[i-1,j,k] + x[i,j-1,k] "
                    "- 2.0 * x[i,j,k])")
        else:
            comp = ("y = x[i,j,k] - 0.05 * (x[i-1,j,k] + x[i+1,j,k] + "
                    "x[i,j-1,k] + x[i,j+1,k] + x[i,j,k-1] + x[i,j,k+1] "
                    "- 6.0 * x[i,j,k])")
        return sft.parse_program({
            "inputs": {"x": {"data": "constant:0.0",
                             "data_type": "float32"}},
            "outputs": ["y"], "dimensions": [8, 8, 8],
            "program": {"y": {
                "computation_string": comp,
                "boundary_conditions":
                {"x": {"type": "constant", "value": 0.0}},
                "data_type": "float32"}}},
            name=f"oc_impl_{nonsym}")

    def test_cg_host_chunks_matches_in_core(self):
        """Implicit diffusion solved out-of-core (chunked operator, host
        CG) matches the in-core device solver and satisfies fn(x)=rhs."""
        p = self._impl3d()
        rng = np.random.default_rng(7)
        rhs = rng.random((8, 8, 8)).astype(np.float32)
        x_dev, info_dev = make_solver(p, tol=1e-6)(rhs)
        x_oc, info_oc = make_solver(p, tol=1e-6,
                                    host_chunks=2)(rhs)
        assert isinstance(x_oc, np.ndarray)
        assert info_oc["residual"] <= 2e-5
        np.testing.assert_allclose(x_oc, np.asarray(x_dev), rtol=1e-4,
                                   atol=1e-6)
        # the returned x satisfies the PROGRAM's equation
        got = sft.run_interpreter(p, {"x": x_oc})
        np.testing.assert_allclose(np.asarray(got["y"]), rhs,
                                   rtol=1e-4, atol=1e-5)

    def test_cgnr_host_chunks(self):
        """Non-symmetric affine chain out-of-core via CGNR (chunked
        forward AND adjoint operators)."""
        p = self._impl3d(nonsym=True)
        rng = np.random.default_rng(8)
        rhs = rng.random((8, 8, 8)).astype(np.float32)
        x, info = make_solver(p, method="cgnr", 
                              tol=1e-8, maxiter=4000, host_chunks=2)(rhs)
        assert info["residual"] <= 1e-4
        got = sft.run_interpreter(p, {"x": x})
        np.testing.assert_allclose(np.asarray(got["y"]), rhs,
                                   rtol=1e-3, atol=1e-4)


def test_cli_solve(tmp_path):
    import json
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    prog = {
        "inputs": {"x": {"data": "constant:0.0", "data_type": "float32"}},
        "outputs": ["y"],
        "dimensions": [8, 8, 8],
        "program": {"y": {
            "computation_string":
                "y = x[i,j,k] - 0.05*(x[i-1,j,k]+x[i+1,j,k]+x[i,j-1,k]"
                "+x[i,j+1,k]+x[i,j,k-1]+x[i,j,k+1]-6.0*x[i,j,k])",
            "boundary_conditions":
            {"x": {"type": "constant", "value": 0.0}},
            "data_type": "float32"}},
    }
    path = tmp_path / "p.json"
    path.write_text(json.dumps(prog))
    out = subprocess.run(
        [sys.executable, "-m", "stencilflow_tpu.cli", "solve", str(path),
         "--rhs", "random:0,1", "--host-chunks", "2",
         "-o", str(tmp_path / "x.dat")],
        capture_output=True, text=True, cwd=repo, env=env)
    assert out.returncode == 0, out.stderr
    assert "converged" in out.stdout
    x = np.fromfile(tmp_path / "x.dat", np.float32).reshape(8, 8, 8)
    assert np.isfinite(x).all()

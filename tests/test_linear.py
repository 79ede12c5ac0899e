"""Affine-stencil extraction (backend/linear.py), which the adjoint
builder and the Krylov solvers rely on."""
import numpy as np
import pytest

import stencilflow_tpu as sft
from stencilflow_tpu.backend.linear import extract_linear
from stencilflow_tpu.frontend.parser import parse_computation


def _kernel(text, fields=("a",)):
    stmts = parse_computation("k", text, {f: (True, True, True)
                                          for f in fields}, {}, {})
    return sft.KernelSpec("k", stmts, np.dtype(np.float32), {})


class TestExtraction:
    def test_affine_chain_with_temporaries(self):
        coeffs = extract_linear(_kernel(
            "t = 2.0 * a[i,j,k] + 1.0; k = t - 0.5 * a[i,j+1,k]"))
        assert coeffs[("a", (0, 0, 0))] == 2.0
        assert coeffs[("a", (0, 1, 0))] == -0.5
        assert coeffs[("const",)] == 1.0

    def test_nonlinear_returns_none(self):
        assert extract_linear(_kernel("k = a[i,j,k] * a[i,j,k+1]")) is None

    @pytest.mark.parametrize("text,expected", [
        ("k = -(a[i,j,k] - b[i,j,k]) / 4.0",
         {("a", (0, 0, 0)): -0.25, ("b", (0, 0, 0)): 0.25}),
        ("k = 3.0 * (a[i-1,j,k] + a[i-1,j,k])", {("a", (-1, 0, 0)): 6.0}),
        ("k = a[i,j,k] - a[i,j,k] + 2.0", {("a", (0, 0, 0)): 0.0,
                                            ("const",): 2.0}),
    ])
    def test_coefficient_maps(self, text, expected):
        assert extract_linear(_kernel(text, ("a", "b"))) == expected

    @pytest.mark.parametrize("text", [
        "k = a[i,j,k] / b[i,j,k]",
        "k = a[i,j,k] / 0.0",
        "k = a[i,j,k] if a[i,j,k] > 0.0 else 0.0",
        "k = min(a[i,j,k], 1.0)",
        "k = sqrt(a[i,j,k])",
    ])
    def test_non_affine_forms_return_none(self, text):
        assert extract_linear(_kernel(text, ("a", "b"))) is None

"""Mixed int x float promotion spec (ADVICE r4 medium, settled round 5).

The framework's defined semantics: at any binary site (arith, compare,
select branches, min/max) a STRONG integer/bool operand meeting a STRONG
floating operand converts to THAT float dtype — JAX's no-f64 lattice.
numpy alone would widen int32/int64 x float32 to float64, a compute
dtype the JAX engines do not compute with x64 off, permanently splitting the
engines.  Implemented in interpreter._match_mixed (oracle), machine._mx
(Python machine), native._res_ty (C++ emitter), and tile_eval's walker
(explicit casts — jnp itself only follows this lattice with x64 off).

The discrete separator: 2**24 + 1 is an int32 that float32 cannot
represent.  Under the spec, `n * 1.0` computes f32 and lands on
2**24 exactly; under numpy's f64 promotion it would stay 2**24 + 1 —
a whole-integer difference no FMA/rounding artifact can produce.
"""
import numpy as np
import pytest

import stencilflow_tpu as sft

BIG = 2 ** 24 + 1   # not representable in float32


def _spec(expr_s, out_dt="float64", extra=None):
    prog = {
        "s": {"computation_string": f"s = {expr_s}",
              "boundary_conditions": {
                  "n": {"type": "constant", "value": 0}},
              "data_type": out_dt}}
    outputs = ["s"]
    if extra:
        prog.update(extra[0])
        outputs = extra[1]
    return {
        "inputs": {"n": {"data": f"constant:{BIG}",
                         "data_type": "int32"}},
        "outputs": outputs, "dimensions": [4, 4, 8],
        "program": prog}


def _engines(p, inputs):
    """(label, outputs_dict) for every engine that accepts the program."""
    from stencilflow_tpu.backend.xla import run_chain
    from stencilflow_tpu.backend.xla import run_chain
    from stencilflow_tpu.sim import simulate
    outs = []
    ref = {k: np.asarray(v)
           for k, v in sft.run_interpreter(p, inputs).items()}
    outs.append(("oracle", ref))
    r = simulate(p, inputs, native=False)
    outs.append(("machine", {k: np.asarray(v).reshape(ref[k].shape)
                             for k, v in r.outputs.items()}))
    try:
        rn = simulate(p, inputs, native=True)
        outs.append(("native", {k: np.asarray(v).reshape(ref[k].shape)
                                for k, v in rn.outputs.items()}))
    except Exception:
        pass   # g++ unavailable: Python machine already covers semantics
    outs.append(("xla", {k: np.asarray(v)
                         for k, v in run_chain(p, inputs).items()}))
    outs.append(("xla-interp", {k: np.asarray(v) for k, v in
                                run_chain(p, inputs,
                                          strategy="interpreter").items()}))
    return outs


class TestMixedPromotionSpec:

    def test_int_times_float_computes_f32(self):
        """int32 * f32 const computes in f32 in EVERY engine: in an f32
        kernel the unrepresentable 2**24+1 collapses to 2**24 BEFORE
        the in-kernel subtraction, so `n*1.0 - 16777216.0` is exactly
        0.0 (numpy's f64 promotion would give exactly 1.0 — a discrete,
        rounding-proof separation; note float consts pin to the KERNEL
        dtype, so this must be an f32 kernel)."""
        p = sft.parse_program(
            _spec("n[i,j,k] * 1.0 - 16777216.0", out_dt="float32"),
            name="mxp_mul")
        inputs = sft.load_input_arrays(p, seed=0)
        for label, outs in _engines(p, inputs):
            got = outs["s"]
            assert np.all(got == 0.0), (
                label, got.ravel()[0], "expected f32-lattice compute")

    def test_mixed_compare_in_f32(self):
        """int32 vs f32 comparison happens at f32 precision: 2**24+1
        == 16777216.0 is TRUE under the spec (f64 compare says False)."""
        extra = ({"q": {"computation_string":
                        "q = (n[i,j,k] == 16777216.0) * 1",
                        "boundary_conditions": {
                            "n": {"type": "constant", "value": 0}},
                        "data_type": "int32"}}, ["q"])
        p = sft.parse_program(_spec("n[i,j,k] * 1.0", extra=extra),
                              name="mxp_cmp")
        inputs = sft.load_input_arrays(p, seed=0)
        for label, outs in _engines(p, inputs):
            assert np.all(outs["q"] == 1), (label, outs["q"].ravel()[0])

    def test_select_and_minmax_branches_match_float(self):
        """np.where / min with one int and one float branch promote to
        the float dtype (not numpy's f64)."""
        extra = ({"q": {"computation_string":
                        "q = (s[i,j,k] if n[i,j,k] > 0 else n[i,j,k])"
                        " + min(n[i,j,k], s[i,j,k])",
                        "boundary_conditions": {
                            "n": {"type": "constant", "value": 0},
                            "s": {"type": "constant", "value": 0}},
                        "data_type": "float64"}}, ["q"])
        p = sft.parse_program(
            _spec("n[i,j,k] * 1.0", out_dt="float32", extra=extra),
            name="mxp_sel")
        inputs = sft.load_input_arrays(p, seed=0)
        for label, outs in _engines(p, inputs):
            # both terms collapse to f32(2**24): select branch n casts
            # to s's f32; min(n, s) likewise
            assert np.all(outs["q"] == 2.0 * 2 ** 24), (
                label, outs["q"].ravel()[0])

    def test_int_int_keeps_numpy_semantics(self):
        """Unmixed sites are untouched: int x int wraps per numpy."""
        spec = {
            "inputs": {"n": {"data": "constant:2000000000",
                             "data_type": "int32"}},
            "outputs": ["q"], "dimensions": [4, 4, 8],
            "program": {
                "q": {"computation_string": "q = n[i,j,k] + n[i,j,k]",
                      "boundary_conditions": {
                          "n": {"type": "constant", "value": 0}},
                      "data_type": "int32"}}}
        p = sft.parse_program(spec, name="mxp_wrap")
        inputs = sft.load_input_arrays(p, seed=0)
        with np.errstate(over="ignore"):   # wraparound is the point
            expect = np.add(np.int32(2000000000), np.int32(2000000000))
        for label, outs in _engines(p, inputs):
            assert np.all(outs["q"] == expect), (label,
                                                 outs["q"].ravel()[0])

    def test_advisor_amplified_consumer_numpy_engines_bit_equal(self):
        """The ADVICE r4 reproducer: non-dyadic consts + an amplified
        int consumer.  The three numpy-semantics engines (oracle,
        machine, native) are BIT-equal; the jnp engines may differ by
        the XLA-CPU FMA contraction of `a*c1 + b*c2` (~1 f32 ulp,
        amplified to a couple of int counts) — a documented platform
        artifact orthogonal to the promotion spec."""
        spec = {
            "inputs": {"n": {"data": "random:1,100",
                             "data_type": "int32"}},
            "outputs": ["q"], "dimensions": [4, 6, 5],
            "program": {
                "s": {"computation_string":
                      "s = n[i,j,k]*0.1 + n[i,j,k-1]*0.3",
                      "boundary_conditions": {
                          "n": {"type": "constant", "value": 0}},
                      "data_type": "float32"},
                "q": {"computation_string": "q = s[i,j,k]*1000000",
                      "boundary_conditions": {
                          "s": {"type": "constant", "value": 0}},
                      "data_type": "int32"}}}
        p = sft.parse_program(spec, name="mxp_advice")
        inputs = sft.load_input_arrays(p, seed=1)
        engines = dict(_engines(p, inputs))
        ref = engines["oracle"]["q"]
        for label in ("machine", "native"):
            if label in engines:
                np.testing.assert_array_equal(engines[label]["q"], ref,
                                              err_msg=label)
        for label in ("xla", "xla-interp"):
            d = np.abs(engines[label]["q"].astype(np.int64)
                       - ref.astype(np.int64))
            assert d.max() <= 4, (label, d.max())   # FMA wiggle only

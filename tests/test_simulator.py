"""Simulator tests: BoundedQueue semantics (mirroring the reference's unit
tests, /root/reference/test/test_stencilflow.py:17-84), and both simulator
engines against the numpy oracle."""
import numpy as np
import pytest

import stencilflow_tpu as sft
from stencilflow_tpu.sim import (BoundedQueue, QueueOverflow, QueueUnderflow,
                                 Simulator)
from stencilflow_tpu.sim.native import NativeSimulator
from stencilflow_tpu.synthesize import jacobi


class TestBoundedQueue:
    """Mirrors the reference's own unit assertions
    (test_stencilflow.py:17-84) plus the ORDER cases those tests skip
    (single-element collections hid the layout)."""

    def test_import_order_and_peek(self):
        q = BoundedQueue("q", 5, [1, 2, 3])
        assert q.size() == 3
        # reference indexing: peek(i) == collection[i],
        # try_peek_last == next element OUT == collection[-1]
        assert q.peek(0) == 1 and q.peek(2) == 3
        assert q.try_peek_last() == 3
        # dequeue order: collection[-1] first (reference layout:
        # enqueue appendleft / dequeue pop-right)
        assert q.dequeue() == 3 and q.dequeue() == 2 and q.dequeue() == 1
        assert q.try_peek_last() is False

    def test_overflow_underflow(self):
        q = BoundedQueue("q", 2)
        q.enqueue(1)
        q.enqueue(2)
        with pytest.raises(QueueOverflow):
            q.enqueue(3)
        assert q.dequeue() == 1   # FIFO: first enqueued leaves first
        assert q.dequeue() == 2
        with pytest.raises(QueueUnderflow):
            q.dequeue()

    def test_try_variants(self):
        q = BoundedQueue("q", 1)
        assert q.try_enqueue("a")
        assert not q.try_enqueue("b")
        assert q.try_dequeue() == "a"
        assert q.try_dequeue() is False   # reference returns False

    def test_import_overflow_and_export(self):
        with pytest.raises(QueueOverflow):
            BoundedQueue("q", 2, [1, 2, 3])
        q = BoundedQueue("q", 3, [4, 5])
        # export lists dequeue order (reference: np.array(queue)[::-1])
        assert q.export_data() == [5, 4]

    def test_maxsize_clamped_to_one(self):
        q = BoundedQueue("q", 0)
        assert q.maxsize == 1


def _check(program, inputs, out, engine, halo=0):
    ref = np.asarray(sft.run_interpreter(program, inputs)[out])
    res = engine(program).run(inputs)
    got = res.outputs[out]
    if halo:
        sl = tuple(slice(halo, -halo) for _ in range(ref.ndim))
        ref, got = ref[sl], got[sl]
    np.testing.assert_array_equal(got, ref)
    return res


@pytest.mark.parametrize("engine", [Simulator, NativeSimulator],
                         ids=["python", "native"])
class TestSimulatorEngines:
    @pytest.mark.parametrize("boundary", ["constant", "copy", "shrink"])
    def test_jacobi3d_chain(self, engine, boundary):
        p = sft.parse_program(jacobi(3, 8, iterations=2, boundary=boundary),
                              name=f"j_{boundary}")
        inputs = sft.load_input_arrays(p, seed=3)
        halo = 2 if boundary == "shrink" else 0
        res = _check(p, inputs, "s1", engine, halo=halo)
        assert res.cycles >= p.total_elements

    def test_fork_join_multi_statement(self, engine):
        rng = np.random.default_rng(7)
        a = rng.random((4, 6, 8)).astype(np.float32)
        p = sft.parse_program({
            "inputs": {"a": {"data": a, "data_type": "float32"}},
            "outputs": ["res"],
            "dimensions": [4, 6, 8],
            "program": {
                "u": {"computation_string":
                      "tmp = a[i,j,k] * 2.0; u = tmp + a[i,j,k-1]",
                      "boundary_conditions": {
                          "a": {"type": "constant", "value": 1.0}},
                      "data_type": "float32"},
                "v": {"computation_string":
                      "v = u[i,j-1,k] if a[i,j,k] > 0.5 else u[i,j+1,k]",
                      "boundary_conditions": {
                          "u": {"type": "constant", "value": 0.0},
                          "a": {"type": "constant", "value": 0.0}},
                      "data_type": "float32"},
                "res": {"computation_string": "res = v[i,j,k] + u[i,j,k]",
                        "boundary_conditions": {
                            "v": {"type": "constant", "value": 0.0},
                            "u": {"type": "constant", "value": 0.0}},
                        "data_type": "float32"},
            },
        }, name="forks")
        _check(p, {"a": a}, "res", engine)

    def test_2d_program_with_scalar(self, engine):
        rng = np.random.default_rng(8)
        a = rng.random((8, 8)).astype(np.float64)
        c = 2.5
        p = sft.parse_program({
            "inputs": {"a": {"data": a, "data_type": "float64"},
                       "c": {"data": c, "data_type": "float64",
                             "input_dims": []}},
            "outputs": ["b"],
            "dimensions": [8, 8],
            "program": {"b": {
                "computation_string": "b = c * a[j,k] + a[j-1,k]",
                "boundary_conditions": {
                    "a": {"type": "constant", "value": 0.0}},
                "data_type": "float64"}},
        }, name="sc2d")
        _check(p, {"a": a, "c": c}, "b", engine)

    def test_buffer_highwater_within_analysis_bounds(self, engine):
        p = sft.parse_program(jacobi(3, 8, iterations=3), name="hw")
        inputs = sft.load_input_arrays(p, seed=9)
        res = engine(p).run(inputs)
        analysis = sft.ChainAnalysis.run(p)
        for key, high in res.edge_high_water.items():
            eb = analysis.edges[key]
            cap = eb.delay_size + eb.internal_size + 2
            assert high <= cap, (key, high, cap)


class TestProofDiscipline:
    """Overflow AND underflow/staleness are detected in both engines, and
    the zero-slack capacities are machine-exact (VERDICT r1 weak #2/#5)."""

    def test_edge_peek_guard(self):
        from stencilflow_tpu.sim.machine import _Edge, SimulationError
        e = _Edge("a", "b", capacity=4)
        for v in range(4):
            assert e.push(float(v))
        assert e.peek(0) == 0.0
        e.release_to(2)
        with pytest.raises(SimulationError, match="stale/underflow"):
            e.peek(1)          # released element
        with pytest.raises(SimulationError, match="stale/underflow"):
            e.peek(4)          # not yet produced

    def test_undersized_edge_deadlocks(self):
        from stencilflow_tpu.sim.machine import DeadlockError
        p = sft.parse_program(jacobi(3, 8, iterations=2), name="undersz")
        inputs = sft.load_input_arrays(p, seed=0)
        sim = Simulator(p)
        key = ("a", "s0")
        assert sim.edges[key].capacity > 2
        sim.edges[key].capacity = 2   # below the window span
        with pytest.raises(DeadlockError):
            sim.run(inputs)

    @staticmethod
    def _corrupt_windows(real_fn):
        """Raise the (a, s0) retention floor by one: the machine releases
        an element the kernel still reads — a seeded staleness bug."""
        def fake(program, analysis):
            w = dict(real_fn(program, analysis))
            lo, hi = w[("a", "s0")]
            w[("a", "s0")] = (lo + 1, hi)
            return w
        return fake

    def test_stale_read_raises_python(self, monkeypatch):
        from stencilflow_tpu.sim import machine
        monkeypatch.setattr(
            machine, "access_windows",
            self._corrupt_windows(machine.access_windows))
        p = sft.parse_program(jacobi(3, 8, iterations=2), name="stale_py")
        inputs = sft.load_input_arrays(p, seed=0)
        with pytest.raises(machine.SimulationError,
                           match="stale/underflow"):
            Simulator(p).run(inputs)

    def test_stale_read_raises_native(self, monkeypatch):
        from stencilflow_tpu.sim import machine, native
        monkeypatch.setattr(
            native, "access_windows",
            self._corrupt_windows(machine.access_windows))
        p = sft.parse_program(jacobi(3, 8, iterations=2), name="stale_cc")
        inputs = sft.load_input_arrays(p, seed=0)
        with pytest.raises(machine.SimulationError,
                           match="stale/underflow"):
            NativeSimulator(p).run(inputs)

    @pytest.mark.parametrize("seed", range(6))
    def test_zero_slack_capacities_are_exact(self, seed):
        """Fuzz corpus: at slack=0 every run completes (tight upper bound
        is sufficient) and high-water never exceeds the static bound
        (edge_capacities is an upper bound); mean occupancy is sane."""
        import os as _os
        import sys as _sys
        _sys.path.insert(0, _os.path.dirname(__file__))
        from test_fuzz import make_random_program
        from stencilflow_tpu.sim.machine import edge_capacities
        rng = np.random.default_rng(500 + seed)
        p = sft.parse_program(make_random_program(rng, seed),
                              name=f"exact{seed}")
        inputs = sft.load_input_arrays(p, seed=seed)
        analysis = sft.ChainAnalysis.run(p)
        caps = edge_capacities(p, analysis)
        ref = sft.run_interpreter(p, inputs)
        for engine in (Simulator, NativeSimulator):
            res = engine(p, analysis=analysis).run(inputs)
            for key, high in res.edge_high_water.items():
                assert high <= caps[key], (key, high, caps[key])
                mean = res.edge_mean_occupancy[key]
                assert 0.0 <= mean <= high + 1e-9
            np.testing.assert_array_equal(
                res.outputs[p.outputs[0]].astype(np.float32),
                np.asarray(ref[p.outputs[0]], dtype=np.float32))


class TestNativeMatchesPython:
    def test_cycle_counts_agree(self):
        p = sft.parse_program(jacobi(2, 12, iterations=2), name="cc")
        inputs = sft.load_input_arrays(p, seed=10)
        r_py = Simulator(p).run(inputs)
        r_cc = NativeSimulator(p).run(inputs)
        assert r_py.cycles == r_cc.cycles
        assert r_py.edge_high_water == r_cc.edge_high_water
        np.testing.assert_array_equal(r_py.outputs["s1"],
                                      r_cc.outputs["s1"])


def test_chrome_trace_export(tmp_path):
    """simulate --trace CSV converts to a Chrome/Perfetto trace whose
    per-kernel activity spans line up with the machine's first-fire
    cycles (counter tracks per FIFO/PC, change points always kept)."""
    import json
    from stencilflow_tpu.sim.trace import csv_to_chrome
    p = sft.parse_program(jacobi(3, 6, iterations=3), name="chrometrace")
    inputs = sft.load_input_arrays(p, seed=0)
    csv = tmp_path / "trace.csv"
    res = Simulator(p).run(inputs, trace=str(csv))
    out = tmp_path / "trace.json"
    n = csv_to_chrome(str(csv), str(out), every=8)
    assert n > 0
    ev = json.loads(out.read_text())["traceEvents"]
    spans = {e["name"].removeprefix("active "): e for e in ev
             if e["ph"] == "X"}
    assert set(spans) == set(p.kernels)
    for k, st in res.kernel_stats.items():
        assert spans[k]["ts"] == st["first_fire"]
    # counter tracks exist for every FIFO and every kernel PC
    names = {e["name"] for e in ev if e["ph"] == "C"}
    assert any(nm.startswith("occ:") for nm in names)
    assert any(nm.startswith("pc:") for nm in names)


def test_per_cycle_trace(tmp_path):
    """--trace CSV: one row per cycle, PCs monotone, occupancies bounded
    by the proven high-water marks."""
    import stencilflow_tpu as sft
    from stencilflow_tpu.sim import simulate
    from stencilflow_tpu.synthesize import jacobi
    p = sft.parse_program(jacobi(2, 8, iterations=2), name="tracetest")
    inputs = sft.load_input_arrays(p, seed=0)
    path = tmp_path / "trace.csv"
    res = simulate(p, inputs, trace=str(path))
    lines = path.read_text().strip().split("\n")
    assert len(lines) == res.cycles + 1
    header = lines[0].split(",")
    assert header[0] == "cycle" and "pc:s1" in header
    first, last = lines[1].split(","), lines[-1].split(",")
    pc_cols = [i for i, h in enumerate(header) if h.startswith("pc:")]
    assert all(int(last[i]) >= int(first[i]) for i in pc_cols)
    occ = {h.split("occ:")[1]: i for i, h in enumerate(header)
           if h.startswith("occ:")}
    for (s, d), hw in res.edge_high_water.items():
        col = occ[f"{s}->{d}"]
        assert max(int(row.split(",")[col]) for row in lines[1:]) <= hw


class TestEngineParityEdgeCases:
    """Round-2 review regressions: oracle-parity for NaN math, NaN-aware
    min/max, narrow dtypes, fault-record reset, exception types."""

    def test_sqrt_of_shrink_junk_matches_oracle(self):
        """sqrt over a shrink-BC junk halo yields NaN in the halo (the
        oracle's semantics) — neither engine may raise, and the pruned
        interiors agree exactly."""
        from stencilflow_tpu.data import prune_halo
        spec = {
            "inputs": {"f": {"data": "random:1,2",
                             "data_type": "float32"}},
            "outputs": ["s"],
            "dimensions": [6, 6, 6],
            "program": {"s": {
                "computation_string": "s = sqrt(f[i,j,k-1])",
                "boundary_conditions":
                {"f": {"type": "shrink", "value": 0.0}},
                "data_type": "float32"}},
        }
        p = sft.parse_program(spec, name="sqrtjunk")
        inputs = sft.load_input_arrays(p, seed=0)
        ref = np.asarray(sft.run_interpreter(p, inputs)["s"])
        assert np.isnan(ref).any()   # junk halo -> NaN
        for engine in (Simulator, NativeSimulator):
            got = engine(p).run(inputs).outputs["s"]
            np.testing.assert_array_equal(
                prune_halo(got, p.raw_dimensions, 1),
                prune_halo(ref, p.raw_dimensions, 1))

    def test_min_propagates_nan_like_numpy(self):
        """min/max propagate NaN in every engine (np.minimum semantics;
        fmin would suppress it, builtin min is order-dependent)."""
        spec = {
            "inputs": {"f": {"data": "random:1,2",
                             "data_type": "float32"}},
            "outputs": ["s"],
            "dimensions": [4, 4, 4],
            "program": {"s": {
                # log(-f) = NaN everywhere (f > 0); min(NaN, 1) = NaN
                "computation_string": "s = min(log(0.0 - f[i,j,k]), 1.0)",
                "boundary_conditions":
                {"f": {"type": "constant", "value": 1.0}},
                "data_type": "float32"}},
        }
        p = sft.parse_program(spec, name="nanmin")
        inputs = sft.load_input_arrays(p, seed=1)
        ref = np.asarray(sft.run_interpreter(p, inputs)["s"])
        assert np.isnan(ref).all()
        for engine in (Simulator, NativeSimulator):
            got = engine(p).run(inputs).outputs["s"]
            assert np.isnan(got).all(), engine.__name__

    @pytest.mark.parametrize("dt", ["bfloat16", "float16"])
    def test_narrow_dtype_parity(self, dt):
        """bf16/f16 kernels: the native core rounds every op to the
        kernel dtype exactly like the oracle and the Python machine."""
        spec = jacobi(3, 6, iterations=2)
        for k in spec["program"].values():
            k["data_type"] = dt
        spec["inputs"]["a"]["data_type"] = dt
        p = sft.parse_program(spec, name=f"narrow_{dt}")
        inputs = sft.load_input_arrays(p, seed=2)
        ref = np.asarray(sft.run_interpreter(p, inputs)[p.outputs[0]],
                         dtype=np.float64)
        for engine in (Simulator, NativeSimulator):
            got = np.asarray(engine(p).run(inputs).outputs[p.outputs[0]],
                             dtype=np.float64)
            np.testing.assert_array_equal(got, ref, err_msg=engine.__name__)

    def _parity(self, spec, name, seed=1):
        """All three engines bit-equal on every output."""
        import warnings
        p = sft.parse_program(spec, name=name)
        inputs = sft.load_input_arrays(p, seed=seed)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # int overflow is on purpose
            ref = sft.run_interpreter(p, inputs)
            py = Simulator(p).run(inputs).outputs
        cc = NativeSimulator(p).run(inputs).outputs
        for o in p.outputs:
            assert np.asarray(cc[o]).dtype == np.asarray(ref[o]).dtype
            np.testing.assert_array_equal(
                np.asarray(py[o]), np.asarray(ref[o]),
                err_msg=f"{name} python {o}")
            np.testing.assert_array_equal(
                np.asarray(cc[o]), np.asarray(ref[o]),
                err_msg=f"{name} native {o}")

    def test_int_kernels_run_natively(self):
        """Integer kernels run in the C++ core with numpy scalar
        semantics: same-width wraparound, weak int constants, bool*int
        masking, min/max/abs, true division to float64 (VERDICT r3 weak
        #7 — formerly a Python-machine fallback)."""
        self._parity({
            "inputs": {"f": {"data": "random:0,50", "data_type": "int32"},
                       "g": {"data": "random:0,50", "data_type": "int32"}},
            "outputs": ["s"], "dimensions": [6, 6, 6],
            "program": {
                "t": {"computation_string":
                      "t = (f[i,j,k] * 3 - g[i,j,k-1])"
                      " + min(f[i-1,j,k], g[i,j,k])",
                      "boundary_conditions":
                      {"f": {"type": "constant", "value": 2},
                       "g": {"type": "constant", "value": 5}},
                      "data_type": "int32"},
                "s": {"computation_string":
                      "s = (t[i,j,k] > 10) * t[i,j+1,k]"
                      " + abs(t[i,j,k] - 100)",
                      "boundary_conditions":
                      {"t": {"type": "constant", "value": 0}},
                      "data_type": "int32"}}}, "intnat")

    def test_int8_wraparound_and_division(self):
        """int8 arithmetic wraps per op at the dtype width (numpy
        same-dtype semantics) and `/` is numpy true division (float64),
        cast back at the consumer — all engines bit-equal."""
        self._parity({
            "inputs": {"f": {"data": "random:0,120", "data_type": "int8"}},
            "outputs": ["s"], "dimensions": [5, 5, 5],
            "program": {
                "t": {"computation_string":
                      "t = f[i,j,k] * 7 - f[i,j,k-1] * 5",
                      "boundary_conditions":
                      {"f": {"type": "constant", "value": 3}},
                      "data_type": "int8"},
                "s": {"computation_string":
                      "s = t[i,j,k] + (f[i,j,k] / 2 > 20) * 4"
                      " + max(t[i-1,j,k], 0 - t[i,j,k])",
                      "boundary_conditions":
                      {"t": {"type": "constant", "value": 1},
                       "f": {"type": "constant", "value": 3}},
                      "data_type": "int8"}}}, "int8wrap", seed=3)

    def test_bool_kernel_and_mixed_dtype_chain(self):
        """Edges carry the PRODUCER's dtype (oracle semantics): a bool
        mask kernel over a float field stays a comparison on floats, and
        the float consumer reads bools — formerly the machine cast reads
        to the consumer dtype, collapsing f>0 to bool(f)."""
        self._parity({
            "inputs": {"f": {"data": "random:-1,1",
                             "data_type": "float32"}},
            "outputs": ["m", "s"], "dimensions": [5, 6, 7],
            "program": {
                "m": {"computation_string":
                      "m = (f[i,j,k] > 0.0) + (f[i,j-1,k] > 0.25)",
                      "boundary_conditions":
                      {"f": {"type": "constant", "value": -1.0}},
                      "data_type": "bool"},
                "s": {"computation_string":
                      "s = m[i,j,k] * f[i,j,k]"
                      " + (1.0 if m[i,j,k+1] else 0.5)",
                      "boundary_conditions":
                      {"m": {"type": "constant", "value": 0},
                       "f": {"type": "constant", "value": -1.0}},
                      "data_type": "float32"}}}, "boolmask", seed=5)

    def test_cross_float_and_int_float_crossings(self):
        """float64->float32 and int16->float32->int32 edges: numpy
        promotion per op, one cast at each kernel's output."""
        self._parity({
            "inputs": {"f": {"data": "random:-1,1",
                             "data_type": "float64"}},
            "outputs": ["s"], "dimensions": [5, 6, 7],
            "program": {
                "t": {"computation_string":
                      "t = f[i,j,k] * 0.3333333333333333 + f[i,j,k-1]",
                      "boundary_conditions":
                      {"f": {"type": "constant", "value": 0.5}},
                      "data_type": "float64"},
                "s": {"computation_string":
                      "s = t[i,j,k] * 1.7 + t[i,j+1,k] / 3.0",
                      "boundary_conditions":
                      {"t": {"type": "constant", "value": 0.25}},
                      "data_type": "float32"}}}, "f64f32")
        self._parity({
            "inputs": {"f": {"data": "random:1,40", "data_type": "int16"}},
            "outputs": ["s"], "dimensions": [4, 5, 6],
            "program": {
                "t": {"computation_string":
                      "t = sqrt(f[i,j,k]) + f[i,j,k-1] * 0.5",
                      "boundary_conditions":
                      {"f": {"type": "constant", "value": 4}},
                      "data_type": "float32"},
                "s": {"computation_string":
                      "s = t[i,j,k] * 10.0 - t[i-1,j,k]",
                      "boundary_conditions":
                      {"t": {"type": "constant", "value": 1.5}},
                      "data_type": "int32"}}}, "intfloat")

    def test_weak_const_select_materializes_strong(self):
        """Float consts in a NON-floating kernel pin to float32 — the
        framework's defined semantics (numpy would materialize a weak
        const strong float64 in np.where, which the JAX engines do not
        compute with x64 off).  All engines, including the jnp backends, must agree
        on this program (review find: the select's constants)."""
        from stencilflow_tpu.backend.xla import compile_chain, run_chain
        spec = {
            "inputs": {"f": {"data": "random:0,1",
                             "data_type": "float32"}},
            "outputs": ["s"], "dimensions": [4, 4, 4],
            "program": {"s": {
                "computation_string":
                "s = ((1.0 if f[i,j,k] > 0.5 else 0.3) + f[i,j,k])"
                " * 100000000",
                "boundary_conditions":
                {"f": {"type": "constant", "value": 0.0}},
                "data_type": "int32"}}}
        self._parity(spec, "weaksel")
        p = sft.parse_program(spec, name="weakselb")
        inputs = sft.load_input_arrays(p, seed=1)
        ref = np.asarray(sft.run_interpreter(p, inputs)["s"])
        for strat in ("interpreter", "tile"):
            got = np.asarray(compile_chain(p, strategy=strat)(inputs)["s"])
            np.testing.assert_array_equal(got, ref,
                                          err_msg=f"xla:{strat}")

    def test_bool_i_history_matches_oracle(self):
        """A bool field read at a nonzero i-offset (bool history along
        the outermost axis), through both fused-XLA strategies."""
        from stencilflow_tpu.backend.xla import run_chain
        spec = {
            "inputs": {"a": {"data": "random:-1,1",
                             "data_type": "float32"}},
            "outputs": ["s"], "dimensions": [7, 8, 8],
            "program": {
                "m": {"computation_string": "m = a[i,j,k] > 0.0",
                      "boundary_conditions":
                      {"a": {"type": "constant", "value": 0.0}},
                      "data_type": "bool"},
                "s": {"computation_string":
                      "s = (m[i-1,j+1,k] * 2) * 0.25 + a[i,j,k]",
                      "boundary_conditions":
                      {"m": {"type": "constant", "value": 0},
                       "a": {"type": "constant", "value": 0.0}},
                      "data_type": "float32"}}}
        p = sft.parse_program(spec, name="boolhist")
        inputs = sft.load_input_arrays(p, seed=0)
        for strategy in ("tile", "interpreter"):
            got = run_chain(p, inputs, strategy=strategy)["s"]
            np.testing.assert_allclose(
                np.asarray(got),
                np.asarray(sft.run_interpreter(p, inputs)["s"]),
                rtol=2e-5, atol=1e-6, err_msg=strategy)

    def test_boolop_ref_to_comparison_temp_stays_native(self):
        """A uniform float kernel using a bool-valued statement temp as
        an and/or operand keeps the fast C++ path (the bool-operand gate
        tracks comparison temps; review find)."""
        spec = {
            "inputs": {"f": {"data": "random:0,4",
                             "data_type": "float32"}},
            "outputs": ["s"], "dimensions": [5, 5, 5],
            "program": {"s": {
                "computation_string":
                "m = f[i,j,k] > 2.0; "
                "s = 1.0 if (m and f[i,j+1,k] > 1.0) else 0.25",
                "boundary_conditions":
                {"f": {"type": "constant", "value": 0.0}},
                "data_type": "float32"}}}
        p = sft.parse_program(spec, name="boolref")
        inputs = sft.load_input_arrays(p, seed=2)
        sim = NativeSimulator(p)   # must not raise NativeBuildError
        np.testing.assert_array_equal(
            np.asarray(sim.run(inputs).outputs["s"]),
            np.asarray(sft.run_interpreter(p, inputs)["s"]))

    def test_boolop_on_ints_is_bitwise(self):
        """The oracle reduces and/or with bitwise &/| — `4 and 3` is
        4 & 3 = 0, not python's operand-returning `and` (3) nor a
        truthiness && (1).  All engines must agree (review find)."""
        self._parity({
            "inputs": {"f": {"data": "constant:4", "data_type": "int32"},
                       "g": {"data": "constant:3", "data_type": "int32"}},
            "outputs": ["s"], "dimensions": [4, 4, 4],
            "program": {"s": {
                "computation_string": "s = f[i,j,k] and g[i,j,k]",
                "boundary_conditions":
                {"f": {"type": "constant", "value": 0},
                 "g": {"type": "constant", "value": 0}},
                "data_type": "int32"}}}, "andint")

    def test_bf16_mixed_chain_falls_back(self):
        """Mixed-dtype kernels touching bfloat16 take the Python machine
        (ml_dtypes scalar promotion is inconsistent with result_type);
        simulate() must still return the oracle's answer, not crash
        (review find: DTypePromotionError escaped)."""
        from stencilflow_tpu.sim import simulate
        from stencilflow_tpu.sim.native import NativeBuildError
        spec = {
            "inputs": {"t": {"data": "random:0,3",
                             "data_type": "bfloat16"},
                       "n": {"data": "random:0,9", "data_type": "int32"}},
            "outputs": ["s"], "dimensions": [4, 4, 4],
            "program": {"s": {
                "computation_string": "s = t[i,j,k] + n[i,j,k]",
                "boundary_conditions":
                {"t": {"type": "constant", "value": 0},
                 "n": {"type": "constant", "value": 0}},
                "data_type": "int32"}}}
        p = sft.parse_program(spec, name="bf16mix")
        inputs = sft.load_input_arrays(p, seed=0)
        with pytest.raises(NativeBuildError):
            NativeSimulator(p)
        res = simulate(p, inputs)
        np.testing.assert_array_equal(
            np.asarray(res.outputs["s"]),
            np.asarray(sft.run_interpreter(p, inputs)["s"]))

    def test_weak_const_demotion_vs_bf16_field(self):
        """JAX's weak-type lattice demotes a weak float const against a
        bf16 neighbor (weak f32 + bf16 -> bf16) where the numpy oracle
        computes f32 — float consts are pinned to the kernel dtype in
        every jnp path (tile_eval/fast_tile/jnp interpreter) so all
        backends match the oracle (found by end-to-end verification)."""
        import warnings
        from stencilflow_tpu.backend.xla import compile_chain, run_chain
        spec = {
            "inputs": {"f": {"data": "random:0,9", "data_type": "int32"},
                       "b": {"data": "random:0,3",
                             "data_type": "bfloat16"}},
            "outputs": ["s"], "dimensions": [6, 6, 6],
            "program": {
                "m": {"computation_string":
                      "m = (f[i,j,k] > 2 and f[i,j,k-1] > 1)",
                      "boundary_conditions":
                      {"f": {"type": "constant", "value": 0}},
                      "data_type": "bool"},
                "w": {"computation_string":
                      "w = (b[i,j,k] + b[i,j+1,k]) * 0.5",
                      "boundary_conditions":
                      {"b": {"type": "constant", "value": 1.0}},
                      "data_type": "bfloat16"},
                "s": {"computation_string":
                      "s = ((1.0 if m[i,j,k] else 0.3) + w[i,j,k])"
                      " * 1000 + (f[i,j,k] and f[i+1,j,k])",
                      "boundary_conditions":
                      {"m": {"type": "constant", "value": 0},
                       "w": {"type": "constant", "value": 0.5},
                       "f": {"type": "constant", "value": 0}},
                      "data_type": "float32"}}}
        p = sft.parse_program(spec, name="weakdemote")
        inputs = sft.load_input_arrays(p, seed=0)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            ref = np.asarray(sft.run_interpreter(p, inputs)["s"])
            py = np.asarray(Simulator(p).run(inputs).outputs["s"])
        np.testing.assert_array_equal(py, ref, err_msg="python machine")
        for strat in ("interpreter", "tile"):
            got = np.asarray(compile_chain(p, strategy=strat)(inputs)["s"])
            np.testing.assert_array_equal(got, ref,
                                          err_msg=f"xla:{strat}")

    def test_int64_kernel_native(self):
        """int64 kernels run natively (typed long long FIFO transport —
        no magnitude envelope since round 5)."""
        self._parity({
            "inputs": {"f": {"data": "random:0,1000000",
                             "data_type": "int64"}},
            "outputs": ["s"], "dimensions": [4, 4, 4],
            "program": {"s": {
                "computation_string":
                "s = f[i,j,k] * f[i,j,k] - f[i,j,k-1] + 17",
                "boundary_conditions":
                {"f": {"type": "constant", "value": 9}},
                "data_type": "int64"}}}, "int64nat", seed=4)

    def test_int64_beyond_2p53_native(self):
        """int64 chains whose values exceed 2**53 (incl. wraparound past
        2**63) stay BIT-exact through the typed (long long) FIFO
        transport — the round-4 double-transport envelope is closed
        (VERDICT r4 #8).  Const-free expressions keep every op in int64
        (a float const would pin to f32 and compute there, by the mixed
        promotion spec)."""
        self._parity({
            "inputs": {"f": {"data": "random:1000000000,4000000000",
                             "data_type": "int64"},
                       "g": {"data": "random:1,1000000",
                             "data_type": "int64"}},
            "outputs": ["q"], "dimensions": [4, 6, 5],
            "program": {
                "s": {"computation_string":
                      "s = f[i,j,k] * f[i,j,k-1] + f[i+1,j,k]",
                      "boundary_conditions":
                      {"f": {"type": "constant", "value": 7}},
                      "data_type": "int64"},
                "q": {"computation_string":
                      "q = s[i,j,k] - s[i,j-1,k] + min(s[i,j,k], "
                      "g[i,j,k] * g[i,j,k])",
                      "boundary_conditions":
                      {"s": {"type": "constant", "value": 0},
                       "g": {"type": "constant", "value": 1}},
                      "data_type": "int64"}}}, "int64big", seed=3)

    def test_int64_scalar_input_beyond_2p53(self):
        """int64 SCALAR inputs cross the native ABI bit-for-bit (typed
        slot in the scalars vector) — a 2**62-magnitude scalar whose
        low bits a double round-trip would destroy stays exact through
        all three engines (closes the last r4 #8 envelope)."""
        import warnings
        big = np.int64(2**62 + 12345)
        spec = {
            "inputs": {"f": {"data": "random:1,1000", "data_type": "int64"},
                       "c": {"data": big, "data_type": "int64",
                             "input_dims": []}},
            "outputs": ["s"], "dimensions": [4, 4, 4],
            "program": {"s": {
                "computation_string": "s = c + f[i,j,k] - f[i,j,k-1]",
                "boundary_conditions":
                {"f": {"type": "constant", "value": 2}},
                "data_type": "int64"}}}
        p = sft.parse_program(spec, name="int64sc")
        inputs = sft.load_input_arrays(p, seed=5)
        inputs["c"] = big
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            ref = sft.run_interpreter(p, inputs)["s"]
            py = Simulator(p).run(inputs).outputs["s"]
        cc = NativeSimulator(p).run(inputs).outputs["s"]
        # the low bits survive only if no double round-trip happened
        assert int(np.asarray(ref).ravel()[0]) % 65536 not in (0, 8192)
        np.testing.assert_array_equal(np.asarray(py), np.asarray(ref))
        np.testing.assert_array_equal(np.asarray(cc), np.asarray(ref))

    def test_fault_record_resets_between_runs(self, monkeypatch):
        """One stale-read fault must not poison later runs through the
        same loaded .so (file-scope record is reset per simulate())."""
        from stencilflow_tpu.sim import machine, native
        real = machine.access_windows
        corrupt = TestProofDiscipline._corrupt_windows(real)
        monkeypatch.setattr(native, "access_windows", corrupt)
        p = sft.parse_program(jacobi(3, 8, iterations=2), name="poisonchk")
        inputs = sft.load_input_arrays(p, seed=0)
        bad = NativeSimulator(p)
        with pytest.raises(machine.SimulationError,
                           match="stale/underflow"):
            bad.run(inputs)
        # a second run of the SAME faulted object must fault again from
        # an actual bad read, and a clean program sharing the process
        # must be unaffected
        with pytest.raises(machine.SimulationError,
                           match="stale/underflow"):
            bad.run(inputs)
        monkeypatch.setattr(native, "access_windows", real)
        clean = NativeSimulator(sft.parse_program(
            jacobi(3, 8, iterations=2), name="cleanchk"))
        res = clean.run(inputs)
        assert res.cycles > 0

    def test_native_deadlock_is_deadlockerror(self, monkeypatch):
        """Undersized edge: the native engine raises the same
        DeadlockError subclass as the Python machine."""
        from stencilflow_tpu.sim import machine, native
        real = machine.edge_capacities

        def undersize(program, analysis, windows=None, slack=0):
            caps = dict(real(program, analysis, windows, slack))
            caps[("a", "s0")] = 2
            return caps
        monkeypatch.setattr(native, "edge_capacities", undersize)
        p = sft.parse_program(jacobi(3, 8, iterations=2), name="ddlk_cc")
        inputs = sft.load_input_arrays(p, seed=0)
        with pytest.raises(machine.DeadlockError):
            NativeSimulator(p).run(inputs)

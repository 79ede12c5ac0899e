"""Differential fuzzing: random stencil chains through every engine.

Random DAGs (forks/joins, ternaries, min/max, mixed offsets and BCs, a
lower-dimensional input and a scalar) evaluated by the numpy oracle, the
fused-XLA backend (single-device, sharded, pipelined, out of core) and the
native C++ simulator — all must agree.  This is the dialect-wide generalization of
the reference's fixture-based ProgramTest sweep."""
import numpy as np
import pytest

import stencilflow_tpu as sft
from stencilflow_tpu.backend.xla import run_chain
from stencilflow_tpu.sim.native import NativeSimulator

OPS = ["add", "sub", "mult"]
BCS = ["constant", "copy"]


def _offset_str(iters, offs):
    parts = []
    for it, o in zip(iters, offs):
        parts.append(it if o == 0 else (f"{it}+{o}" if o > 0
                                        else f"{it}-{-o}"))
    return "[" + ", ".join(parts) + "]"


def make_random_program(rng: np.random.Generator, seed_id: int,
                        ndim: int = 0):
    ndim = ndim or int(rng.integers(2, 4))
    dims = [int(rng.integers(4, 9)) for _ in range(ndim)]
    iters = ["i", "j", "k"][3 - ndim:]
    n_stages = int(rng.integers(2, 6))

    def rand_access(field):
        offs = [int(rng.integers(-2, 3)) for _ in range(ndim)]
        return field + _offset_str(iters, offs)

    def rand_expr(avail, depth=0):
        r = rng.random()
        if depth > 2 or r < 0.35:
            choice = rng.random()
            if choice < 0.6:
                return rand_access(str(rng.choice(avail)))
            if choice < 0.75:
                return f"{rng.uniform(-2, 2):.3f}"
            if choice < 0.85:
                return "sc"
            if choice < 0.93 or ndim == 2:
                # lower-dim access arity matches the field rank
                return "row" + _offset_str(["k"],
                                           [int(rng.integers(-1, 2))])
            # i-spanning partial field (3-D programs only)
            return "ik" + _offset_str(
                ["i", "k"], [int(rng.integers(-1, 2)),
                             int(rng.integers(-1, 2))])
        if r < 0.75:
            op = {"add": "+", "sub": "-", "mult": "*"}[
                str(rng.choice(OPS))]
            return (f"({rand_expr(avail, depth + 1)} {op} "
                    f"{rand_expr(avail, depth + 1)})")
        if r < 0.85:
            return (f"min({rand_expr(avail, depth + 1)}, "
                    f"{rand_expr(avail, depth + 1)})")
        if r < 0.95:
            return (f"({rand_expr(avail, depth + 1)} if "
                    f"{rand_expr(avail, depth + 1)} > 0.0 else "
                    f"{rand_expr(avail, depth + 1)})")
        return f"abs({rand_expr(avail, depth + 1)})"

    inputs = {
        "a": {"data": "random:-1,1", "data_type": "float32"},
        "row": {"data": "random:-1,1", "data_type": "float32",
                "input_dims": ["k"]},
        "sc": {"data": float(rng.uniform(-1, 1)), "data_type": "float32",
               "input_dims": []},
    }
    if ndim == 3:
        inputs["ik"] = {"data": "random:-1,1", "data_type": "float32",
                        "input_dims": ["i", "k"]}
    program = {}
    avail = ["a"]
    for s in range(n_stages):
        name = f"s{s}"
        expr = rand_expr(avail)
        # guarantee a structural dependency on the previous stage
        if s > 0:
            expr = f"({expr} + {rand_access(avail[-1])})"
        used = sorted({f for f in ["a", "row", "ik"] + avail
                       if f in expr})
        bcs = {}
        for f in used:
            kind = str(rng.choice(BCS))
            bcs[f] = {"type": kind, "value": float(rng.uniform(-1, 1))}
        program[name] = {
            "computation_string": f"{name} = {expr}",
            "boundary_conditions": bcs,
            "data_type": "float32",
        }
        avail.append(name)
    return {
        "inputs": inputs,
        "outputs": [avail[-1]],
        "dimensions": dims,
        "program": program,
    }


def _deep_program(rng, stages, max_r=3):
    """Deep chain with random radii and occasional long-range reconvergence
    (stresses the cumulative-halo and delay algebra)."""
    dims = [int(rng.integers(8, 13)) for _ in range(3)]
    prog = {}
    avail = ["a"]
    for s in range(stages):
        prev = avail[-1]
        offs = [[int(rng.integers(-max_r, max_r + 1)) for _ in range(3)]
                for _ in range(int(rng.integers(2, 5)))]
        terms = " + ".join(
            prev + "[" + ",".join(
                f"{it}{o:+d}" if o else it
                for it, o in zip("ijk", off)) + "]"
            for off in offs)
        fields = {prev}
        extra = ""
        if s > 2 and rng.random() < 0.4:
            far = str(rng.choice(avail[:-1]))
            extra = f" + 0.1 * {far}[i,j,k]"
            fields.add(far)
        prog[f"s{s}"] = {
            "computation_string":
                f"s{s} = {1.0/len(offs):.5f} * ({terms}){extra}",
            "boundary_conditions": {
                f: {"type": "constant",
                    "value": float(rng.uniform(-1, 1))} for f in fields},
            "data_type": "float32"}
        avail.append(f"s{s}")
    return {"inputs": {"a": {"data": "random:-1,1",
                             "data_type": "float32"}},
            "outputs": [avail[-1]], "dimensions": dims, "program": prog}


@pytest.mark.parametrize("seed", [0, 5])
def test_deep_chain_stream_and_sim(seed):
    rng = np.random.default_rng(7000 + seed)
    spec = _deep_program(rng, int(rng.integers(10, 17)))
    p = sft.parse_program(spec, name=f"deep{seed}")
    inputs = sft.load_input_arrays(p, seed=seed)
    out = p.outputs[0]
    ref = np.asarray(sft.run_interpreter(p, inputs)[out], dtype=np.float64)
    got = run_chain(p, inputs)[out]
    np.testing.assert_allclose(got, ref, rtol=3e-5, atol=1e-6)
    gs = NativeSimulator(p).run(inputs).outputs[out]
    np.testing.assert_allclose(gs, ref, rtol=3e-5, atol=1e-6)


def _affine_program(rng, stages):
    """Random wide-footprint affine chains (wide and narrow stages mixed),
    constant BCs with random values."""
    dims = [int(rng.integers(3, 6)), int(rng.choice([24, 32])),
            int(rng.choice([16, 24, 32]))]
    prog = {}
    avail = ["a"]
    for s in range(stages):
        prev = avail[-1]
        r = int(rng.integers(1, 3))
        n = int(rng.integers(6, 18))
        offsets = set()
        while len(offsets) < n:
            offsets.add((int(rng.integers(-1, 2)),
                         int(rng.integers(-r, r + 1)),
                         int(rng.integers(-r, r + 1))))
        terms = " + ".join(
            f"{float(rng.uniform(0.3, 1.5)) / n:.5f} * {prev}[" +
            ",".join(f"{it}{o:+d}" if o else it
                     for it, o in zip("ijk", off)) + "]"
            for off in sorted(offsets))
        bias = (f" + {float(rng.uniform(-0.5, 0.5)):.4f}"
                if rng.random() < 0.5 else "")
        prog[f"s{s}"] = {
            "computation_string": f"s{s} = {terms}{bias}",
            "boundary_conditions": {
                prev: {"type": "constant",
                       "value": float(rng.uniform(-1, 1))}},
            "data_type": "float32"}
        avail.append(f"s{s}")
    return {"inputs": {"a": {"data": "random:-1,1",
                             "data_type": "float32"}},
            "outputs": [avail[-1]], "dimensions": dims, "program": prog}


@pytest.mark.parametrize("seed", range(6))
def test_random_affine_chains(seed):
    """Random wide-footprint affine chains through the single-device and
    mesh-sharded fused-XLA paths, and their adjoints against autodiff."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from stencilflow_tpu.parallel.domain import compile_sharded_chain

    rng = np.random.default_rng(3000 + seed)
    spec = _affine_program(rng, int(rng.integers(2, 4)))
    p = sft.parse_program(spec, name=f"affine{seed}")
    inputs = sft.load_input_arrays(p, seed=seed)
    out = p.outputs[0]
    ref = np.asarray(sft.run_interpreter(p, inputs)[out], dtype=np.float64)

    got = np.asarray(run_chain(p, inputs)[out])
    np.testing.assert_allclose(got, ref, rtol=3e-5, atol=1e-6,
                               err_msg="single device")

    devs = np.array(jax.devices()[:4]).reshape(2, 2)
    mesh = Mesh(devs, ("x", "y"))
    fn3, plan3 = compile_sharded_chain(p, mesh, (None, "x", "y"))
    sh = plan3.input_shardings()
    dev_in = {n: jax.device_put(jnp.asarray(v), sh[n])
              for n, v in inputs.items()}
    got3 = np.asarray(fn3(dev_in)[out])
    assert_close_modulo_reassociation(got3, ref, spec, inputs, out,
                                      "sharded (j,k)")

    vg = sft.value_and_grad(p)(inputs)
    fvg = sft.fast_value_and_grad(p)(inputs)
    np.testing.assert_allclose(float(fvg[0]), float(vg[0]), rtol=1e-4)
    np.testing.assert_allclose(np.asarray(fvg[1]["a"]),
                               np.asarray(vg[1]["a"]), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("seed", range(4))
def test_random_multi_output_programs(seed):
    """Random DAGs exposing TWO outputs at different pipeline depths
    (multi-output paths in every engine)."""
    rng = np.random.default_rng(8000 + seed)
    spec = make_random_program(rng, seed)
    kernels = list(spec["program"])
    if len(kernels) < 2:
        pytest.skip("single-kernel draw")
    # expose a mid-chain kernel alongside the final one
    extra = kernels[int(rng.integers(0, len(kernels) - 1))]
    spec["outputs"] = sorted({spec["outputs"][0], extra})
    p = sft.parse_program(spec, name=f"mo{seed}")
    inputs = sft.load_input_arrays(p, seed=seed)
    ref = {o: np.asarray(v, dtype=np.float64)
           for o, v in sft.run_interpreter(p, inputs).items()}
    for name, engine in [
            ("xla", lambda: run_chain(p, inputs)),
            ("xla interpreter strategy",
             lambda: run_chain(p, inputs, strategy="interpreter")),
            ("sim", lambda: NativeSimulator(p).run(inputs).outputs)]:
        got = engine()
        for o in p.outputs:
            np.testing.assert_allclose(
                got[o], ref[o], rtol=2e-5, atol=1e-6,
                err_msg=f"{name}:{o}")


@pytest.mark.parametrize("seed", range(20))
def test_random_program_all_engines(seed):
    rng = np.random.default_rng(1000 + seed)
    spec = make_random_program(rng, seed)
    p = sft.parse_program(spec, name=f"fuzz{seed}")
    inputs = sft.load_input_arrays(p, seed=seed)
    out = p.outputs[0]
    ref = np.asarray(sft.run_interpreter(p, inputs)[out],
                     dtype=np.float64)

    got_xla = run_chain(p, inputs)[out]
    np.testing.assert_allclose(got_xla, ref, rtol=2e-5, atol=1e-6,
                               err_msg="xla backend")

    got_interp = run_chain(p, inputs, strategy="interpreter")[out]
    np.testing.assert_allclose(got_interp, ref, rtol=2e-5, atol=1e-6,
                               err_msg="xla interpreter strategy")

    got_sim = NativeSimulator(p).run(inputs).outputs[out]
    np.testing.assert_allclose(got_sim, ref, rtol=2e-5, atol=1e-6,
                               err_msg="native simulator")


def assert_close_modulo_reassociation(got, ref, spec, inputs, out,
                                      label):
    """allclose(rtol=2e-5), except for RARE cells where two equally
    valid f32 evaluations legitimately part ways: XLA contracts a*b+c
    to FMA differently across compilations (measured: the shard_map
    body vs the jitted interpreter — ~1 ulp at ~15% of cells on a
    mul-add-heavy random chain), and cancellation can amplify that
    1 ulp past any fixed relative tolerance.  Outliers must be (1) rare
    (< 0.2% of cells) and (2) no farther from the float64 truth than
    plain f32 rounding puts the oracle itself at those cells — a
    genuine halo/stitching bug fails both."""
    import copy
    close = np.isclose(got, ref, rtol=2e-5, atol=1e-6)
    if close.all():
        return
    frac = 1.0 - close.mean()
    assert frac < 2e-3, f"{label}: {frac:.2%} of cells mismatch"
    spec64 = copy.deepcopy(spec)
    for k in spec64["program"]:
        spec64["program"][k]["data_type"] = "float64"
    for k in spec64["inputs"]:
        spec64["inputs"][k]["data_type"] = "float64"
    p64 = sft.parse_program(spec64, name="shadow64")
    in64 = {k: np.asarray(v).astype(np.float64)
            for k, v in inputs.items()}
    truth = np.asarray(sft.run_interpreter(p64, in64)[out])
    bad = ~close
    e_got = np.abs(got.astype(np.float64) - truth)[bad].max()
    e_ref = np.abs(ref.astype(np.float64) - truth)[bad].max()
    assert e_got <= 8 * e_ref + 1e-5, (
        f"{label}: outlier cells are farther from the f64 truth "
        f"({e_got:.3e}) than f32 rounding explains ({e_ref:.3e})")


def make_mixed_dtype_program(rng, nondyadic: bool = False,
                             amplified_consumer: bool = False):
    """Random chains with a different dtype per kernel (float32/float64/
    int32/int16/bool): edges carry the PRODUCER's dtype, results are cast
    once at each kernel's output (the oracle's semantics — see
    interpreter.eval_kernel).  Constants are kept f32-exact (the jnp
    backends hold them weak where the numpy oracle pins them) and small
    enough for every int width (NEP 50 raises on out-of-range weak ints).

    ``nondyadic`` draws full-precision float consts (0.1-like values
    whose f32 vs f64 compute differs) and ``amplified_consumer`` appends
    an int32 stage multiplying the chain output by 2**10 — together they
    make the mixed int x float PROMOTION spec observable (ADVICE r4: the
    dyadic consts of the base leg are exact in both f32 and f64, hiding
    a wrong compute dtype)."""
    dims = [int(rng.integers(4, 8)) for _ in range(3)]

    def acc(field):
        offs = [int(rng.integers(-1, 2)) for _ in range(3)]
        return field + _offset_str(["i", "j", "k"], offs)

    def fconst():
        if nondyadic:
            return f"{float(rng.uniform(-2, 2))!r}"
        return f"{round(float(rng.uniform(-2, 2)) * 64) / 64!r}"

    inputs = {"a": {"data": "random:-1,1", "data_type": "float32"},
              "n": {"data": "random:1,40", "data_type": "int32"}}
    avail = [("a", "float32"), ("n", "int32")]
    prog = {}
    stages = int(rng.integers(3, 6))
    for s in range(stages):
        name = f"s{s}"
        dt = str(rng.choice(["float32", "float64", "int32", "int16",
                             "bool"]))
        picks = [avail[-1]] + [avail[int(rng.integers(0, len(avail)))]]
        (x, xdt), (y, ydt) = picks

        def term(f, fdt):
            a = acc(f)
            if fdt == "bool":
                # bool fields enter arithmetic via promotion (mask mult)
                return f"({a} * {int(rng.integers(1, 4))})"
            return a
        if dt == "bool":
            expr = f"({term(x, xdt)} > {term(y, ydt)})"
        elif dt.startswith("int"):
            c = int(rng.integers(-5, 8))
            expr = (f"({term(x, xdt)} * {int(rng.integers(1, 4))} "
                    f"- {term(y, ydt)} + {c})")
            if rng.random() < 0.4:
                expr = f"min({expr}, {term(x, xdt)})"
            if rng.random() < 0.3:
                expr = f"abs({expr})"
        else:
            expr = (f"({term(x, xdt)} * {fconst()} + {term(y, ydt)})")
            if rng.random() < 0.4:
                expr = (f"({expr} if {term(x, xdt)} > {fconst()} "
                        f"else {term(y, ydt)})")
        bcs = {}
        for f, fdt in dict(picks).items():
            if fdt == "bool":
                bcs[f] = {"type": "constant", "value": 0}
            elif fdt.startswith("int"):
                bcs[f] = {"type": "constant",
                          "value": int(rng.integers(0, 5))}
            else:
                bcs[f] = {"type": str(rng.choice(BCS)),
                          "value": float(round(rng.uniform(-1, 1) * 64)
                                         / 64)}
        prog[name] = {"computation_string": f"{name} = {expr}",
                      "boundary_conditions": bcs, "data_type": dt}
        avail.append((name, dt))
    if amplified_consumer:
        last = avail[-1][0]
        mul = 1 if avail[-1][1] == "bool" else 1024
        prog["amp"] = {
            "computation_string": f"amp = {acc(last)} * {mul}",
            "boundary_conditions": {
                last: {"type": "constant", "value": 0}},
            "data_type": "int32"}
        avail.append(("amp", "int32"))
    return {"inputs": inputs, "outputs": [avail[-1][0]],
            "dimensions": dims, "program": prog}


@pytest.mark.parametrize("seed", range(8))
def test_random_mixed_dtype_programs(seed):
    """Cross-dtype edges through every engine: oracle, Python machine,
    native C++ simulator, fused XLA (tile and interpreter strategies).
    Integer/bool outputs must be bit-equal (incl. wraparound); float
    outputs within the usual tolerance."""
    import warnings
    from stencilflow_tpu.sim.machine import Simulator
    rng = np.random.default_rng(42000 + seed)
    spec = make_mixed_dtype_program(rng)
    p = sft.parse_program(spec, name=f"mixdt{seed}")
    inputs = sft.load_input_arrays(p, seed=seed)
    out = p.outputs[0]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # int overflow wrap is on purpose
        ref = np.asarray(sft.run_interpreter(p, inputs)[out])
        got_py = Simulator(p).run(inputs).outputs[out]
    engines = [("python machine", np.asarray(got_py)),
               ("native simulator",
                np.asarray(NativeSimulator(p).run(inputs).outputs[out])),
               ("xla backend", np.asarray(run_chain(p, inputs)[out])),
               ("xla interpreter strategy",
                np.asarray(run_chain(p, inputs,
                                     strategy="interpreter")[out]))]
    exact = ref.dtype.kind in "ib"
    for label, got in engines:
        assert got.dtype == ref.dtype, label
        if exact:
            np.testing.assert_array_equal(got, ref, err_msg=label)
        else:
            np.testing.assert_allclose(
                got.astype(np.float64), ref.astype(np.float64),
                rtol=2e-5, atol=1e-6, err_msg=label)


@pytest.mark.parametrize("seed", range(8))
def test_random_mixed_promotion_programs(seed):
    """The mixed int x float PROMOTION spec under non-dyadic consts with
    an amplified int32 consumer (ADVICE r4): the three numpy-semantics
    engines (oracle / Python machine / native C++) must stay BIT-equal —
    a wrong compute dtype (numpy's f64 widening) shows up here as whole
    integer counts.  The jnp engines are checked to a small absolute
    slack on the amplified ints: XLA CPU contracts `a*c1 + b*c2` into
    FMA (~1 f32 ulp, a platform artifact orthogonal to promotion —
    tests/test_mixed_promotion.py pins the spec itself discretely)."""
    import warnings
    from stencilflow_tpu.sim.machine import SimulationError, Simulator
    rng = np.random.default_rng(52000 + seed)
    spec = make_mixed_dtype_program(rng, nondyadic=True,
                                    amplified_consumer=True)
    p = sft.parse_program(spec, name=f"mixpr{seed}")
    inputs = sft.load_input_arrays(p, seed=seed)
    out = p.outputs[0]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # int overflow wrap on purpose
        ref = np.asarray(sft.run_interpreter(p, inputs)[out])
        got_py = np.asarray(Simulator(p).run(inputs).outputs[out])
        np.testing.assert_array_equal(got_py, ref,
                                      err_msg="python machine")
        try:
            got_nat = np.asarray(
                NativeSimulator(p).run(inputs).outputs[out])
            np.testing.assert_array_equal(got_nat, ref,
                                          err_msg="native simulator")
        except SimulationError:
            pass   # outside the native scope (bf16 mixing etc.)
        for label, got in [
                ("xla", np.asarray(run_chain(p, inputs)[out])),
                ("xla interpreter strategy", np.asarray(run_chain(
                    p, inputs, strategy="interpreter")[out]))]:
            assert got.dtype == ref.dtype, label
            if ref.dtype.kind in "ib":
                d = np.abs(got.astype(np.int64) - ref.astype(np.int64))
                assert d.max() <= 8, (label, d.max())
            else:
                np.testing.assert_allclose(
                    got.astype(np.float64), ref.astype(np.float64),
                    rtol=2e-5, atol=1e-6, err_msg=label)


@pytest.mark.parametrize("seed", range(10))
def test_random_2d_programs(seed):
    """2-D random DAGs (padded to (1, J, K)) through the fused-XLA tile
    and interpreter strategies and the (j, k)-sharded body vs the
    oracle."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from stencilflow_tpu.backend.xla import chain_halo
    from stencilflow_tpu.frontend.analysis import ChainAnalysis
    from stencilflow_tpu.parallel.domain import compile_sharded_chain

    rng = np.random.default_rng(4200 + seed)
    spec = make_random_program(rng, seed, ndim=2)
    halo = chain_halo(ChainAnalysis.run(sft.parse_program(spec,
                                                          name="probe")))
    # every 2-way-sharded block must be wider than the halo
    spec["dimensions"] = [max(d, 2 * (h + 1))
                          for d, h in zip(spec["dimensions"], halo[1:])]
    spec["dimensions"] = [d + d % 2 for d in spec["dimensions"]]
    p = sft.parse_program(spec, name=f"r2d{seed}")
    inputs = sft.load_input_arrays(p, seed=seed)
    out = p.outputs[0]
    ref = np.asarray(sft.run_interpreter(p, inputs)[out], np.float64)
    for strategy in ("tile", "interpreter"):
        got = np.asarray(run_chain(p, inputs, strategy=strategy)[out])
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=2e-5, atol=1e-6,
                                   err_msg=strategy)
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("x", "y"))
    fn, plan = compile_sharded_chain(p, mesh, (None, "x", "y"))
    sh = plan.input_shardings()
    got = np.asarray(fn({n: jax.device_put(jnp.asarray(v), sh[n])
                         for n, v in inputs.items()})[out])
    assert_close_modulo_reassociation(got, ref, spec, inputs, out,
                                      "sharded (j,k)")


@pytest.mark.parametrize("seed", [0, 3])
def test_random_outofcore_and_pipeline(seed):
    """Random 3-D DAGs through the out-of-core chunk body and the 2-way
    pipeline split vs the oracle."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from stencilflow_tpu.backend.xla import chain_halo
    from stencilflow_tpu.frontend.analysis import ChainAnalysis
    from stencilflow_tpu.outofcore import run_chunked
    from stencilflow_tpu.parallel.pipeline import compile_pipeline_split

    rng = np.random.default_rng(4300 + seed)
    spec = make_random_program(rng, seed, ndim=3)
    # each of the 2 chunks must keep an interior after halo widening
    h = chain_halo(ChainAnalysis.run(sft.parse_program(spec,
                                                       name="probe")))[0]
    spec["dimensions"][0] = 2 * (h + 2)
    p = sft.parse_program(spec, name=f"ooc{seed}")
    inputs = sft.load_input_arrays(p, seed=seed)
    out = p.outputs[0]
    ref = np.asarray(sft.run_interpreter(p, inputs)[out], np.float64)
    got = run_chunked(p, inputs, chunks=2)[out]
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=1e-6,
                               err_msg="out of core")
    mesh = Mesh(np.array(jax.devices()[:2]), ("p",))
    fn, _ = compile_pipeline_split(p, mesh, "p", io="replicated")
    got = np.asarray(fn({k: jnp.asarray(v) for k, v in inputs.items()})[out])
    assert_close_modulo_reassociation(got, ref, spec, inputs, out,
                                      "pipeline")


@pytest.mark.parametrize("seed", range(4))
def test_random_program_comm_overlap(seed):
    """Random DAGs through the comm/compute-overlapped sharded body
    ((j, k) and i sharding) vs the oracle — the fuzz generalization of
    test_comm_overlap's crafted cases."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from stencilflow_tpu.backend.xla import chain_halo
    from stencilflow_tpu.frontend.analysis import ChainAnalysis
    from stencilflow_tpu.parallel.domain import compile_sharded_chain

    rng = np.random.default_rng(9100 + seed)
    spec = make_random_program(rng, seed)
    p0 = sft.parse_program(spec, name=f"ov{seed}")
    halo = chain_halo(ChainAnalysis.run(p0))
    # re-dimension so every 2-way-sharded block keeps an interior
    # (block = 2h+2 > 2*halo is required by the overlap bodies)
    nd = len(spec["dimensions"])
    spec["dimensions"] = [2 * (2 * h + 2) for h in halo[3 - nd:]]
    p = sft.parse_program(spec, name=f"ov{seed}w")
    inputs = sft.load_input_arrays(p, seed=seed)
    out = p.outputs[0]
    ref = np.asarray(sft.run_interpreter(p, inputs)[out], np.float64)

    devs = np.array(jax.devices()[:4]).reshape(2, 2)
    mesh = Mesh(devs, ("x", "y"))
    fn, plan = compile_sharded_chain(p, mesh, (None, "x", "y"),
                                     comm_overlap=True)
    sh = plan.input_shardings()
    dev_in = {n: jax.device_put(jnp.asarray(v), sh[n])
              for n, v in inputs.items()}
    got = np.asarray(fn(dev_in)[out])
    assert_close_modulo_reassociation(got, ref, spec, inputs, out,
                                      "xla comm_overlap (j,k)")

    if len(p.raw_dimensions) == 3 and halo[0] > 0:
        mesh1 = Mesh(np.array(jax.devices()[:2]), ("x",))
        fn1, plan1 = compile_sharded_chain(p, mesh1, ("x", None, None),
                                           comm_overlap=True)
        sh1 = plan1.input_shardings()
        dev1 = {n: jax.device_put(jnp.asarray(v), sh1[n])
                for n, v in inputs.items()}
        got1 = np.asarray(fn1(dev1)[out])
        assert_close_modulo_reassociation(got1, ref, spec, inputs, out,
                                          "xla comm_overlap (i)")


@pytest.mark.parametrize("seed", range(6))
def test_random_mixed_dtype_sharded(seed):
    """Mixed-dtype chains (bool/int/float edges, incl. bool fields read
    at i-offsets) through the domain-decomposed path on the CPU mesh:
    int/bool halo exchange and the sharded bodies must match the oracle
    bit-exactly for int/bool outputs."""
    import warnings

    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from stencilflow_tpu.backend.xla import chain_halo
    from stencilflow_tpu.frontend.analysis import ChainAnalysis
    from stencilflow_tpu.parallel.domain import compile_sharded_chain

    rng = np.random.default_rng(77200 + seed)
    spec = make_mixed_dtype_program(rng)
    p0 = sft.parse_program(spec, name=f"mixsh{seed}")
    halo = chain_halo(ChainAnalysis.run(p0))
    # re-dimension so every 2-way-sharded block keeps an interior
    spec["dimensions"] = [2 * (2 * h + 2) for h in halo]
    p = sft.parse_program(spec, name=f"mixsh{seed}w")
    inputs = sft.load_input_arrays(p, seed=seed)
    out = p.outputs[0]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # int wraparound is on purpose
        ref = np.asarray(sft.run_interpreter(p, inputs)[out])

    def check(fn, plan, label):
        sh = plan.input_shardings()
        dev_in = {n: jax.device_put(jnp.asarray(v), sh[n])
                  for n, v in inputs.items()}
        got = np.asarray(fn(dev_in)[out])
        assert got.dtype == ref.dtype, label
        if ref.dtype.kind in "ib":
            np.testing.assert_array_equal(got, ref, err_msg=label)
        else:
            assert_close_modulo_reassociation(got, ref, spec, inputs,
                                              out, label)

    devs = np.array(jax.devices()[:4]).reshape(2, 2)
    mesh = Mesh(devs, ("x", "y"))
    fn, plan = compile_sharded_chain(p, mesh, (None, "x", "y"))
    check(fn, plan, "xla sharded (j,k)")

    if halo[0] > 0:
        mesh1 = Mesh(np.array(jax.devices()[:2]), ("x",))
        fn1, plan1 = compile_sharded_chain(p, mesh1, ("x", None, None))
        check(fn1, plan1, "xla sharded (i)")

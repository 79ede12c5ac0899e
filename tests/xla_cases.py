"""Edge-case stencil programs and the fused-XLA execution paths they run
through, shared by the test_paths_* modules (``run_path``).

Each case is a program spec in the JSON dialect.  ``paths_for`` lists the
paths a case is in scope for, decided from the program alone (rank,
divisibility, halo against block size), so every worker collects the same
tests.  ``check`` compares a path's outputs with the numpy oracle: bit-exact
for int/bool outputs, float outputs within the fused-evaluation tolerance,
and shrink-BC programs on the core that excludes the chain halo.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

import stencilflow_tpu as sft
from stencilflow_tpu.synthesize import synthesize_stencil


def _bc(field, kind="constant", value=0.0):
    return {field: {"type": kind, "value": value}}


def _kernel(text, bcs, dtype="float32"):
    return {"computation_string": text, "boundary_conditions": bcs,
            "data_type": dtype}


def _rand(dtype="float32", lo=-1, hi=1, dims=None):
    spec = {"data": f"random:{lo},{hi}", "data_type": dtype}
    if dims is not None:
        spec["input_dims"] = dims
    return spec


def _synth(shape, dims, stages=2, **kw):
    kw.setdefault("seed_data", "random:-1,1")
    return synthesize_stencil(num_stages=stages, dimensions=dims,
                              shape=shape, **kw)


def _asym():
    return {"inputs": {"a": _rand(),
                       "c": {"data": 0.25, "data_type": "float32",
                             "input_dims": []}},
            "outputs": ["v"], "dimensions": [12, 8, 16],
            "program": {
                "u": _kernel("u = c * (a[i-2,j,k] + a[i,j,k])",
                             _bc("a", value=2.0)),
                "v": _kernel("v = u[i+1,j,k] - u[i,j-1,k]",
                             _bc("u", value=1.0))}}


def _multiout():
    return {"inputs": {"a": _rand()},
            "outputs": ["shallow", "deep"], "dimensions": [12, 8, 16],
            "program": {
                "shallow": _kernel(
                    "shallow = 0.5 * (a[i-1,j,k] + a[i+1,j,k])", _bc("a")),
                "mid": _kernel("mid = shallow[i,j-1,k] + shallow[i,j+1,k]",
                               _bc("shallow", value=1.0)),
                "deep": _kernel("deep = mid[i+2,j,k] - a[i,j,k]",
                                {**_bc("mid"), **_bc("a")})}}


def _diag_copy():
    return {"inputs": {"a": _rand()},
            "outputs": ["y"], "dimensions": [8, 12, 12],
            "program": {
                "m": _kernel("m = 0.5*a[i-2,j+2,k+2] + a[i+1,j-1,k-1]",
                             _bc("a", "copy")),
                "y": _kernel("y = m[i,j,k] + m[i,j+1,k-1]",
                             _bc("m", "copy"))}}


def _wide_j(kind):
    return {"inputs": {"a": _rand()},
            "outputs": ["y"], "dimensions": [4, 256, 16],
            "program": {
                "m": _kernel("m = a[i,j-1,k] + 0.5*a[i,j+2,k+1] "
                             "+ 0.25*a[i-1,j+1,k]", _bc("a", kind, 0.25)),
                "y": _kernel("y = m[i,j,k] + m[i,j-2,k]",
                             _bc("m", kind, 0.25))}}


def _partial_rank():
    return {"inputs": {"a": _rand(),
                       "cik": _rand(lo=0, dims=["i", "k"]),
                       "cij": _rand(lo=0, dims=["i", "j"])},
            "outputs": ["y"], "dimensions": [8, 16, 32],
            "program": {"y": _kernel(
                "y = a[i,j,k] + cik[i,k] * a[i-1,j,k]"
                " + cij[i,j] * a[i,j+1,k]", _bc("a", value=0.5))}}


def _static_coef():
    return {"inputs": {"a": _rand(),
                       "c": _rand(lo=1, hi=2, dims=["j", "k"])},
            "outputs": ["s1"], "dimensions": [8, 16, 16],
            "program": {
                "s0": _kernel("s0 = c[j,k] * (a[i-1,j,k] + a[i+1,j,k])",
                              {**_bc("a"), **_bc("c", value=1.0)}),
                "s1": _kernel("s1 = c[j,k] + s0[i-1,j,k] + s0[i+1,j,k]",
                              {**_bc("s0"), **_bc("c", value=1.0)})}}


def _mixed_2d():
    return {"inputs": {"a": _rand(),
                       "col": _rand(dims=["j"]),
                       "row": _rand(dims=["k"]),
                       "sc": {"data": 0.5, "data_type": "float32",
                              "input_dims": []}},
            "outputs": ["c"], "dimensions": [48, 48],
            "program": {
                "b": _kernel("b = 0.25*(a[j-1,k]+a[j+1,k]+a[j,k-1]"
                             "+a[j,k+1]) + col[j] + row[k-1]*sc",
                             {**_bc("a", value=1.0), **_bc("col"),
                              **_bc("row")}),
                "c": _kernel("c = b[j,k] - 0.5*(b[j-2,k+1] + b[j+1,k-2])",
                             {"b": {"type": "copy"}})}}


def _const_ireach():
    return {"inputs": {"a": _rand()},
            "outputs": ["s1"], "dimensions": [16, 8, 16],
            "program": {
                "s0": _kernel("s0 = -0.748", {}),
                "s1": _kernel("s1 = s0[i+2,j,k] + s0[i-2,j,k] + a[i,j,k]",
                              {**_bc("s0", value=0.5), **_bc("a")})}}


def _bool_ihist():
    return {"inputs": {"a": _rand()},
            "outputs": ["s"], "dimensions": [8, 8, 8],
            "program": {
                "m": _kernel("m = a[i,j,k] > 0.0", _bc("a"), "bool"),
                "s": _kernel("s = (m[i-1,j+1,k] * 2) * 0.25 + a[i,j,k]",
                             {"m": {"type": "constant", "value": 0},
                              **_bc("a")})}}


def _narrow_int():
    return {"inputs": {"n": _rand("int32", 1, 40)},
            "outputs": ["t"], "dimensions": [6, 14, 6],
            "program": {
                "s": _kernel("s = n[i-1,j,k] * 3 - n[i,j+1,k]",
                             {"n": {"type": "constant", "value": 2}},
                             "int16"),
                "t": _kernel("t = min(s[i,j,k-1] + s[i+1,j,k], s[i,j,k])",
                             {"s": {"type": "constant", "value": 1}},
                             "int16")}}


def _mixed_cross():
    return {"inputs": {"a": _rand()},
            "outputs": ["s3"], "dimensions": [16, 8, 8],
            "program": {
                "s0": _kernel("s0 = (a[i-1,j,k] + a[i+1,j,k]) * 0.5",
                              _bc("a"), "float64"),
                "s1": _kernel("s1 = s0[i,j,k] * 0.5", _bc("s0")),
                "s2": _kernel("s2 = s1[i-1,j,k] + s0[i,j,k]",
                              {**_bc("s1"), **_bc("s0")}, "float64"),
                "s3": _kernel("s3 = s2[i,j,k] * 2.0", _bc("s2"),
                              "float64")}}


def _jk_only():
    return {"inputs": {"c": _rand(lo=1, hi=2, dims=["j", "k"])},
            "outputs": ["s1"], "dimensions": [6, 8, 8],
            "program": {
                "s0": _kernel("s0 = c[j,k] * 2.0", _bc("c")),
                "s1": _kernel("s1 = s0[i-1,j,k] + s0[i+1,j,k]",
                              _bc("s0"))}}


def _fork_join():
    return {"inputs": {"a": _rand(),
                       "row": _rand(dims=["k"]),
                       "c": {"data": 1.5, "data_type": "float32",
                             "input_dims": []}},
            "outputs": ["res"], "dimensions": [8, 12, 16],
            "program": {
                "u": _kernel("u = a[i,j,k] * c + row[k]",
                             {**_bc("a"), **_bc("row")}),
                "v": _kernel("v = 0.5 * (u[i-1,j,k] + u[i+1,j,k])",
                             _bc("u", value=1.0)),
                "res": _kernel("res = v[i,j,k] + u[i,j+1,k]",
                               {**_bc("v"), **_bc("u")})}}


def _branches():
    def st(name, src):
        return _kernel(f"{name} = 0.25 * ({src}[i-1,j,k] + {src}[i+1,j,k] "
                       f"+ {src}[i,j,k-1] + {src}[i,j,k+1])", _bc(src))
    return {"inputs": {"a": _rand()},
            "outputs": ["j0"], "dimensions": [24, 8, 8],
            "program": {"s0": st("s0", "a"),
                        "aa0": st("aa0", "s0"), "aa1": st("aa1", "aa0"),
                        "bb0": st("bb0", "s0"), "bb1": st("bb1", "bb0"),
                        "j0": _kernel("j0 = aa1[i,j,k] + bb1[i,j,k]", {})}}


def _early_output():
    return {"inputs": {"a": _rand()},
            "outputs": ["early", "late"], "dimensions": [8, 12, 12],
            "program": {
                "early": _kernel("early = a[i,j,k] * 2.0 + a[i-1,j,k]",
                                 _bc("a")),
                "mid": _kernel("mid = early[i,j-1,k] + a[i,j,k]",
                               {**_bc("early"), **_bc("a")}),
                "late": _kernel("late = mid[i+1,j,k] + early[i,j,k] "
                                "+ a[i,j,k+1]",
                                {**_bc("mid"), **_bc("early"),
                                 **_bc("a")})}}


def _reconverge():
    prog, prev = {}, "a"
    for s in range(8):
        expr = (f"s{s} = 0.16 * ({prev}[i-1,j,k] + {prev}[i+1,j,k] + "
                f"{prev}[i,j-1,k] + {prev}[i,j+1,k] + {prev}[i,j,k-1] + "
                f"{prev}[i,j,k+1])")
        bcs = _bc(prev, value=0.2)
        if s % 4 == 3:
            expr += f" + 0.1 * s{s - 3}[i-3,j,k]"
            bcs.update(_bc(f"s{s - 3}", value=0.2))
        prog[f"s{s}"] = _kernel(expr, bcs)
        prev = f"s{s}"
    return {"inputs": {"a": _rand()}, "outputs": ["s7"],
            "dimensions": [32, 24, 32], "program": prog}


def _transcendental():
    return {"inputs": {"a": _rand(lo=0.5, hi=2)},
            "outputs": ["y"], "dimensions": [8, 8, 16],
            "program": {
                "t": _kernel("t = sqrt(a[i,j,k]) + exp(a[i-1,j,k] * 0.5)"
                             " - log(a[i,j,k+1])", _bc("a", value=1.0)),
                "y": _kernel("y = tanh(t[i,j,k]) * abs(t[i+1,j-1,k]) "
                             "/ (1.0 + t[i,j,k] * t[i,j,k])",
                             _bc("t", "copy"))}}


def _bf16_chain():
    return {"inputs": {"a": _rand("bfloat16")},
            "outputs": ["s1"], "dimensions": [8, 8, 16],
            "program": {
                "s0": _kernel("s0 = 0.5 * (a[i-1,j,k] + a[i+1,j,k])",
                              _bc("a"), "bfloat16"),
                "s1": _kernel("s1 = s0[i,j,k-1] * 0.25 + s0[i,j+1,k]",
                              _bc("s0"), "float32")}}


def _one_d():
    return _synth("diffusion", (64,), stages=3)


CASES = {
    "jacobi3d_constant": lambda: _synth("diffusion", (16, 16, 16), 3),
    "jacobi3d_copy": lambda: _synth("diffusion", (16, 16, 16), 3,
                                    boundary="copy"),
    "jacobi3d_shrink": lambda: _synth("diffusion", (16, 16, 16), 3,
                                      boundary="shrink"),
    "jacobi3d_bc_value": lambda: _synth("diffusion", (12, 16, 8), 2,
                                        boundary_value=0.7),
    "asymmetric_i_offsets_scalar": _asym,
    "multi_output_lags": _multiout,
    "hotspot_mixed_rank": lambda: _synth("hotspot", (8, 16, 16)),
    "diagonal_copy_bc": _diag_copy,
    "wide_j_constant": lambda: _wide_j("constant"),
    "wide_j_copy": lambda: _wide_j("copy"),
    "wide_j_shrink": lambda: _wide_j("shrink"),
    "partial_rank_i_inputs": _partial_rank,
    "static_jk_coefficient": _static_coef,
    "mixed_rank_2d": _mixed_2d,
    "jacobi2d": lambda: _synth("diffusion", (64, 64), 4),
    "wide_k_constant": lambda: _synth("diffusion", (8, 8, 256)),
    "wide_k_copy": lambda: _synth("diffusion", (8, 8, 256),
                                  boundary="copy"),
    "wide_k_shrink": lambda: _synth("diffusion", (8, 8, 256),
                                    boundary="shrink"),
    "box_r2_bc_value": lambda: _synth("box", (8, 16, 24), extent=2,
                                      boundary_value=0.3),
    "box_r1": lambda: _synth("box", (10, 12, 16)),
    "box_shrink": lambda: _synth("box", (12, 14, 16), boundary="shrink"),
    "cross_r3_2d": lambda: _synth("cross", (12, 16), extent=3),
    "constant_stage_i_reach": _const_ireach,
    "bool_i_history": _bool_ihist,
    "narrow_int_unaligned": _narrow_int,
    "mixed_float_crossing": _mixed_cross,
    "jk_rank_inputs_only": _jk_only,
    "fork_join_lower_rank": _fork_join,
    "interleaved_branches": _branches,
    "early_output_input_reuse": _early_output,
    "long_range_reconvergence": _reconverge,
    "hdiff": lambda: _synth("hdiff", (6, 16, 16)),
    "transcendental_ops": _transcendental,
    "bfloat16_edge": _bf16_chain,
    "one_d": _one_d,
}


def program(name):
    return sft.parse_program(copy.deepcopy(CASES[name]()), name=name)


def _halo(p):
    from stencilflow_tpu.backend.xla import chain_halo
    from stencilflow_tpu.frontend.analysis import ChainAnalysis
    return chain_halo(ChainAnalysis.run(p))


def shrink_halo(p):
    """Core margin to prune: the chain halo when any BC is shrink."""
    from stencilflow_tpu.ir import BCKind
    if any(bc.kind == BCKind.SHRINK for k in p.kernels.values()
           for bc in k.boundary_conditions.values()):
        return max(_halo(p))
    return 0


# mesh layouts: (mesh shape, dim_axes); axis names follow the shape
JK_LAYOUT = ((2, 2), (None, "x", "y"))
I_LAYOUT = ((2,), ("x", None, None))


def layout_ok(p, layout):
    shape, axes = layout
    names = ("x", "y")[:len(shape)]
    sizes = dict(zip(names, shape))
    halo = _halo(p)
    for d, ax in enumerate(axes):
        if ax is None:
            continue
        n = sizes[ax]
        if p.dimensions[d] % n:
            return False
        if halo[d] >= p.dimensions[d] // n:
            return False
    return True


def paths_for(name):
    p = program(name)
    halo = _halo(p)
    paths = ["tile", "interpreter"]
    if layout_ok(p, JK_LAYOUT):
        paths += ["sharded_jk", "overlap_jk"]
    if layout_ok(p, I_LAYOUT):
        paths += ["sharded_i", "overlap_i"]
    if len(p.kernels) >= 2:
        paths.append("pipeline")
    I = p.dimensions[0]
    if len(p.raw_dimensions) >= 2 and I % 2 == 0 and halo[0] < I // 2:
        paths.append("outofcore")
        if layout_ok(p, ((2, 2), (None, "x", "y"))):
            paths.append("outofcore_sharded")
    return paths


def check(p, inputs, got, label):
    ref = sft.run_interpreter(p, inputs)
    h = shrink_halo(p)
    for o in p.outputs:
        exp = np.asarray(ref[o])
        out = np.asarray(got[o])
        assert out.shape == exp.shape, (label, o, out.shape, exp.shape)
        assert out.dtype == exp.dtype, (label, o, out.dtype, exp.dtype)
        if h:
            core = tuple(slice(h, n - h) for n in exp.shape)
            exp, out = exp[core], out[core]
        if exp.dtype.kind in "iub":
            np.testing.assert_array_equal(out, exp, err_msg=f"{label}:{o}")
        else:
            tol = 1e-2 if exp.dtype.itemsize == 2 else 2e-5
            np.testing.assert_allclose(
                out.astype(np.float64), exp.astype(np.float64),
                rtol=tol, atol=1e-6, err_msg=f"{label}:{o}")


def _mesh(shape):
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices()[:n]).reshape(shape),
                ("x", "y")[:len(shape)])


def run_path(name, path):
    from stencilflow_tpu.backend.xla import run_chain
    from stencilflow_tpu.outofcore import run_chunked
    from stencilflow_tpu.parallel.domain import (compile_sharded_chain,
                                                 place_global_inputs)
    from stencilflow_tpu.parallel.pipeline import compile_pipeline_split

    p = program(name)
    inputs = sft.load_input_arrays(p, seed=7)
    if path in ("tile", "interpreter"):
        got = run_chain(p, inputs, strategy=path)
    elif path.startswith(("sharded_", "overlap_")):
        shape, axes = JK_LAYOUT if path.endswith("_jk") else I_LAYOUT
        fn, plan = compile_sharded_chain(
            p, _mesh(shape), axes, comm_overlap=path.startswith("overlap"))
        got = fn(place_global_inputs(p, plan, inputs))
    elif path == "pipeline":
        mesh = Mesh(np.array(jax.devices()[:2]), ("p",))
        fn, _plan = compile_pipeline_split(p, mesh, "p")
        got = fn({k: jnp.asarray(v) for k, v in inputs.items()})
    elif path == "outofcore":
        got = run_chunked(p, inputs, 2)
    elif path == "outofcore_sharded":
        shape, axes = JK_LAYOUT
        got = run_chunked(p, inputs, 2, mesh=_mesh(shape), dim_axes=axes)
    else:
        raise ValueError(path)
    check(p, inputs, got, f"{name}/{path}")

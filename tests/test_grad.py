"""Differentiability: adjoints of stencil chains (grad.py).

For a LINEAR chain y = A x, the gradient of sum(y) w.r.t. x is A^T 1 —
computable in closed form for interior points (each stage's coefficients
sum over the transposed stencil), giving exact oracles for reverse-mode
correctness.  Nonlinear programs (limiters/ternaries) must produce finite
subgradients, and the whole thing must remain jittable and composable
with further transforms.
"""
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import stencilflow_tpu as sft
from stencilflow_tpu.grad import adjoint_program
from stencilflow_tpu.synthesize import jacobi, synthesize_stencil


def test_linear_chain_adjoint_exact():
    # diffusion stages have coefficient sum 1, so d(sum y)/dx = 1 at
    # points whose stencil cone stays interior
    p = sft.parse_program(jacobi(3, 12, iterations=3), name="g1")
    inputs = {k: jnp.asarray(v)
              for k, v in sft.load_input_arrays(p, seed=0).items()}
    f = sft.value_and_grad(p)
    val, grads = f(inputs)
    g = np.asarray(grads["a"])
    assert g.shape == (12, 12, 12)
    np.testing.assert_allclose(g[4:8, 4:8, 4:8], 1.0, rtol=1e-5)
    # value matches the forward interpreter
    ref = sum(np.asarray(v).sum()
              for v in sft.run_interpreter(
                  p, sft.load_input_arrays(p, seed=0)).values())
    np.testing.assert_allclose(float(val), ref, rtol=1e-5)


def test_custom_loss_and_wrt():
    spec = synthesize_stencil(num_stages=2, dimensions=(6, 10, 10),
                              shape="hotspot")
    p = sft.parse_program(spec, name="g2")
    inputs = {k: jnp.asarray(v)
              for k, v in sft.load_input_arrays(p, seed=1).items()}
    out = p.outputs[0]
    f = sft.value_and_grad(p, loss=lambda o: (o[out] ** 2).sum(),
                           wrt=["a", "power"])
    _val, grads = f(inputs)
    assert set(grads) == {"a", "power"}
    assert all(np.isfinite(np.asarray(g)).all() for g in grads.values())
    with pytest.raises(ValueError, match="not program inputs"):
        sft.value_and_grad(p, wrt=["nope"])


def test_nonlinear_subgradients_and_descent():
    # hdiff's flux limiters: gradients stay finite, and a few gradient
    # steps on the input actually reduce the loss
    spec = synthesize_stencil(num_stages=1, dimensions=(4, 12, 12),
                              shape="hdiff")
    p = sft.parse_program(spec, name="g3")
    inputs = {k: jnp.asarray(v)
              for k, v in sft.load_input_arrays(p, seed=2).items()}
    out = p.outputs[0]
    f = sft.value_and_grad(p, loss=lambda o: (o[out] ** 2).sum(),
                          wrt=["a"])
    losses = []
    a = inputs["a"]
    for _ in range(5):
        val, grads = f({**inputs, "a": a})
        losses.append(float(val))
        a = a - 0.5 * grads["a"]
    assert losses[-1] < losses[0]
    assert np.isfinite(losses).all()


def test_sharded_adjoint():
    """Gradients flow through shard_map + the ppermute halo exchange
    (JAX transposes the collective); sharded interior adjoint is exact.
    Inputs committed with the exposed plan's shardings."""
    from jax.sharding import Mesh
    p = sft.parse_program(jacobi(3, 16, iterations=3), name="g5")
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("x", "y"))
    f = sft.value_and_grad(p, mesh=mesh, dim_axes=(None, "x", "y"))
    sh = f.plan.input_shardings()
    inputs = {k: jax.device_put(jnp.asarray(v), sh[k])
              for k, v in sft.load_input_arrays(p, seed=4).items()}
    _val, grads = f(inputs)
    g = np.asarray(grads["a"])
    np.testing.assert_allclose(g[6:10, 6:10, 6:10], 1.0, rtol=1e-5)


def test_default_wrt_skips_integer_inputs():
    a = np.random.default_rng(0).random((4, 8, 8)).astype(np.float32)
    mask = np.ones((4, 8, 8), np.int32)
    p = sft.parse_program({
        "inputs": {"a": {"data": a, "data_type": "float32"},
                   "m": {"data": mask, "data_type": "int32"}},
        "outputs": ["r"], "dimensions": [4, 8, 8],
        "program": {"r": {
            "computation_string":
                "r = a[i,j,k] if m[i,j,k] > 0 else 0.0",
            "boundary_conditions": {
                "a": {"type": "constant", "value": 0.0},
                "m": {"type": "constant", "value": 0.0}},
            "data_type": "float32"}}}, name="g6")
    inputs = {k: jnp.asarray(v)
              for k, v in sft.load_input_arrays(p).items()}
    _val, grads = sft.value_and_grad(p)(inputs)
    assert set(grads) == {"a"}   # int input excluded by default


class TestAdjointProgram:
    def test_matches_autodiff(self):
        from stencilflow_tpu.backend.xla import compile_chain, run_chain
        p = sft.parse_program(jacobi(3, 12, iterations=3), name="ap1")
        adj, cot = adjoint_program(p)
        g_fast = run_chain(adj, sft.load_input_arrays(adj))["adj_a"]
        fn = compile_chain(p)
        a = jnp.asarray(sft.load_input_arrays(p, seed=0)["a"])
        g_ad = np.asarray(jax.grad(
            lambda x: fn({"a": x})[p.outputs[0]].sum())(a))
        np.testing.assert_allclose(np.asarray(g_fast).squeeze(),
                                   g_ad.squeeze(), rtol=1e-5, atol=1e-6)

    @pytest.mark.parametrize("seed", range(3))
    def test_random_affine_random_cotangent(self, seed):
        import sys
        sys.path.insert(0, os.path.dirname(__file__))
        from test_fuzz import _affine_program
        from stencilflow_tpu.backend.xla import compile_chain, run_chain
        rng = np.random.default_rng(4000 + seed)
        p = sft.parse_program(_affine_program(rng, int(rng.integers(2, 4))),
                              name=f"ap{seed}")
        adj, cot = adjoint_program(p)
        out = p.outputs[0]
        ct = rng.random(tuple(p.dimensions)).astype(np.float32)
        g_fast = run_chain(adj, {cot[out]: ct})["adj_a"]
        fn = compile_chain(p)
        a = jnp.asarray(sft.load_input_arrays(p, seed=seed)["a"])
        g_ad = np.asarray(jax.grad(
            lambda x: (fn({"a": x})[out] *
                       jnp.asarray(ct.reshape(x.shape))).sum())(a))
        np.testing.assert_allclose(np.asarray(g_fast).squeeze(),
                                   g_ad.squeeze(), rtol=3e-5, atol=1e-5)

    @pytest.mark.parametrize("nd,iters", [(3, 2), (2, 3)])
    def test_copy_bc_adjoint(self, nd, iters):
        """Transpose of edge-clamp (copy) BCs: the OOB positions scatter
        their weight onto their own center, realized as boundary terms
        with 1-D OOB-indicator inputs (VERDICT r1 #9)."""
        from stencilflow_tpu.backend.xla import compile_chain, run_chain
        p = sft.parse_program(jacobi(nd, 10, iterations=iters,
                                     boundary="copy"),
                              name=f"cb{nd}{iters}")
        adj, cot = adjoint_program(p)
        out = p.outputs[0]
        rng = np.random.default_rng(50)
        ct = rng.random(tuple(p.dimensions)).astype(np.float32)
        adj_in = {**sft.load_input_arrays(adj), cot[out]: ct}
        g_fast = run_chain(adj, adj_in)["adj_a"]
        fn = compile_chain(p)
        a = jnp.asarray(sft.load_input_arrays(p, seed=0)["a"])
        ct_raw = jnp.asarray(ct.reshape(tuple(p.raw_dimensions)))
        g_ad = np.asarray(jax.grad(
            lambda x: (fn({"a": x})[out] * ct_raw).sum())(a))
        np.testing.assert_allclose(np.asarray(g_fast).squeeze(),
                                   g_ad.squeeze(), rtol=1e-5, atol=1e-6)

    def test_copy_bc_diagonal_offsets(self):
        """Copy-BC transpose with multi-dim (diagonal) offsets: the OOB
        union factorizes through per-dim indicator inputs."""
        from stencilflow_tpu.backend.xla import compile_chain, run_chain
        spec = {
            "inputs": {"a": {"data": "random:-1,1",
                             "data_type": "float32"}},
            "outputs": ["y"], "dimensions": [6, 10, 10],
            "program": {
                "m": {"computation_string":
                      "m = 0.3*a[i-1,j+2,k] + 0.2*a[i,j,k-2] "
                      "+ 0.5*a[i+1,j-1,k+1]",
                      "boundary_conditions": {
                          "a": {"type": "copy", "value": 0.0}},
                      "data_type": "float32"},
                "y": {"computation_string":
                      "y = m[i,j,k] + 0.25*m[i,j+1,k-1]",
                      "boundary_conditions": {
                          "m": {"type": "copy", "value": 0.0}},
                      "data_type": "float32"}}}
        p = sft.parse_program(spec, name="cbdiag")
        adj, cot = adjoint_program(p)
        rng = np.random.default_rng(51)
        ct = rng.random((6, 10, 10)).astype(np.float32)
        adj_in = {**sft.load_input_arrays(adj), cot["y"]: ct}
        g_fast = run_chain(adj, adj_in)["adj_a"]
        fn = compile_chain(p)
        a = jnp.asarray(sft.load_input_arrays(p, seed=0)["a"])
        g_ad = np.asarray(jax.grad(
            lambda x: (fn({"a": x})["y"] * jnp.asarray(ct)).sum())(a))
        np.testing.assert_allclose(np.asarray(g_fast), g_ad,
                                   rtol=1e-5, atol=1e-6)

    def test_fast_value_and_grad_copy_bc(self):
        from stencilflow_tpu.grad import fast_value_and_grad
        p = sft.parse_program(jacobi(3, 8, iterations=2, boundary="copy"),
                              name="fvgcb")
        inputs = {k: jnp.asarray(v)
                  for k, v in sft.load_input_arrays(p, seed=1).items()}
        vf, gf = fast_value_and_grad(p)(inputs)
        v2, g2 = sft.value_and_grad(p)(inputs)
        np.testing.assert_allclose(float(vf), float(v2), rtol=1e-5)
        np.testing.assert_allclose(np.asarray(gf["a"]),
                                   np.asarray(g2["a"]),
                                   rtol=1e-5, atol=1e-6)

    def test_shrink_bc_rejected(self):
        p = sft.parse_program(jacobi(3, 8, iterations=2,
                                     boundary="shrink"), name="shradj")
        with pytest.raises(ValueError, match="shrink"):
            adjoint_program(p)

    def test_dead_kernel_skipped(self):
        """A kernel whose output is neither consumed nor a program output
        has zero cotangent; adjoint_program must skip it (not emit a read
        of an undefined adj_<dead> field) and still match jax.grad."""
        from stencilflow_tpu.backend.xla import compile_chain, run_chain
        p = sft.parse_program({
            "inputs": {"a": {"data": "random:0,1",
                             "data_type": "float32"}},
            "outputs": ["y"], "dimensions": [8, 8],
            "program": {
                "b": {"computation_string":
                      "b = 0.5 * a[j, k] + 0.25 * a[j, k-1]",
                      "boundary_conditions": {
                          "a": {"type": "constant", "value": 0.0}},
                      "data_type": "float32"},
                "dead": {"computation_string":
                         "dead = 2.0 * b[j, k] + a[j+1, k]",
                         "boundary_conditions": {
                             "b": {"type": "constant", "value": 0.0},
                             "a": {"type": "constant", "value": 0.0}},
                         "data_type": "float32"},
                "y": {"computation_string":
                      "y = b[j, k] + 0.5 * b[j-1, k]",
                      "boundary_conditions": {
                          "b": {"type": "constant", "value": 0.0}},
                      "data_type": "float32"}}}, name="deadk")
        adj, cot = adjoint_program(p)
        assert "adj_dead" not in adj.kernels
        g_fast = run_chain(adj, sft.load_input_arrays(adj))["adj_a"]
        fn = compile_chain(p)
        a = jnp.asarray(sft.load_input_arrays(p, seed=0)["a"])
        g_ad = np.asarray(jax.grad(
            lambda x: fn({"a": x})["y"].sum())(a))
        np.testing.assert_allclose(np.asarray(g_fast).squeeze(),
                                   g_ad.squeeze(), rtol=1e-5, atol=1e-6)

    def test_fast_value_and_grad(self):
        """Compiled fwd + elementwise cotangent + compiled adjoint chain ==
        value_and_grad for an affine chain and a custom loss."""
        from stencilflow_tpu.grad import fast_value_and_grad
        p = sft.parse_program(jacobi(3, 12, iterations=3), name="ap4")
        out = p.outputs[0]
        target = np.random.default_rng(5).random(
            (12, 12, 12)).astype(np.float32)

        def loss(o):
            return ((o[out] - jnp.asarray(target)) ** 2).sum()

        inputs = {k: jnp.asarray(v)
                  for k, v in sft.load_input_arrays(p, seed=6).items()}
        vf, gf = fast_value_and_grad(p, loss=loss)(inputs)
        vs, gs = sft.value_and_grad(p, loss=loss)(inputs)
        np.testing.assert_allclose(float(vf), float(vs), rtol=1e-5)
        np.testing.assert_allclose(np.asarray(gf["a"]),
                                   np.asarray(gs["a"]),
                                   rtol=1e-4, atol=1e-5)
        assert gf["a"].shape == inputs["a"].shape

    def test_fast_value_and_grad_sharded(self):
        """Both passes as shard_map domain decompositions on the mesh."""
        from jax.sharding import Mesh
        from stencilflow_tpu.grad import fast_value_and_grad
        p = sft.parse_program(jacobi(3, 16, iterations=3), name="ap5")
        out = p.outputs[0]
        target = np.random.default_rng(7).random(
            (16, 16, 16)).astype(np.float32)

        def loss(o):
            return ((o[out] - jnp.asarray(target)) ** 2).sum()

        mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2),
                    ("x", "y"))
        f = fast_value_and_grad(p, loss=loss, mesh=mesh,
                                dim_axes=(None, "x", "y"))
        assert f.plan is not None
        inputs = {k: jnp.asarray(v)
                  for k, v in sft.load_input_arrays(p, seed=9).items()}
        vf, gf = f(inputs)
        vs, gs = sft.value_and_grad(p, loss=loss)(inputs)
        np.testing.assert_allclose(float(vf), float(vs), rtol=1e-5)
        np.testing.assert_allclose(np.asarray(gf["a"]),
                                   np.asarray(gs["a"]),
                                   rtol=1e-4, atol=1e-5)

    def test_multi_output_adjoint_with_consumed_output(self):
        """An output read by LATER kernels: its adjoint kernel sums the
        cotangent input AND the consumer terms."""
        from stencilflow_tpu.backend.xla import compile_chain, run_chain
        p = sft.parse_program({
            "inputs": {"a": {"data": "random:0,1",
                             "data_type": "float32"}},
            "outputs": ["mid", "top"], "dimensions": [6, 10, 10],
            "program": {
                "mid": {"computation_string":
                        "mid = 0.5 * (a[i,j-1,k] + a[i,j+1,k])",
                        "boundary_conditions": {
                            "a": {"type": "constant", "value": 0.0}},
                        "data_type": "float32"},
                "top": {"computation_string":
                        "top = mid[i,j,k-1] - 0.25 * mid[i+1,j,k]",
                        "boundary_conditions": {
                            "mid": {"type": "constant", "value": 0.0}},
                        "data_type": "float32"}}}, name="moadj")
        adj, cot = adjoint_program(p)
        rng = np.random.default_rng(11)
        cts = {cot[o]: rng.random((6, 10, 10)).astype(np.float32)
               for o in p.outputs}
        g_fast = run_chain(adj, cts)["adj_a"]
        fn = compile_chain(p)
        a = jnp.asarray(sft.load_input_arrays(p, seed=0)["a"])
        g_ad = np.asarray(jax.grad(lambda x: sum(
            (fn({"a": x})[o] * jnp.asarray(cts[cot[o]])).sum()
            for o in p.outputs))(a))
        np.testing.assert_allclose(np.asarray(g_fast), g_ad,
                                   rtol=1e-5, atol=1e-6)

    def test_adjoint_composes_with_sharding_and_fusion(self):
        """The adjoint IS a chain: it domain-decomposes over a mesh like
        any program, and transposing a temporally-fused chain gives the
        N-step adjoint in one fused chain."""
        from jax.sharding import Mesh
        from stencilflow_tpu.parallel.domain import run_sharded_chain
        from stencilflow_tpu.backend.xla import compile_chain, run_chain

        # fused: adjoint of compose_iterations(p1, 4) == grad of 4 steps
        p1 = sft.parse_program(jacobi(3, 16, iterations=1), name="af1")
        p4 = sft.compose_iterations(p1, 4)
        adj, cot = adjoint_program(p4)
        g_fast = run_chain(adj, sft.load_input_arrays(adj))[adj.outputs[0]]
        fn = compile_chain(sft.parse_program(
            jacobi(3, 16, iterations=4), name="af4"))
        a = jnp.asarray(sft.load_input_arrays(p1, seed=0)["a"])
        g_ad = np.asarray(jax.grad(
            lambda x: fn({"a": x})["s3"].sum())(a))
        np.testing.assert_allclose(np.asarray(g_fast).squeeze(),
                                   g_ad, rtol=1e-5, atol=1e-6)

        # sharded: the adjoint program under domain decomposition
        mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("x", "y"))
        g_sh = run_sharded_chain(adj, mesh, (None, "x", "y"),
                                 sft.load_input_arrays(adj))
        np.testing.assert_allclose(
            np.asarray(g_sh[adj.outputs[0]]).squeeze(), g_ad,
            rtol=1e-5, atol=1e-6)

    def test_rejections(self):
        from stencilflow_tpu.synthesize import synthesize_stencil
        ph = sft.parse_program(
            synthesize_stencil(num_stages=1, dimensions=(4, 12, 12),
                               shape="hdiff"), name="apnl")
        with pytest.raises(ValueError, match="not affine"):
            adjoint_program(ph, wrt=["a"])
        pc = sft.parse_program(jacobi(2, 8, iterations=1,
                                      boundary="shrink"), name="apbc")
        with pytest.raises(ValueError, match="shrink"):
            adjoint_program(pc)
        p = sft.parse_program(jacobi(2, 8, iterations=1), name="apw")
        with pytest.raises(ValueError, match="not a program input"):
            adjoint_program(p, wrt=["zzz"])


def test_higher_order():
    p = sft.parse_program(jacobi(2, 8, iterations=1), name="g4")
    a = jnp.asarray(sft.load_input_arrays(p, seed=3)["a"])
    g1 = sft.grad(p)

    def scalar(x):
        return (g1({"a": x})["a"] ** 2).sum()

    h = jax.grad(scalar)(a)   # grad-of-grad traces cleanly
    assert np.isfinite(np.asarray(h)).all()


def test_traced_frontend_composes_with_adjoint_solve_iterate():
    """Programs from the traced-Python frontend flow through the adjoint
    transform, the CG solver, and the iterate driver unchanged."""
    from stencilflow_tpu.solve import solve_cg

    def model(x):
        y = x - 0.2 * (x[0, -1, 0] + x[0, 1, 0] + x[0, 0, -1]
                       + x[0, 0, 1] - 4.0 * x)
        return {"y": y}

    p = sft.trace_program(model, dimensions=(16, 16),
                          inputs={"x": np.float32}, name="tcomp")
    adj, _cot = adjoint_program(p)
    g = np.asarray(sft.run_interpreter(
        adj, sft.load_input_arrays(adj))["adj_x"]).squeeze()
    np.testing.assert_allclose(g[6:10, 6:10], 1.0, rtol=1e-5)

    b = np.random.default_rng(0).random((16, 16)).astype(np.float32)
    x, info = solve_cg(p, b, tol=1e-6)
    y = np.asarray(sft.run_interpreter(p, {"x": np.asarray(x)})["y"])
    assert np.linalg.norm(y - b) / np.linalg.norm(b) < 1e-5

    state = sft.iterate(p, {"x": b}, steps=4, feed={"x": "y"})
    assert np.isfinite(np.asarray(state["x"])).all()


def test_adjoint_of_vectorized_reference_fixture():
    """The upstream vectorized fixture transposes cleanly: W propagates
    and the adjoint matches autodiff (skipped if the reference tree is
    absent)."""
    path = "/root/reference/test/stencils/jacobi3d_32x32x32_8itr_4vec.json"
    if not os.path.exists(path):
        pytest.skip("reference fixtures unavailable")
    from stencilflow_tpu.backend.xla import compile_chain, run_chain
    p = sft.parse_program(path)
    adj, _cot = adjoint_program(p)
    assert adj.vectorization == p.vectorization > 1
    g = run_chain(adj, sft.load_input_arrays(adj))[adj.outputs[0]]
    fn = compile_chain(p)
    a = jnp.asarray(sft.load_input_arrays(
        p, prefix=os.path.dirname(path), seed=0)["a"])
    g_ad = np.asarray(jax.grad(
        lambda x: fn({"a": x})[p.outputs[0]].sum())(a))
    np.testing.assert_allclose(np.asarray(g).squeeze(), g_ad.squeeze(),
                               rtol=1e-5, atol=1e-6)


def test_adjoint_ignores_dead_nonaffine_kernel():
    """A non-affine diagnostic kernel feeding no output must not block
    the fast adjoint: dead kernels never enter the transposed chain, so
    only LIVE kernels need to be affine/shrink-free."""
    from stencilflow_tpu.backend.xla import compile_chain
    from stencilflow_tpu.grad import adjoint_program
    spec = {
        "inputs": {"a": {"data": "random:-1,1", "data_type": "float32"}},
        "outputs": ["s1"],
        "dimensions": [8, 8, 8],
        "program": {
            "s0": {"computation_string":
                   "s0 = 0.5 * (a[i-1,j,k] + a[i+1,j,k])",
                   "boundary_conditions":
                   {"a": {"type": "constant", "value": 0.0}},
                   "data_type": "float32"},
            # dead: consumed by nothing, not an output, NOT affine
            "mon": {"computation_string":
                    "mon = min(abs(s0[i,j,k]), a[i,j,k] * a[i,j,k])",
                    "boundary_conditions":
                    {"s0": {"type": "constant", "value": 0.0},
                     "a": {"type": "constant", "value": 0.0}},
                    "data_type": "float32"},
            "s1": {"computation_string": "s1 = s0[i,j,k] * 2.0",
                   "boundary_conditions":
                   {"s0": {"type": "constant", "value": 0.0}},
                   "data_type": "float32"},
        },
    }
    p = sft.parse_program(spec, name="deadmon")
    adj, _cot = adjoint_program(p)
    assert not any("mon" in k for k in adj.kernels)
    g = sft.run_interpreter(adj, sft.load_input_arrays(adj, seed=41))
    fn = compile_chain(p)
    a = jnp.asarray(sft.load_input_arrays(p, seed=41)["a"])
    g_ad = np.asarray(jax.grad(
        lambda x: fn({"a": x})[p.outputs[0]].sum())(a))
    np.testing.assert_allclose(np.asarray(g[adj.outputs[0]]), g_ad,
                               rtol=2e-5, atol=1e-6)


def test_fast_value_and_grad_host_chunks():
    """Out-of-core fast gradients: chunked forward + per-chunk loss
    cotangent + chunked adjoint match the in-core path exactly."""
    from stencilflow_tpu.grad import fast_value_and_grad
    from stencilflow_tpu.synthesize import jacobi
    p = sft.parse_program(jacobi(3, 8, iterations=2), name="ocvag")
    inputs = {k: np.asarray(v)
              for k, v in sft.load_input_arrays(p, seed=60).items()}

    def loss(outputs):
        return sum(jnp.sum(v * 0.5) for v in outputs.values())

    f_dev = fast_value_and_grad(p, loss=loss)
    f_oc = fast_value_and_grad(p, loss=loss, host_chunks=2)
    v1, g1 = f_dev({k: jnp.asarray(v) for k, v in inputs.items()})
    v2, g2 = f_oc(inputs)
    assert isinstance(g2["a"], np.ndarray)
    # per-chunk partial sums reassociate the f32 reduction
    np.testing.assert_allclose(v2, float(v1), rtol=1e-5)
    np.testing.assert_allclose(g2["a"], np.asarray(g1["a"]), rtol=1e-5,
                               atol=1e-7)

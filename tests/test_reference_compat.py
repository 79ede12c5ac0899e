"""Dialect-compatibility sweep: every program JSON shipped with the
reference (read in place from the read-only mount, when present) must parse,
analyze, execute, and verify in this framework — the acceptance checklist's
"JSON dialect accepted verbatim for all test/stencils/*.json" item.

Each program runs through: parser → chain analysis → fused-XLA backend →
whole-domain oracle comparison; small programs additionally cross-check the
cycle-accurate simulator.  Shrink-BC programs are compared with the halo
pruned, mirroring the reference's -halo discipline (README.md:50-56).
"""
import glob
import os

import numpy as np
import pytest

import stencilflow_tpu as sft
from stencilflow_tpu.backend.xla import run_chain
from stencilflow_tpu.data import arrays_are_equal, load_input_arrays, \
    prune_halo
from stencilflow_tpu.frontend.analysis import ChainAnalysis
from stencilflow_tpu.backend.xla import chain_halo
from stencilflow_tpu.ir import BCKind

REF_STENCILS = "/root/reference/test/stencils"

if os.path.isdir(REF_STENCILS):
    PROGRAMS = sorted(glob.glob(os.path.join(REF_STENCILS, "*.json")))
else:  # pragma: no cover
    PROGRAMS = []

pytestmark = pytest.mark.skipif(
    not PROGRAMS, reason="reference fixture programs not mounted")


def _max_shrink_halo(program, analysis) -> int:
    uses_shrink = any(
        bc.kind == BCKind.SHRINK
        for k in program.kernels.values()
        for bc in k.boundary_conditions.values())
    if not uses_shrink:
        return 0
    return max(chain_halo(analysis))


@pytest.mark.parametrize("path", PROGRAMS,
                         ids=[os.path.basename(p) for p in PROGRAMS])
def test_reference_program(path):
    program = sft.parse_program(path)
    analysis = ChainAnalysis.run(program)
    assert analysis.critical_path_cycles >= 0

    inputs = load_input_arrays(program, prefix=REF_STENCILS, seed=0)
    ref = sft.run_interpreter(program, inputs)

    out = run_chain(program, inputs)
    halo = _max_shrink_halo(program, analysis)
    for o in program.outputs:
        exp = prune_halo(np.asarray(ref[o]), program.raw_dimensions, halo)
        got = prune_halo(out[o], program.raw_dimensions, halo)
        assert arrays_are_equal(exp, got), f"XLA mismatch on {o}"

    # interpreter-strategy cross-check for small domains
    if program.total_elements <= 4096:
        got_s = run_chain(program, inputs, strategy="interpreter")
        for o in program.outputs:
            exp = prune_halo(np.asarray(ref[o]), program.raw_dimensions,
                             halo)
            got = prune_halo(got_s[o], program.raw_dimensions, halo)
            assert arrays_are_equal(exp, got), \
                f"interpreter-strategy mismatch on {o}"

    # simulator cross-check for small domains (cycle loop cost)
    if program.total_elements <= 40000:
        from stencilflow_tpu.sim import simulate
        res = simulate(program, inputs, analysis=analysis)
        for o in program.outputs:
            exp = prune_halo(np.asarray(ref[o]), program.raw_dimensions,
                             halo)
            got = prune_halo(res.outputs[o], program.raw_dimensions, halo)
            assert arrays_are_equal(exp, got), f"simulator mismatch on {o}"


def test_vectorization_analysis_matches_reference_model():
    """W drives the ANALYSIS exactly as in the reference — per-kernel
    latency = ceil(tree_latency / W) (compute_graph.py:461-474), internal
    buffer extents +W-1 in the fastest dim (compute_graph.py:146-161),
    runtime lower bound = (N + critical_path) / W
    (kernel_chain_graph.py:770-774) — while the fused-XLA lowering is
    W-neutral by design: the whole array IS the vector, so W changes no
    generated code."""
    import copy
    import json
    import math

    from stencilflow_tpu.config import OP_LATENCY

    path = os.path.join(REF_STENCILS, "jacobi3d_32x32x32_8itr_8vec.json")
    spec = json.load(open(path))
    W = spec["vectorization"]
    assert W > 1
    p_vec = sft.parse_program(path)
    spec1 = copy.deepcopy(spec)
    spec1.pop("vectorization")
    p_one = sft.parse_program(spec1, name="jacobi3d_unvec")

    an_vec = ChainAnalysis.run(p_vec)
    an_one = ChainAnalysis.run(p_one)

    # reference latency of the 7-point star: 5 chained adds + 1 mult
    # (left-assoc parse), +1 for the output node
    tree = 5 * OP_LATENCY["add"] + OP_LATENCY["mult"] + 1
    for k in p_vec.kernels:
        assert an_one.kernel_latencies[k] == tree
        assert an_vec.kernel_latencies[k] == math.ceil(tree / W)

    # internal buffer extent: max-min per dim, +W-1 in the fastest dim
    info1 = an_one.kernel_accesses["b0"]["a"]
    infoW = an_vec.kernel_accesses["b0"]["a"]
    assert info1.buffer_extent == (2, 2, 2)
    assert infoW.buffer_extent == (2, 2, 2 + W - 1)

    # runtime lower bound divides by W
    N = p_vec.total_elements
    assert an_vec.runtime_lower_bound() == \
        (N + an_vec.critical_path_cycles) // W

    # and the lowering is W-neutral: identical bits with and without W
    from stencilflow_tpu.backend.xla import run_chain
    inputs = load_input_arrays(p_vec, seed=0)
    out_vec = run_chain(p_vec, inputs)
    out_one = run_chain(p_one, inputs)
    np.testing.assert_array_equal(np.asarray(out_vec["b7"]),
                                  np.asarray(out_one["b7"]))


@pytest.mark.skipif(not os.path.isdir(REF_STENCILS),
                    reason="reference fixtures unavailable")
def test_distributed_harness_case_8itr_split_at_b6():
    """The reference's distributed harness splits the 8-iteration chain
    at the b6_to_b7 stream and verifies rank-1's output against the CPU
    reference (test_distributed_program.sh:120-125).  Same case here:
    wavefront pipeline over 2 devices cut after b6, verified against the
    oracle."""
    import jax
    from jax.sharding import Mesh

    from stencilflow_tpu.parallel.pipeline import compile_pipeline_split
    path = os.path.join(REF_STENCILS, "jacobi3d_32x32x32_8itr.json")
    p = sft.parse_program(path)
    inputs = load_input_arrays(p, prefix=REF_STENCILS, seed=0)
    ref = sft.run_interpreter(p, inputs)
    mesh = Mesh(np.array(jax.devices()[:2]), ("p",))
    fn, plan = compile_pipeline_split(p, mesh, "p", split_at=["b6"])
    assert [sorted(s) for s in plan.segments][-1] == ["b7"]
    import jax.numpy as jnp
    out = fn({k: jnp.asarray(v) for k, v in inputs.items()})
    np.testing.assert_allclose(np.asarray(out["b7"]),
                               np.asarray(ref["b7"]), rtol=1e-5,
                               atol=1e-6)

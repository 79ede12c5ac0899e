"""Whole-domain XLA backend: jit the chain as one fused program.

Two lowering strategies, both correct against the numpy oracle:

* ``compile_chain(..., strategy="interpreter")`` traces the per-kernel
  pad/shift interpreter (interpreter.py) under ``jax.jit`` — the analogue of
  the reference's CPU verification backend
  (/root/reference/stencilflow/sdfg_generator.py:580-677), letting XLA fuse
  what it can.
* ``compile_chain(..., strategy="tile")`` evaluates the whole chain through
  the widened-tile evaluator (tile_eval.py) with the domain as a single tile
  padded by the chain's cumulative halo — the same code path the
  multi-device shard_map, pipeline and out-of-core bodies use, so their
  results agree structurally with the single-device one.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import ir
from ..frontend.analysis import ChainAnalysis
from ..frontend.chain import ChainGraph
from ..interpreter import ChainInterpreter
from .tile_eval import evaluate_chain_tile

Vec3 = Tuple[int, int, int]


def chain_halo(analysis: ChainAnalysis) -> Vec3:
    """Per-dim cumulative halo budget for fused evaluation of the chain.

    Max of the input-composed halo AND every kernel's stage_halo: an
    input-LESS (constant) stage contributes reach no input path
    carries — its consumers still read its planes at offsets, so a
    sharded/tiled evaluation region must cover those planes or the
    consumers read unevaluated ring slots (found by fuzz seed 91005:
    an i-sharded constant-stage chain NaN'd at the shard seam).  The
    j/k-sharded variant happened to survive only because input-less
    stages are constant-valued (uniform planes make the un-widened
    wrap-reads value-correct); the widened region makes it sound by
    construction instead of by accident.  For chains whose every stage
    descends from an input, input_halo dominates and this is
    unchanged."""
    h = [0, 0, 0]
    for vec in list(analysis.input_halo().values()) + \
            list(analysis.stage_halo().values()):
        for d in range(3):
            h[d] = max(h[d], vec[d])
    return tuple(h)


def pad_input_to_tile(arr, dim_mask, dimensions: Vec3, halo: Vec3):
    """Zero-pad an input array by the halo budget in its spanned dims.

    The padding values are irrelevant (OOB reads are masked by the BC logic);
    zeros keep the pad cheap and XLA-friendly.
    """
    arr = jnp.asarray(arr)
    if arr.ndim == 0:
        return arr
    spanned = [d for d in range(3) if dim_mask[d]]
    shape = tuple(dimensions[d] for d in spanned)
    arr = arr.reshape(shape)
    pads = [(halo[d], halo[d]) for d in spanned]
    return jnp.pad(arr, pads)


def _tile_forward(program: ir.Program, graph: ChainGraph, halo: Vec3,
                  inputs: Dict[str, Any]) -> Dict[str, Any]:
    tiles = {
        name: pad_input_to_tile(inputs[name], spec.dim_mask,
                                program.dimensions, halo)
        for name, spec in program.inputs.items()
    }
    results = evaluate_chain_tile(program, graph, tiles, (0, 0, 0), halo)
    dims = program.dimensions
    core = tuple(slice(halo[d], halo[d] + dims[d]) for d in range(3))
    raw = program.raw_dimensions
    return {name: arr[core].reshape(raw) for name, arr in results.items()}


def compile_chain(program: ir.Program,
                  analysis: Optional[ChainAnalysis] = None,
                  strategy: str = "tile",
                  donate: bool = False):
    """Return a jitted ``fn(inputs: dict) -> outputs: dict`` for the chain."""
    graph = ChainGraph.build(program)
    if strategy == "interpreter":
        interp = ChainInterpreter(program, graph, xp=jnp)

        def forward(inputs):
            return interp(inputs)
    elif strategy == "tile":
        analysis = analysis or ChainAnalysis.run(program, graph)
        halo = chain_halo(analysis)
        forward = functools.partial(_tile_forward, program, graph, halo)
    else:
        raise ValueError(f"unknown strategy: {strategy}")
    kwargs = {"donate_argnums": (0,)} if donate else {}
    return jax.jit(forward, **kwargs)


def run_chain(program: ir.Program, inputs: Dict[str, Any],
              strategy: str = "tile") -> Dict[str, np.ndarray]:
    """Convenience: compile + run + device_get."""
    fn = compile_chain(program, strategy=strategy)
    out = fn({k: jnp.asarray(v) for k, v in inputs.items()})
    return {k: np.asarray(v) for k, v in out.items()}

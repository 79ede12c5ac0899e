"""Domain decomposition over a device mesh with halo exchange.

Each device owns a contiguous block of the (i, j, k) domain.  One halo
exchange per chain evaluation: every sharded input sends slabs of the chain's
*cumulative* halo width to its mesh neighbors via ``lax.ppermute`` (which XLA
hands to NCCL on the GPU), after which the whole kernel chain is evaluated
locally on the widened block through the shared tile evaluator —
communication volume is the minimum possible for a fused chain (one halo per
input, not one per stage).

Global boundary blocks receive zero slabs from ppermute (no source sends to
them), which is safe: the tile evaluator masks every out-of-domain read with
its boundary condition using *global* coordinates derived from the device's
mesh position.

Reference counterpart: the multi-FPGA `split_sdfg` + SMI streams
(/root/reference/stencilflow/sdfg_generator.py:782-1000); this module maps
that capability onto shard_map + collectives.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from .. import ir
from ..frontend.analysis import ChainAnalysis
from ..frontend.chain import ChainGraph
from ..backend.xla import chain_halo
from ..backend.tile_eval import evaluate_chain_tile

Vec3 = Tuple[int, int, int]


@dataclasses.dataclass
class DomainDecomposition:
    """Static plan for sharding one program's domain over a mesh.

    ``dim_axes[d]`` is the mesh axis name dim ``d`` is sharded over (None =
    replicated).  Dims must divide evenly by the axis size and each local
    block must be wider than the halo (single-hop exchange).
    """
    program: ir.Program
    mesh: Mesh
    dim_axes: Tuple[Optional[str], Optional[str], Optional[str]]
    halo: Vec3          # effective halo: chain halo in sharded dims, else 0
    block: Vec3

    @classmethod
    def plan(cls, program: ir.Program, mesh: Mesh,
             dim_axes: Sequence[Optional[str]],
             analysis: Optional[ChainAnalysis] = None
             ) -> "DomainDecomposition":
        analysis = analysis or ChainAnalysis.run(program)
        full_halo = chain_halo(analysis)
        dims = program.dimensions
        if dim_axes is None:
            raise ValueError(
                "dim_axes is required, e.g. (None, 'x', 'y') to shard "
                "(j, k) over a 2-D mesh")
        dim_axes = tuple(dim_axes)
        block = []
        halo = []
        for d in range(3):
            ax = dim_axes[d]
            n = mesh.shape[ax] if ax is not None else 1
            if dims[d] % n != 0:
                raise ValueError(
                    f"dim {d} ({dims[d]}) not divisible by mesh axis "
                    f"'{ax}' size {n}")
            b = dims[d] // n
            # unsharded dims span the whole domain locally: offset reads
            # wrap onto globally-OOB cells which every BC mask corrects, so
            # no widening is needed there
            h = full_halo[d] if (ax is not None and n > 1) else 0
            if h >= b > 0 and h > 0:
                raise ValueError(
                    f"halo {h} >= local block {b} in dim {d}; "
                    "use fewer shards or a shallower chain")
            block.append(b)
            halo.append(h)
        return cls(program, mesh, dim_axes, tuple(halo), tuple(block))

    # -- shardings -----------------------------------------------------------
    def spec_for_input(self, name: str) -> P:
        spec = self.program.inputs[name]
        if spec.is_scalar:
            return P()
        return P(*[self.dim_axes[d] for d in range(3) if spec.dim_mask[d]])

    def spec_for_output(self) -> P:
        raw = self.program.raw_dimensions
        # outputs are produced at raw (unpadded) rank; padded leading dims
        # of size 1 are dropped, so map the trailing raw dims
        return P(*[self.dim_axes[d] for d in range(3 - len(raw), 3)])

    def input_shardings(self) -> Dict[str, NamedSharding]:
        return {n: NamedSharding(self.mesh, self.spec_for_input(n))
                for n in self.program.inputs}


def _exchange_halo(arr, local_dims: Dict[int, int],
                   plan: DomainDecomposition):
    """Widen a local block by the halo in every spanned dim, pulling neighbor
    slabs (zeros at global boundaries)."""
    for pos, d in enumerate(local_dims):
        h = plan.halo[d]
        ax = plan.dim_axes[d]
        if h == 0:
            continue
        if ax is None or plan.mesh.shape[ax] == 1:
            pad = [(0, 0)] * arr.ndim
            pad[pos] = (h, h)
            arr = jnp.pad(arr, pad)
            continue
        n = plan.mesh.shape[ax]
        lo_slab = lax.slice_in_dim(arr, 0, h, axis=pos)
        hi_slab = lax.slice_in_dim(arr, arr.shape[pos] - h, arr.shape[pos],
                                   axis=pos)
        # send my high slab to my right neighbor (becomes their left halo)
        left_halo = lax.ppermute(hi_slab, ax,
                                 [(p, p + 1) for p in range(n - 1)])
        # send my low slab to my left neighbor (becomes their right halo)
        right_halo = lax.ppermute(lo_slab, ax,
                                  [(p + 1, p) for p in range(n - 1)])
        arr = jnp.concatenate([left_halo, arr, right_halo], axis=pos)
    return arr


def _widen_and_origin(plan: DomainDecomposition, inputs: Dict[str, Any]):
    """Shared per-device preamble: halo-exchange every array input and
    compute this shard's global origin."""
    program = plan.program
    tiles: Dict[str, Any] = {}
    for name, spec in program.inputs.items():
        arr = inputs[name]
        if spec.is_scalar:
            tiles[name] = arr
            continue
        spanned = [d for d in range(3) if spec.dim_mask[d]]
        local_dims = {d: plan.block[d] for d in spanned}
        tiles[name] = _exchange_halo(arr, local_dims, plan)
    origin = []
    for d in range(3):
        ax = plan.dim_axes[d]
        idx = lax.axis_index(ax) if ax is not None else 0
        origin.append(jnp.int32(idx * plan.block[d]))
    return tiles, origin


def _local_forward(plan: DomainDecomposition, graph: ChainGraph,
                   inputs: Dict[str, Any]) -> Dict[str, Any]:
    program = plan.program
    halo = plan.halo
    tiles, origin = _widen_and_origin(plan, inputs)
    results = evaluate_chain_tile(program, graph, tiles, origin, halo,
                                  core_shape=plan.block)
    core = tuple(slice(halo[d], halo[d] + plan.block[d]) for d in range(3))
    raw = program.raw_dimensions
    local_raw = tuple(plan.block[3 - len(raw) + i] for i in range(len(raw)))
    return {n: arr[core].reshape(local_raw) for n, arr in results.items()}


def _block_origin(plan: DomainDecomposition):
    """Global element offset of this device's (unwidened) block."""
    origin = []
    for d in range(3):
        ax = plan.dim_axes[d]
        idx = lax.axis_index(ax) if ax is not None else 0
        origin.append(jnp.int32(idx * plan.block[d]))
    return origin


def _local_forward_overlap(plan: DomainDecomposition, graph: ChainGraph,
                           inputs: Dict[str, Any]) -> Dict[str, Any]:
    """Comm/compute-overlapped per-device body.

    The interior of the local block — cells at least the cumulative halo
    away from every sharded block edge — depends only on local data, so it
    is evaluated directly on the UNWIDENED block with no data dependency on
    the ppermute halo slabs; XLA's async collective scheduler is then free
    to keep the permutes in flight behind the interior evaluation.  Thin
    boundary strips (3h-thick input slabs producing h output planes per
    face, spanning the full widened extent of every other dim so corners
    are covered) are evaluated from the widened array afterwards and
    stitched over the interior pass's invalid rim.

    Overcompute vs the blocking body: the interior pass wastes its rim
    (2h/B per sharded dim) and each face re-evaluates a 3h slab — worth it
    when exchange latency is exposed, which only a multi-device profile can
    decide; hence opt-in (``comm_overlap=True``).

    The reference has no analogue (its SMI FIFO streams overlap by
    construction, /root/reference/stencilflow/sdfg_generator.py:848-963);
    this is the equivalent of that elastic overlap for the
    lockstep-collective halo exchange.
    """
    program = plan.program
    halo, B = plan.halo, plan.block
    origin = _block_origin(plan)

    # interior pass: raw local tiles, no exchange.  Wrap-around reads in
    # sharded dims land on wrong-neighbor cells, so the outermost
    # cumulative-halo rim is invalid (overwritten by strips below);
    # unsharded dims keep the single-chip invariant (wraps land on
    # globally-OOB cells that the BC masks fix).
    outs = dict(evaluate_chain_tile(program, graph, dict(inputs), origin,
                                    (0, 0, 0), core_shape=B))

    # widened arrays for the strips (the data the interior did not wait on)
    tiles_w, _ = _widen_and_origin(plan, inputs)

    for d in [d for d in range(3) if halo[d] > 0]:
        h = halo[d]
        for side in (0, 1):
            strip_tiles: Dict[str, Any] = {}
            for name, spec in program.inputs.items():
                arr = tiles_w[name]
                if spec.is_scalar or not spec.dim_mask[d]:
                    strip_tiles[name] = arr
                    continue
                pos = sum(spec.dim_mask[:d])
                ext = arr.shape[pos]          # B_d + 2h
                lo = 0 if side == 0 else ext - 3 * h
                strip_tiles[name] = lax.slice_in_dim(arr, lo, lo + 3 * h,
                                                     axis=pos)
            so = list(origin)
            if side == 1:
                so[d] = so[d] + jnp.int32(B[d] - h)
            res = evaluate_chain_tile(
                program, graph, strip_tiles, so, halo,
                core_shape=tuple(h if dd == d else B[dd]
                                 for dd in range(3)))
            for n, arr in res.items():
                core = [slice(halo[dd], halo[dd] + B[dd]) for dd in range(3)]
                core[d] = slice(h, 2 * h)
                dst = [slice(0, B[dd]) for dd in range(3)]
                dst[d] = slice(0, h) if side == 0 else slice(B[d] - h, B[d])
                outs[n] = outs[n].at[tuple(dst)].set(arr[tuple(core)])

    raw = program.raw_dimensions
    local_raw = tuple(B[3 - len(raw) + i] for i in range(len(raw)))
    return {n: arr.reshape(local_raw) for n, arr in outs.items()}


def compile_sharded_chain(program: ir.Program, mesh: Mesh,
                          dim_axes: Sequence[Optional[str]],
                          analysis: Optional[ChainAnalysis] = None,
                          comm_overlap: bool = False):
    """Build a jitted, mesh-sharded ``fn(inputs) -> outputs`` for the chain:
    halo exchange, then the fused tile evaluator on each device's widened
    block (any subset of (i, j, k) may be sharded).  Inputs must be
    committed with ``plan.input_shardings()`` (or will be resharded on
    entry).  Returns ``(fn, plan)``.

    ``comm_overlap=True`` restructures the per-device body so the block
    interior is evaluated with no data dependency on the halo ppermutes
    (XLA can keep them in flight behind it) and only thin boundary strips
    wait for neighbor slabs — at the cost of rim/strip overcompute.
    Opt-in: whether latency hiding beats the overcompute is a measurement
    per mesh.
    """
    analysis = analysis or ChainAnalysis.run(program)
    plan = DomainDecomposition.plan(program, mesh, dim_axes, analysis)
    in_specs = {n: plan.spec_for_input(n) for n in program.inputs}
    out_specs = {n: plan.spec_for_output() for n in program.outputs}
    if comm_overlap and not any(h > 0 for h in plan.halo):
        comm_overlap = False    # no exchange to hide
    compile_sharded_chain.last_config = {"comm_overlap": comm_overlap}
    body = functools.partial(
        _local_forward_overlap if comm_overlap else _local_forward,
        plan, analysis.graph)
    sm = shard_map(body, mesh=mesh, in_specs=(in_specs,),
                   out_specs=out_specs, check_vma=False)
    return jax.jit(sm), plan


def place_global_inputs(program: ir.Program,
                        plan: DomainDecomposition,
                        inputs: Dict[str, Any]) -> Dict[str, Any]:
    """Commit every input as a GLOBAL mesh-sharded array.

    Uses ``jax.make_array_from_callback`` so each process supplies only its
    addressable shards — required for multi-host SPMD (where
    ``device_put`` of a host-local array cannot address remote devices;
    the reference's per-rank input loading,
    bin/run_distributed_program.py:217-277) and equivalent to
    ``device_put`` on a single process.  Every process must hold the same
    full (replicated) numpy input, e.g. from the shared program JSON with
    one seed."""
    shardings = plan.input_shardings()
    placed = {}
    for n, v in inputs.items():
        spec = program.inputs[n]
        if spec.is_scalar:
            sh = NamedSharding(plan.mesh, P())
            arr = np.asarray(v)
        else:
            sh = shardings[n]
            arr = np.asarray(v)
        placed[n] = jax.make_array_from_callback(
            arr.shape, sh, lambda idx, a=arr: a[idx])
    return placed


def run_sharded_chain(program: ir.Program, mesh: Mesh,
                      dim_axes: Sequence[Optional[str]],
                      inputs: Dict[str, Any],
                      as_numpy: bool = True,
                      comm_overlap: bool = False) -> Dict[str, Any]:
    """One-shot sharded evaluation.  ``as_numpy=False`` returns the global
    jax Arrays (required on multi-host meshes, where a process can only
    convert its own shards — verify via ``arr.addressable_shards``)."""
    fn, plan = compile_sharded_chain(program, mesh, dim_axes,
                                     comm_overlap=comm_overlap)
    out = fn(place_global_inputs(program, plan, inputs))
    if not as_numpy:
        return out
    return {k: np.asarray(v) for k, v in out.items()}

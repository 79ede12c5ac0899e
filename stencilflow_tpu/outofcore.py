"""Out-of-core execution: domains larger than device memory.

The reference's defining property is that domains are *never resident
on-chip* — one element per cycle flows from DRAM through the pipeline
(/root/reference/stencilflow/sdfg_generator.py:248-467: read maps feed
FIFOs, buffer state is only ``stencil extent x plane size``).  This module
adds the level above device memory: when the domain does not fit it, stream
i-chunks from host memory through one compiled chunk kernel.

Mechanics: the i axis is split into C chunks.  Each chunk's inputs are
host-sliced with the chain's cumulative i-halo on both sides (zero-padded
at global edges — the evaluator's origin-based boundary masks treat those
exactly like the globally-OOB reads of the sharded path), one jitted
origin-parameterized kernel evaluates all chunks, and outputs are
assembled on host.  Per-chunk device residency is O(N/C).  The chunk
kernel is the fused tile evaluator of the single-device backend.

Inputs may be numpy arrays or ``np.memmap``s (so the working set never
has to exist in host RAM either); outputs are written into caller-provided
arrays/memmaps via ``out=`` or freshly allocated.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np

from . import ir
from .frontend.analysis import ChainAnalysis
from .backend.xla import chain_halo


@dataclasses.dataclass
class ChunkPlan:
    """Geometry of an out-of-core run."""
    chunks: int
    block: int      # core i-planes per chunk
    halo: int       # i-halo each side (the chain's cumulative i extent)
    backend: str    # "xla" | "sharded-xla"
    config: Dict[str, Any]


def compile_chunked_chain(program: ir.Program,
                          chunks: int,
                          analysis: Optional[ChainAnalysis] = None):
    """Build ``(chunk_fn, plan)``: a jitted ``chunk_fn(origin_i, tiles)
    -> outputs`` evaluating one i-chunk, compiled once for all chunks.

    ``tiles`` are the chunk's host-sliced inputs: i-spanning fields carry
    ``block + 2*halo`` planes (zero-padded at global edges); others pass
    whole.  ``origin_i`` is the global i index of the chunk's first
    *widened* plane (core start minus halo).
    """
    import jax
    import jax.numpy as jnp

    analysis = analysis or ChainAnalysis.run(program)
    I = program.dimensions[0]
    if len(program.raw_dimensions) < 2 or I <= 1:
        raise ValueError("out-of-core chunking streams the i axis; "
                         f"domain {program.raw_dimensions} has no i "
                         "extent to chunk")
    if chunks < 1 or I % chunks:
        raise ValueError(f"chunks={chunks} must divide I={I}")
    Ic = I // chunks
    h = chain_halo(analysis)[0]
    if chunks > 1 and h >= Ic:
        raise ValueError(f"chain i-halo {h} >= chunk block {Ic}; "
                         "use fewer chunks")
    halo_i = h if chunks > 1 else 0
    raw = program.raw_dimensions
    local_raw = (Ic,) + tuple(raw[1:])

    graph = analysis.graph
    from .backend.tile_eval import evaluate_chain_tile

    def body(origin_i, tiles):
        # evaluate_chain_tile takes the *core* origin; origin_i is the
        # chunk's first widened plane
        origin = [jnp.int32(origin_i) + halo_i, jnp.int32(0),
                  jnp.int32(0)]
        results = evaluate_chain_tile(
            program, graph, tiles, origin, (halo_i, 0, 0),
            core_shape=(Ic,) + tuple(program.dimensions[1:]))
        core = (slice(halo_i, halo_i + Ic),)
        return {n: arr[core].reshape(local_raw)
                for n, arr in results.items()}

    plan = ChunkPlan(chunks=chunks, block=Ic, halo=halo_i, backend="xla",
                     config={})
    return jax.jit(body), plan


def compile_chunked_sharded(program: ir.Program,
                            chunks: int,
                            mesh,
                            dim_axes=(None, "x", "y"),
                            analysis: Optional[ChainAnalysis] = None):
    """Out-of-core x domain decomposition (VERDICT r4 #7): each host
    i-chunk is evaluated SHARDED over ``mesh`` — dim_axes maps j/k to
    mesh axes (i must stay None: it is the chunked streaming dim).  Per
    device the chunk body holds O((block + 2h) * J/X * K/Y): each host
    feeds its shard's i-chunks while j/k halos come from mesh neighbors
    (multi-hop when the chain halo exceeds a shard).

    Returns ``(chunk_fn, plan)`` with the same ``chunk_fn(origin_i,
    tiles) -> outputs`` contract as compile_chunked_chain — tiles and
    outputs are GLOBAL (j, k) extents; shard_map shards/assembles them.
    The reference's long-domain story combines its Optimizer spill with
    split_sdfg (SURVEY.md §5); this composes the two analogues here."""
    import jax
    import jax.numpy as jnp
    from jax import lax
    from jax.sharding import PartitionSpec as P
    from jax import shard_map

    from .backend.tile_eval import evaluate_chain_tile
    from .parallel.pipeline import _gather_axis_halo

    analysis = analysis or ChainAnalysis.run(program)
    dims = program.dimensions
    I, J, K = dims
    if dim_axes[0] is not None:
        raise ValueError("dim 0 (i) is the chunked streaming dim; "
                         "shard j/k only (dim_axes[0] must be None)")
    dax = {d: ax for d, ax in enumerate(dim_axes)
           if ax is not None and d in (1, 2)}
    for d, ax in dax.items():
        if ax not in mesh.shape:
            raise ValueError(f"unknown mesh axis {ax!r}")
        if dims[d] % mesh.shape[ax]:
            raise ValueError(f"dim {d} ({dims[d]}) not divisible by "
                             f"mesh axis {ax!r} ({mesh.shape[ax]})")
    if chunks < 1 or I % chunks:
        raise ValueError(f"chunks={chunks} must divide I={I}")
    Ic = I // chunks
    halo = chain_halo(analysis)
    h = (halo[0] if chunks > 1 else 0, halo[1], halo[2])
    if chunks > 1 and h[0] >= Ic:
        raise ValueError(f"chain i-halo {h[0]} >= chunk block {Ic}; "
                         "use fewer chunks")
    nx = {d: mesh.shape[a] for d, a in dax.items()}
    loc = {d: dims[d] // nx.get(d, 1) for d in (1, 2)}
    graph = analysis.graph
    raw = program.raw_dimensions
    local_raw = (Ic,) + tuple(raw[1:])
    input_names = list(program.inputs)

    def body(origin_i, tiles):
        xidx = {d: lax.axis_index(a) for d, a in dax.items()}
        wide = {}
        for name in input_names:
            spec = program.inputs[name]
            arr = tiles[name]
            if spec.is_scalar:
                wide[name] = arr
                continue
            spanned = [d for d in range(3) if spec.dim_mask[d]]
            for pos, d in reversed(list(enumerate(spanned))):
                if d == 0:
                    continue   # i-halo arrived in the host slab
                if d in dax:
                    wide[name] = arr = _gather_axis_halo(
                        arr, dax[d], nx[d], pos, h[d], loc[d])
                elif h[d]:
                    pad = [(0, 0)] * arr.ndim
                    pad[pos] = (h[d], h[d])
                    wide[name] = arr = jnp.pad(arr, pad)
            wide[name] = arr
        origin = (jnp.int32(origin_i) + h[0],
                  xidx[1] * loc[1] if 1 in dax else 0,
                  xidx[2] * loc[2] if 2 in dax else 0)
        results = evaluate_chain_tile(program, graph, wide, origin,
                                      tuple(h),
                                      core_shape=(Ic, loc[1], loc[2]))
        core = (slice(h[0], h[0] + Ic), slice(h[1], h[1] + loc[1]),
                slice(h[2], h[2] + loc[2]))
        return {n: arr[core] for n, arr in results.items()}

    in_specs = {}
    for name in input_names:
        spec = program.inputs[name]
        if spec.is_scalar:
            in_specs[name] = P()
            continue
        spanned = [d for d in range(3) if spec.dim_mask[d]]
        in_specs[name] = P(*[dax.get(d) for d in spanned])
    out_specs = {n: P(None, dax.get(1), dax.get(2))
                 for n in program.outputs}
    fn = shard_map(body, mesh=mesh, in_specs=(P(), in_specs),
                   out_specs=out_specs, check_vma=False)
    jfn = jax.jit(fn)

    def chunk_fn(origin_i, tiles):
        res = jfn(origin_i, tiles)
        return {n: arr.reshape(local_raw) for n, arr in res.items()}

    n_dev = int(np.prod([nx[d] for d in nx])) or 1
    per_host = sum(
        (Ic + 2 * h[0]) * (loc[1] + 2 * h[1]) * (loc[2] + 2 * h[2])
        * np.dtype(program.field_dtype(f)).itemsize
        for f in list(program.inputs) + list(program.kernels)
        if f not in program.inputs or not program.inputs[f].is_scalar)
    plan = ChunkPlan(chunks=chunks, block=Ic, halo=h[0],
                     backend="sharded-xla",
                     config={"dim_axes": tuple(dim_axes),
                             "devices": n_dev,
                             "per_device_tile_bytes": int(per_host)})
    return chunk_fn, plan


def _host_slab(arr: np.ndarray, lo: int, hi: int, extent: int):
    """``arr[lo:hi]`` along axis 0 with zero padding outside
    ``[0, extent)`` — the host-side equivalent of the sharded path's
    boundary ppermute zeros (parallel/domain.py:_exchange_halo)."""
    lo_pad, hi_pad = max(0, -lo), max(0, hi - extent)
    sl = np.asarray(arr[max(0, lo):min(hi, extent)])
    if lo_pad or hi_pad:
        pad = [(lo_pad, hi_pad)] + [(0, 0)] * (sl.ndim - 1)
        sl = np.pad(sl, pad)
    return sl


def run_chunked(program: ir.Program,
                inputs: Dict[str, Any],
                chunks: int,
                out: Optional[Dict[str, np.ndarray]] = None,
                analysis: Optional[ChainAnalysis] = None,
                compiled=None,
                **compile_kw) -> Dict[str, np.ndarray]:
    """Evaluate the chain out-of-core: host-slice i-chunks (+halo),
    stream each through the compiled kernel, assemble outputs on host.

    ``inputs`` values may be numpy arrays or memmaps at raw rank;
    ``out`` may supply preallocated (possibly memmapped) output arrays.
    ``compiled`` reuses a prior ``compile_chunked_chain`` result.
    """
    analysis = analysis or ChainAnalysis.run(program)
    if compiled is not None:
        fn, plan = compiled
    elif "mesh" in compile_kw:
        fn, plan = compile_chunked_sharded(program, chunks,
                                           analysis=analysis,
                                           **compile_kw)
    else:
        fn, plan = compile_chunked_chain(program, chunks, analysis,
                                         **compile_kw)
    if plan.chunks != chunks:
        raise ValueError(f"compiled for {plan.chunks} chunks, got "
                         f"{chunks}")
    I = program.dimensions[0]
    Ic, h = plan.block, plan.halo
    raw = program.raw_dimensions

    outputs: Dict[str, np.ndarray] = {}
    for o in program.outputs:
        dt = np.dtype(program.kernels[o].dtype)
        if out is not None and o in out:
            got = out[o]
            if got.shape != tuple(raw) or got.dtype != dt:
                raise ValueError(f"out[{o!r}] has shape {got.shape} "
                                 f"dtype {got.dtype}; want {tuple(raw)} "
                                 f"{dt}")
            outputs[o] = got
        else:
            outputs[o] = np.empty(tuple(raw), dtype=dt)

    # double-buffered drain: fn dispatches asynchronously, so slicing +
    # dispatching chunk c+1 before materializing chunk c's outputs
    # overlaps the host writeback/transfer with the device compute
    # (device residency stays O(N/C): one in-flight chunk + one
    # draining result set)
    pending = None   # (chunk_index, device_outputs)

    def drain(p):
        ci, got = p
        for o in program.outputs:
            outputs[o][ci * Ic:(ci + 1) * Ic] = np.asarray(got[o])

    for c in range(chunks):
        lo = c * Ic - h
        hi = (c + 1) * Ic + h
        tiles: Dict[str, Any] = {}
        for name, spec in program.inputs.items():
            arr = inputs[name]
            if spec.is_scalar or not spec.dim_mask[0]:
                tiles[name] = np.asarray(arr)
                continue
            tiles[name] = _host_slab(arr, lo, hi, I)
        got = fn(np.int32(lo), tiles)
        if pending is not None:
            drain(pending)
        pending = (c, got)
    drain(pending)
    return outputs

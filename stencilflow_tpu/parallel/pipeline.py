"""Operator-pipeline split across devices (reference: split_sdfg).

The reference cuts the FPGA pipeline at a stream and bridges the halves with
SMI remote FIFOs (/root/reference/stencilflow/sdfg_generator.py:782-1000),
with elastic FIFOs absorbing skew.  Collectives are lockstep, so the mapping
here is a *wavefront pipeline*: the domain is chunked along the outermost
dim, device ``s`` owns the ``s``-th contiguous segment of the kernel DAG, and
at pipeline step ``t`` device ``s`` processes chunk ``t - s`` — intermediate
tiles hop to the next device (`lax.ppermute`) after every step, so all
segments compute concurrently on different chunks (the gearbox concept of the
reference maps to chunking the stream into tiles).

Chunks are widened by the chain's cumulative halo so each segment's stencil
reads stay local; program inputs are replicated and sliced on demand.  This
mode exists for parity and for chains whose intermediates do not fit one
device — domain decomposition (domain.py) is the preferred mapping otherwise.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from .. import ir
from ..frontend.analysis import ChainAnalysis
from ..frontend.chain import ChainGraph
from ..backend.xla import chain_halo
from ..backend.tile_eval import evaluate_chain_tile

Vec3 = Tuple[int, int, int]


def split_kernels(graph: ChainGraph, num_segments: int) -> List[List[str]]:
    """Cut the topologically ordered kernel list into contiguous segments
    (each prefix is downward-closed, so every cut is valid — the analogue of
    choosing a cut from enumerate_cuts)."""
    order = graph.kernel_order
    n = len(order)
    if num_segments > n:
        raise ValueError(f"cannot split {n} kernels into {num_segments} "
                         "segments")
    bounds = [round(i * n / num_segments) for i in range(num_segments + 1)]
    segments = [order[bounds[i]:bounds[i + 1]] for i in range(num_segments)]
    if any(not s for s in segments):
        raise ValueError("empty pipeline segment; use fewer segments")
    return segments


def split_kernels_at(graph: ChainGraph,
                     cut_after: Sequence[str]) -> List[List[str]]:
    """Cut the pipeline at named kernels: each segment ends just after a
    named kernel (its output is the inter-device stream — the analogue of
    the reference's split at a named stream, sdfg_generator.py:782).  The
    resulting ``len(cut_after)+1`` segments stay in topological order."""
    order = graph.kernel_order
    pos = {k: i for i, k in enumerate(order)}
    missing = [k for k in cut_after if k not in pos]
    if missing:
        raise ValueError(f"unknown cut kernel(s): {missing}; "
                         f"kernels are {order}")
    idxs = sorted(pos[k] for k in cut_after)
    if len(set(idxs)) != len(cut_after):
        raise ValueError("duplicate cut kernels")
    if idxs and idxs[-1] == len(order) - 1:
        raise ValueError(f"cannot cut after the last kernel "
                         f"{order[-1]!r}: the tail segment would be empty")
    bounds = [0] + [i + 1 for i in idxs] + [len(order)]
    return [order[bounds[i]:bounds[i + 1]] for i in range(len(bounds) - 1)]


def split_kernels_at_cut(graph: ChainGraph,
                         before: Sequence[str]) -> List[List[str]]:
    """Segments ``[before, after]`` for an ARBITRARY downward-closed cut
    set — any member of ``graph.enumerate_cuts()``, including cuts that
    are not a prefix of the global topological order (forks with
    interleaved branches).  Each segment is the topological order
    restricted to its side, which is a valid order of the induced
    subgraph, so the wavefront executor runs it unchanged (the
    reference's cut-at-any-stream, sdfg_generator.py:782)."""
    order = graph.kernel_order
    bset = set(before)
    unknown = sorted(bset - set(order))
    if unknown:
        raise ValueError(f"unknown cut kernel(s): {unknown}; "
                         f"kernels are {order}")
    if not bset or len(bset) == len(order):
        raise ValueError("cut must be a non-trivial kernel subset")
    for k in sorted(bset):
        for p in graph.producers(k):
            if p in graph.program.kernels and p not in bset:
                raise ValueError(
                    f"cut is not downward-closed: {k!r} (inside) reads "
                    f"{p!r} (outside); valid cuts are "
                    "graph.enumerate_cuts() members")
    return [[k for k in order if k in bset],
            [k for k in order if k not in bset]]


def validate_segments(graph: ChainGraph,
                      segments: Sequence[Sequence[str]]
                      ) -> List[List[str]]:
    """Check an explicit segment partition: every kernel exactly once and
    no dependency from a later segment back into an earlier one.  Returns
    the segments re-ordered internally by the global topological order
    (any such subsequence is a valid order of the induced subgraph)."""
    order = graph.kernel_order
    seg_of: Dict[str, int] = {}
    for si, seg in enumerate(segments):
        for k in seg:
            if k in seg_of:
                raise ValueError(f"kernel {k!r} appears in segments "
                                 f"{seg_of[k]} and {si}")
            seg_of[k] = si
    missing = [k for k in order if k not in seg_of]
    extra = sorted(set(seg_of) - set(order))
    if missing or extra:
        raise ValueError(f"segments must partition the kernels; "
                         f"missing={missing} unknown={extra}")
    if any(not s for s in segments):
        raise ValueError("empty pipeline segment")
    for k in order:
        for p in graph.producers(k):
            if p in seg_of and seg_of[p] > seg_of[k]:
                raise ValueError(
                    f"segment {seg_of[k]} kernel {k!r} reads {p!r} from "
                    f"later segment {seg_of[p]}: each segment's producers "
                    "must live in the same or an earlier segment")
    return [[k for k in order if seg_of[k] == si]
            for si in range(len(segments))]


def optimize_split(program: ir.Program, graph: ChainGraph,
                   num_segments: int) -> Tuple[List[List[str]], Dict]:
    """Search contiguous cuts for the best pipeline partition: minimize
    the bottleneck segment's compute load (ops/cell), breaking
    ties on inter-device stream traffic (bytes/cell crossing the cuts).
    This is the role the reference's ``enumerate_cuts`` search serves for
    its multi-FPGA partitioning (kernel_chain_graph.py:116-160); for the
    wavefront pipeline only contiguous topological cuts are valid, so the
    search is two exact O(n²·S) DPs (minimal bottleneck, then minimal
    crossing among bottleneck-optimal partitions) rather than an
    enumeration.

    Returns ``(segments, stats)`` with per-segment loads and per-cut
    crossing bytes.
    """
    from ..frontend.analysis import operation_count
    order = graph.kernel_order
    n = len(order)
    if num_segments > n:
        raise ValueError(f"cannot split {n} kernels into {num_segments} "
                         "segments")
    # plain op counts, each op weighted 1: per-op costs on the GPU are
    # not measured (report.py counts the same way)
    load = [sum(operation_count(program.kernels[k]).values())
            for k in order]
    prefix = [0]
    for v in load:
        prefix.append(prefix[-1] + v)

    idx = {k: i for i, k in enumerate(order)}
    # crossing bytes per cell for a cut after position i: kernel fields
    # produced at <= i and read later (program inputs are replicated);
    # program outputs produced early ride the carry across every later
    # cut until emission, so they always cross
    cross = [0] * n
    for i in range(n - 1):
        total = 0
        for j, k in enumerate(order):
            if j > i:
                continue
            reads_later = any(idx.get(c, -1) > i
                              for c in graph.consumers(k)
                              if c in program.kernels)
            if reads_later or k in program.outputs:
                total += np.dtype(program.kernels[k].dtype).itemsize
        cross[i] = total

    INF = float("inf")
    # phase 1 — exact minimal bottleneck: dp1[s][j] = min over cuts of
    # the max segment load splitting order[:j] into s segments
    dp1 = [[INF] * (n + 1) for _ in range(num_segments + 1)]
    dp1[0][0] = 0.0
    for s in range(1, num_segments + 1):
        for j in range(s, n + 1):
            dp1[s][j] = min(
                (max(dp1[s - 1][i], prefix[j] - prefix[i])
                 for i in range(s - 1, j)), default=INF)
    bstar = dp1[num_segments][n]
    # phase 2 — among partitions whose every segment load <= bstar,
    # exactly minimize total crossing bytes
    dp2 = [[INF] * (n + 1) for _ in range(num_segments + 1)]
    cut_at = [[-1] * (n + 1) for _ in range(num_segments + 1)]
    dp2[0][0] = 0.0
    for s in range(1, num_segments + 1):
        for j in range(s, n + 1):
            for i in range(s - 1, j):
                if dp2[s - 1][i] == INF or \
                        prefix[j] - prefix[i] > bstar:
                    continue
                c = dp2[s - 1][i] + (cross[i - 1] if i > 0 else 0)
                if c < dp2[s][j]:
                    dp2[s][j] = c
                    cut_at[s][j] = i
    # reconstruct
    bounds = [n]
    j = n
    for s in range(num_segments, 0, -1):
        j = cut_at[s][j]
        bounds.append(j)
    bounds.reverse()
    segments = [order[bounds[i]:bounds[i + 1]]
                for i in range(num_segments)]
    stats = {
        "segment_loads": [prefix[bounds[i + 1]] - prefix[bounds[i]]
                          for i in range(num_segments)],
        "cut_bytes_per_cell": [cross[bounds[i + 1] - 1]
                               for i in range(num_segments - 1)],
        "bottleneck_load": bstar,
    }
    return segments, stats


@dataclasses.dataclass
class PipelineSplit:
    program: ir.Program
    mesh: Mesh
    axis: str                      # mesh axis carrying pipeline stages
    segments: List[List[str]]
    halo: Vec3
    num_chunks: int
    chunk: int                     # chunk extent along dim 0
    # pipeline x domain composition: domain dim (1=j / 2=k) -> mesh axis
    # carrying that dim's shards (None/{}: full domain per device)
    domain_axes: Optional[Dict[int, str]] = None


def _gather_axis_halo(arr, mesh_axis: str, n: int, pos: int, h: int,
                      local: int):
    """Widen ``arr`` by ``h`` rows on both sides of array axis ``pos``
    with data pulled from mesh neighbors along ``mesh_axis`` — multi-hop
    when ``h`` exceeds the local extent.  Devices past the global edge
    contribute ppermute zeros, which the BC masks at global coordinates
    correct (the pipeline's widened-tile discipline).  With one device
    on the axis this degenerates to zero padding."""
    pad = [(0, 0)] * arr.ndim
    pad[pos] = (h, h)
    if h == 0:
        return arr
    if n == 1:
        return jnp.pad(arr, pad)
    hops = -(-h // local)
    right = [(p, p + 1) for p in range(n - 1)]
    left = [(p + 1, p) for p in range(n - 1)]
    fr = fl = arr
    froms_right, froms_left = [], []
    for _ in range(hops):
        fr = lax.ppermute(fr, mesh_axis, left)    # neighbor above
        fl = lax.ppermute(fl, mesh_axis, right)   # neighbor below
        froms_right.append(fr)
        froms_left.append(fl)
    stacked = jnp.concatenate(
        list(reversed(froms_left)) + [arr] + froms_right, axis=pos)
    start = hops * local - h
    return lax.slice_in_dim(stacked, start, start + local + 2 * h,
                            axis=pos)


def _segment_eval(program, graph, segment, tiles, origin, halo,
                  core_shape):
    """Evaluate one contiguous kernel segment on a widened tile dict."""
    sub_order = [n for n in graph.order if n not in program.kernels
                 or n in segment]
    # evaluate_chain_tile walks graph.kernel_order; restrict via a shallow
    # proxy graph that only exposes this segment's kernels.
    proxy = dataclasses.replace(graph)
    proxy.order = sub_order
    return evaluate_chain_tile(program, proxy, tiles, origin, halo,
                               keep=segment, core_shape=core_shape)


def _segment_program(program: ir.Program, graph: ChainGraph,
                     segment: List[str], seg_idx: int,
                     later_kernels: Set[str]) -> ir.Program:
    """Stand-alone sub-program for one pipeline segment.

    Upstream kernel fields the segment reads become full-3D inputs (their
    widened tiles arrive in the pipeline carry); outputs are the segment's
    kernels consumed by ``later_kernels`` (membership in later segments —
    NOT topological position, so non-prefix downward-closed cuts work) or
    by the program itself.  Global ``dimensions`` are kept — boundary-
    condition masks must see global coordinates (the widened-tile origin
    is supplied at run time)."""
    seg_set = set(segment)
    kernels = {k: program.kernels[k] for k in segment}
    inputs: Dict[str, ir.InputSpec] = {}
    for k in segment:
        for f in program.kernels[k].accesses():
            if f in seg_set or f in inputs:
                continue
            if f in program.inputs:
                inputs[f] = program.inputs[f]
            else:
                inputs[f] = ir.InputSpec(f, program.kernels[f].dtype,
                                         (True, True, True), None)
    later_reads = set()
    for k in later_kernels:
        later_reads.update(program.kernels[k].accesses())
    outs = [k for k in segment
            if k in later_reads or k in program.outputs]
    return dataclasses.replace(program,
                               name=f"{program.name}_seg{seg_idx}",
                               inputs=inputs, outputs=outs, kernels=kernels)


def _pipeline_body(plan: PipelineSplit, graph: ChainGraph,
                   inputs: Dict[str, Any]) -> Dict[str, Any]:
    program = plan.program
    S = len(plan.segments)
    C = plan.num_chunks
    halo = plan.halo
    dims = program.dimensions
    tile_shape = (plan.chunk + 2 * halo[0], dims[1] + 2 * halo[1],
                  dims[2] + 2 * halo[2])
    s = lax.axis_index(plan.axis)

    # Replicated padded inputs, sliced per step.
    padded: Dict[str, Any] = {}
    for name, spec in program.inputs.items():
        arr = inputs[name]
        if spec.is_scalar:
            padded[name] = arr
            continue
        spanned = [d for d in range(3) if spec.dim_mask[d]]
        shape = tuple(dims[d] for d in spanned)
        pads = [(halo[d], halo[d]) for d in spanned]
        padded[name] = jnp.pad(jnp.asarray(arr).reshape(shape), pads)

    def input_tile(name, spec, c):
        arr = padded[name]
        if spec.is_scalar:
            return arr
        spanned = [d for d in range(3) if spec.dim_mask[d]]
        starts, sizes = [], []
        for d in spanned:
            if d == 0:
                starts.append(c * plan.chunk)
                sizes.append(plan.chunk + 2 * halo[0])
            else:
                starts.append(0)
                sizes.append(dims[d] + 2 * halo[d])
        return lax.dynamic_slice(arr, starts, sizes)

    # Carried tile: only the INTERFACE fields hop devices — kernels read
    # by a later segment, plus program outputs produced before the last
    # segment (they must reach the writing device).  Intra-segment
    # temporaries never leave their device (the reference's cut-stream
    # bandwidth model: only the cut edges cross, sdfg_generator.py:848).
    seg_of = {k: i for i, seg in enumerate(plan.segments) for k in seg}
    carried = set()
    for kname, kspec in program.kernels.items():
        for f in kspec.accesses():
            if f in seg_of and seg_of[f] < seg_of[kname]:
                carried.add(f)
    # every program output must reach the writing (last) device
    carried |= set(program.outputs)
    carried = sorted(carried)

    def empty_tile():
        return {k: jnp.zeros(tile_shape, dtype=program.kernels[k].dtype)
                for k in carried}

    out_shape = (C * plan.chunk, dims[1], dims[2])
    outputs0 = {o: jnp.zeros(out_shape, program.kernels[o].dtype)
                for o in program.outputs}

    branches = []
    for seg_idx, segment in enumerate(plan.segments):
        def branch(args, segment=segment, seg_idx=seg_idx):
            tiles, origin = args
            res = _segment_eval(program, graph, segment, tiles, origin,
                                halo, (plan.chunk, dims[1], dims[2]))
            new = dict(tiles)
            new.update(res)
            return {k: new[k] for k in carried}
        branches.append(branch)

    def step(carry, t):
        tiles, outputs = carry
        c = t - s  # chunk index this device works on at step t
        valid = (c >= 0) & (c < C)
        c_clamped = jnp.clip(c, 0, C - 1)
        origin = (c_clamped * plan.chunk, 0, 0)
        full = {n: input_tile(n, spec, c_clamped)
                for n, spec in program.inputs.items()}
        full.update(tiles)
        seg = jnp.minimum(s, S - 1)
        new_tiles = lax.switch(seg, branches, (full, origin))

        # last stage writes its finished chunk (if valid)
        def write(outputs):
            out = {}
            core = (slice(halo[0], halo[0] + plan.chunk),
                    slice(halo[1], halo[1] + dims[1]),
                    slice(halo[2], halo[2] + dims[2]))
            for o in program.outputs:
                chunk_val = new_tiles[o][core]
                out[o] = lax.dynamic_update_slice(
                    outputs[o], chunk_val, (c_clamped * plan.chunk, 0, 0))
            return out

        is_last = (s == S - 1) & valid
        outputs = lax.cond(is_last, write, lambda o: o, outputs)

        # hop tiles to the next stage
        perm = [(p, p + 1) for p in range(S - 1)]
        next_tiles = {k: lax.ppermute(v, plan.axis, perm)
                      for k, v in new_tiles.items()}
        return (next_tiles, outputs), None

    (_, outputs), _ = lax.scan(step, (empty_tile(), outputs0),
                               jnp.arange(S + C - 1))
    # replicate the result: only stage S-1 holds real data
    mask = (s == S - 1).astype(jnp.float32)
    outputs = {k: lax.psum(v * mask.astype(v.dtype), plan.axis)
               for k, v in outputs.items()}
    raw = program.raw_dimensions
    # C * chunk == dims[0] by construction
    return {k: v.reshape(raw) for k, v in outputs.items()}


def _pipeline_body_sharded(plan: PipelineSplit, graph: ChainGraph,
                           inputs: Dict[str, Any]) -> Dict[str, Any]:
    """Memory-scalable wavefront: every per-device buffer is O(N/S).

    Three systolic rings replace the replicated-I/O body (the cut-stream-
    only traffic model of the reference, sdfg_generator.py:848-963):

    * **feed ring** (leftward, ``p+1 -> p``): device ``d`` starts holding
      its own halo-widened input shard (chunk ``d``); after ``t`` shifts,
      stage 0 holds exactly chunk ``t`` — the chunk it must start at step
      ``t``.  Inputs are i-sharded (``P(axis)``), never replicated; the
      i-halo is gathered multi-hop when the chain halo spans several
      chunks.
    * **wavefront carry** (rightward, ``p -> p+1``): ONE stacked buffer
      sized by the widest cut — entry ``i`` at the hop out of stage ``s``
      is ``cut_layouts[s][i]``, each stage un/packing by its own static
      layout.  Only the fields actually crossing a cut ever travel
      (the reference charges exactly the cut stream,
      sdfg_generator.py:848), and the carry does NOT grow with S.
    * **output return ring** (rightward, cyclic): the last stage drops
      each finished core chunk into the ring; chunk ``c`` reaches its home
      device ``c`` after ``(c+1) mod S`` hops, where an arithmetic capture
      condition (no lax.switch, no psum) stores it into that device's
      O(N/S) output shard.

    Requires ``num_chunks == S`` and ``dims[0] % S == 0`` (the caller
    falls back to the replicated body otherwise).
    """
    program = plan.program
    S = len(plan.segments)
    C = plan.num_chunks
    assert C == S
    halo = plan.halo
    dims = program.dimensions
    chunk = plan.chunk
    # pipeline x domain composition: j/k may be sharded over further
    # mesh axes — every buffer shrinks to the LOCAL extents, halos in
    # sharded dims are gathered from domain neighbors (real data, not
    # zero padding), and origins carry the shard's global offset so BC
    # masks stay global (VERDICT r4 #4)
    dax = dict(plan.domain_axes or {})
    nx = {d: plan.mesh.shape[a] for d, a in dax.items()}
    loc = {d: dims[d] // nx.get(d, 1) for d in (1, 2)}
    xidx = {d: lax.axis_index(a) for d, a in dax.items()}
    tile_shape = (chunk + 2 * halo[0], loc[1] + 2 * halo[1],
                  loc[2] + 2 * halo[2])
    s = lax.axis_index(plan.axis)

    right = [(p, p + 1) for p in range(S - 1)]
    left = [(p + 1, p) for p in range(S - 1)]
    ring = [(p, (p + 1) % S) for p in range(S)]

    seg_of = {k: i for i, seg in enumerate(plan.segments) for k in seg}
    idx_of = {k: i for i, k in enumerate(graph.kernel_order)}

    # per-cut layout: fields crossing the cut after segment cs — kernels
    # read by a later segment plus outputs produced at or before cs
    cut_layouts: List[List[str]] = []
    for cs in range(S - 1):
        L = []
        for f in program.kernels:
            if seg_of[f] > cs:
                continue
            later = any(seg_of.get(c, -1) > cs
                        for c in graph.consumers(f)
                        if c in program.kernels)
            if later or f in program.outputs:
                L.append(f)
        cut_layouts.append(sorted(L, key=idx_of.get))
    M = max(len(L) for L in cut_layouts)
    wave_dtype = jnp.result_type(
        *[np.dtype(program.kernels[f].dtype)
          for L in cut_layouts for f in L])

    # i-spanning inputs still read by segments past the first ride a
    # separate named carry (injected by stage 0 from its feed slot)
    i_inputs = [n for n, sp in program.inputs.items()
                if not sp.is_scalar and sp.dim_mask[0]]
    carried_inputs = sorted({
        f for kname, kspec in program.kernels.items()
        if seg_of[kname] > 0 for f in kspec.accesses()
        if f in i_inputs})

    # --- per-device widened input shard (the feed ring's initial load) ---
    feed0: Dict[str, Any] = {}
    small: Dict[str, Any] = {}   # replicated non-i inputs, padded once
    for name, spec in program.inputs.items():
        arr = inputs[name]
        if spec.is_scalar:
            small[name] = arr
            continue
        spanned = [d for d in range(3) if spec.dim_mask[d]]
        if not spec.dim_mask[0]:
            # replicated (non-i) input: pad by the halo, then slice the
            # local widened window of any domain-sharded dim (its global
            # window [x*L - h, x*L + L + h) is [x*L, ...) after the pad)
            arr = jnp.asarray(arr).reshape(
                tuple(dims[d] for d in spanned))
            pads = [(halo[d], halo[d]) for d in spanned]
            arr = jnp.pad(arr, pads)
            for pos, d in enumerate(spanned):
                if d in dax:
                    arr = lax.dynamic_slice_in_dim(
                        arr, xidx[d] * loc[d], loc[d] + 2 * halo[d],
                        axis=pos)
            small[name] = arr
            continue
        # i-spanning input, sharded over the pipeline axis (and any
        # domain axes): widen j/k by pad or neighbor gather, then gather
        # the i-halo from pipeline neighbors — multi-hop when the chain
        # halo exceeds one chunk/shard.  O(local + 2*halo) per device;
        # devices past a global edge contribute zeros, which the BC
        # masks at global coordinates correct.
        arr = jnp.asarray(arr).reshape(
            tuple(chunk if d == 0 else loc[d] for d in spanned))
        for pos, d in reversed(list(enumerate(spanned))):
            if d == 0:
                continue
            if d in dax:
                arr = _gather_axis_halo(arr, dax[d], nx[d], pos,
                                        halo[d], loc[d])
            elif halo[d]:
                pad = [(0, 0)] * arr.ndim
                pad[pos] = (halo[d], halo[d])
                arr = jnp.pad(arr, pad)
        arr = _gather_axis_halo(arr, plan.axis, S, 0, halo[0], chunk)
        feed0[name] = arr

    def zero_input_tiles(names):
        out = {}
        for k in names:
            spec = program.inputs[k]
            shp = tuple(tile_shape[d] for d in range(3)
                        if spec.dim_mask[d])
            out[k] = jnp.zeros(shp, np.dtype(spec.dtype))
        return out

    out_local0 = {o: jnp.zeros((chunk, loc[1], loc[2]),
                               program.kernels[o].dtype)
                  for o in program.outputs}
    ring0 = {o: jnp.zeros((chunk, loc[1], loc[2]),
                          program.kernels[o].dtype)
             for o in program.outputs}
    wave0 = jnp.zeros((M,) + tile_shape, wave_dtype)

    # branches: unpack the incoming cut stack by the segment's own static
    # layout, evaluate, pack the outgoing cut; also return every program
    # output tile (zeros when this segment does not see it) for the ring
    branches = []
    for seg_idx, segment in enumerate(plan.segments):
        def branch(args, segment=segment, seg_idx=seg_idx):
            stack, tiles, origin = args
            tiles = dict(tiles)
            if seg_idx > 0:
                for i, f in enumerate(cut_layouts[seg_idx - 1]):
                    tiles[f] = stack[i].astype(program.kernels[f].dtype)
            res = _segment_eval(program, graph, segment, tiles, origin,
                                halo, (chunk, loc[1], loc[2]))
            new = dict(tiles)
            new.update(res)
            out_layout = (cut_layouts[seg_idx] if seg_idx < S - 1 else [])
            parts = [new[f].astype(wave_dtype)[None] for f in out_layout]
            parts += [jnp.zeros((M - len(parts),) + tile_shape,
                                wave_dtype)] if len(parts) < M else []
            out_stack = jnp.concatenate(parts, axis=0) if parts else wave0
            outs = {o: (new[o] if o in new else
                        jnp.zeros(tile_shape, program.kernels[o].dtype))
                    for o in program.outputs}
            return out_stack, outs
        branches.append(branch)

    # arithmetic capture step for this device's output chunk (see above)
    t_cap = s + jnp.int32(S - 1) + jax.lax.rem(s + 1, jnp.int32(S))

    def step(carry, t):
        feed, wave, wave_in, out_ring, out_local = carry
        c = t - s
        valid = (c >= 0) & (c < C)
        c_clamped = jnp.clip(c, 0, C - 1)
        origin = (c_clamped * chunk,
                  xidx[1] * loc[1] if 1 in dax else 0,
                  xidx[2] * loc[2] if 2 in dax else 0)

        # stage 0 takes its input tiles from the feed slot; later stages
        # from the input carry
        tiles = dict(small)
        for n in i_inputs:
            src = feed[n]
            if n in wave_in:
                src = jnp.where(s == 0, src, wave_in[n])
            tiles[n] = src
        seg = jnp.minimum(s, S - 1)
        out_stack, outs = lax.switch(seg, branches, (wave, tiles, origin))
        new_wave_in = {n: tiles[n] for n in carried_inputs}

        # last stage drops its finished core chunk into the return ring
        core = (slice(halo[0], halo[0] + chunk),
                slice(halo[1], halo[1] + loc[1]),
                slice(halo[2], halo[2] + loc[2]))
        is_last = (s == S - 1) & valid
        new_ring = {}
        for o in program.outputs:
            done = outs[o][core]
            new_ring[o] = jnp.where(is_last, done.astype(out_ring[o].dtype),
                                    out_ring[o])

        # capture: my chunk is in my ring slot exactly at step t_cap
        grab = t == t_cap
        out_local = {o: jnp.where(grab, new_ring[o], out_local[o])
                     for o in program.outputs}

        # systolic shifts
        feed = {n: lax.ppermute(v, plan.axis, left)
                for n, v in feed.items()}
        out_stack = lax.ppermute(out_stack, plan.axis, right)
        new_wave_in = {n: lax.ppermute(v, plan.axis, right)
                       for n, v in new_wave_in.items()}
        new_ring = {o: lax.ppermute(v, plan.axis, ring)
                    for o, v in new_ring.items()}
        return (feed, out_stack, new_wave_in, new_ring, out_local), None

    T = max(S + C - 1, 3 * S - 3)
    carry0 = (feed0, wave0, zero_input_tiles(carried_inputs),
              ring0, out_local0)
    (_f, _w, _wi, _r, out_local), _ = lax.scan(step, carry0,
                                               jnp.arange(T))
    # sharded io requires rank-3 programs, so the local raw shape is the
    # per-device (chunk, local-j, local-k) block
    return {k: v.reshape((chunk, loc[1], loc[2]))
            for k, v in out_local.items()}


def compile_pipeline_split(program: ir.Program, mesh: Mesh, axis: str,
                           num_chunks: Optional[int] = None,
                           analysis: Optional[ChainAnalysis] = None,
                           split_at: Optional[Sequence[str]] = None,
                           cut: Optional[Sequence[str]] = None,
                           segments: Optional[Sequence[Sequence[str]]]
                           = None,
                           optimize_cuts: bool = False,
                           io: str = "auto",
                           domain_axes: Optional[Dict[int, str]] = None):
    """Jitted wavefront-pipelined chain over ``mesh.shape[axis]`` devices.
    Each segment runs the fused tile evaluator over the widened chunk.

    ``io="sharded"`` (the default when the shape allows): inputs and
    outputs are i-sharded over the pipeline axis and every per-device
    buffer is O(N/S) (_pipeline_body_sharded) — the memory-scalable mode
    that justifies pipelining chains too deep for one device.  Requires
    ``dims[0]`` divisible by the device count, rank-3 output, and one
    dtype across cut-crossing fields (the i-halo may exceed a chunk —
    the body gathers it multi-hop).  ``io="replicated"`` keeps the
    round-1 body (replicated inputs/outputs, any chunk count, mixed
    dtypes).

    Partition selection (at most one): ``split_at`` cuts after named
    kernels in the global topological order; ``cut`` realizes ONE
    arbitrary downward-closed cut set (any ``enumerate_cuts()`` member —
    forks may interleave, the cut need not be an order prefix);
    ``segments`` gives the full partition explicitly (validated);
    ``optimize_cuts`` searches contiguous cuts for minimal bottleneck.
    Returns ``(fn, plan)``.

    ``domain_axes`` composes the pipeline with DOMAIN DECOMPOSITION on a
    multi-dim mesh (the story for chains both deep and large):
    ``{1: "x"}`` shards j (and/or ``{2: "y"}`` k) over further mesh axes,
    so each pipeline segment runs on an O(N/(S*X)) subdomain with
    per-segment halo gathered from domain neighbors while wavefront
    chunks ride the pipeline axis.  Requires sharded io and a domain
    extent divisible by the axis size — the reference's analogue scales
    operators only, each device holding the full domain
    (/root/reference/stencilflow/sdfg_generator.py:782-1000).
    """
    analysis = analysis or ChainAnalysis.run(program)
    if domain_axes:
        bad = [d for d in domain_axes if d not in (1, 2)]
        if bad:
            raise ValueError(f"domain_axes keys must be 1 (j) or 2 (k), "
                             f"got {sorted(domain_axes)}")
        for d, ax in domain_axes.items():
            if ax == axis:
                raise ValueError(
                    f"domain axis {ax!r} is the pipeline axis")
            if program.dimensions[d] % mesh.shape[ax]:
                raise ValueError(
                    f"dim {d} ({program.dimensions[d]}) not divisible "
                    f"by mesh axis {ax!r} ({mesh.shape[ax]})")
        if io == "replicated":
            raise ValueError("domain_axes requires sharded pipeline io")
        io = "sharded"

    graph = analysis.graph
    S = mesh.shape[axis]
    if sum(x is not None for x in (split_at, cut, segments)) > 1:
        raise ValueError("pass at most one of split_at / cut / segments")
    if segments is not None:
        # explicit partition: any order-respecting assignment, including
        # non-prefix downward-closed cuts on forked chains
        segments = validate_segments(graph, segments)
    elif cut is not None:
        # one arbitrary downward-closed cut set (enumerate_cuts member)
        segments = split_kernels_at_cut(graph, cut)
    elif split_at is not None:
        segments = split_kernels_at(graph, split_at)
    elif optimize_cuts:
        segments, _stats = optimize_split(program, graph, S)
    else:
        segments = split_kernels(graph, S)
    if len(segments) != S:
        raise ValueError(
            f"partition gives {len(segments)} segments but mesh axis "
            f"{axis!r} has {S} devices")
    halo = chain_halo(analysis)
    dims = program.dimensions
    # the sharded body packs every cut-crossing field into ONE stacked
    # carry; mixed dtypes would round-trip through a promoted type
    # (lossy for e.g. int32 > 2^24 in float32), so require uniformity
    seg_of = {f: si for si, seg in enumerate(segments) for f in seg}
    crossing = {
        np.dtype(program.kernels[f].dtype)
        for f in program.kernels
        if any(seg_of.get(c, -1) > seg_of[f]
               for c in graph.consumers(f) if c in program.kernels)
        or (f in program.outputs and seg_of[f] < S - 1)}
    # sharded-I/O eligibility: C == S chunks of equal size, rank-3 output
    # (the i-halo may span multiple chunks — gathered multi-hop), one
    # dtype across all cut-crossing fields
    can_shard = (S > 1 and dims[0] % S == 0
                 and len(program.raw_dimensions) == 3
                 and len(crossing) <= 1
                 and (num_chunks is None or num_chunks == S))
    if io == "sharded" and not can_shard:
        raise ValueError(
            "sharded pipeline I/O needs num_chunks == devices, dim 0 "
            f"divisible by {S}, a 3-D output, and one dtype across "
            f"cut-crossing fields (got {sorted(d.name for d in crossing)})")
    sharded_io = io == "sharded" or (io == "auto" and can_shard)
    if num_chunks is None:
        num_chunks = S if sharded_io else max(1, min(S, dims[0]))
    if dims[0] % num_chunks != 0:
        raise ValueError(f"dim 0 ({dims[0]}) not divisible into "
                         f"{num_chunks} chunks")
    chunk = dims[0] // num_chunks
    plan = PipelineSplit(program, mesh, axis, segments, halo, num_chunks,
                         chunk, domain_axes=dict(domain_axes or {}))
    compile_pipeline_split.last_config = {
        "io": "sharded" if sharded_io else "replicated"}
    if sharded_io:
        dax = dict(domain_axes or {})
        in_spec_map = {}
        for n, spec in program.inputs.items():
            if spec.is_scalar or not spec.dim_mask[0]:
                # non-i inputs stay replicated; the body slices the
                # local widened window of any domain-sharded dim
                in_spec_map[n] = P()
            else:
                spanned = [d for d in range(3) if spec.dim_mask[d]]
                in_spec_map[n] = P(axis, *[dax.get(d)
                                           for d in spanned[1:]])
        out_specs = {n: P(axis, dax.get(1), dax.get(2))
                     for n in program.outputs}
        body = functools.partial(_pipeline_body_sharded, plan, graph)
    else:
        in_spec_map = {n: P() for n in program.inputs}
        out_specs = {n: P() for n in program.outputs}
        body = functools.partial(_pipeline_body, plan, graph)
    compile_pipeline_split.last_config["in_specs"] = dict(in_spec_map)
    compile_pipeline_split.last_config["out_specs"] = dict(out_specs)
    fn = shard_map(body, mesh=mesh, in_specs=(in_spec_map,),
                   out_specs=out_specs, check_vma=False)
    return jax.jit(fn), plan


def run_pipeline_split(program: ir.Program, mesh: Mesh, axis: str,
                       inputs: Dict[str, Any],
                       num_chunks: Optional[int] = None,
                       split_at: Optional[Sequence[str]] = None,
                       cut: Optional[Sequence[str]] = None
                       ) -> Dict[str, np.ndarray]:
    fn, _ = compile_pipeline_split(program, mesh, axis, num_chunks,
                                   split_at=split_at, cut=cut)
    out = fn({k: jnp.asarray(v) for k, v in inputs.items()})
    return {k: np.asarray(v) for k, v in out.items()}

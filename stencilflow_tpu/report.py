"""Analytic performance report: op counts, communication volume, and a
dual roofline against a device's published peaks.

The reference reports peak/upper-bound GOp/s at an FPGA clock, runtime lower
bound in cycles, minimum communication volume, and required bandwidth
(/root/reference/bin/report.py:23-57, kernel_chain_graph.py:721-774).  Here
the analogous model has two ceilings, both from ``device.PEAKS``:

* **memory roofline**: minimum traffic = every input + output array moved
  once (the reference's minimum-communication-volume model) at the device's
  memory bandwidth;
* **compute roofline**: the chain's per-cell operation count at the
  device's float32 rate.

The runtime lower bound is the max of the two.  Operations are plain
counts, each weighted 1: per-op costs on the GPU are not measured.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from typing import Dict, Optional

from .device import H100_SXM, Peaks, peaks_for
from .frontend.analysis import ChainAnalysis
from .ir import Program


@dataclasses.dataclass
class Report:
    program: Program
    analysis: ChainAnalysis
    hw: Peaks

    @classmethod
    def build(cls, program: Program,
              analysis: Optional[ChainAnalysis] = None,
              hw: Optional[Peaks] = None) -> "Report":
        """``hw`` defaults to the H100 SXM row of ``device.PEAKS``."""
        return cls(program, analysis or ChainAnalysis.run(program),
                   hw or peaks_for(H100_SXM))

    # -- model ---------------------------------------------------------------
    def ops_per_cell(self) -> float:
        """Operations per domain cell over the whole chain (each op
        weighted 1)."""
        return float(sum(per_cell for per_cell, _tot in
                         self.analysis.operation_counts().values()))

    def total_ops(self) -> float:
        return self.ops_per_cell() * self.program.total_elements

    def hbm_footprint_bytes(self) -> int:
        """Device-resident bytes of an in-core run: every input + output
        array."""
        return self.analysis.minimum_communication_volume()

    def suggested_host_chunks(self) -> int:
        """1 when the in-core footprint fits device memory (with 25%
        headroom for XLA temporaries), else the smallest power-of-two
        i-chunk count that brings the per-chunk footprint under it
        (out-of-core execution, ``run --host-chunks``); 0 when no chunking
        helps (the i extent cannot absorb it, or non-i-spanning arrays
        alone exceed the budget — only i-spanning bytes shrink with
        chunking)."""
        budget = 0.75 * self.hw.hbm_bytes
        total = self.hbm_footprint_bytes()
        if total <= budget:
            return 1
        p = self.program
        elem = 1
        for d in p.dimensions:
            elem *= d
        i_bytes = sum(
            np.prod(spec.shape(p.dimensions), dtype=np.int64)
            * spec.dtype.itemsize
            for spec in p.inputs.values()
            if not spec.is_scalar and spec.dim_mask[0])
        i_bytes += sum(elem * np.dtype(p.kernels[o].dtype).itemsize
                       for o in p.outputs)   # outputs span the domain
        fixed = total - int(i_bytes)
        if fixed > budget:
            return 0
        I = p.dimensions[0]
        c = 2
        while c <= I:
            if I % c == 0 and fixed + i_bytes / c <= budget:
                return c
            c *= 2
        return 0

    def hbm_time_s(self) -> float:
        return (self.analysis.minimum_communication_volume()
                / self.hw.hbm_bandwidth)

    def compute_time_s(self) -> float:
        return self.total_ops() / self.hw.fp32_flops

    def bound_fractions(self, measured_time_s: float) -> Dict[str, float]:
        """Fractions of each roofline term for a measured per-evaluation
        time (the reference's upper-bound-vs-peak distinction,
        /root/reference/bin/report.py:40-43)."""
        return {"vs_hbm": self.hbm_time_s() / measured_time_s,
                "vs_compute": self.compute_time_s() / measured_time_s}

    def roofline_time_s(self) -> float:
        """Runtime lower bound: the larger of the memory and compute
        floors."""
        return max(self.hbm_time_s(), self.compute_time_s(), 1e-12)

    def bound(self) -> str:
        return ("compute" if self.compute_time_s() > self.hbm_time_s()
                else "hbm")

    def roofline_gcell_s(self) -> float:
        return self.program.total_elements / self.roofline_time_s() / 1e9

    def fast_memory_bytes(self) -> int:
        """On-chip working set of the streaming schedule (delay + line
        buffers), the reference's fast-memory total."""
        return self.analysis.fast_memory_bytes()

    # -- multi-device scaling model -------------------------------------------
    def mesh_scaling(self, mesh_dims: Dict[str, int],
                     dim_axes=(None, "x", "y"),
                     link_bandwidth: Optional[float] = None) -> Dict:
        """Analytic scaling of the shard_map domain decomposition over a
        device mesh: per-device compute (widened by the chain halo) plus
        the one cumulative-halo exchange per chain evaluation
        (parallel/domain.py), priced at ``link_bandwidth`` (default: the
        device's link rate each way; NVLink joins every pair of cards at
        the same rate, so the mesh shape does not change it).  The
        analogue of the reference's required-bandwidth model
        (bin/report.py:55-57) — it answers "does the halo exchange fit
        under the compute" for a proposed mesh.

        ``mesh_dims``: {axis name: devices along it}; ``dim_axes``: per
        padded dim (i, j, k) the mesh axis that shards it, or None.
        """
        from .backend.xla import chain_halo
        if link_bandwidth is None:
            link_bandwidth = self.hw.link_bandwidth
        dims = self.program.dimensions
        halo = chain_halo(self.analysis)
        used = [a for a in dim_axes if a]
        if len(set(used)) != len(used):
            raise ValueError(f"mesh axis used for two dims: {dim_axes}")
        unknown = [a for a in used if a not in mesh_dims]
        if unknown:
            raise ValueError(f"dim_axes name(s) {unknown} missing from "
                             f"mesh {dict(mesh_dims)}")
        n_dev = int(np.prod(list(mesh_dims.values())))  # unused axes
        local = list(dims)                              # replicate
        shards = [1, 1, 1]
        for d, ax in enumerate(dim_axes):
            m = mesh_dims.get(ax, 1) if ax else 1
            if m <= 1:
                continue
            if dims[d] % m:
                raise ValueError(
                    f"dim {d} ({dims[d]}) not divisible by mesh axis "
                    f"{ax!r} ({m})")
            shards[d] = m
            local[d] = dims[d] // m

        # redundant compute on the exchanged halo shell
        widened = 1.0
        for d in range(3):
            if shards[d] > 1:
                widened *= (local[d] + 2 * halo[d]) / local[d]
        frac = np.prod(local) / self.program.total_elements
        t_comp = max(self.hbm_time_s() * frac * widened,
                     self.compute_time_s() * frac * widened, 1e-12)

        # cumulative-halo exchange: per sharded dim, both directions, for
        # every full-domain input field (domain.py exchanges inputs once
        # per evaluation with the chain-cumulative halo).  Exchanges run
        # dim-by-dim, so later dims' slabs span the already-widened
        # earlier dims (corner traffic) — validated EXACTLY against the
        # collective-permute bytes of the compiled sharded HLO
        # (tests/test_mesh_model.py).
        link_bytes = 0
        for name, spec in self.program.inputs.items():
            if spec.is_scalar:
                continue
            isz = np.dtype(self.program.field_dtype(name)).itemsize
            for d in range(3):
                if shards[d] <= 1 or not spec.dim_mask[d] or not halo[d]:
                    continue
                cross = 1
                for o in range(3):
                    if o == d or not spec.dim_mask[o]:
                        continue
                    w = local[o]
                    if o < d and shards[o] > 1 and halo[o]:
                        # earlier-exchanged dim: the slab spans its
                        # widened extent (corner traffic)
                        w += 2 * halo[o]
                    cross *= w
                link_bytes += 2 * halo[d] * cross * isz
        t_link = link_bytes / link_bandwidth
        t_step = t_comp + t_link         # no compute/comm overlap assumed
        t_single = self.roofline_time_s()

        # --comm-overlap variant (parallel/domain.py overlap bodies): the
        # interior evaluates the UNWIDENED local block with no dependency
        # on the ppermute slabs (so the exchange hides behind it), then
        # per sharded face a 3h-thick strip re-evaluates from the widened
        # array — strips span the widened extents of every other dim
        # (corner coverage).  Overcompute per sharded dim = interior rim
        # (2h wasted planes inside the unwidened pass) + 2 x 3h strip
        # planes, i.e. ~ (B + 6h) vs the blocking body's (B + 2h).
        per_cell = t_comp / (np.prod(local) * widened)   # cost/evaluated cell
        interior_cells = float(np.prod(local))
        strip_cells = 0.0
        for d in range(3):
            if shards[d] <= 1 or not halo[d]:
                continue
            face = 1.0
            for o in range(3):
                if o == d:
                    continue
                face *= local[o] + (2 * halo[o]
                                    if shards[o] > 1 and halo[o] else 0)
            strip_cells += 2 * 3 * halo[d] * face
        t_int = per_cell * interior_cells
        t_strips = per_cell * strip_cells
        t_step_ov = max(t_int, t_link) + t_strips
        overlap = {
            "interior_cells": interior_cells,
            "strip_cells": strip_cells,
            "t_interior_s": t_int,
            "t_strips_s": t_strips,
            "t_step_s": t_step_ov,
            "hidden_link_s": min(t_link, t_int),
            "exposed_link_s": max(0.0, t_link - t_int),
            "parallel_efficiency": t_single / (n_dev * t_step_ov)
            if t_step_ov > 0 else 1.0,
            "scaled_gcell_s":
                self.program.total_elements / t_step_ov / 1e9
                if t_step_ov > 0 else float("inf"),
            "wins": t_step_ov < t_step,
            # exchange time above which overlap pays: overcompute cost =
            # t_int + t_strips - t_comp; overlap wins when the hidden
            # exchange exceeds it (t_link <= t_int regime)
            "break_even_link_s": max(0.0, t_int + t_strips - t_comp),
        }
        return {
            "devices": n_dev,
            "mesh": dict(mesh_dims),
            "dim_axes": list(dim_axes),
            "local_dims": local,
            "halo": list(halo),
            "link_bytes_per_device": link_bytes,
            "t_compute_s": t_comp,
            "t_link_s": t_link,
            "t_step_s": t_step,
            "parallel_efficiency": t_single / (n_dev * t_step),
            "scaled_gcell_s":
                self.program.total_elements / t_step / 1e9,
            "comm_overlap": overlap,
        }

    # -- output --------------------------------------------------------------
    def as_dict(self) -> Dict:
        ops = {op: cnt for op, (cnt, _t) in
               self.analysis.operation_counts().items()}
        return {
            "hardware": self.hw.name,
            "dimensions": list(self.program.raw_dimensions),
            "kernels": len(self.program.kernels),
            "vectorization": self.program.vectorization,
            "ops_per_cell": ops,
            "total_ops_per_cell": self.ops_per_cell(),
            "total_ops": self.total_ops(),
            "critical_path_cycles": self.analysis.critical_path_cycles,
            "runtime_lower_bound_cycles":
                self.analysis.runtime_lower_bound(),
            "min_communication_volume_bytes":
                self.analysis.minimum_communication_volume(),
            "fast_memory_bytes": self.fast_memory_bytes(),
            "hbm_footprint_bytes": self.hbm_footprint_bytes(),
            "suggested_host_chunks": self.suggested_host_chunks(),
            "hbm_time_s": self.hbm_time_s(),
            "compute_time_s": self.compute_time_s(),
            "roofline_time_s": self.roofline_time_s(),
            "bound_by": self.bound(),
            "roofline_gcell_s": self.roofline_gcell_s(),
            # GOp/s framing (the reference's headline unit, bin/report.py)
            "peak_gop_s": self.hw.fp32_flops / 1e9,
            "achievable_gop_s":
                self.total_ops() / self.roofline_time_s() / 1e9,
        }

    def full_dump(self) -> str:
        """Complete analysis dump (the reference's KernelChainGraph.report,
        kernel_chain_graph.py:603-719): per-kernel accesses, latencies, and
        per-edge delay/line-buffer sizes."""
        a = self.analysis
        lines = [str(self), "", "kernels:"]
        for kname in a.graph.kernel_order:
            lines.append(f"  {kname}: latency={a.kernel_latencies[kname]} "
                         f"cycles")
            for field, info in a.kernel_accesses[kname].items():
                lines.append(
                    f"    reads {field}: accesses={info.accesses} "
                    f"extent={info.buffer_extent} "
                    f"line-buffer={info.buffer_size} elems")
        lines.append("edges (delay + line buffers):")
        for (src, dst), eb in a.edges.items():
            lines.append(
                f"  {src} -> {dst}: delay={eb.delay_size} "
                f"internal={eb.internal_size} "
                f"({eb.total_bytes()} B {np.dtype(eb.dtype).name})")
        lines.append(f"critical path: {a.critical_path_cycles} cycles")
        halos = a.input_halo()
        lines.append(f"fused-tile input halos: {halos}")
        # the remaining reference report() fields
        # (kernel_chain_graph.py:640-719): per-kernel input-path delays,
        # the buffer total, both kernel-string forms, and the optimizer's
        # fast/slow placement demo
        lines.append("input path delays (per in-edge alignment skew):")
        for kname in a.graph.kernel_order:
            ins = {src: (eb.delay_extent, eb.delay_size)
                   for (src, dst), eb in a.edges.items() if dst == kname}
            lines.append(f"  {kname}: " + (", ".join(
                f"{s}: skew={ext} ({n} elems)"
                for s, (ext, n) in ins.items()) or "(source)"))
        total_elems = sum(eb.total_elements for eb in a.edges.values())
        total_bytes = sum(eb.total_bytes() for eb in a.edges.values())
        lines.append(f"total buffer size: {total_elems} elems "
                     f"({total_bytes} B)")
        from .frontend.export import kernel_to_string, kernel_to_relative
        rank = len(self.program.raw_dimensions)
        lines.append("kernel strings (dialect absolute / relative-access):")
        for kname in a.graph.kernel_order:
            ks = self.program.kernels[kname]
            lines.append(f"  {kname}: {kernel_to_string(ks, rank)}")
            lines.append(f"    relative: {kernel_to_relative(ks)}")
        # optimizer demo at the single-stream comm-volume bound (the
        # reference hardcodes bound=12001 elements; we bound at one
        # stream's volume so the demo always has work to do)
        from .optimizer import Optimizer
        opt = Optimizer(self.program, a)
        bound = int(self.program.total_elements
                    * np.dtype("float32").itemsize)
        opt.minimize_fast_mem(comm_volume_bound=bound)
        lines.append(f"optimizer demo (minimize_fast_mem, comm bound "
                     f"{bound} B = one float32 stream):")
        lines.append("  " + opt.summary().replace("\n", "\n  "))
        return "\n".join(lines)

    def __str__(self) -> str:
        d = self.as_dict()
        lines = [
            f"program: {self.program.name}  dims={d['dimensions']}  "
            f"kernels={d['kernels']}  W={d['vectorization']}",
            f"ops/cell: {d['ops_per_cell']}  (total "
            f"{d['total_ops_per_cell']:.0f})",
            f"critical path: {d['critical_path_cycles']} cycles; "
            f"runtime lower bound: {d['runtime_lower_bound_cycles']} cycles",
            f"min communication volume: "
            f"{d['min_communication_volume_bytes']/2**20:.2f} MiB",
            f"on-chip (streaming) working set: "
            f"{d['fast_memory_bytes']/2**10:.1f} KiB",
            f"roofline [{d['hardware']}]: "
            f"HBM {d['hbm_time_s']*1e6:.1f} us vs compute "
            f"{d['compute_time_s']*1e6:.1f} us -> bound by {d['bound_by']}; "
            f"best possible {d['roofline_gcell_s']:.1f} GCell/s "
            f"({d['achievable_gop_s']:.0f} GOp/s)",
        ]
        if d["suggested_host_chunks"] != 1:
            gib = d["hbm_footprint_bytes"] / 2**30
            hint = (f"run --host-chunks {d['suggested_host_chunks']}"
                    if d["suggested_host_chunks"] else
                    "no i-chunking fits; shard across devices")
            lines.append(
                f"HBM footprint {gib:.1f} GiB exceeds the device "
                f"({self.hw.hbm_bytes/2**30:.0f} GiB): out-of-core "
                f"advised -> {hint}")
            # out-of-core x domain decomposition: per-host/device
            # footprint when each chunk is additionally j-sharded
            # across N devices (outofcore.compile_chunked_sharded)
            C = max(2, d["suggested_host_chunks"] or 2)
            I, J, K = self.program.dimensions
            from .backend.xla import chain_halo
            h = chain_halo(self.analysis)
            for n_dev in (4, 8):
                if J % n_dev:
                    continue
                per = sum(
                    (I // C + 2 * h[0]) * (J // n_dev + 2 * h[1])
                    * (K + 2 * h[2])
                    * np.dtype(self.program.field_dtype(f)).itemsize
                    for f in (list(self.program.inputs)
                              + list(self.program.kernels))
                    if f not in self.program.inputs
                    or not self.program.inputs[f].is_scalar)
                lines.append(
                    f"  with {n_dev}-way j-sharded chunks "
                    f"(run-distributed + host chunking): "
                    f"{per/2**20:.1f} MiB per device tile")
                break
        return "\n".join(lines)

"""Command-line interface — parity with the reference's ``bin/`` tool set
(/root/reference/bin/: run_program, report, synthesize, sdfg_generator,
split_sdfg, run_distributed_program).

    python -m stencilflow_tpu.cli run <prog.json> [emulation|hardware] ...
    python -m stencilflow_tpu.cli simulate <prog.json>
    python -m stencilflow_tpu.cli report <prog.json> [--optimize-ratio R]
    python -m stencilflow_tpu.cli synthesize -o out.json [params]
    python -m stencilflow_tpu.cli partition <prog.json> --devices N
    python -m stencilflow_tpu.cli run-distributed <prog.json> --devices N ...
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def _cmd_run(args) -> int:
    from .device import NoGPUError
    from .driver import VerificationError, run_program
    try:
        res = run_program(
            args.stencil_file, mode=args.mode,
            generate_input=args.generate_input,
            synthetic_reads=args.synthetic_reads,
            run_simulation=args.run_simulation,
            compare_to_reference=args.compare_to_reference,
            input_directory=args.input_directory,
            skip_execution=args.skip_execution,
            halo=args.halo, repetitions=args.repetitions,
            backend=args.backend, print_result=args.print_result,
            host_chunks=args.host_chunks,
            log_level=args.log_level,
            profile_dir=args.profile,
            seed=args.seed,
            tolerance=args.tolerance)
    except VerificationError as exc:
        print(f"VERIFICATION FAILED: {exc}", file=sys.stderr)
        return 1
    except NoGPUError as exc:
        print(f"error: hardware mode needs a GPU ({exc})", file=sys.stderr)
        return 2
    except ValueError as exc:
        # configuration errors (bad chunk counts, scope rejections with
        # --backend forced, malformed programs) exit cleanly
        print(f"error: {exc}", file=sys.stderr)
        return 2
    print(f"backend: {res.backend}")
    if res.wall_time_s is not None:
        gcell = res.program.total_elements / res.wall_time_s / 1e9
        line = (f"wall time: {res.wall_time_s*1e3:.3f} ms/run "
                f"(~{gcell:.3g} GCell/s incl. transfers")
        if args.mode == "hardware":
            from .device import device_info, peaks_for
            from .report import Report
            rep = Report.build(res.program, analysis=res.analysis,
                               hw=peaks_for(device_info().kind))
            line += f"; roofline {rep.roofline_gcell_s():.1f} GCell/s"
        print(line + ")")
    if res.simulation_cycles is not None:
        print(f"simulated cycles: {res.simulation_cycles}")
    if res.verified_against_reference is not None:
        print("verified against reference: "
              f"{'OK' if res.verified_against_reference else 'FAIL'}")
    if res.verified_against_simulation is not None:
        print("verified against simulation: "
              f"{'OK' if res.verified_against_simulation else 'FAIL'}")
    if res.results_dir:
        print(f"results written to {res.results_dir}/")
    return 0


def _cmd_simulate(args) -> int:
    from .data import load_input_arrays, save_output_arrays
    from .frontend.parser import parse_program
    from .sim import simulate
    program = parse_program(args.stencil_file)
    inputs = load_input_arrays(program, prefix=args.input_directory,
                               seed=args.seed)
    trace, tmp_dir = args.trace, None
    if args.trace_chrome and not trace:
        import tempfile
        tmp_dir = tempfile.mkdtemp(prefix="sft_trace_")
        trace = os.path.join(tmp_dir, "trace.csv")
    try:
        res = simulate(program, inputs, native=not args.no_native,
                       trace=trace)
        if args.trace:
            print(f"per-cycle trace written to {args.trace}")
        if args.trace_chrome:
            from .sim.trace import csv_to_chrome
            n = csv_to_chrome(trace, args.trace_chrome,
                              every=args.trace_every)
            print(f"chrome trace written to {args.trace_chrome} "
                  f"({n} events; open in Perfetto / chrome://tracing)")
    finally:
        if tmp_dir is not None:
            import shutil
            shutil.rmtree(tmp_dir, ignore_errors=True)
    print(f"cycles: {res.cycles} (elements: {program.total_elements})")
    for (src, dst), high in res.edge_high_water.items():
        mean = res.edge_mean_occupancy.get((src, dst))
        mean_s = f", mean occupancy {mean:.2f}" if mean is not None else ""
        print(f"  edge {src}->{dst}: high water {high}{mean_s}")
    for k, st in res.kernel_stats.items():
        print(f"  kernel {k}: first fire {st['first_fire']}, last fire "
              f"{st['last_fire']}, stalls {st['stall_cycles']}")
    if args.output_dir:
        save_output_arrays(res.outputs, args.output_dir)
        print(f"results written to {args.output_dir}/")
    return 0


def _cmd_iterate(args) -> int:
    """Time-step a chain with device-resident state and checkpoints."""
    from .data import load_input_arrays, save_output_arrays
    from .frontend.parser import parse_program
    from .iterate import iterate
    program = parse_program(args.stencil_file)
    inputs = load_input_arrays(program, prefix=args.input_directory,
                               seed=args.seed)
    state = iterate(program, inputs, args.steps,
                    chunk=args.chunk,
                    fuse=args.fuse_steps,
                    host_chunks=args.host_chunks,
                    checkpoint_every=args.checkpoint_every,
                    checkpoint_dir=args.checkpoint_dir,
                    checkpoint_format=args.checkpoint_format,
                    resume=not args.no_resume)
    print(f"ran {args.steps} steps")
    if args.output_dir:
        save_output_arrays(state, args.output_dir)
        print(f"state written to {args.output_dir}/")
    return 0


def _cmd_solve(args) -> int:
    """Implicit solve: find x with fn(x) = rhs, the chain as matrix-free
    linear operator (CG / CGNR; out-of-core with --host-chunks)."""
    import numpy as np

    from .frontend.parser import parse_program
    from .solve import make_solver
    program = parse_program(args.stencil_file)
    raw = tuple(program.raw_dimensions)
    rhs_spec = args.rhs
    if rhs_spec.startswith(("constant:", "random:")):
        from .data import load_array
        from .ir import InputSpec
        dt = np.dtype(program.kernels[
            args.out or program.outputs[0]].dtype)
        mask = (False,) * (3 - len(raw)) + (True,) * len(raw)
        rhs = load_array(InputSpec("rhs", dt, mask, rhs_spec),
                         program.dimensions,
                         rng=np.random.default_rng(args.seed))
    else:
        rhs = np.fromfile(rhs_spec, np.dtype(program.kernels[
            args.out or program.outputs[0]].dtype)).reshape(raw)
    solver = make_solver(program, field=args.field, out=args.out,
                         method=args.method, tol=args.tol,
                         maxiter=args.maxiter,
                         host_chunks=args.host_chunks)
    x, info = solver(rhs)
    print(f"converged in {info['iterations']} iterations; "
          f"true relative residual {info['residual']:.3e}")
    if args.output:
        from .data import save_array
        save_array(np.asarray(x).reshape(raw), args.output)
        print(f"x written to {args.output}")
    return 0 if info["residual"] <= args.tol * 100 else 1


def _cmd_adjoint(args) -> int:
    """Transpose an affine chain into its adjoint program (grad.py) and
    emit it in the JSON dialect — the backward pass then runs through any
    backend/CLI command like a forward chain."""
    import json as _json

    from .frontend.export import program_to_json
    from .frontend.parser import parse_program
    from .grad import adjoint_program
    program = parse_program(args.stencil_file)
    wrt = ([w.strip() for w in args.wrt.split(",")] if args.wrt else None)
    adj, cot = adjoint_program(program, wrt)
    spec = program_to_json(adj)
    out = args.output or f"{program.name}_adjoint.json"
    with open(out, "w") as f:
        _json.dump(spec, f, indent=2)
    print(f"wrote {out} (cotangent inputs: {cot}; "
          f"outputs: {adj.outputs})")
    return 0


def _cmd_canonicalize(args) -> int:
    """Canonicalization passes + JSON re-export — the analogue of
    bin/canonicalize_sdfg.py (cleanup) + bin/sdfg_to_stencilflow.py
    (dialect emission)."""
    import json as _json

    from .frontend.canonicalize import canonicalize
    from .frontend.export import program_to_json
    from .frontend.parser import parse_program
    program = parse_program(args.stencil_file)
    constants = {}
    if args.symbols:
        for kv in args.symbols.split(","):
            k, v = kv.split("=")
            constants[k.strip()] = float(v)
    program = canonicalize(program, constants=constants or None,
                           min_max_to_select=args.predicate_min_max)
    spec = program_to_json(program)
    out = args.output or f"{program.name}_canonical.json"
    with open(out, "w") as f:
        _json.dump(spec, f, indent=2)
    print(f"wrote {out} ({len(program.kernels)} kernels)")
    return 0


def _cmd_import_sdfg(args) -> int:
    """Serialized-DaCe-SDFG ingestion (bin/sdfg_to_stencilflow.py's import
    direction, without a dace dependency — .sdfg files are JSON)."""
    import json as _json

    from .frontend.export import program_to_json
    from .frontend.sdfg_import import sdfg_to_program
    dims = ([int(x) for x in args.dimensions.split(",")]
            if args.dimensions else None)
    symbols = None
    if args.symbols:
        symbols = {}
        for part in args.symbols.split(","):
            name, sep, val = part.partition("=")
            try:
                v = float(val)
            except ValueError:
                sep = ""
            if not sep or not name.strip():
                print(f"bad --symbols entry {part!r} "
                      "(want NAME=NUMBER)", file=sys.stderr)
                return 2
            symbols[name.strip()] = int(v) if v == int(v) else v
    program = sdfg_to_program(args.sdfg_file, dimensions=dims,
                              input_data=args.input_data,
                              vectorization=args.vector_length,
                              symbols=symbols)
    spec = program_to_json(program)
    out = args.output or f"{program.name}.json"
    with open(out, "w") as f:
        _json.dump(spec, f, indent=2)
    print(f"wrote {out} ({len(program.kernels)} kernels, "
          f"inputs {sorted(program.inputs)}, outputs {program.outputs})")
    return 0


def _cmd_compile(args) -> int:
    """Lower a program and save the compiled artifact (StableHLO text) —
    the analogue of bin/sdfg_generator.py's JSON -> SDFG file flow."""
    import jax.numpy as jnp

    from .backend import compile_chain_best
    from .data import load_input_arrays
    from .frontend.parser import parse_program
    program = parse_program(args.stencil_file)
    fn, backend = compile_chain_best(program)
    inputs = {k: jnp.asarray(v)
              for k, v in load_input_arrays(program, seed=0).items()}
    import jax
    lowered = jax.jit(fn).lower(inputs)
    text = lowered.as_text()
    out = args.output or f"{program.name}.stablehlo.txt"
    with open(out, "w") as f:
        f.write(text)
    print(f"lowered with backend '{backend}' -> {out} "
          f"({len(text)} bytes)")
    return 0


def _parse_axes(text: str):
    """'none,x,y' -> (None, 'x', 'y'); exactly one entry per padded dim.
    Returns None (and prints to stderr) on malformed input."""
    axes = tuple(None if t.strip().lower() in ("none", "-") else t.strip()
                 for t in text.split(","))
    if len(axes) != 3:
        print(f"axis list needs 3 entries (i,j,k), got {len(axes)}",
              file=sys.stderr)
        return None
    return axes


def _parse_mesh(text: str):
    """'x=2,y=4' -> {'x': 2, 'y': 4}; None on malformed input."""
    mesh = {}
    for part in text.split(","):
        ax, sep, n = part.partition("=")
        if (not sep or not ax.strip() or not n.strip().isdigit()
                or int(n) < 1):
            print(f"bad --mesh entry {part!r} (want axis=N, N >= 1)",
                  file=sys.stderr)
            return None
        mesh[ax.strip()] = int(n)
    return mesh


def _cmd_report(args) -> int:
    from .frontend.analysis import ChainAnalysis
    from .frontend.parser import parse_program
    from .report import Report
    program = parse_program(args.stencil_file)
    analysis = ChainAnalysis.run(program)
    if args.plot:
        from .utils import plot_chain_graph, plot_compute_graph
        print("wrote " + plot_chain_graph(program,
                                          f"{program.name}_chain.png"))
        for kname, kspec in program.kernels.items():
            print("wrote " + plot_compute_graph(
                kspec, f"{program.name}_{kname}_compute.png"))
    from .device import peaks_for
    report = Report.build(program, analysis,
                          hw=peaks_for(args.device_kind))
    mesh_scaling = None
    if args.mesh:
        mesh_dims = _parse_mesh(args.mesh)
        axes = _parse_axes(args.mesh_axes)
        if mesh_dims is None or axes is None:
            return 2
        mesh_scaling = report.mesh_scaling(mesh_dims, axes)
    if args.json:
        d = report.as_dict()
        if mesh_scaling:
            d["mesh_scaling"] = mesh_scaling
        print(json.dumps(d, indent=2, default=str))
    elif args.verbose:
        print(report.full_dump())
    else:
        print(report)
    if args.optimize_ratio is not None:
        from .optimizer import Optimizer
        opt = Optimizer(program, analysis)
        opt.optimize_to_ratio(args.optimize_ratio)
        print(f"\nmemory placement at slow/fast ratio "
              f"{args.optimize_ratio}:")
        print(opt.summary())
    if mesh_scaling is not None and not args.json:
        s = mesh_scaling
        print(f"\nmesh scaling [{s['devices']} devices, "
              f"mesh {s['mesh']}, dims->axes {s['dim_axes']}]:")
        print(f"  local block {s['local_dims']}  "
              f"halo {s['halo']}  "
              f"exchange {s['link_bytes_per_device']/2**20:.2f} MiB/device")
        print(f"  step: compute {s['t_compute_s']*1e6:.1f} us + "
              f"exchange {s['t_link_s']*1e6:.1f} us = "
              f"{s['t_step_s']*1e6:.1f} us  "
              f"-> {s['scaled_gcell_s']:.1f} GCell/s, "
              f"efficiency {s['parallel_efficiency']:.2f}")
        if args.comm_overlap:
            o = s["comm_overlap"]
            print(f"  --comm-overlap: interior {o['t_interior_s']*1e6:.1f}"
                  f" us (hides {o['hidden_link_s']*1e6:.1f} us of "
                  f"exchange, {o['exposed_link_s']*1e6:.1f} us exposed) "
                  f"+ strips "
                  f"{o['t_strips_s']*1e6:.1f} us "
                  f"({o['strip_cells']/1e6:.2f} Mcell overcompute) = "
                  f"{o['t_step_s']*1e6:.1f} us -> "
                  f"{o['scaled_gcell_s']:.1f} GCell/s")
            be = o["break_even_link_s"]
            print(f"  verdict: overlap "
                  f"{'WINS' if o['wins'] else 'loses'} on this mesh "
                  f"(pays above {be*1e6:.1f} us exchange; modeled "
                  f"{s['t_link_s']*1e6:.1f} us)")
    return 0


def _cmd_synthesize(args) -> int:
    from .synthesize import synthesize_stencil
    spec = synthesize_stencil(
        num_stages=args.num_stages,
        dimensions=tuple(args.dimensions),
        shape=args.shape,
        extent=args.extent,
        data_type=args.data_type,
        vectorization=args.vectorization,
        fork_frequency=args.fork_frequency,
        fork_length=args.fork_length,
        input_frequency=args.input_frequency,
        boundary=args.boundary,
    )
    text = json.dumps(spec, indent=2, default=str)
    if args.output:
        with open(args.output, "w") as f:
            f.write(text)
        print(f"wrote {args.output}")
    else:
        print(text)
    return 0


def _cmd_partition(args) -> int:
    from .frontend.analysis import ChainAnalysis
    from .frontend.parser import parse_program
    from .parallel.pipeline import split_kernels
    program = parse_program(args.stencil_file)
    analysis = ChainAnalysis.run(program)
    graph = analysis.graph
    print(f"kernels (topological): {graph.kernel_order}")
    if args.at:
        from .parallel.pipeline import split_kernels_at
        segments = split_kernels_at(
            graph, [k.strip() for k in args.at.split(",")])
        if len(segments) != args.devices:
            print(f"note: {len(segments)} segments from --at; pass "
                  f"--devices {len(segments)} to run-distributed")
    elif args.cut:
        from .parallel.pipeline import split_kernels_at_cut
        segments = split_kernels_at_cut(
            graph, [k.strip() for k in args.cut.split(",")])
    elif args.optimize:
        from .parallel.pipeline import optimize_split
        segments, stats = optimize_split(program, graph, args.devices)
        print(f"optimized cuts: segment loads {stats['segment_loads']} "
              f"(ops/cell), crossing "
              f"{stats['cut_bytes_per_cell']} B/cell per cut")
    else:
        segments = split_kernels(graph, args.devices)
    for i, seg in enumerate(segments):
        print(f"  device {i}: {seg}")
    if args.enumerate_cuts:
        print("all valid pipeline cuts (downward-closed subsets):")
        for cut in graph.enumerate_cuts():
            print(f"  {sorted(cut)}")
    return 0


def _make_mesh_2d(devices, n):
    """Near-square 2-D ('x', 'y') mesh over n devices."""
    import numpy as np
    from jax.sharding import Mesh
    a = int(np.floor(np.sqrt(n)))
    while n % a:
        a -= 1
    return Mesh(np.array(devices).reshape(a, n // a), ("x", "y"))


def _run_distributed_multihost(args, program, inputs, devices) -> int:
    """Multi-host SPMD body: global mesh over every process's devices, one
    sharded evaluation, per-host verification of the addressable shards
    (the reference verified on the last rank after a barrier,
    bin/run_distributed_program.py:304-341; with global arrays every host
    can check exactly the shards it owns)."""
    import jax
    import numpy as np
    from jax.sharding import Mesh

    from .data import arrays_are_equal
    from .interpreter import run_interpreter
    from .parallel.domain import run_sharded_chain

    if args.parallel_mode == "pipeline":
        # multi-host wavefront pipeline: 1-D global mesh over every
        # process's devices; inputs become global arrays via
        # make_array_from_callback (each host materializes exactly the
        # shards it owns), outputs verify per-host like domain mode
        import jax.numpy as jnp
        from jax.sharding import NamedSharding

        from .parallel.pipeline import compile_pipeline_split

        pmesh = Mesh(np.array(devices), ("p",))
        fn, _plan = compile_pipeline_split(
            program, pmesh, "p", num_chunks=args.num_chunks,
            split_at=([k.strip() for k in args.split_at.split(",")]
                      if args.split_at else None),
            cut=([k.strip() for k in args.cut.split(",")]
                 if args.cut else None),
            optimize_cuts=args.optimize_cuts)
        cfg = compile_pipeline_split.last_config
        gin = {}
        for n, v in inputs.items():
            arr = jnp.asarray(v)
            sh = NamedSharding(pmesh, cfg["in_specs"][n])
            gin[n] = jax.make_array_from_callback(
                arr.shape, sh, lambda idx, a=arr: a[idx])
        out = fn(gin)
        host = args.host_id
        print(f"host {host}: ran pipeline over {args.devices} global "
              f"devices (mesh {dict(pmesh.shape)}, io={cfg['io']}, "
              f"{len(jax.local_devices())} local)")
        if args.compare_to_reference:
            ref = run_interpreter(program, inputs)
            ok = True
            for o in program.outputs:
                expected = np.asarray(ref[o]).reshape(
                    program.raw_dimensions)
                for shard in out[o].addressable_shards:
                    if not arrays_are_equal(expected[shard.index],
                                            np.asarray(shard.data)):
                        print(f"host {host}: MISMATCH on {o} shard "
                              f"{shard.index}", file=sys.stderr)
                        ok = False
            print(f"host {host}: verified local shards: "
                  + ("OK" if ok else "FAIL"))
            return 0 if ok else 1
        return 0

    mesh = _make_mesh_2d(devices, args.devices)
    axes = ((None, "x", "y") if not args.dim_axes
            else _parse_axes(args.dim_axes))
    if axes is None:
        return 2
    out = run_sharded_chain(program, mesh, axes, inputs, as_numpy=False,
                            comm_overlap=args.comm_overlap)
    host = args.host_id
    print(f"host {host}: ran domain over {args.devices} global devices "
          f"(mesh {dict(mesh.shape)}, "
          f"{len(jax.local_devices())} local)")
    if args.compare_to_reference:
        ref = run_interpreter(program, inputs)
        ok = True
        for o in program.outputs:
            expected = np.asarray(ref[o])
            for shard in out[o].addressable_shards:
                if not arrays_are_equal(expected[shard.index],
                                        np.asarray(shard.data)):
                    print(f"host {host}: MISMATCH on {o} shard "
                          f"{shard.index}", file=sys.stderr)
                    ok = False
        print(f"host {host}: verified local shards: "
              + ("OK" if ok else "FAIL"))
        return 0 if ok else 1
    return 0


def _cmd_run_distributed(args) -> int:
    import os
    multihost = args.coordinator is not None
    if multihost and (args.num_hosts is None or args.host_id is None):
        print("--coordinator requires --num-hosts and --host-id",
              file=sys.stderr)
        return 2
    # flag validation runs BEFORE jax.distributed.initialize / the
    # multi-host dispatch so misdirected flags are rejected up front
    # instead of being silently ignored (or hanging the rendezvous)
    if args.parallel_mode == "pipeline" and args.dim_axes:
        print("--dim-axes applies to domain mode only", file=sys.stderr)
        return 2
    if args.parallel_mode == "pipeline" and args.comm_overlap:
        print("--comm-overlap applies to domain mode only",
              file=sys.stderr)
        return 2
    if args.parallel_mode == "domain" and (args.split_at or args.cut or
                                           args.optimize_cuts or
                                           args.pipeline_domain):
        print("--split-at/--cut/--optimize-cuts/--pipeline-domain apply "
              "to pipeline mode only (pass --parallel-mode pipeline)",
              file=sys.stderr)
        return 2
    if args.force_host_devices:
        # per-process virtual device count (global = local * num_hosts)
        local = (args.devices // args.num_hosts if multihost
                 else args.devices)
        flags = os.environ.get("XLA_FLAGS", "")
        if "host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + f" --xla_force_host_platform_device_count="
                f"{local}").strip()
    import jax
    if args.force_host_devices:
        try:
            jax.config.update("jax_platforms", "cpu")
        except Exception as exc:
            # the platform is already pinned (a backend query ran before
            # this CLI) — running on real hardware would silently ignore
            # the user's request to simulate
            print("--force-host-devices: cannot switch to the virtual "
                  f"CPU mesh ({exc}); the platform is already "
                  "initialized", file=sys.stderr)
            return 2
    if multihost:
        # the JAX runtime owns the mesh — the coordination service
        # replaces the reference's MPI rendezvous
        # (bin/run_distributed_program.py:98-116,283-299); barriers are
        # implicit in SPMD program dispatch.  Processes sharing a machine
        # each name their own card: a JAX process reserves most of the
        # memory of every card it opens
        kw = {}
        if args.local_device_ids:
            kw["local_device_ids"] = [
                int(x) for x in args.local_device_ids.split(",")]
        jax.distributed.initialize(
            coordinator_address=args.coordinator,
            num_processes=args.num_hosts,
            process_id=args.host_id, **kw)
    import numpy as np
    from jax.sharding import Mesh

    from .data import load_input_arrays
    from .frontend.parser import parse_program
    from .interpreter import run_interpreter
    from .data import arrays_are_equal

    program = parse_program(args.stencil_file)
    inputs = load_input_arrays(program, prefix=args.input_directory,
                               seed=args.seed)
    devices = jax.devices()[:args.devices]
    if len(devices) < args.devices:
        print(f"only {len(devices)} devices available", file=sys.stderr)
        return 2
    if multihost:
        return _run_distributed_multihost(args, program, inputs, devices)

    if args.parallel_mode == "pipeline":
        from .parallel.pipeline import compile_pipeline_split
        import jax.numpy as jnp
        domain_axes = None
        if args.pipeline_domain:
            # "j=2" / "j=2,k=2": shard the named domain dims over extra
            # mesh axes of the given sizes; the pipeline keeps the rest
            domain_axes = {}
            dshape, dnames = [], []
            for part in args.pipeline_domain.split(","):
                dim_name, _, n = part.partition("=")
                d = {"j": 1, "k": 2}.get(dim_name.strip())
                if d is None or not n.strip().isdigit():
                    print(f"--pipeline-domain: expected 'j=N[,k=M]', "
                          f"got {args.pipeline_domain!r}",
                          file=sys.stderr)
                    return 2
                ax = "x" if not dnames else "y"
                domain_axes[d] = ax
                dnames.append(ax)
                dshape.append(int(n.strip()))
            dn = int(np.prod(dshape))
            if args.devices % dn:
                print(f"--devices {args.devices} not divisible by the "
                      f"domain factor {dn}", file=sys.stderr)
                return 2
            mesh = Mesh(np.array(devices).reshape(
                (args.devices // dn, *dshape)), ("p", *dnames))
        else:
            mesh = Mesh(np.array(devices), ("p",))
        fn, _plan = compile_pipeline_split(
            program, mesh, "p", num_chunks=args.num_chunks,
            split_at=([k.strip() for k in args.split_at.split(",")]
                      if args.split_at else None),
            cut=([k.strip() for k in args.cut.split(",")]
                 if args.cut else None),
            optimize_cuts=args.optimize_cuts,
            domain_axes=domain_axes)
        out = fn({k: jnp.asarray(v) for k, v in inputs.items()})
        outputs = {k: np.asarray(v) for k, v in out.items()}
    else:
        from .parallel.domain import run_sharded_chain
        mesh = _make_mesh_2d(devices, args.devices)
        if args.dim_axes:
            axes = _parse_axes(args.dim_axes)
            if axes is None:
                return 2
            bad = [a for a in axes if a and a not in mesh.shape]
            if bad:
                print(f"unknown mesh axis {bad} (mesh has "
                      f"{list(mesh.shape)})", file=sys.stderr)
                return 2
        else:
            axes = (None, "x", "y")
        outputs = run_sharded_chain(program, mesh, axes, inputs,
                                    comm_overlap=args.comm_overlap)
    print(f"ran {args.parallel_mode} over {args.devices} devices "
          f"(mesh {dict(mesh.shape)})")

    if args.compare_to_reference:
        ref = run_interpreter(program, inputs)
        ok = True
        for o in program.outputs:
            if not arrays_are_equal(np.asarray(ref[o]), outputs[o]):
                print(f"MISMATCH on {o}", file=sys.stderr)
                ok = False
        print("verified against reference: " + ("OK" if ok else "FAIL"))
        return 0 if ok else 1
    return 0


def build_parser() -> argparse.ArgumentParser:
    from .device import H100_SXM, PEAKS
    ap = argparse.ArgumentParser(prog="stencilflow_tpu")
    sub = ap.add_subparsers(dest="command", required=True)

    p = sub.add_parser("run", help="run a program end to end")
    p.add_argument("stencil_file")
    p.add_argument("mode", nargs="?", default="emulation",
                   choices=["emulation", "hardware"])
    p.add_argument("--run-simulation", action="store_true")
    p.add_argument("--compare-to-reference", action="store_true")
    p.add_argument("--input-directory")
    p.add_argument("--skip-execution", action="store_true")
    p.add_argument("--halo", type=int, default=0)
    p.add_argument("--repetitions", type=int, default=1)
    p.add_argument("--backend", default="auto",
                   choices=["auto", "xla", "interpreter"],
                   help="auto/xla: the fused-XLA chain; interpreter: the "
                        "numpy oracle itself")
    p.add_argument("--host-chunks", type=int, default=0, metavar="N",
                   help="out-of-core: stream the domain through the "
                        "device in N i-chunks (for domains larger than "
                        "device memory; inputs/outputs stay on host)")
    p.add_argument("--tolerance", type=float, default=None,
                   help="relative verification tolerance for "
                        "--compare-to-reference / --run-simulation "
                        "(default: config.VERIFY_RTOL)")
    p.add_argument("--print-result", action="store_true")
    p.add_argument("--generate-input", action="store_true",
                   help="replace file-backed inputs with constant data "
                        "(reference: -generate-input)")
    p.add_argument("--synthetic-reads", action="store_true",
                   help="replace ALL inputs with constants for "
                        "pure-compute benchmarking")
    p.add_argument("--log-level", type=int, default=1, choices=[0, 1, 2, 3])
    p.add_argument("--profile", metavar="DIR",
                   help="capture a jax.profiler trace of the run")
    p.add_argument("--seed", type=int, default=0)
    p.set_defaults(fn=_cmd_run)

    p = sub.add_parser("simulate", help="cycle-accurate dataflow simulation")
    p.add_argument("stencil_file")
    p.add_argument("--input-directory")
    p.add_argument("--output-dir")
    p.add_argument("--no-native", action="store_true",
                   help="use the Python machine instead of the C++ core")
    p.add_argument("--trace", metavar="CSV",
                   help="write a per-cycle CSV (kernel PCs + FIFO "
                        "occupancies; uses the Python engine)")
    p.add_argument("--trace-chrome", metavar="JSON",
                   help="write a Chrome/Perfetto trace (counter tracks "
                        "per FIFO and kernel + activity spans; implies "
                        "the Python engine)")
    p.add_argument("--trace-every", type=int, default=1,
                   help="decimation for --trace-chrome counter samples "
                        "(change points always kept)")
    p.add_argument("--seed", type=int, default=0)
    p.set_defaults(fn=_cmd_simulate)

    p = sub.add_parser("iterate",
                       help="time-step a chain with checkpoint/resume")
    p.add_argument("stencil_file")
    p.add_argument("--steps", type=int, required=True)
    p.add_argument("--chunk", type=int, default=16)
    p.add_argument("--fuse-steps", type=int, default=1,
                   help="compose this many time steps into one deeper "
                        "chain before compiling (multiplies arithmetic "
                        "intensity; steps must be a multiple)")
    p.add_argument("--host-chunks", type=int, default=0, metavar="N",
                   help="out-of-core time-stepping: state stays in host "
                        "memory, each step streams the domain through "
                        "the device in N i-chunks (combine with "
                        "--fuse-steps to amortize host<->device traffic)")
    p.add_argument("--checkpoint-every", type=int, default=0)
    p.add_argument("--checkpoint-dir")
    p.add_argument("--checkpoint-format", default="npz",
                   choices=["npz", "orbax"],
                   help="npz: one host file per checkpoint; orbax: "
                        "async device-sharded checkpoints (production "
                        "choice for mesh-sharded runs)")
    p.add_argument("--no-resume", action="store_true")
    p.add_argument("--output-dir")
    p.add_argument("--input-directory")
    p.add_argument("--seed", type=int, default=0)
    p.set_defaults(fn=_cmd_iterate)

    p = sub.add_parser("solve",
                       help="implicit solve fn(x) = rhs with the chain "
                            "as matrix-free linear operator (CG/CGNR)")
    p.add_argument("stencil_file")
    p.add_argument("--rhs", required=True,
                   help=".dat file, constant:<v>, or random:<a>,<b>")
    p.add_argument("--method", default="cg", choices=["cg", "cgnr"])
    p.add_argument("--tol", type=float, default=1e-6)
    p.add_argument("--maxiter", type=int, default=1000)
    p.add_argument("--field", help="solve input (default: sole input)")
    p.add_argument("--out", help="solve output (default: first output)")
    p.add_argument("--host-chunks", type=int, default=0, metavar="N",
                   help="out-of-core solve: chunked operator sweeps, "
                        "host-resident CG vectors")
    p.add_argument("-o", "--output", help="write x to this .dat file")
    p.add_argument("--seed", type=int, default=0)
    p.set_defaults(fn=_cmd_solve)

    p = sub.add_parser("canonicalize",
                       help="cleanup passes + JSON dialect re-export")
    p.add_argument("stencil_file")
    p.add_argument("-o", "--output")
    p.add_argument("--symbols", help='e.g. "C=1.5,D=2"')
    p.add_argument("--predicate-min-max", action="store_true")
    p.set_defaults(fn=_cmd_canonicalize)

    p = sub.add_parser("import-sdfg",
                       help="ingest a serialized DaCe SDFG with Stencil "
                            "library nodes into the JSON dialect "
                            "(no dace dependency)")
    p.add_argument("sdfg_file")
    p.add_argument("-o", "--output")
    p.add_argument("--dimensions",
                   help="override domain dims, e.g. '64,64,64' (required "
                        "when the SDFG shapes are symbolic)")
    p.add_argument("--input-data", default="constant:1.0",
                   help="data spec for imported inputs (reference: "
                        "-data-directory; default constant:1.0)")
    p.add_argument("--vector-length", type=int, default=1)
    p.add_argument("--symbols",
                   help="specialize free SDFG symbols, e.g. 'I=128,J=64'"
                        " (the reference's bin/canonicalize_sdfg.py "
                        "-symbols; seeds the interstate-edge symbol "
                        "environment)")
    p.set_defaults(fn=_cmd_import_sdfg)

    p = sub.add_parser("adjoint",
                       help="transpose an affine chain into its adjoint "
                            "program (JSON dialect)")
    p.add_argument("stencil_file")
    p.add_argument("-o", "--output")
    p.add_argument("--wrt", help="comma-separated input names "
                                 "(default: all floating field inputs)")
    p.set_defaults(fn=_cmd_adjoint)

    p = sub.add_parser("compile",
                       help="lower a program and save the StableHLO "
                            "artifact")
    p.add_argument("stencil_file")
    p.add_argument("-o", "--output")
    p.set_defaults(fn=_cmd_compile)

    p = sub.add_parser("report", help="analytic performance report")
    p.add_argument("stencil_file")
    p.add_argument("--json", action="store_true")
    p.add_argument("--device-kind", default=H100_SXM, choices=sorted(PEAKS),
                   help="device whose published peaks the roofline uses "
                        "(a jax device_kind)")
    p.add_argument("--plot", action="store_true",
                   help="write chain/compute graph PNGs")
    p.add_argument("--verbose", action="store_true",
                   help="full analysis dump (buffers, accesses, paths)")
    p.add_argument("--optimize-ratio", type=float, default=None,
                   help="also print the fast/slow placement at this ratio")
    p.add_argument("--mesh", default=None,
                   help="project domain-decomposition scaling over a "
                        "device mesh, e.g. --mesh x=2,y=4")
    p.add_argument("--mesh-axes", default="none,x,y",
                   help="mesh axis sharding each padded dim (i,j,k); "
                        "'none' leaves a dim unsharded")
    p.add_argument("--comm-overlap", action="store_true",
                   help="with --mesh: print the comm/compute-overlap "
                        "tradeoff (hidden exchange vs strip overcompute) "
                        "and its break-even")
    p.set_defaults(fn=_cmd_report)

    p = sub.add_parser("synthesize", help="generate a benchmark program")
    p.add_argument("-o", "--output")
    p.add_argument("--num-stages", type=int, default=4)
    p.add_argument("--dimensions", type=int, nargs="+",
                   default=[64, 64, 64])
    p.add_argument("--shape", default="cross",
                   choices=["cross", "box", "diffusion", "hotspot",
                            "hdiff"])
    p.add_argument("--extent", type=int, default=1)
    p.add_argument("--data-type", default="float32")
    p.add_argument("--vectorization", type=int, default=1)
    p.add_argument("--fork-frequency", type=int, default=0)
    p.add_argument("--fork-length", type=int, default=1)
    p.add_argument("--input-frequency", type=int, default=0)
    p.add_argument("--boundary", default="constant")
    p.set_defaults(fn=_cmd_synthesize)

    p = sub.add_parser("partition",
                       help="plan a pipeline split across devices")
    p.add_argument("stencil_file")
    p.add_argument("--devices", type=int, default=2)
    p.add_argument("--at", default=None,
                   help="comma-separated kernel names to cut after "
                        "(named-stream split) instead of auto-balancing")
    p.add_argument("--cut", default=None,
                   help="comma-separated kernel names forming one "
                        "downward-closed cut set (may be non-prefix on "
                        "forked chains; see --enumerate-cuts)")
    p.add_argument("--optimize", action="store_true",
                   help="search cuts minimizing the bottleneck segment "
                        "load, tie-breaking on inter-device traffic")
    p.add_argument("--enumerate-cuts", action="store_true")
    p.set_defaults(fn=_cmd_partition)

    p = sub.add_parser("run-distributed",
                       help="multi-device run (domain or pipeline split)")
    p.add_argument("stencil_file")
    p.add_argument("--devices", type=int, default=2)
    p.add_argument("--parallel-mode", default="domain",
                   choices=["domain", "pipeline"])
    p.add_argument("--num-chunks", type=int, default=None)
    p.add_argument("--split-at", default=None,
                   help="pipeline mode: comma-separated kernel names to "
                        "cut after (the reference's split at a named "
                        "stream); cuts+1 must equal --devices")
    p.add_argument("--cut", default=None,
                   help="pipeline mode (2 devices): comma-separated "
                        "kernel names forming a downward-closed cut set "
                        "(any 'partition --enumerate-cuts' member, "
                        "non-prefix fork cuts included)")
    p.add_argument("--optimize-cuts", action="store_true",
                   help="pipeline mode: search cuts minimizing the "
                        "bottleneck segment load")
    p.add_argument("--pipeline-domain", default=None, metavar="SPEC",
                   help="pipeline mode: ALSO shard the domain over extra "
                        "mesh axes, e.g. 'j=4' (segments over p, each "
                        "segment's domain j-sharded 4-way with "
                        "per-segment halo exchange) or 'j=2,k=2'; "
                        "--devices must be divisible by the product")
    p.add_argument("--dim-axes", default=None,
                   help="domain mode: mesh axis per padded dim (i,j,k), "
                        "e.g. 'x,y,none' to shard (i, j); default "
                        "'none,x,y'")
    p.add_argument("--compare-to-reference", action="store_true")
    p.add_argument("--input-directory")
    p.add_argument("--force-host-devices", action="store_true",
                   help="simulate the mesh with virtual CPU devices")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="multi-host launch: jax.distributed coordination "
                        "service address (process 0 binds it); replaces "
                        "the reference's MPI rendezvous")
    p.add_argument("--num-hosts", type=int, default=None,
                   help="multi-host: total number of processes")
    p.add_argument("--host-id", type=int, default=None,
                   help="multi-host: this process's id (0-based)")
    p.add_argument("--local-device-ids", default=None, metavar="IDS",
                   help="multi-host: comma-separated local GPU ids this "
                        "process owns (processes sharing a machine take "
                        "one card each; default: every local device)")
    p.add_argument("--comm-overlap", action="store_true",
                   help="domain mode: evaluate the block interior with no "
                        "data dependency on the halo ppermutes (exchange "
                        "latency hiding at the cost of strip overcompute)")
    p.set_defaults(fn=_cmd_run_distributed)

    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return args.fn(args)
    except ValueError as exc:
        # configuration errors (invalid cuts/segments, bad chunk counts,
        # malformed programs) exit 2 with a message on every subcommand
        print(f"error: {exc}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())

"""Multi-host distributed launch smoke test.

Spawns two real OS processes, each with its own set of virtual CPU
devices, wired together with ``jax.distributed.initialize`` through the
CLI's ``run-distributed --coordinator`` path — the analogue of
the reference's 2-rank MPI harness
(/root/reference/test/test_distributed_program.sh:37-124,
bin/run_distributed_program.py:98-299).  Each process runs the same SPMD
domain-decomposition program over the 4-device global mesh and verifies
the output shards it owns against the interpreter oracle.
"""
import json
import os
import socket
import subprocess
import sys

import pytest


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.parametrize("dim_axes", ["none,x,y", "x,y,none"])
def test_two_process_domain_decomposition(tmp_path, dim_axes):
    prog = {
        "inputs": {"a": {"data": "random:-1,1", "data_type": "float32"}},
        "outputs": ["s1"],
        "dimensions": [8, 16, 16],
        "program": {
            "s0": {"computation_string":
                   "s0 = 0.25 * (a[i,j-1,k] + a[i,j+1,k] + a[i,j,k-1]"
                   " + a[i,j,k+1])",
                   "boundary_conditions": {
                       "a": {"type": "constant", "value": 1.0}},
                   "data_type": "float32"},
            "s1": {"computation_string":
                   "s1 = s0[i,j,k] + 0.5 * (s0[i-1,j,k] + s0[i+1,j,k])",
                   "boundary_conditions": {
                       "s0": {"type": "constant", "value": 0.0}},
                   "data_type": "float32"},
        },
    }
    path = tmp_path / "mh.json"
    path.write_text(json.dumps(prog))

    port = _free_port()
    env_base = {
        **os.environ,
        "JAX_PLATFORMS": "cpu",
        # per-process local device count is set by the CLI
        # (--force-host-devices divides --devices by --num-hosts)
        "XLA_FLAGS": "",
    }
    procs = []
    for host_id in range(2):
        cmd = [sys.executable, "-m", "stencilflow_tpu.cli",
               "run-distributed", str(path),
               "--devices", "4", "--parallel-mode", "domain",
               "--dim-axes", dim_axes,
               "--force-host-devices",
               "--coordinator", f"127.0.0.1:{port}",
               "--num-hosts", "2", "--host-id", str(host_id),
               "--compare-to-reference"]
        procs.append(subprocess.Popen(
            cmd, cwd=os.path.dirname(os.path.dirname(
                os.path.abspath(__file__))),
            env=env_base, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for host_id, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"host {host_id} failed:\n{out}"
        assert f"host {host_id}: verified local shards: OK" in out, out
        assert "4 global devices" in out, out


def test_two_process_pipeline_split(tmp_path):
    """2-process multihost PIPELINE split (VERDICT r3 next #8): the
    4-stage chain splits over the 4-device global mesh (2 local per
    host), inputs become global arrays from per-host shards, and each
    host verifies the output shards it owns against the oracle —
    the reference's 2-rank MPI pipeline harness role
    (test_distributed_program.sh:120-132)."""
    prog = {
        "inputs": {"a": {"data": "random:-1,1", "data_type": "float32"}},
        "outputs": ["s3"],
        "dimensions": [8, 16, 16],
        "program": {
            f"s{i}": {
                "computation_string":
                    f"s{i} = 0.25 * ({p}[i,j-1,k] + {p}[i,j+1,k] "
                    f"+ {p}[i,j,k-1] + {p}[i,j,k+1])",
                "boundary_conditions": {
                    p: {"type": "constant", "value": 1.0}},
                "data_type": "float32"}
            for i, p in enumerate(["a", "s0", "s1", "s2"])
        },
    }
    path = tmp_path / "mhpp.json"
    path.write_text(json.dumps(prog))

    port = _free_port()
    env_base = {**os.environ, "JAX_PLATFORMS": "cpu", "XLA_FLAGS": ""}
    procs = []
    for host_id in range(2):
        cmd = [sys.executable, "-m", "stencilflow_tpu.cli",
               "run-distributed", str(path),
               "--devices", "4", "--parallel-mode", "pipeline",
               "--force-host-devices",
               "--coordinator", f"127.0.0.1:{port}",
               "--num-hosts", "2", "--host-id", str(host_id),
               "--compare-to-reference"]
        procs.append(subprocess.Popen(
            cmd, cwd=os.path.dirname(os.path.dirname(
                os.path.abspath(__file__))),
            env=env_base, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for host_id, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"host {host_id} failed:\n{out}"
        assert f"host {host_id}: verified local shards: OK" in out, out
        assert "ran pipeline over 4 global devices" in out, out


def test_misdirected_flags_rejected_before_multihost_dispatch(capsys):
    """Pipeline-only flags with a multi-host domain launch exit 2 with a
    message instead of being silently ignored across all hosts."""
    from stencilflow_tpu.cli import main as cli_main
    from stencilflow_tpu.synthesize import jacobi
    import json, tempfile, os
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "p.json")
        with open(path, "w") as f:
            json.dump(jacobi(3, 8, iterations=1), f)
        rc = cli_main(["run-distributed", path, "--devices", "4",
                       "--parallel-mode", "domain",
                       "--coordinator", "127.0.0.1:1",
                       "--num-hosts", "2", "--host-id", "0",
                       "--split-at", "s0"])
    assert rc == 2
    assert "pipeline mode only" in capsys.readouterr().err

"""Out-of-core time-stepping: a domain that never fits device memory.

A COSMO-style horizontal-diffusion block (hdiff: lap -> flux-limited
flx/fly -> out) is time-stepped over a domain held in memory-mapped host
files.  Nothing but one i-chunk (+ halo) is ever resident on the device,
and with ``fuse`` > 1 each host<->device sweep advances several steps:

    state (np.memmap) --chunk0+halo--> [device: fused F-step chain] --+
          ^                                                           |
          +--------------------- chunk outputs <----------------------+

At production scale the same script time-steps a 2048 x 4096 x 4096 grid
(128 GiB per field, 384 GiB in all — about 5x an 80 GB H100) by just
raising SIZE; `report` prints the footprint and the suggested chunk count:

    python -m stencilflow_tpu.cli report <program.json>
    ... HBM footprint 384.0 GiB exceeds the device (75 GiB):
        out-of-core advised -> run --host-chunks 8

Run (any JAX backend; sized small so CPU emulation finishes quickly):

    JAX_PLATFORMS=cpu python examples/outofcore_weather.py
"""
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import stencilflow_tpu as sft
from stencilflow_tpu.iterate import iterate
from stencilflow_tpu.outofcore import run_chunked
from stencilflow_tpu.report import Report
from stencilflow_tpu.synthesize import synthesize_stencil

SIZE = (16, 32, 32)      # raise to (2048, 4096, 4096) on real hardware
CHUNKS = 4
STEPS = 4
FUSE = 2                 # chain two hdiff applications per sweep

program = sft.parse_program(
    synthesize_stencil(num_stages=1, dimensions=SIZE, shape="hdiff"),
    name="hdiff_outofcore")

rep = Report.build(program)
print(f"in-core HBM footprint: {rep.hbm_footprint_bytes() / 2**20:.1f} "
      f"MiB; suggested host chunks on an H100: "
      f"{rep.suggested_host_chunks()}")

with tempfile.TemporaryDirectory() as tmp:
    # the working set lives in memory-mapped files — neither device
    # memory NOR host RAM needs to hold a full field
    state = {}
    rng = np.random.default_rng(0)
    for name, spec in program.inputs.items():
        shape = spec.shape(program.dimensions)
        if not shape:
            state[name] = np.float32(0.025)
            continue
        mm = np.memmap(os.path.join(tmp, f"{name}.dat"),
                       dtype=np.float32, mode="w+", shape=shape)
        mm[:] = rng.random(shape, dtype=np.float32)
        mm.flush()
        state[name] = mm

    # one chunked sweep == one chain application; verify vs the oracle
    ref = sft.run_interpreter(program, state)
    got = run_chunked(program, state, CHUNKS)
    out = program.outputs[0]
    np.testing.assert_allclose(got[out], np.asarray(ref[out]),
                               rtol=2e-5, atol=1e-6)
    print(f"single sweep over {CHUNKS} chunks matches the oracle")

    # out-of-core time-stepping with temporal fusion: STEPS steps in
    # STEPS/FUSE sweeps; checkpoint/resume works unchanged (npz)
    final = iterate(program, state, steps=STEPS, fuse=FUSE,
                    host_chunks=CHUNKS,
                    feed={"a": out},   # the diffused field feeds back
                    checkpoint_every=2,
                    checkpoint_dir=os.path.join(tmp, "ckpt"))
    print(f"{STEPS} steps in {STEPS // FUSE} sweeps; "
          f"final field mean = {float(final['a'].mean()):.6f}")
    print("checkpoints:",
          sorted(os.listdir(os.path.join(tmp, "ckpt"))))

"""Execution backend: the chain fused into one XLA program.

The reference's backends are DaCe SDFG expansions per vendor
(/root/reference/stencilflow/stencil/{intel_fpga,xilinx,cpu}.py); ours is
one lowering over the same typed IR: ``xla`` (whole-domain jit through the
widened-tile evaluator), with multi-device execution layered in
``stencilflow_tpu.parallel``.
"""
from .xla import chain_halo, compile_chain, run_chain


def compile_chain_best(program, analysis=None):
    """The lowering for the running platform (``device.lowering``).
    Returns ``(fn, backend_name)``."""
    from ..device import device_info, lowering
    name = lowering(device_info().platform)
    return compile_chain(program, analysis), name


__all__ = ["chain_halo", "compile_chain", "run_chain", "compile_chain_best"]

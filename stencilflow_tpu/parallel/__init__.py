"""Multi-device execution: domain decomposition with halo exchange, and
operator-pipeline splitting across devices.

The replacement for the reference's multi-FPGA story
(/root/reference/stencilflow/sdfg_generator.py:782-1000 split_sdfg,
/root/reference/bin/run_distributed_program.py): instead of cutting the
operator pipeline at a stream and bridging with SMI remote FIFOs under MPI,
we shard the *domain* over a ``jax.sharding.Mesh`` and exchange halos with
``lax.ppermute`` (domain decomposition), and additionally support the
reference-style operator-pipeline cut for feature parity.
"""
from .domain import DomainDecomposition, compile_sharded_chain
from .pipeline import PipelineSplit, compile_pipeline_split

__all__ = ["DomainDecomposition", "compile_sharded_chain",
           "PipelineSplit", "compile_pipeline_split"]

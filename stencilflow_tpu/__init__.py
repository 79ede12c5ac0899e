"""stencilflow_tpu — a stencil-dataflow framework on JAX.

A from-scratch rebuild of the capabilities of spcl/stencilflow (CGO'21): the
same JSON program dialect and buffer/delay analyses, but lowered to JAX/XLA
instead of FPGA HLS pipelines.  Chained stencil operators are fused into one
XLA program over halo-widened tiles, verified against a whole-domain
interpreter oracle, and scaled across devices via shard_map domain
decomposition with halo exchange.

Facade mirrors the reference package (/root/reference/stencilflow/__init__.py).
"""

__version__ = "0.1.0"

from .config import ITERATORS, JUNK_VAL, VERIFY_RTOL
from .dtypes import str_to_dtype, dtype_to_str
from .ir import (Access, Assign, BCKind, BinOp, BoolOp, BoundaryCondition,
                 Call, Compare, Const, InputSpec, KernelSpec, Program, Ref,
                 Select, UnaryOp)
from .frontend.parser import parse_program, StencilSyntaxError
from .frontend.chain import ChainGraph, CycleError
from .frontend.analysis import ChainAnalysis, flatten_index
from .frontend.canonicalize import (canonicalize, nest_dimension,
                                    program_from_op_list, version_program)
from .frontend.trace import trace_program
from .frontend.export import program_to_json
from .grad import (adjoint_program, fast_value_and_grad, grad,
                   value_and_grad)
from .solve import make_solver, solve_cg, solve_cgnr
from .iterate import compose_iterations, iterate, make_step
from .outofcore import compile_chunked_chain, run_chunked
from .interpreter import ChainInterpreter, run_interpreter
from .data import (arrays_are_equal, load_array, load_input_arrays,
                   prune_halo, save_array, save_output_arrays)

__all__ = [
    "ITERATORS", "JUNK_VAL", "VERIFY_RTOL",
    "str_to_dtype", "dtype_to_str",
    "Access", "Assign", "BCKind", "BinOp", "BoolOp", "BoundaryCondition",
    "Call", "Compare", "Const", "InputSpec", "KernelSpec", "Program", "Ref",
    "Select", "UnaryOp",
    "parse_program", "StencilSyntaxError",
    "ChainGraph", "CycleError",
    "ChainAnalysis", "flatten_index",
    "canonicalize", "nest_dimension", "program_from_op_list",
    "version_program",
    "trace_program", "program_to_json",
    "compose_iterations", "iterate", "make_step",
    "adjoint_program", "fast_value_and_grad", "grad", "value_and_grad",
    "make_solver", "solve_cg", "solve_cgnr",
    "compile_chunked_chain", "run_chunked",
    "ChainInterpreter", "run_interpreter",
    "arrays_are_equal", "load_array", "load_input_arrays", "prune_halo",
    "save_array", "save_output_arrays",
]

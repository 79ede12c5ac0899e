"""Framework-wide configuration constants.

The op-latency table mirrors the reference's per-op pipeline-latency model
(/root/reference/stencilflow/compute_graph.config:1-21) and is used for delay
alignment analysis and the dataflow simulator.  Device peak rates live in
device.py.
"""
from __future__ import annotations

# Per-op pipeline latency (cycles) used by the dataflow scheduling analysis.
# Same shape as the reference's compute_graph.config.
OP_LATENCY = {
    "add": 16,
    "sub": 16,
    "mult": 16,
    "div": 128,
    "neg": 16,
    "min": 16,
    "max": 16,
    "comp": 16,   # comparisons
    "cond": 16,   # ternary select
    "bool": 16,   # and/or
    "sin": 128,
    "cos": 128,
    "tan": 128,
    "sinh": 128,
    "cosh": 128,
    "tanh": 128,
    "sqrt": 128,
    "exp": 128,
    "log": 128,
    "abs": 16,
    "name": 0,
    "num": 0,
    "subscript": 0,
    "output": 0,
}

# Relative tolerance for result verification
# (reference: stencil_chain.config eps=1e-10; comparisons use 1e-5 relative,
#  /root/reference/stencilflow/helper.py:261-276).
EPS = 1e-10
VERIFY_RTOL = 1e-5

# Junk value written into shrink-boundary halo cells
# (reference: /root/reference/stencilflow/stencil/_common.py:8).
JUNK_VAL = -100000.0

# Canonical iterator names (reference: helper.py:27).
ITERATORS = ("i", "j", "k")

"""Edge-case programs (tests/xla_cases.py) through the fused-XLA path(s):
outofcore,outofcore_sharded.  Every case must match the numpy oracle."""
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(__file__))
from xla_cases import CASES, paths_for, run_path  # noqa: E402

PATHS = "outofcore,outofcore_sharded".split(",")
PARAMS = [(name, path) for name in CASES for path in paths_for(name)
          if path in PATHS]


@pytest.mark.parametrize("name,path", PARAMS,
                         ids=[f"{n}-{p}" for n, p in PARAMS])
def test_matches_oracle(name, path):
    run_path(name, path)

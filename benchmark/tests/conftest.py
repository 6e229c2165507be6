"""The benchmark's own tests: on the CPU, the count of work, the trace
arithmetic, the harness and the reference at small sizes; on a card
(marker ``cuda``), a short run of a cell and the control.

    python -m pytest -p no:cacheprovider benchmark/tests
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# a configuration small enough for the CPU: the family's shapes, 40 nodes
TINY = dict(num_states=4, num_inputs=2, num_stages=3, stopping_time=3,
            nodes_per_stage=[1, 3, 9, 27], num_nodes=40)


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"

"""The port's NumPy host layer against the JAX package's: the scenario
tree (golden values and every index plan), the example problem families,
and the rule that ``raocp_tpu_torch`` never imports JAX."""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import raocp_tpu.models as jax_models  # noqa: E402
from raocp_tpu import MarkovChainScenarioTreeFactory as JaxFactory  # noqa
import raocp_tpu_torch.models as port_models  # noqa: E402
from raocp_tpu_torch import MarkovChainScenarioTreeFactory  # noqa: E402

P = np.array([[0.1, 0.8, 0.1],
              [0.4, 0.6, 0.0],
              [0.0, 0.3, 0.7]])
V = np.array([0.5, 0.5, 0.0])

TREE_ARRAYS = ("ancestors", "stages", "probabilities", "w_values",
               "child_first", "child_count", "child_rank", "children_padded",
               "children_mask", "stage_start")


@pytest.mark.parametrize("args", [(4, 3), (5, 2), (3, None)])
def test_tree_matches_jax(args):
    num_stages, stopping = args
    port = MarkovChainScenarioTreeFactory(P, V, num_stages, stopping).create()
    ref = JaxFactory(P, V, num_stages, stopping).create()
    assert port.num_nodes == ref.num_nodes
    assert port.num_nonleaf_nodes == ref.num_nonleaf_nodes
    assert port.num_stages == ref.num_stages
    assert port.max_branching == ref.max_branching
    assert port.stage_child == ref.stage_child
    for name in TREE_ARRAYS:
        np.testing.assert_array_equal(getattr(port, name),
                                      getattr(ref, name), err_msg=name)


def test_golden_tree():
    t = MarkovChainScenarioTreeFactory(P, V, 4, 3).create()
    assert (t.num_nodes, t.num_nonleaf_nodes, t.num_stages) == (32, 20, 5)
    assert t.stage_child == (2, None, None, 1)


FAMILIES = [
    ("demo_problem", {}),
    ("lqr_binary_problem", {}),
    ("mass_spring_problem", dict(num_stages=4)),
    ("random_network_problem", dict(num_states=6, num_inputs=3,
                                    num_modes=3, num_stages=4,
                                    stopping_time=4)),
    ("soc_network_problem", dict(num_states=4, num_inputs=2, num_modes=2,
                                 num_stages=4, stopping_time=2)),
]


@pytest.mark.parametrize("name,kwargs", FAMILIES)
def test_example_families_match_jax(name, kwargs):
    """Same seeds, same draws: the port's families are the same problems."""
    port, x0p = getattr(port_models, name)(**kwargs)
    ref, x0r = getattr(jax_models, name)(**kwargs)
    np.testing.assert_array_equal(x0p, x0r)
    assert port.tree.num_nodes == ref.tree.num_nodes
    for j in range(1, ref.tree.num_nodes):
        np.testing.assert_array_equal(port.state_dynamics_at_node(j),
                                      ref.state_dynamics_at_node(j))
        np.testing.assert_array_equal(port.control_dynamics_at_node(j),
                                      ref.control_dynamics_at_node(j))
    for i in range(ref.tree.num_nonleaf_nodes):
        np.testing.assert_array_equal(port.risk_at_node(i).matrix_e,
                                      ref.risk_at_node(i).matrix_e)


def test_port_never_imports_jax():
    """A fresh process imports the port, builds and steps the demo, and
    finds no JAX module loaded."""
    code = (
        "import sys, torch\n"
        "torch.set_num_threads(1)\n"
        "import raocp_tpu_torch as r\n"
        "from raocp_tpu_torch.models import demo_problem\n"
        "problem, x0 = demo_problem()\n"
        "res = r.Solver(problem).solve(x0, max_iters=3, tol=1e-3)\n"
        "assert res.num_iters == 4, res.num_iters\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m == 'jax' or m.startswith(('jax.', 'jaxlib',\n"
        "                                            'raocp_tpu.')))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    out = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"

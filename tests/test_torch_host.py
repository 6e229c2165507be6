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
    """A fresh process imports the port (accel, mpc, parallel and utils
    included),
    builds, steps and validates the demo, and finds no JAX module loaded,
    and no matplotlib either (only the plotting functions import it)."""
    code = (
        "import sys, torch\n"
        "torch.set_num_threads(1)\n"
        "import raocp_tpu_torch as r\n"
        "import raocp_tpu_torch.accel, raocp_tpu_torch.mpc\n"
        "import raocp_tpu_torch.parallel\n"
        "import raocp_tpu_torch.utils.evaluate, raocp_tpu_torch.utils.plots\n"
        "from raocp_tpu_torch.models import demo_problem\n"
        "problem, x0 = demo_problem()\n"
        "solver = r.Solver(problem, device='cpu')\n"
        "res = solver.solve(x0, max_iters=3, tol=1e-3)\n"
        "assert res.num_iters == 4, res.num_iters\n"
        "res = solver.solve(x0, max_iters=3, tol=1e-3, accel='anderson')\n"
        "solver.validate(res)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m == 'jax' or m.startswith(('jax.', 'jaxlib',\n"
        "                                            'raocp_tpu.',\n"
        "                                            'matplotlib')))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    out = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def _entry_points():
    import raocp_tpu_torch as rt
    from raocp_tpu_torch.core import modal
    from raocp_tpu_torch.core import stacked
    return {
        "Solver": rt.Solver.__init__,
        "RiskAverseMPC": rt.RiskAverseMPC.__init__,
        "demo_mpc_controller": port_models.demo_mpc_controller,
        "network_mpc_controller": port_models.network_mpc_controller,
        "build_stacked": stacked.build_stacked,
        "from_numpy": stacked.from_numpy,
        "upload": modal.upload,
    }


@pytest.mark.parametrize("name", ["Solver", "RiskAverseMPC",
                                  "demo_mpc_controller",
                                  "network_mpc_controller", "build_stacked",
                                  "from_numpy", "upload"])
def test_entry_points_default_to_the_card(name):
    import inspect
    default = inspect.signature(_entry_points()[name]).parameters[
        "device"].default
    assert default == "cuda"


def test_solver_without_a_device_raises_without_a_card():
    """Nothing looks for a GPU and carries on on the CPU: where there is no
    card, the default device makes the call raise (PyTorch's own error)."""
    import torch
    import raocp_tpu_torch as rt
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device works")
    problem, x0 = port_models.demo_problem()
    with pytest.raises((RuntimeError, AssertionError)):
        rt.Solver(problem)
    assert rt.Solver(problem, device="cpu").solve(
        x0, max_iters=2, tol=1e-3).num_iters >= 2


def test_flat_partition_on_a_mesh_solves(tmp_path):
    """On a real 2-rank gloo mesh (two processes on the CPU),
    ``partition="flat"``, and under ``"auto"`` a tree with no subtree
    frontier or ``pad_multiple``, take the flat node partition and solve
    as the single device does."""
    import test_torch_subtree as worker

    (res, arrays), _ = worker.run_world(2, ("misconfig",), str(tmp_path))
    worker._assert_flat_cases_match_single(res["misconfig"], arrays)

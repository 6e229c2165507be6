"""``build_stacked(offline="device")`` in the port against the JAX package's
(float64): the branch order of the JAX package (host tables for a fully
tabled tree, whatever ``offline`` says; the stage tables broadcast on the
device for a fully stage-constant tree with ``keep_dense``; the device
Riccati program otherwise), and ``network_mpc_controller(offline="device")``
building without raising."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import raocp_tpu.models as jax_models  # noqa: E402
from raocp_tpu.core.stacked import build_stacked as jax_build  # noqa: E402
import raocp_tpu_torch as rt  # noqa: E402
import raocp_tpu_torch.models as port_models  # noqa: E402
from raocp_tpu_torch.core.stacked import build_stacked, to_numpy  # noqa: E402

SMALL_NET = dict(num_states=6, num_inputs=3, num_modes=3, num_stages=4,
                 stopping_time=4)
# stopped before the last stage: chain stages, tabled but not stage-constant
CHAIN_NET = dict(num_states=6, num_inputs=3, num_modes=3, num_stages=4,
                 stopping_time=2)


def _assert_leaves_close(got_sp, want_sp, atol):
    got, got_static = to_numpy(got_sp)
    want, want_static = to_numpy(want_sp)
    for name, v in got_static.items():
        assert want_static[name] == v, name

    def close(name, g, w):
        if w is None:
            assert g is None, name
        elif isinstance(w, tuple):
            assert len(g) == len(w), name
            for k, (a, b) in enumerate(zip(g, w)):
                close(f"{name}[{k}]", a, b)
        elif isinstance(w, dict):
            for k in w:
                close(f"{name}.{k}", g[k], w[k])
        else:
            assert g is not None and g.shape == w.shape, name
            if w.dtype.kind in "biu":
                np.testing.assert_array_equal(g, w, err_msg=name)
            else:
                np.testing.assert_allclose(g, w, rtol=0, atol=atol,
                                           err_msg=name)

    for name, v in got.items():
        if name in want:
            close(name, v, want[name])
        else:
            assert v is None, name


@pytest.mark.parametrize("keep_dense", [False, True])
def test_demo_device_offline_matches_jax(keep_dense):
    """The ragged demo runs the device Riccati program in both packages."""
    port_spec, _ = port_models.demo_problem()
    jax_spec, _ = jax_models.demo_problem()
    port = build_stacked(port_spec, dtype=torch.float64, offline="device",
                         keep_dense=keep_dense, device="cpu")
    ref = jax_build(jax_spec, dtype=jnp.float64, offline="device",
                    keep_dense=keep_dense)
    assert (port.K is not None) and (port.P is not None) == keep_dense
    _assert_leaves_close(port, ref, 1e-10)


def test_demo_device_offline_solves_in_937():
    problem, x0 = port_models.demo_problem()
    res = rt.Solver(problem, offline="device", device="cpu").solve(
        x0, max_iters=2000, tol=1e-3)
    assert res.converged and res.num_iters == 937


@pytest.mark.parametrize("kwargs", [SMALL_NET, CHAIN_NET],
                         ids=["stage_constant", "chain_stages"])
def test_keep_dense_device_matches_host(kwargs):
    """Stage tables broadcast on the device (stage-constant tree) and the
    device Riccati program (chain stages) give the host dense build."""
    spec, _ = port_models.random_network_problem(**kwargs)
    host = build_stacked(spec, dtype=torch.float64, keep_dense=True,
                         device="cpu")
    dev = build_stacked(spec, dtype=torch.float64, offline="device",
                        keep_dense=True, device="cpu")
    assert dev.P is not None and dev.Abar is not None
    _assert_leaves_close(dev, host, 1e-10)
    jax_spec, _ = jax_models.random_network_problem(**kwargs)
    ref = jax_build(jax_spec, dtype=jnp.float64, offline="device",
                    keep_dense=True)
    _assert_leaves_close(dev, ref, 1e-10)


def test_fully_tabled_tree_ignores_offline():
    """A fully tabled tree takes the host tables whatever ``offline``
    says (JAX ``core/stacked.py:957``): no dense stacks either way."""
    spec, _ = port_models.random_network_problem(**CHAIN_NET)
    host = build_stacked(spec, dtype=torch.float64, device="cpu")
    dev = build_stacked(spec, dtype=torch.float64, offline="device",
                        device="cpu")
    assert dev.K is None and dev.P is None and dev.A is None
    _assert_leaves_close(dev, host, 0.0)


def test_network_mpc_controller_device_offline_builds():
    controller, x0 = port_models.network_mpc_controller(
        num_states=4, num_inputs=2, num_modes=3, num_stages=3,
        stopping_time=3, offline="device", device="cpu")
    solver, problem = controller.solver_for_mode(0)
    assert solver.stacked.num_nodes == problem.tree.num_nodes == 40
    assert solver.stacked.K is None          # the host stage tables
    assert x0.shape == (4,)

"""K1, the sweep kernel's wrapper and its plain torch version, against the
JAX package's Pallas kernel (interpret mode) and its XLA path, on the
``tests/test_pallas.py`` fixture. The kernel itself is tested on a card by
``tests/test_torch_cuda.py``."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from raocp_tpu.core.stacked import build_stacked as jax_build  # noqa: E402
from raocp_tpu.models import random_network_problem as jax_family  # noqa
from raocp_tpu.ops.pallas_sweep import project_dynamics_pallas  # noqa: E402
from raocp_tpu.ops.prox import project_dynamics as jax_project  # noqa: E402
from raocp_tpu_torch.core.stacked import build_stacked  # noqa: E402
from raocp_tpu_torch.models import random_network_problem  # noqa: E402
from raocp_tpu_torch.ops import sweep  # noqa: E402
from raocp_tpu_torch.ops.prox import project_dynamics  # noqa: E402

# the tests/test_pallas.py fixture: fully uniform 121-node tree
FIXTURE = dict(num_states=6, num_inputs=3, num_modes=3, num_stages=4,
               stopping_time=4)
# float32: the TPU test's own tolerance; float64: summation-order noise
TOLS = {"float32": 1e-5, "float64": 1e-10}


def _problem(dtype, pad=1, device="cpu"):
    spec, x0 = random_network_problem(**FIXTURE)
    sp = build_stacked(spec, dtype=getattr(torch, dtype), pad_multiple=pad,
                       device=device)
    rng = np.random.default_rng(0)
    x_in = rng.standard_normal((sp.np_pad, sp.n))
    u_in = rng.standard_normal((sp.nl_pad, sp.m))
    return sp, x0, x_in, u_in


@pytest.mark.parametrize("pad", [1, 8])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_sweep_ref_matches_pallas_and_xla(dtype, pad):
    sp, x0, x_in, u_in = _problem(dtype, pad)
    assert sweep.sweep_eligible(sp)
    tdt = getattr(torch, dtype)
    x, u = sweep.project_dynamics_sweep_ref(
        sp, torch.as_tensor(x_in, dtype=tdt), torch.as_tensor(u_in, dtype=tdt),
        torch.as_tensor(x0, dtype=tdt))
    spec, _ = jax_family(**FIXTURE)
    jsp = jax_build(spec, dtype=getattr(jnp, dtype), pad_multiple=pad)
    args = (jnp.asarray(x_in, jsp.dtype), jnp.asarray(u_in, jsp.dtype),
            jnp.asarray(x0, jsp.dtype))
    with jax.default_matmul_precision("float32"):
        x_pl, u_pl = project_dynamics_pallas(jsp, *args, interpret=True)
        x_xla, u_xla = jax_project(jsp, *args)
    tol = TOLS[dtype]
    for want_x, want_u in ((x_pl, u_pl), (x_xla, u_xla)):
        np.testing.assert_allclose(x.numpy(), np.asarray(want_x),
                                   rtol=tol, atol=tol)
        np.testing.assert_allclose(u.numpy(), np.asarray(want_u),
                                   rtol=tol, atol=tol)
    # ghost rows are exactly zero
    assert torch.all(x[sp.num_nodes:] == 0)
    assert torch.all(u[sp.num_nonleaf:] == 0)


def test_cpu_tensors_take_the_plain_version():
    """On CPU tensors the wrapper (and prox's dispatch to it) runs the plain
    version: no launch counted, no library built or loaded, no nvcc."""
    sp, x0, x_in, u_in = _problem("float64", pad=8)
    args = (torch.as_tensor(x_in), torch.as_tensor(u_in),
            torch.as_tensor(x0))
    before = sweep.LAUNCHES
    x, u = sweep.project_dynamics_sweep(sp, *args)
    x2, u2 = project_dynamics(sp, *args)
    x_ref, u_ref = sweep.project_dynamics_sweep_ref(sp, *args)
    assert torch.equal(x, x_ref) and torch.equal(u, u_ref)
    assert torch.equal(x2, x_ref) and torch.equal(u2, u_ref)
    assert sweep.LAUNCHES == before
    assert sweep._LIB is None


def test_wrapper_rejects_what_the_kernel_does_not_take():
    sp, x0, x_in, u_in = _problem("float64")
    x, u, x0t = (torch.as_tensor(x_in), torch.as_tensor(u_in),
                 torch.as_tensor(x0))
    with pytest.raises(ValueError, match="shape"):
        sweep.project_dynamics_sweep(sp, x[:-1], u, x0t)
    with pytest.raises(TypeError):
        sweep.project_dynamics_sweep(sp, x.float(), u, x0t)
    with pytest.raises(ValueError, match="contiguous"):
        sweep.project_dynamics_sweep(sp, x.t().contiguous().t(), u, x0t)
    strided = tuple(w.transpose(0, 1).contiguous().transpose(0, 1)
                    for w in sp.ab_fwd)
    with pytest.raises(ValueError, match="ab_fwd must be contiguous"):
        sweep.project_dynamics_sweep(
            dataclasses.replace(sp, ab_fwd=strided), x, u, x0t)

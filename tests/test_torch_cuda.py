"""K1 on the card: the CUDA sweep kernel against its plain torch version.

These tests need an NVIDIA GPU and skip without one. This file imports no
JAX, so it runs on a machine without it:

    python -m pytest -p no:cacheprovider --noconftest tests/test_torch_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from raocp_tpu_torch.core.stacked import build_stacked  # noqa: E402
from raocp_tpu_torch.models import random_network_problem  # noqa: E402
from raocp_tpu_torch.ops import sweep  # noqa: E402
from raocp_tpu_torch.ops.prox import project_dynamics  # noqa: E402

# the tests/test_pallas.py fixture, and a wider one (n=50, m=20, c=3)
FIXTURES = {
    "small": dict(num_states=6, num_inputs=3, num_modes=3, num_stages=4,
                  stopping_time=4),
    "wide": dict(num_states=50, num_inputs=20, num_modes=3, num_stages=5,
                 stopping_time=5),
}
# float64: summation-order noise; float32: the TPU test's tolerance, and
# 1e-4 for 170-term sums over stages
TOLS = {("small", "float32"): 1e-5, ("small", "float64"): 1e-12,
        ("wide", "float32"): 1e-4, ("wide", "float64"): 1e-12}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(FIXTURES))
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_kernel_matches_plain_version(cuda, name, dtype):
    spec, x0 = random_network_problem(**FIXTURES[name])
    tdt = getattr(torch, dtype)
    sp = build_stacked(spec, dtype=tdt, pad_multiple=8, device=cuda)
    rng = np.random.default_rng(0)
    args = tuple(torch.as_tensor(a, dtype=tdt, device=cuda) for a in (
        rng.standard_normal((sp.np_pad, sp.n)),
        rng.standard_normal((sp.nl_pad, sp.m)), x0))
    before = sweep.LAUNCHES
    x, u = sweep.project_dynamics_sweep(sp, *args)
    torch.cuda.synchronize()
    assert sweep.LAUNCHES == before + 1
    x_ref, u_ref = sweep.project_dynamics_sweep_ref(sp, *args)
    scale = max(1.0, float(x_ref.abs().max()), float(u_ref.abs().max()))
    tol = TOLS[name, dtype] * scale
    torch.testing.assert_close(x, x_ref, rtol=0, atol=tol)
    torch.testing.assert_close(u, u_ref, rtol=0, atol=tol)
    assert torch.all(x[sp.num_nodes:] == 0)
    assert torch.all(u[sp.num_nonleaf:] == 0)
    # prox's dispatch takes the kernel on the card
    x2, _ = project_dynamics(sp, *args)
    assert sweep.LAUNCHES == before + 2
    torch.testing.assert_close(x2, x, rtol=0, atol=0)


@pytest.mark.cuda
def test_kernel_rejects_cpu_problem_with_cuda_tensors(cuda):
    spec, x0 = random_network_problem(**FIXTURES["small"])
    sp = build_stacked(spec, dtype=torch.float32)
    x = torch.zeros((sp.np_pad, sp.n), device=cuda)
    u = torch.zeros((sp.nl_pad, sp.m), device=cuda)
    with pytest.raises(ValueError, match="the problem on"):
        sweep.project_dynamics_sweep(
            sp, x, u, torch.as_tensor(x0, dtype=torch.float32, device=cuda))

"""The dual half of the CP step (``ops/dual.py``) on the CPU: the plain
twin is the step's composition as it was, bit for bit; the wrapper runs it
for CPU tensors, raises on what the kernel does not take, and plans each
row family's vectors and groups from the operands' strides. The kernel
itself is tested on a card by ``tests/test_torch_cuda.py``, which builds
its cases with :func:`dual_case` (this file imports no JAX)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import raocp_tpu_torch as rt  # noqa: E402
from raocp_tpu_torch import solver as solver_mod  # noqa: E402
from raocp_tpu_torch.core.stacked import build_stacked  # noqa: E402
from raocp_tpu_torch.core.variables import (Dual, Primal,  # noqa: E402
                                            lane_view, primal_shapes)
from raocp_tpu_torch.models import (demo_problem,  # noqa: E402
                                    random_network_problem)
from raocp_tpu_torch.ops import dual as dual_mod  # noqa: E402
from raocp_tpu_torch.ops.operator import ell  # noqa: E402
from raocp_tpu_torch.ops.prox import (g_conj_projections,  # noqa: E402
                                      half_shift_dual)

SMALL = dict(num_states=6, num_inputs=3, num_modes=3, num_stages=4,
             stopping_time=4)
HEADLINE = dict(num_states=50, num_inputs=20, num_modes=3, num_stages=8,
                stopping_time=8)
CONFIG5_WIDTH = dict(num_states=100, num_inputs=40, num_modes=3,
                     num_stages=3, stopping_time=3)
# name -> (problem, dtype, lanes, alpha2 per lane, tables mixed, strided
# eta). Every case's L z and L z+ come from ``ell`` (e3 and e4 column
# slices of one tensor, e5 the same tensor as e6, e12 as e13). "mixed":
# ball constraints and the L2Ball risk's SOC block, half the rows of each
# constraint turned into boxes. "strided": eta's parts are views at an odd
# offset and a column stride of 2 (no vectors, every stride read).
CASES = {
    "demo_f64": ("demo", "float64", None, False, False, False),
    "small_f32": (SMALL, "float32", None, False, False, False),
    "small_lanes3_f64": (SMALL, "float64", 3, True, False, False),
    "small_lanes8_f32": (SMALL, "float32", 8, True, False, False),
    "mixed_f64": ("ball_soc", "float64", None, False, True, False),
    "mixed_lanes2_f32": ("ball_soc", "float32", 2, True, True, False),
    "strided_f64": (SMALL, "float64", 2, False, False, True),
}


def _problem(kind, dtype, device):
    if kind == "demo":
        spec, _ = demo_problem()
    elif kind == "ball_soc":
        spec, _ = random_network_problem(**SMALL, constraint="ball")
        spec = spec.with_all_risks(rt.L2Ball(0.3))
    else:
        spec, _ = random_network_problem(**kind)
    return build_stacked(spec, dtype=getattr(torch, dtype), device=device)


def _mixed_tables(sp, rng):
    """Every other row of each constraint a box (finite bounds), the rest
    balls about random centres, their radii spread over decades."""
    out = {}
    for lo, hi, c, r in (("nl_lo", "nl_hi", "nl_ball_c", "nl_ball_r"),
                         ("l_lo", "l_hi", "l_ball_c", "l_ball_r")):
        rows, cols = getattr(sp, lo).shape
        box = torch.arange(rows) % 2 == 0
        like = dict(dtype=sp.dtype, device=sp.device)
        radii = torch.as_tensor(30.0 * np.exp(1.5 * rng.standard_normal(
            rows)))
        out[r] = torch.where(box, torch.tensor(float("inf")),
                             radii).to(**like)
        out[c] = torch.as_tensor(rng.standard_normal((rows, cols)), **like)
        out[lo] = torch.full((rows, cols), -0.5, **like)
        out[hi] = torch.full((rows, cols), 0.5, **like)
    return dataclasses.replace(sp, **out)


def _row_scaled(rng, shape, lead):
    """Normal entries, each row scaled by a lognormal factor, so that the
    norms fall inside, outside and across every cone and ball."""
    rows = shape[0]
    scale = 3.0 * np.exp(1.5 * rng.standard_normal(lead + (rows,)))
    v = rng.standard_normal(lead + shape)
    return v * scale.reshape(lead + (rows,) + (1,) * (len(shape) - 1))


def dual_case(name, device="cpu", problem=None):
    """(sp, eta, L z, L z+, alpha2, shift) of the case ``name``; with
    ``problem`` (kwargs of ``random_network_problem``) in place of the
    case's own tree."""
    kind, *rest = CASES[name]
    return _case(problem or kind, *rest, device)


def _case(kind, dtype, lanes, per_lane, mixed, strided, device):
    sp = _problem(kind, dtype, device)
    rng = np.random.default_rng(7)
    if mixed:
        sp = _mixed_tables(sp, rng)
    lead = () if lanes is None else (lanes,)
    like = dict(dtype=sp.dtype, device=sp.device)

    def tensor(a):
        return torch.as_tensor(a, **like)

    def primal():
        return Primal(*(tensor(rng.standard_normal(lead + s))
                        for s in primal_shapes(sp)))

    Lz, Lzn = ell(sp, primal()), ell(sp, primal())
    parts = []
    for shape in (t.shape[len(lead):] for t in Lz):
        v = _row_scaled(rng, tuple(shape), lead)
        if strided and len(shape) == 2:
            wide = np.zeros(lead + (shape[0], 2 * shape[1] + 1))
            wide[..., 1::2] = v
            parts.append(tensor(wide)[..., 1::2])
        else:
            parts.append(tensor(v))
    eta = Dual(*parts)
    alpha = (tensor(rng.uniform(0.05, 0.5, lanes)) if per_lane
             else tensor(0.2497))
    return sp, eta, Lz, Lzn, alpha, half_shift_dual(sp)


def _composition(sp, eta, Lz, Lzn, alpha2, shift):
    """The CP step's dual half as ``solver._cp_step`` wrote it before the
    kernel."""
    a2 = [lane_view(alpha2, e) for e in eta]
    mod = Dual(*((e + a * (2.0 * lzn - lz)) / a + s
                 for e, a, lzn, lz, s in zip(eta, a2, Lzn, Lz, shift)))
    proj = g_conj_projections(sp, mod)
    return Dual(*(a * (m - p) for a, m, p in zip(a2, mod, proj)))


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_twin_and_wrapper_are_the_composition(name):
    """dual_update_plain and the wrapper on CPU tensors give the old
    composition's bits in every part, and the wrapper launches nothing."""
    args = dual_case(name)
    want = _composition(*args)
    launches = dual_mod.LAUNCHES
    for got in (dual_mod.dual_update_plain(*args),
                dual_mod.dual_update(*args)):
        for a, b in zip(got, want):
            assert a.shape == b.shape and torch.equal(a, b)
    assert dual_mod.LAUNCHES == launches


def test_cases_reach_every_branch():
    """The mixed case's inputs fall in each of the SOC's three cases and on
    both sides of the balls, so that the card's comparison sees them
    all."""
    sp, eta, Lz, Lzn, alpha, shift = dual_case("mixed_f64")
    a = lane_view(alpha, eta.e3)
    mod = Dual(*((e + a * (2.0 * lzn - lz)) / a + s
                 for e, lzn, lz, s in zip(eta, Lzn, Lz, shift)))
    head = torch.cat([mod.e3, mod.e4, mod.e5[:, None]], dim=-1).norm(dim=-1)
    t = mod.e6
    assert bool((head <= t).any() and (head <= -t).any()
                and ((head > t) & (head > -t)).any())
    ball = torch.isfinite(sp.nl_ball_r)
    dist = (mod.e7 - sp.nl_ball_c).norm(dim=-1)
    assert bool((ball & (dist > sp.nl_ball_r)).any()
                and (ball & (dist <= sp.nl_ball_r)).any())
    assert sp.risk_soc_rows is not None


def _bad_calls():
    sp, eta, Lz, Lzn, alpha, shift = dual_case("small_lanes3_f64")
    half = Dual(*(t.half() for t in eta))
    short = eta._replace(e3=eta.e3[..., :-1])
    lanes4 = eta._replace(e7=torch.zeros((4,) + tuple(eta.e7.shape[1:]),
                                         dtype=sp.dtype))
    return {
        "a float16 dual": (TypeError, (sp, half, Lz, Lzn, alpha, shift)),
        "a float32 alpha2": (TypeError, (sp, eta, Lz, Lzn,
                                         alpha.float(), shift)),
        "a part's shape": (ValueError, (sp, short, Lz, Lzn, alpha, shift)),
        "lanes that disagree": (ValueError, (sp, lanes4, Lz, Lzn, alpha,
                                             shift)),
        "alpha2's lanes": (ValueError, (sp, eta, Lz, Lzn, alpha[:2],
                                        shift)),
        "alpha2 as a list": (TypeError, (sp, eta, Lz, Lzn, [0.1], shift)),
        "a missing part": (ValueError, (sp, Dual(*eta)[:10], Lz, Lzn, alpha,
                                        shift)),
    }


@pytest.mark.parametrize("what", sorted(_bad_calls()))
def test_wrapper_raises_on_what_the_kernel_does_not_take(what):
    error, args = _bad_calls()[what]
    with pytest.raises(error):
        dual_mod.dual_update(*args)


@pytest.mark.parametrize("width,dtype,strided,want", [
    # the headline's widths (n=50, m=20): 2 entries a thread at a time,
    # as 8-byte loads (L z's rows are 70 wide, e4 starts 200 bytes in);
    # node rows 25 of them, nonleaf rows 35, leaf rows 25
    ("headline", "float32", False, ((2, 2, 2), (32, 16, 16), (1, 1, 1))),
    # config 5's (n=100, m=40): 4 at a time, 16-byte loads
    ("config5", "float32", False, ((4, 4, 4), (32, 16, 16), (1, 1, 1))),
    ("config5", "float64", False, ((2, 2, 2), (32, 32, 32), (1, 1, 1))),
    # eta at an odd offset, column stride 2: the same plan, loaded an
    # entry at a time
    ("headline", "float64", True, ((2, 2, 2), (32, 16, 16), (0, 0, 0))),
])
def test_plan_follows_widths_and_strides(width, dtype, strided, want):
    kwargs = dict(HEADLINE if width == "headline" else CONFIG5_WIDTH,
                  num_stages=2, stopping_time=2)
    args = _case(kwargs, dtype, None, False, False, strided, "cpu")
    _, _, dims, _ = dual_mod._call(*args)
    assert (tuple(dims[10:13]), tuple(dims[13:16]),
            tuple(dims[16:19])) == want


def test_cpu_loop_counts_no_dual_launches():
    """On the CPU the device loop's periods run the plain twin: no launch
    is counted, though every step went through the wrapper."""
    problem, x0 = random_network_problem(**dict(SMALL, num_stages=3,
                                                stopping_time=3))
    solver = rt.Solver(problem, device="cpu")
    before = dict(solver_mod.LOOP_COUNTS)
    res = solver.solve(x0, max_iters=50, tol=0.0, check_every=10)
    ran = {k: solver_mod.LOOP_COUNTS[k] - before[k] for k in before}
    assert res.num_iters > 0 and ran["steps"] >= res.num_iters
    assert ran["dual_launches"] == 0

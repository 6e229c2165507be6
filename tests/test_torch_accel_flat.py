"""The accelerators' flat extended vectors (``raocp_tpu_torch.accel``).

An extended vector W = (z, eta, L z, L'eta) is one flat buffer whose 32
leaves are contiguous views at aligned offsets, (z, eta) first; each
history is one ``[memory, size]`` buffer. The padding between leaves must
stay exactly 0 through a solve, T on a flat point must give the CP step's
leaves bit for bit, and an iteration must cost a few operations, not one
per leaf.
"""

import collections

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch.utils._python_dispatch import (  # noqa: E402
    TorchDispatchMode, _disable_current_modes)

import raocp_tpu_torch as rt  # noqa: E402
import raocp_tpu_torch.accel as accel  # noqa: E402
import raocp_tpu_torch.models as port_models  # noqa: E402
from raocp_tpu_torch.ops.operator import ell, ell_t  # noqa: E402
from raocp_tpu_torch.solver import _cp_step  # noqa: E402

# the 121-node uniform fixture of tests/test_torch_accel_loop.py
UNIFORM = dict(num_states=6, num_inputs=3, num_modes=3, num_stages=4,
               stopping_time=4)
PROBLEMS = {"demo": lambda: port_models.demo_problem(),
            "uniform": lambda: port_models.random_network_problem(
                **UNIFORM)}


def _solver(problem, dtype):
    spec, x0 = PROBLEMS[problem]()
    return rt.Solver(spec, dtype=getattr(torch, dtype), device="cpu"), x0


def _start(solver, x0, alpha=0.1):
    """``accel._start`` from the zero point with x0 at the root: (the
    problem, its leaves, W0, T(W0), x0 as a tensor)."""
    sp = solver.stacked
    x0t = torch.as_tensor(np.asarray(x0), dtype=sp.dtype)
    z0, eta0 = sp.zero_primal(), sp.zero_dual()
    z0.x[0] = x0t
    leaves = (*z0, *eta0, *ell(sp, z0), *ell_t(sp, eta0))
    a, shift, W0, T0 = accel._start(sp, z0, eta0, alpha, x0t)
    return sp, leaves, W0, T0, (a, x0t, shift)


def _padding(lay, buf):
    """The entries of ``buf`` ([..., size]) that no leaf covers."""
    mask = torch.ones(lay.size, dtype=torch.bool)
    for o, s in zip(lay.offsets, lay.shapes):
        mask[o:o + int(np.prod(s))] = False
    return buf[..., mask]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("problem", sorted(PROBLEMS))
def test_layout(problem, dtype):
    """Every leaf is a contiguous view of W0 holding the start point's
    leaf, starting at an offset of a multiple of 256 bytes (the dual
    kernel's vector loads want 16), in the order z, eta, L z, L'eta, so
    that (z, eta) is the prefix ``[:n_true]``; the padding is 0 and the
    problem has some."""
    solver, x0 = _solver(problem, dtype)
    sp, leaves, W0, _, _ = _start(solver, x0)
    lay = accel._layout(sp)
    size = W0.element_size()
    assert W0.dim() == 1 and W0.is_contiguous() and W0.numel() == lay.size
    views = accel._views(lay, W0)
    assert len(views) == len(leaves) == 32
    end = 0
    for o, view, leaf in zip(lay.offsets, views, leaves):
        assert o >= end and (o * size) % accel._ALIGN_BYTES == 0
        assert view.is_contiguous() and view.shape == leaf.shape
        assert view.data_ptr() == W0.data_ptr() + o * size
        assert view.data_ptr() % 16 == 0
        assert torch.equal(view, leaf)
        end = o + leaf.numel()
    assert lay.n_true == lay.offsets[16] \
        == sum(-(-v.numel() * size // 256) * 256 // size
               for v in leaves[:16])
    z, eta, Lz, Lt = accel._split(sp, W0)
    assert [v.data_ptr() for v in (*z, *eta)] \
        == [v.data_ptr() for v in views[:16]]
    assert all(v.data_ptr() < W0.data_ptr() + lay.n_true * size
               for v in (*z, *eta))
    pad = _padding(lay, W0)
    assert pad.numel() > 0 and bool((pad == 0).all())


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("problem", sorted(PROBLEMS))
def test_t_ext_is_the_cp_step(problem, dtype):
    """T on a flat point: each leaf of the flat result is the CP step's
    leaf bit for bit (column slices included), the padding 0; and
    ``_sq``/``_h_dot`` are the per-leaf sums to rounding."""
    solver, x0 = _solver(problem, dtype)
    sp, _, W0, T0, (a, x0t, shift) = _start(solver, x0)
    rng = np.random.default_rng(7)
    W = (W0 + torch.as_tensor(rng.standard_normal(W0.numel()),
                              dtype=W0.dtype)) \
        * torch.as_tensor(_padding_mask(sp), dtype=W0.dtype)
    z, eta, Lz, Lt = accel._split(sp, W)
    want = _cp_step(sp, z, eta, Lz, Lt, a, a, x0t, shift)
    got = accel._t_ext(sp, W, a, x0t, shift)
    for g, w in zip(accel._views(accel._layout(sp), got),
                    [v for part in want for v in part]):
        assert torch.equal(g, w)
    assert bool((_padding(accel._layout(sp), got) == 0).all())
    per_leaf = sum(float(torch.vdot(v.reshape(-1), v.reshape(-1)))
                   for v in (*z, *eta))
    tol = 1e-12 if dtype == "float64" else 1e-5
    assert abs(float(accel._sq(sp, W)) - per_leaf) <= tol * per_leaf
    H = torch.stack([W, got, T0])
    dots = accel._h_dot(sp, H, W)
    for m in range(3):
        row = accel._split(sp, H[m])
        want_m = sum(float(torch.vdot(r.reshape(-1), v.reshape(-1)))
                     for r, v in zip((*row[0], *row[1]), (*z, *eta)))
        assert abs(float(dots[m]) - want_m) <= tol * per_leaf


def _padding_mask(sp):
    lay = accel._layout(sp)
    mask = np.zeros(lay.size)
    for o, s in zip(lay.offsets, lay.shapes):
        mask[o:o + int(np.prod(s))] = 1.0
    return mask


def _kept_loop(monkeypatch):
    """``accel._loop_for`` patched to keep each loop state it returns."""
    kept = []
    real = accel._loop_for

    def keeping(*args, **kwargs):
        kept.append(real(*args, **kwargs))
        return kept[-1]

    monkeypatch.setattr(accel, "_loop_for", keeping)
    return kept


@pytest.mark.parametrize("method,iters,opts", [
    ("anderson", 60, {}), ("supermann", 100, {}),
    ("supermann", 100, {"accel_memory": 3})])
def test_padding_stays_zero(monkeypatch, method, iters, opts):
    """A window of the demo in float64 (Anderson 60 iterations, SuperMann
    100, at memory 5 and 3) through the device loop: the padding of W, R,
    Wn, Rn and of every history row is exactly 0 at the end, the leaves
    are not, and the loop took more than one kind of step."""
    kept = _kept_loop(monkeypatch)
    solver, x0 = _solver("demo", "float64")
    before = dict(accel.BODY_RUNS)
    res = solver.solve(x0, max_iters=iters, tol=1e-12, accel=method,
                       check_every=1, **opts)
    assert res.num_iters == iters + 1 and len(kept) == 1
    L = kept[0]
    lay = accel._layout(solver.stacked)
    hists = (L.dW, L.dR) if method == "anderson" else (L.U, L.Y)
    for buf in (L.W, L.R, L.Wn, L.Rn, *hists):
        assert bool((_padding(lay, buf) == 0).all())
        assert float(buf.abs().max()) > 0
    taken = [name for name in accel.BODIES[method][1:]
             if accel.BODY_RUNS[method, name] > before.get((method, name), 0)]
    assert len(taken) >= 2


class _Count(TorchDispatchMode):
    """The aten calls made under the mode."""

    def __init__(self):
        super().__init__()
        self.calls = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.calls[str(func)] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("method,bound", [("anderson", 100),
                                          ("supermann", 100)])
def test_iteration_is_a_few_operations(monkeypatch, method, bound):
    """One eager iteration of the device loop, outside its T evaluations
    and residual checks (``_t_ext`` and ``_residuals``, the CP step's own
    code, run with the count paused): a fixed number of aten calls, the
    same in every iteration that takes the same branches. Measured on the
    demo: Anderson 64 (66 in the first iteration), SuperMann 76 (88 with a
    line-search try), 7 more with a check; 1,068 and 1,204 when every
    helper looped over the 32 leaves. Views count as calls here and launch
    nothing on a card."""
    def paused(real):
        def run(*args, **kwargs):
            with _disable_current_modes():
                return real(*args, **kwargs)
        return run

    for name in ("_t_ext", "_residuals"):
        monkeypatch.setattr(accel, name, paused(getattr(accel, name)))
    counts = []
    real = getattr(accel, f"_{method}_iteration")

    def counted(*args, **kwargs):
        with _Count() as c:
            real(*args, **kwargs)
        counts.append(sum(c.calls.values()))

    monkeypatch.setattr(accel, f"_{method}_iteration", counted)
    solver, x0 = _solver("demo", "float64")
    res = solver.solve(x0, max_iters=30, tol=1e-12, accel=method,
                       check_every=5)
    ran = counts[:res.num_iters]
    assert len(ran) == 31 and max(ran) <= bound
    # one count a kind of iteration: plain, with a check, the first (or
    # with a line-search try)
    assert len(set(ran)) <= 3
    # the guarded iterations past the cap make one call: the guard's read
    assert counts[res.num_iters:] == [1] * (len(counts) - res.num_iters)

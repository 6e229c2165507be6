"""The over-relaxation of the CP loop (``ops/relax.py``) on the CPU: the
plain twin is the loop's expression ``c + relax * (p - c)``, bit for bit;
the wrapper runs it for CPU tensors, raises on what the kernel does not
take and lays every leaf out for the library (axes merged, 16-byte
vectors where strides and addresses allow); the loop counts no launch on
the CPU and never calls the wrapper at relax 1.0. The kernel itself is
tested on a card by ``tests/test_torch_cuda.py``, which builds its cases
with :func:`relax_case` (this file imports no JAX)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import raocp_tpu_torch as rt  # noqa: E402
from raocp_tpu_torch import solver as solver_mod  # noqa: E402
from raocp_tpu_torch.core.stacked import build_stacked  # noqa: E402
from raocp_tpu_torch.core.variables import (Dual, Primal,  # noqa: E402
                                            dual_shapes, primal_shapes)
from raocp_tpu_torch.models import random_network_problem  # noqa: E402
from raocp_tpu_torch.ops import relax as relax_mod  # noqa: E402
from raocp_tpu_torch.ops.operator import ell, ell_t  # noqa: E402

SMALL = dict(num_states=6, num_inputs=3, num_modes=3, num_stages=4,
             stopping_time=4)
CONFIG5_WIDTH = dict(num_states=100, num_inputs=40, num_modes=3,
                     num_stages=3, stopping_time=3)
RHO = 1.8
# name -> (tree, dtype, the current side's lanes, the step side's lanes,
# odd). Every case is the loop's four pairs (z, eta, L z, L'eta): both
# sides' L z from ``ell`` (e3 and e4 column slices of one tensor, e5 the
# tensor of e6, e12 of e13, e1 the primal's y), L'eta from ``ell_t``.
# "odd": every leaf of the current side a view one element off its
# allocation (no 16-byte vectors anywhere). A side without lanes where the
# other has them is read by every lane.
CASES = {
    "small_f64": (SMALL, "float64", None, None, False),
    "small_f32": (SMALL, "float32", None, None, False),
    "config5_width_f32": (CONFIG5_WIDTH, "float32", None, None, False),
    "config5_width_f64": (CONFIG5_WIDTH, "float64", None, None, False),
    "lanes8_f32": (CONFIG5_WIDTH, "float32", 8, 8, False),
    "lanes8_f64": (CONFIG5_WIDTH, "float64", 8, 8, False),
    "broadcast_f32": (SMALL, "float32", None, 3, False),
    "odd_f64": (SMALL, "float64", 2, 2, True),
}


def relax_case(name, device="cpu", problem=None):
    """(rho, the loop's four (current, step) pairs) of the case ``name``;
    with ``problem`` (kwargs of ``random_network_problem``) in place of
    the case's own tree."""
    kind, dtype, lanes_c, lanes_p, odd = CASES[name]
    spec, _ = random_network_problem(**(problem or kind))
    sp = build_stacked(spec, dtype=getattr(torch, dtype), device=device)
    rng = np.random.default_rng(11)
    like = dict(dtype=sp.dtype, device=sp.device)

    def lead(lanes):
        return () if lanes is None else (lanes,)

    def tree(cls, shapes, lanes):
        return cls(*(torch.as_tensor(rng.standard_normal(lead(lanes) + s),
                                     **like) for s in shapes))

    def shifted(t):
        buf = torch.empty(t.numel() + 1, **like)
        return buf[1:].view(t.shape).copy_(t)

    def side(lanes):
        z = tree(Primal, primal_shapes(sp), lanes)
        eta = tree(Dual, dual_shapes(sp), lanes)
        return z, eta, ell(sp, z), ell_t(sp, eta)

    cur, new = side(lanes_c), side(lanes_p)
    if odd:
        cur = tuple(type(t)(*(shifted(v) for v in t)) for t in cur)
    return RHO, tuple(zip(cur, new))


def _expression(rho, pairs):
    """The loop's relaxation as ``solver._period`` wrote it before the
    kernel."""
    return tuple(type(cur)(*(c + rho * (p - c) for c, p in zip(cur, nw)))
                 for cur, nw in pairs)


def test_cases_hold_strided_and_aliased_leaves():
    """The cases' step side holds what ``ell`` returns: e3 and e4 views
    of one tensor (row stride n + m), e5 the tensor of e6 and e12 of
    e13."""
    _, pairs = relax_case("config5_width_f32")
    Lz = pairs[2][1]
    assert Lz.e3.stride(0) == Lz.e4.stride(0) == 140
    assert Lz.e3.untyped_storage().data_ptr() \
        == Lz.e4.untyped_storage().data_ptr()
    assert Lz.e5 is Lz.e6 and Lz.e12 is Lz.e13


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_twin_and_wrapper_are_the_expression(name):
    """over_relax_plain and the wrapper on CPU tensors give the loop's
    expression's bits in every leaf of every pair, in its shape and tree
    type, and the wrapper launches nothing."""
    rho, pairs = relax_case(name)
    want = _expression(rho, pairs)
    launches = relax_mod.LAUNCHES
    for got in (relax_mod.over_relax_plain(rho, pairs),
                relax_mod.over_relax(rho, pairs)):
        assert [type(t) for t in got] == [type(t) for t in want]
        for a, b in zip((v for t in got for v in t),
                        (v for t in want for v in t)):
            assert a.shape == b.shape and a.dtype == b.dtype
            assert torch.equal(a, b)
    assert relax_mod.LAUNCHES == launches


def test_plain_tuples_are_trees_too():
    """Trees may be plain tuples: each pair's results come back as a tuple
    of as many leaves, in their shapes."""
    rho, pairs = relax_case("lanes8_f32")
    (z, zn), *_ = pairs
    for fn in (relax_mod.over_relax, relax_mod.over_relax_plain):
        (whole,), (alone,) = fn(rho, ((tuple(z), tuple(zn)),)), \
            fn(rho, (((z.x,), (zn.x,)),))
        assert type(whole) is tuple and len(whole) == len(z)
        assert type(alone) is tuple and len(alone) == 1
        assert torch.equal(alone[0], whole[0]) and whole[0].shape == z.x.shape


def _bad_calls():
    rho, pairs = relax_case("small_f64")
    (z, zn), (eta, en), (Lz, Lzn), (Lt, Ltn) = pairs
    return {
        "a float16 leaf": (TypeError, (rho, ((z, Primal(*(
            t.half() for t in zn))),))),
        "mixed dtypes": (TypeError, (rho, ((z, zn), (Dual(*(
            t.float() for t in eta)), en)))),
        "a leaf's shape": (ValueError, (rho, ((z, zn._replace(
            x=zn.x[:-1])),))),
        "lanes on both sides that differ": (ValueError, (rho, ((
            z._replace(x=z.x.expand(2, *z.x.shape)),
            zn._replace(x=zn.x.expand(3, *zn.x.shape))),))),
        "four axes": (ValueError, (rho, ((
            z._replace(x=z.x[None, None]), zn._replace(
                x=zn.x[None, None])),))),
        "trees of other lengths": (ValueError, (rho, ((z, zn[:4]),))),
        "more leaves than the table": (ValueError, (rho, pairs + ((
            z, zn),))),
        "rho as a tensor": (TypeError, (torch.tensor(rho), pairs)),
        "rho as a bool": (TypeError, (True, pairs)),
        "a number for a leaf": (TypeError, (rho, (((1.0,), (2.0,)),))),
    }


@pytest.mark.parametrize("what", sorted(_bad_calls()))
def test_wrapper_raises_on_what_the_kernel_does_not_take(what):
    error, args = _bad_calls()[what]
    with pytest.raises(error):
        relax_mod.over_relax(*args)


def _layout(name):
    """The library's table of a case, by leaf: (lanes, rows, cols, vec)
    and the strides (c's lane, row, column; p's)."""
    rho, pairs = relax_case(name)
    dtype, device, trees = relax_mod._leaves(rho, pairs)
    outs, table = relax_mod._table(trees, dtype, device)
    rows = [table[i:i + relax_mod.FIELDS]
            for i in range(0, len(table), relax_mod.FIELDS)]
    names = [f"{k}.{f}" for k, t in zip("z eta Lz Lt".split(), outs)
             for f in t._fields]
    return {n: (tuple(r[9:12]) + (r[13],), tuple(r[3:9]))
            for n, r in zip(names, rows)}, outs


def _sizes(dtype="float32"):
    sp = build_stacked(random_network_problem(**CONFIG5_WIDTH)[0],
                       dtype=getattr(torch, dtype), device="cpu")
    return sp.np_pad, sp.nl_pad


def test_table_merges_axes_and_keeps_strides():
    """At config 5's width (n=100, m=40) in float32: a contiguous leaf is
    one row of all its entries; L z's e3 and e4 keep their rows (row
    stride n + m = 140 on both sides); every leaf takes 16-byte vectors;
    outputs are new contiguous tensors."""
    layout, outs = _layout("config5_width_f32")
    np_pad, _ = _sizes()
    assert layout["z.x"] == ((1, 1, np_pad * 100, 1), (0, 0, 1, 0, 0, 1))
    assert layout["Lz.e3"] == ((1, np_pad, 100, 1), (0, 140, 1, 0, 140, 1))
    assert layout["Lz.e4"] == ((1, np_pad, 40, 1), (0, 140, 1, 0, 140, 1))
    assert layout["Lz.e6"] == ((1, 1, np_pad, 1), (0, 0, 1, 0, 0, 1))
    assert all(v[0][3] == 1 for v in layout.values())
    assert all(t.is_contiguous() for tree in outs for t in tree)


def test_table_takes_lanes_broadcasts_and_odd_addresses():
    """Eight lanes of a contiguous leaf are one row; L z's e3 in eight
    lanes is one stack of 8 np_pad rows (its lane stride is np_pad rows);
    a side without lanes is read by every lane (stride 0 over the lanes,
    which merge into one axis of rows with the whole leaf as a row);
    leaves one element off their allocation move no vectors."""
    layout, _ = _layout("lanes8_f32")
    np_pad, nl_pad = _sizes()
    assert layout["eta.e7"] == ((1, 1, 8 * nl_pad * 140, 1),
                                (0, 0, 1, 0, 0, 1))
    assert layout["Lz.e3"] == ((1, 8 * np_pad, 100, 1),
                               (0, 140, 1, 0, 140, 1))
    broadcast, _ = _layout("broadcast_f32")
    (lanes, rows, cols, _), strides = broadcast["z.x"]
    assert (lanes, rows) == (1, 3) and strides[1] == 0 \
        and strides[4] == cols
    odd, _ = _layout("odd_f64")
    assert not any(v[0][3] for v in odd.values())


@pytest.mark.parametrize("relax", [1.8, 1.0])
def test_cpu_loop_counts_no_relax_launches(relax, monkeypatch):
    """On the CPU the device loop's periods run the plain twin: no launch
    is counted at relax 1.8, though every step went through the wrapper;
    at relax 1.0 the wrapper is never called."""
    calls = []
    real = solver_mod.over_relax

    def counted(rho, pairs):
        calls.append(rho)
        return real(rho, pairs)

    monkeypatch.setattr(solver_mod, "over_relax", counted)
    problem, x0 = random_network_problem(**dict(SMALL, num_stages=3,
                                                stopping_time=3))
    solver = rt.Solver(problem, device="cpu")
    before = dict(solver_mod.LOOP_COUNTS)
    res = solver.solve(x0, max_iters=50, tol=0.0, check_every=10,
                       relax=relax)
    ran = {k: solver_mod.LOOP_COUNTS[k] - before[k] for k in before}
    assert res.num_iters > 0 and ran["steps"] >= res.num_iters
    assert ran["relax_launches"] == 0
    assert calls == ([relax] * ran["steps"] if relax != 1.0 else [])

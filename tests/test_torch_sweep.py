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


# ----------------------------------------------------------------- schedule
# Trees with the stage row counts of the three configurations the card
# runs, built at a small width (the schedule and the work depend on the
# tree only through its stage rows) and then given the real widths.
TREES = {
    "small": (FIXTURE, 6, 3),
    "headline": (dict(num_states=3, num_inputs=2, num_modes=3, num_stages=8,
                      stopping_time=8), 50, 20),
    "config5": (dict(num_states=3, num_inputs=2, num_modes=3, num_stages=10,
                     stopping_time=10), 100, 40),
}


@pytest.fixture(scope="module")
def shaped():
    """``shaped(name, dtype)``: the stacked tree ``name`` with its real
    widths n, m written over the small ones it was built at."""
    built = {}

    def get(name, dtype):
        kwargs, n, m = TREES[name]
        if (name, dtype) not in built:
            spec, _ = random_network_problem(**kwargs)
            sp = build_stacked(spec, dtype=getattr(torch, dtype),
                               device="cpu")
            built[name, dtype] = dataclasses.replace(sp, n=n, m=m)
        return built[name, dtype]

    return get


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name", sorted(TREES))
def test_schedule_covers_every_stage_once_each_way(shaped, name, dtype):
    sp = shaped(name, dtype)
    plan = sweep.sweep_schedule(sp)
    ns_nl = sp.num_stages - 1
    launches = plan["launches"]
    assert plan["launch_count"] == len(launches)
    apex = [la for la in launches if la["kind"] == "apex"]
    assert len(apex) == 1
    assert apex[0]["stages"] == tuple(range(plan["apex_stages"]))
    assert 1 <= plan["apex_stages"] <= min(ns_nl, sweep.MAX_APEX)
    for direction in ("backward", "forward"):
        covered = list(apex[0]["stages"]) + [
            la["stages"][0] for la in launches
            if la["kind"] == "stage" and la["direction"] == direction]
        assert sorted(covered) == list(range(ns_nl))
    # the order of the dependency chain: leaves to apex, apex to leaves
    order = [(la["direction"], la["stages"][0]) for la in launches]
    k0 = plan["apex_stages"]
    assert order == ([("backward", k) for k in range(ns_nl - 1, k0 - 1, -1)]
                     + [("both", 0)]
                     + [("forward", k) for k in range(k0, ns_nl)])
    # one launch per direction of each stage below the apex, and the apex
    assert plan["launch_count"] == 2 * (ns_nl - k0) + 1
    # the launch that writes the last rows zeroes the ghost rows
    assert [la["zero_ghosts"] for la in launches] == \
        [False] * (len(launches) - 1) + [True]
    ss = sp.stage_start
    esize = sweep._esize(sp.dtype)
    for la in launches:
        assert la["tm"] in {tm for _, tm in sweep.THREAD_TILES[esize]}
        assert la["tile"] % la["tm"] == 0 and la["tile"] >= la["tm"]
        assert la["tile"] // la["tm"] <= sweep.THREADS
        assert 0 < la["smem"] <= sweep.MAX_SMEM == 232448
        if la["kind"] == "stage":
            k = la["stages"][0]
            assert la["rows"] == ss[k + 1] - ss[k]
            assert la["tiles"] == -(-la["rows"] // la["tile"])
            assert 1 <= la["grid"] <= la["tiles"]
            assert la["smem"] == sweep.smem_bytes(
                la["direction"] == "forward", la["tile"], la["tm"], sp.n,
                sp.m, sp.stage_child[k], esize)
            # one block an SM at the most: the blocks walk over the rest
            assert la["grid"] == min(la["tiles"], sweep.NUM_SMS)
        else:
            assert la["tm"] == sweep.APEX_TM and la["grid"] == 1
    # what the library is handed agrees with the launches
    tm, tile, grid = (list(a) for a in plan["c_arrays"])
    for la in launches:
        if la["kind"] == "stage":
            e = la["stages"][0] + (ns_nl if la["direction"] == "forward"
                                   else 0)
            assert (tm[e], tile[e], grid[e]) == (la["tm"], la["tile"],
                                                 la["grid"])


def test_schedule_launch_counts(shaped):
    """The rule the card was measured with. A stage joins the apex while it
    has at most 4 rows or next to no work: SMALL runs as the apex launch
    alone, and at the headline and at config 5 the apex takes the two
    stages at the root, which leaves 13 and 17 launches. Below the apex a
    stage's rows are dealt evenly to one block an SM, in as many rounds as
    shared memory makes necessary, and the thread tile follows the rows of
    a block: 8 from 32 rows on (float32 only), 4 from 12, 2 from 4."""
    small = sweep.sweep_schedule(shaped("small", "float64"))
    assert (small["launch_count"], small["apex_stages"]) == (1, 4)
    headline = sweep.sweep_schedule(shaped("headline", "float32"))
    assert (headline["launch_count"], headline["apex_stages"]) == (13, 2)
    plan = sweep.sweep_schedule(shaped("config5", "float32"))
    assert (plan["launch_count"], plan["apex_stages"]) == (17, 2)
    shapes = {(la["direction"], la["stages"][0]):
              (la["tm"], la["tile"], la["grid"]) for la in plan["launches"]}
    for direction in ("backward", "forward"):
        # 19,683 rows: two rounds of 132 tiles of ceil(74.6 / 8) * 8 rows
        assert shapes[direction, 9] == (8, 80, 132)
        assert shapes[direction, 8] == (8, 56, 118)     # 6,561 = 132 x 49.7
        assert shapes[direction, 7] == (4, 20, 110)     # 2,187 = 132 x 16.6
        assert shapes[direction, 6] == (2, 6, 122)      # 729 = 132 x 5.5
        assert shapes[direction, 5] == (1, 2, 122)      # 243 = 132 x 1.8
        assert shapes[direction, 4] == (1, 1, 81)
        assert shapes[direction, 2] == (1, 1, 9)
    # float64 has no kernel of the widest thread tile, and its 19,683-row
    # backward step needs four rounds: 40 rows fit beside the slabs, not 76
    f64 = {(la["direction"], la["stages"][0]):
           (la["tm"], la["tile"], la["grid"])
           for la in sweep.sweep_schedule(
               shaped("config5", "float64"))["launches"]}
    assert max(tm for tm, _, _ in f64.values()) == 4
    assert f64["backward", 9] == (4, 40, 132)
    assert f64["forward", 9] == (4, 76, 132)
    # a card of half the SMs gets larger tiles: 2,187 = 66 x 33.1 (tm 8)
    fewer = sweep.plan_sweep(tuple(3 ** k for k in range(8)), (3,) * 8, 50,
                             20, 4, sms=66)
    assert [la["tile"] for la in fewer["launches"]][:2] == [40, 12]


@pytest.mark.parametrize("esize", [4, 8])
@pytest.mark.parametrize("n,m,c", [(6, 3, 3), (50, 20, 3), (50, 18, 3),
                                   (100, 40, 3), (100, 40, 5), (7, 5, 2)])
def test_tiles_respect_the_shared_memory_limit(n, m, c, esize):
    """Every launch of a deep tree of any of these widths fits in the
    232,448 bytes a block may use: n=100, m=40 in float64 included."""
    rows = tuple(min(c ** k, 10 ** 6) for k in range(16))
    plan = sweep.plan_sweep(rows, (c,) * 16, n, m, esize)
    tms = {la["tm"] for la in plan["launches"]}
    assert tms <= {tm for _, tm in sweep.THREAD_TILES[esize]}
    assert 1 in tms and max(tms) > 1
    for la in plan["launches"]:
        assert la["smem"] <= 232448
        for fwd in ((False, True) if la["kind"] == "apex"
                    else (la["direction"] == "forward",)):
            assert sweep.smem_bytes(fwd, la["tile"], la["tm"], n, m, c,
                                    esize) <= la["smem"]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name", sorted(TREES))
def test_packed_weights_hold_every_operand(shaped, name, dtype):
    """What the kernel is handed for each product of each launch: its
    layout deals every column group to a thread of the block, and its
    packed right operand [passes, Kp, cw], read back chunk after chunk, is
    the operand itself with zero rows and columns as padding."""
    sp = shaped(name, dtype)
    n, m = sp.n, sp.m
    esize = sweep._esize(sp.dtype)
    rng = np.random.default_rng(3)
    for la in sweep.sweep_schedule(sp)["launches"]:
        for k in la["stages"]:
            c = sp.stage_child[k]
            for fwd in ((False, True) if la["kind"] == "apex"
                        else (la["direction"] == "forward",)):
                cols = sweep.slab_cols(fwd, la["tile"], la["tm"], n, m, c)
                for width, kp in sweep._products(fwd, n, m, c):
                    product = sweep._product(la["tile"], la["tm"], width, kp)
                    _, passes, cpp, ks = product
                    nrg = la["tile"] // la["tm"]
                    assert nrg * cpp * ks <= sweep.THREADS
                    assert 4 * cpp <= cols and cpp <= sweep.MAX_CPP
                    assert 4 * cpp * (passes - 1) < width <= 4 * cpp * passes
                    assert ks == 1 or la["tm"] == 1
                    # a slab of one pass is one 16-byte-aligned run
                    assert (4 * cpp * esize) % 16 == 0 and kp % 4 == 0
                    rows = (kp - 4, 4) if kp > 4 else (kp,)
                    blocks = [torch.as_tensor(
                        rng.standard_normal((r - (i == 0), width)),
                        dtype=sp.dtype) for i, r in enumerate(rows)]
                    packed = sweep._packed(blocks, width, product)
                    assert packed.shape == (passes, kp, 4 * cpp)
                    assert packed.is_contiguous()
                    back = packed.permute(1, 0, 2).reshape(kp, -1)
                    assert torch.all(back[:, width:] == 0)
                    assert torch.equal(back[:rows[0] - 1, :width], blocks[0])
                    assert torch.all(back[rows[0] - 1] == 0)
                    if len(blocks) == 2:
                        assert torch.equal(back[rows[0]:, :width], blocks[1])


def test_a_width_too_large_for_one_row_group_raises():
    with pytest.raises(RuntimeError, match="shared memory"):
        sweep.plan_sweep((1, 3), (3, 3), 20000, 40, 8)


@pytest.mark.parametrize("name,flop,nbytes", [
    # 48,800 per nonleaf node x 3,280; 195,200 x 29,524
    ("headline", 160_064_000, 5_210_200),
    ("config5", 5_763_084_800, 84_050_480),
])
def test_sweep_work_matches_the_hand_counts(shaped, name, flop, nbytes):
    sp = shaped(name, "float32")
    work = sweep.sweep_work(sp)
    n, m, c = sp.n, sp.m, 3
    per_node = (2 * c * n * (n + m) + 2 * m * m + 4 * m * n) \
        + (2 * n * m + 2 * (n + m) * c * n)
    assert per_node == {"headline": 48_800, "config5": 195_200}[name]
    assert work["flop"] == per_node * sp.num_nonleaf == flop
    assert round(flop / 1e6, 1) in (160.1, 5763.1)
    # x and u in and out, x0, and each stage's weights once
    weights = (sp.num_stages - 1) * (2 * c * n * (n + m) + 2 * m * n + m * m)
    assert work["bytes"] == 4 * (2 * sp.num_nodes * n
                                 + 2 * sp.num_nonleaf * m + n + weights) \
        == nbytes
    assert sweep.sweep_work(shaped(name, "float64"))["bytes"] == 2 * nbytes

"""The roofline's pieces on the CPU: ``cp_iteration`` against the JAX
package's, the torch stage path of the dynamics projection against the
JAX package's XLA path and K1's plain twin, the ``stage_path()`` switch,
the per-component work counts of ``ops/work.py`` against PyTorch's flop
counter and a census of the tensors each component reads and returns, and
the three scripts' refusal to run without a card. Float64, small trees;
the tolerances are float64 summation-order noise."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402
from torch.utils._pytree import tree_flatten  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

import raocp_tpu.models as jax_models  # noqa: E402
import raocp_tpu.ops.operator as jop  # noqa: E402
import raocp_tpu.ops.prox as jprox  # noqa: E402
import raocp_tpu.solver as jsolver  # noqa: E402
from raocp_tpu.core.stacked import build_stacked as jax_build  # noqa: E402
from raocp_tpu.core.variables import Dual as JDual  # noqa: E402
from raocp_tpu.core.variables import Primal as JPrimal  # noqa: E402
import raocp_tpu_torch.models as port_models  # noqa: E402
from raocp_tpu_torch import solver as port_solver  # noqa: E402
from raocp_tpu_torch.core.stacked import build_stacked  # noqa: E402
from raocp_tpu_torch.core.variables import (Dual, Primal,  # noqa: E402
                                            tree_inf_norm)
from raocp_tpu_torch.ops import prox, sweep, work  # noqa: E402
from raocp_tpu_torch.ops.operator import ell, ell_t  # noqa: E402
from raocp_tpu_torch.scripts import (bench_pallas, bench_sweep,  # noqa: E402
                                     roofline)
from util import random_dual, random_primal  # noqa: E402

TOL = 1e-12

# name -> (family, arguments, pad_multiple, branch of L / L'): uniform
# networks that K1 takes (3 and 4 stages; padded), one whose stages after
# its stopping time are mode-constant chains (the Riccati tables of
# modes), the ragged demo (gathers; padded), and the demo with L / L'
# forced off the stage-stacked blocks (mode-grouped, and unfused)
TREES = {
    "network3": ("random_network_problem",
                 dict(num_states=5, num_inputs=2, num_modes=3, num_stages=3,
                      stopping_time=3), 1, None),
    "network4_pad8": ("random_network_problem",
                      dict(num_states=6, num_inputs=3, num_modes=3,
                           num_stages=4, stopping_time=4), 8, None),
    "network_chain": ("random_network_problem",
                      dict(num_states=6, num_inputs=3, num_modes=3,
                           num_stages=4, stopping_time=2), 1, None),
    "demo": ("demo_problem", {}, 1, None),
    "demo_pad4": ("demo_problem", {}, 4, None),
    "demo_modal": ("demo_problem", {}, 1, "modal"),
    "demo_unfused": ("demo_problem", {}, 1, "unfused"),
}


def _branch(sp, branch):
    if branch is None:
        return sp
    none = tuple(None for _ in sp.qr_fwd)
    changes = dict(qr_fwd=none, qr_bwd=none)
    if branch == "unfused":
        changes["QRm"] = None
    return dataclasses.replace(sp, **changes)


def _pair(name):
    """(port problem, JAX problem, x0) of ``TREES[name]``, float64."""
    family, kwargs, pad, branch = TREES[name]
    port_spec, x0 = getattr(port_models, family)(**kwargs)
    jax_spec, _ = getattr(jax_models, family)(**kwargs)
    sp = build_stacked(port_spec, dtype=torch.float64, pad_multiple=pad,
                       device="cpu")
    jsp = jax_build(jax_spec, dtype=jnp.float64, pad_multiple=pad)
    return _branch(sp, branch), _branch(jsp, branch), x0


def _port(name):
    family, kwargs, pad, branch = TREES[name]
    spec, x0 = getattr(port_models, family)(**kwargs)
    sp = build_stacked(spec, dtype=torch.float64, pad_multiple=pad,
                       device="cpu")
    return _branch(sp, branch), x0


def T(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def _close(got, want, what):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()) if want.size else 0.0)
    assert np.abs(got - want).max(initial=0.0) <= TOL * scale, what


# -- cp_iteration ---------------------------------------------------------

@pytest.mark.parametrize("name", ["demo", "network4_pad8"])
def test_cp_iteration_matches_jax(name):
    """All six outputs of one step and its residuals, on the same random
    iterates, step sizes 0.3 / 0.2."""
    sp, jsp, x0 = _pair(name)
    rng = np.random.default_rng(7)
    z, eta = random_primal(jsp, rng), random_dual(jsp, rng)
    jz, jeta = JPrimal(*map(jnp.asarray, z)), JDual(*map(jnp.asarray, eta))
    want = jax.jit(lambda jsp, z, e: jsolver.cp_iteration(
        jsp, z, e, jop.ell(jsp, z), jop.ell_t(jsp, e), 0.3, 0.2,
        jnp.asarray(x0)))(jsp, jz, jeta)
    pz, peta = Primal(*map(T, z)), Dual(*map(T, eta))
    got = port_solver.cp_iteration(sp, pz, peta, ell(sp, pz),
                                   ell_t(sp, peta), 0.3, 0.2, T(x0))
    for k, (g, w) in enumerate(zip(got, want)):
        if isinstance(g, torch.Tensor):
            _close(g, w, f"output {k}")
        else:
            for field, gl, wl in zip(g._fields, g, w):
                _close(gl, wl, f"output {k} {field}")
    # the step alone is _cp_step's, and the residuals are its own
    step = port_solver._cp_step(sp, pz, peta, ell(sp, pz), ell_t(sp, peta),
                                0.3, 0.2, T(x0))
    for a, b in zip(tree_flatten(step)[0], tree_flatten(got[:4])[0]):
        assert torch.equal(a, b)


# -- the stage path -------------------------------------------------------

@pytest.mark.parametrize("name", ["network3", "network4_pad8", "demo"])
def test_stage_path_matches_jax_and_the_twin(name):
    """``project_dynamics_stages`` against the JAX package's
    ``project_dynamics`` (its XLA stage path off the TPU) and, on a tree K1
    takes, against K1's plain twin."""
    sp, jsp, x0 = _pair(name)
    rng = np.random.default_rng(11)
    x_in = rng.standard_normal((sp.np_pad, sp.n))
    u_in = rng.standard_normal((sp.nl_pad, sp.m))
    x, u = prox.project_dynamics_stages(sp, T(x_in), T(u_in), T(x0))
    jx, ju = jax.jit(jprox.project_dynamics, static_argnums=())(
        jsp, jnp.asarray(x_in), jnp.asarray(u_in), jnp.asarray(x0))
    _close(x, jx, "x against JAX")
    _close(u, ju, "u against JAX")
    assert sweep.sweep_eligible(sp) == name.startswith("network")
    if sweep.sweep_eligible(sp):
        tx, tu = sweep.project_dynamics_sweep_ref(sp, T(x_in), T(u_in),
                                                  T(x0))
        _close(x, tx, "x against the twin")
        _close(u, tu, "u against the twin")


@pytest.fixture
def twin_calls(monkeypatch):
    """Counts the calls of K1's plain twin (K1's path on the CPU)."""
    calls = []
    real = sweep.project_dynamics_sweep_ref

    def spy(*args):
        calls.append(1)
        return real(*args)

    monkeypatch.setattr(sweep, "project_dynamics_sweep_ref", spy)
    return calls


def test_stage_path_switch_routes_prox_f(twin_calls):
    """Inside ``stage_path()`` prox_f takes the stage path (the twin is not
    called and the projection is ``project_dynamics_stages``'s); outside
    it K1's path again, with the same result as before."""
    sp, x0 = _port("network4_pad8")
    rng = np.random.default_rng(3)
    z = Primal(*(T(rng.standard_normal(tuple(l.shape)))
                 for l in sp.zero_primal()))
    before = prox.prox_f(sp, z, 0.1, T(x0))
    assert len(twin_calls) == 1
    with sweep.stage_path():
        assert not sweep.sweep_eligible(sp)
        inside = prox.prox_f(sp, z, 0.1, T(x0))
    assert len(twin_calls) == 1
    s = torch.cat([z.s[:1] - 0.1, z.s[1:]])
    x, u = prox.project_dynamics_stages(sp, z.x, z.u, T(x0))
    assert torch.equal(inside.x, x) and torch.equal(inside.u, u)
    _close(inside.x, before.x, "the stage path against K1's")
    y, tau, s = prox.project_kernel(sp, z.y, z.tau, s)
    assert torch.equal(inside.s, s) and torch.equal(inside.y, y)
    after = prox.prox_f(sp, z, 0.1, T(x0))
    assert len(twin_calls) == 2 and sweep.sweep_eligible(sp)
    for a, b in zip(after, before):
        assert torch.equal(a, b)


def test_stage_path_switch_is_scoped():
    """The previous state returns on exit, after an exception and from a
    nested block; the default is K1's path."""
    sp, _ = _port("network3")
    assert sweep.sweep_eligible(sp)
    with pytest.raises(RuntimeError, match="inside"):
        with sweep.stage_path():
            raise RuntimeError("inside")
    assert sweep.sweep_eligible(sp)
    with sweep.stage_path():
        with sweep.stage_path():
            pass
        assert not sweep.sweep_eligible(sp)
    assert sweep.sweep_eligible(sp)
    # the switch is no gate of K1's own wrapper, which a caller may still
    # call on a tree it takes
    with sweep.stage_path():
        x, u = sweep.project_dynamics_sweep(
            sp, torch.zeros(sp.np_pad, sp.n, dtype=sp.dtype),
            torch.zeros(sp.nl_pad, sp.m, dtype=sp.dtype),
            torch.zeros(sp.n, dtype=sp.dtype))
    assert x.shape == (sp.np_pad, sp.n)


# -- the work counts ------------------------------------------------------

class _Census(TorchDispatchMode):
    """Records the outside tensors each op reads: an outside tensor is
    one the caller handed in (a leaf of an input or a table of the
    problem), keyed by its storage; ops that read no data (views, the
    ``*_like`` and ``new_*`` factories) are not reads."""

    _NO_READ = {"new_zeros", "new_empty", "new_ones", "new_full",
                "empty_like", "zeros_like", "ones_like", "full_like"}

    def __init__(self, outside):
        super().__init__()
        self.outside = outside
        self.read = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.overloadpacket.__name__ not in self._NO_READ \
                and not func.is_view:
            for a in tree_flatten((args, kwargs))[0]:
                if isinstance(a, torch.Tensor):
                    key = a.untyped_storage().data_ptr()
                    if key in self.outside:
                        self.read.add(key)
        return func(*args, **kwargs)


def _views(tensors):
    """storage -> {distinct view: bytes} of ``tensors``."""
    out = {}
    for t in tensors:
        out.setdefault(t.untyped_storage().data_ptr(), {})[
            (t.data_ptr(), tuple(t.shape), t.stride())] = \
            t.numel() * t.element_size()
    return out


def _tensors(obj):
    """Every tensor of ``obj``: a tensor, a tuple or list of them, a
    problem (its fields, mode-grouped matrices included)."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, (tuple, list)):
        return [t for o in obj for t in _tensors(o)]
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return [t for f in dataclasses.fields(obj)
                for t in _tensors(getattr(obj, f.name))]
    return []


def census(fn, sp, *inputs):
    """Bytes of the distinct outside tensors ``fn`` reads (each as the
    caller handed it) plus the distinct tensors it returns that are not
    inputs (views of one result summed, a view returned twice once)."""
    outside = _views(_tensors(sp) + _tensors(inputs))
    with _Census(outside) as mode:
        out = fn()
    reads = sum(sum(outside[k].values()) for k in mode.read)
    returned = _views([t for t in tree_flatten(out)[0]
                       if isinstance(t, torch.Tensor)])
    writes = sum(sum(v.values()) for k, v in returned.items()
                 if k not in outside)
    return reads + writes


def flops(fn):
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


def _state(sp, x0, seed=0):
    """A random primal and dual (every leaf its own tensor), L z and L'eta
    as the loop carries them, two step sizes, x0 and the half-shift."""
    rng = np.random.default_rng(seed)
    z = Primal(*(T(rng.standard_normal(tuple(l.shape)))
                 for l in sp.zero_primal()))
    eta = Dual(*(T(rng.standard_normal(tuple(l.shape)))
                 for l in sp.zero_dual()))
    return dict(z=z, eta=eta, Lz=ell(sp, z), Lt=ell_t(sp, eta),
                a1=T(0.01), a2=T(0.02), x0=T(x0),
                shift=prox.half_shift_dual(sp))


def _components(sp, v):
    """name -> (call, its inputs, the work count)."""
    z, eta, x0 = v["z"], v["eta"], v["x0"]
    step = (z, eta, v["Lz"], v["Lt"], v["a1"], v["a2"], x0, v["shift"])
    return {
        "ell": (lambda: ell(sp, z), (z,), work.ell(sp)),
        "ell_t": (lambda: ell_t(sp, eta), (eta,), work.ell_t(sp)),
        "project_dynamics_stages": (
            lambda: prox.project_dynamics_stages(sp, z.x, z.u, x0),
            (z.x, z.u, x0), work.project_dynamics_stages(sp)),
        "project_kernel": (
            lambda: prox.project_kernel(sp, z.y, z.tau, z.s),
            (z.y, z.tau, z.s), work.project_kernel(sp)),
        "prox_f": (lambda: prox.prox_f(sp, z, v["a1"], x0),
                   (z, v["a1"], x0), work.prox_f(sp)),
        "g_conj_projections": (lambda: prox.g_conj_projections(sp, eta),
                               (eta,), work.g_conj_projections(sp)),
        "max_norm": (lambda: tree_inf_norm(z), (z,), work.max_norm(sp)),
        "cp_step": (lambda: port_solver._cp_step(sp, *step), step,
                    work.cp_step(sp)),
        "cp_iteration": (lambda: port_solver.cp_iteration(sp, *step), step,
                         work.cp_iteration(sp)),
    }


COMPONENTS = ["ell", "ell_t", "project_dynamics_stages", "project_kernel",
              "prox_f", "g_conj_projections", "max_norm", "cp_step",
              "cp_iteration"]


@pytest.mark.parametrize("component", COMPONENTS)
@pytest.mark.parametrize("tree", sorted(TREES))
def test_work_counts_equal_the_flop_counter_and_the_census(tree, component):
    """The contraction count equals ``FlopCounterMode``'s, and the
    compulsory bytes the census of what the call reads from outside and
    returns; the total adds the elementwise work."""
    sp, x0 = _port(tree)
    fn, inputs, count = _components(sp, _state(sp, x0))[component]
    assert flops(fn) == count["flop_mm"]
    assert census(fn, sp, *inputs) == count["bytes"]
    assert count["flop"] == count["flop_mm"] + count["flop_ew"]
    assert count["flop_ew"] >= 0
    if "bytes_unfused" in count:
        assert count["bytes_unfused"] > count["bytes"]


@pytest.mark.parametrize("tree", ["network4_pad8", "demo"])
@pytest.mark.parametrize("unroll", [1, 3])
def test_production_trip_count(tree, unroll):
    """The roofline's production trip (``unroll`` steps, the residuals of
    the last, the host's read): per iteration, its contractions and its
    census over ``unroll``."""
    sp, x0 = _port(tree)
    v = _state(sp, x0)
    args = (v["z"], v["eta"], v["Lz"], v["Lt"], v["a1"], v["a2"], v["x0"],
            v["shift"])
    count = work.production_trip(sp, unroll)

    def fn():
        return roofline.trip(sp, *args, unroll=unroll)

    assert flops(fn) == pytest.approx(unroll * count["flop_mm"], rel=1e-12)
    assert census(fn, sp, *args) == pytest.approx(unroll * count["bytes"],
                                                  rel=1e-12)
    step = work.cp_step(sp)
    assert count["bytes"] < step["bytes"] or unroll == 1
    assert count["bytes_unfused"] > unroll * count["bytes"] or unroll == 1


@pytest.mark.parametrize("tree", sorted(TREES))
def test_project_dynamics_count_is_k1s_where_k1_runs(tree):
    """``work.project_dynamics`` is K1's count (``sweep_work``) on a tree
    K1 takes, whose operations equal the stage path's contractions; the
    stage path's count elsewhere."""
    sp, _ = _port(tree)
    count, stages = work.project_dynamics(sp), \
        work.project_dynamics_stages(sp)
    if sweep.sweep_eligible(sp):
        assert count["bytes"] == sweep.sweep_work(sp)["bytes"]
        assert count["flop"] == count["flop_mm"] == stages["flop_mm"]
    else:
        assert count == stages


def test_bound_takes_the_larger_time():
    """Bytes over 3.35 TB/s against operations over the type's rates."""
    assert work.bound(dict(flop=0, bytes=3.35e12), torch.float32) \
        == (1.0, "bytes")
    secs, by = work.bound(dict(flop=2 * 67e12, flop_mm=67e12, flop_ew=67e12,
                               bytes=1.0), torch.float32)
    assert (secs, by) == (2.0, "operations")
    secs, by = work.bound(dict(flop=2 * 34e12, flop_mm=34e12, flop_ew=34e12,
                               bytes=1.0), torch.float64)
    assert (secs, by) == (1.0, "operations")


def test_xla_cost_beside_the_port_count(capsys):
    """XLA's ``cost_analysis()`` of the JAX package's L and L' beside the
    port's counts (printed, not compared: XLA counts every fused op's
    operands, the port the compulsory traffic), on the 364-node n=50
    network in float32."""
    kwargs = dict(num_states=50, num_inputs=20, num_modes=3, num_stages=5,
                  stopping_time=5)
    port_spec, _ = port_models.random_network_problem(**kwargs)
    jax_spec, _ = jax_models.random_network_problem(**kwargs)
    sp = build_stacked(port_spec, dtype=torch.float32, device="cpu")
    jsp = jax_build(jax_spec, dtype=jnp.float32)
    z = jsp.zero_primal()
    eta = jsp.zero_dual()
    for name, fn, arg, count in (("ell", jop.ell, z, work.ell(sp)),
                                 ("ell_t", jop.ell_t, eta, work.ell_t(sp))):
        cost = jax.jit(lambda a, fn=fn: fn(jsp, a)).lower(arg).compile() \
            .cost_analysis()
        cost = cost[0] if isinstance(cost, (list, tuple)) else cost
        xla_flop, xla_bytes = cost.get("flops", 0.0), \
            cost.get("bytes accessed", 0.0)
        with capsys.disabled():
            print(f"\n{name} at {sp.num_nodes} nodes, float32: XLA-CPU "
                  f"{xla_flop:.0f} flop, {xla_bytes:.0f} bytes; the port "
                  f"{count['flop']} flop ({count['flop_mm']} in products), "
                  f"{count['bytes']} bytes; XLA / port "
                  f"{xla_flop / count['flop']:.3f} flop, "
                  f"{xla_bytes / count['bytes']:.3f} bytes")
        assert count["flop"] > 0 and count["bytes"] > 0


# -- the scripts ----------------------------------------------------------

def test_roofline_rows_are_the_jax_scripts_and_two_more():
    """The JAX script's seven rows and K1's and the kernel projection's;
    every apply runs on the CPU and takes its previous outputs."""
    sp, x0 = _port("network3")
    rows = roofline.components(sp, x0, unroll=2)
    assert [r[0] for r in rows] == [
        "L apply", "L' apply", "project_dynamics (K1)", "project_kernel",
        "prox_f", "g* projections", "cp_step (2 applies + prox)",
        "cp_iteration (step + residuals)", "production trip / iteration"]
    for name, apply, count, per in rows:
        apply()
        apply()
        assert count["bytes"] > 0 and per == (2 if "trip" in name else 1)
    with pytest.raises(RuntimeError, match="card"):
        roofline.rows(sp, x0)
    with pytest.raises(RuntimeError, match="card"):
        bench_pallas.ab_row("network3", sp, x0)


@pytest.mark.parametrize("script", [roofline, bench_pallas, bench_sweep])
def test_scripts_refuse_without_a_card(script, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        script.main([])

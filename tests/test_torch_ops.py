"""The port's batched ops against the JAX package's on the same NumPy
inputs (float64): the cone projections, L / L' on every branch (and their
adjointness), prox_f and the dual-prox projections, at 1e-10."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import raocp_tpu.models as jax_models  # noqa: E402
import raocp_tpu.ops.cones as jcones  # noqa: E402
import raocp_tpu.ops.operator as jop  # noqa: E402
import raocp_tpu.ops.prox as jprox  # noqa: E402
from raocp_tpu.core.stacked import build_stacked as jax_build  # noqa: E402
from raocp_tpu.core.variables import Dual as JDual  # noqa: E402
from raocp_tpu.core.variables import Primal as JPrimal  # noqa: E402
import raocp_tpu_torch.models as port_models  # noqa: E402
import raocp_tpu_torch.ops.cones as cones  # noqa: E402
from raocp_tpu_torch.core.stacked import build_stacked  # noqa: E402
from raocp_tpu_torch.core.variables import Dual, Primal  # noqa: E402
from raocp_tpu_torch.ops.operator import ell, ell_t  # noqa: E402
from raocp_tpu_torch.ops.prox import (g_conj_projections,  # noqa: E402
                                      half_shift_dual, prox_f, prox_g_conj)
from util import random_dual, random_primal  # noqa: E402

TOL = 1e-10


def T(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def close(got, want, tol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)


# -- cones ------------------------------------------------------------------

def _cone_inputs():
    rng = np.random.default_rng(0)
    v = rng.standard_normal((40, 5))
    v[0] = 0.0                                   # the origin
    t = rng.standard_normal(40) * 2.0
    t[1] = -10.0                                 # deep in the polar cone
    t[2] = 10.0                                  # inside the cone
    t[0] = 0.0
    return v, t


def test_soc_projection_matches_jax():
    v, t = _cone_inputs()
    px, pt = cones.soc_project_parts(T(v), T(t))
    jx, jt = jcones.soc_project_parts(jnp.asarray(v), jnp.asarray(t))
    close(px, jx)
    close(pt, jt)
    stacked = np.concatenate([v, t[:, None]], axis=1)
    close(cones.soc_project(T(stacked)), jcones.soc_project(stacked))
    assert torch.isfinite(px).all() and torch.all(px[0] == 0)


def test_box_ball_constraint_projection_matches_jax():
    rng = np.random.default_rng(1)
    v = 3.0 * rng.standard_normal((30, 4))
    lo = -rng.random((30, 4))
    hi = rng.random((30, 4))
    lo[:10] = -np.inf                            # unbounded rows
    hi[5:15] = np.inf
    c = rng.standard_normal((30, 4))
    r = rng.random(30) + 0.5
    r[::2] = np.inf                              # box rows
    v[3] = c[3]                                  # at a ball centre
    close(cones.box_project(T(v), T(lo), T(hi)),
          jcones.box_project(v, lo, hi))
    close(cones.ball_project(T(v), T(c), T(r)),
          jcones.ball_project(v, c, r))
    got = cones.constraint_project(T(v), T(lo), T(hi), T(c), T(r))
    close(got, jcones.constraint_project(v, lo, hi, c, r))
    assert torch.isfinite(got).all()
    close(cones.nonneg_project(T(v)), jcones.nonneg_project(v))


@pytest.mark.parametrize("with_soc", [False, True])
def test_risk_dual_projection_matches_jax(with_soc):
    rng = np.random.default_rng(2)
    v = rng.standard_normal((12, 7))
    v[0] = 0.0
    free = rng.random((12, 7)) < 0.2
    zero = (rng.random((12, 7)) < 0.2) & ~free
    soc = tail = None
    if with_soc:
        soc = np.zeros((12, 7), bool)
        tail = np.zeros((12, 7), bool)
        soc[:, 3:6] = True
        tail[:, 6] = True
        free[:, 3:] = zero[:, 3:] = False
        v[1, 6] = -10.0                          # polar
        v[2, 6] = 10.0                           # inside
    got = cones.risk_dual_project(
        T(v), torch.as_tensor(free), torch.as_tensor(zero),
        None if soc is None else torch.as_tensor(soc),
        None if tail is None else torch.as_tensor(tail))
    want = jcones.risk_dual_project(v, free, zero, soc, tail)
    close(got, want)
    assert torch.isfinite(got).all()


# -- operators and prox maps ------------------------------------------------

FIXTURES = {
    "demo": ("demo_problem", {}, 1),
    "demo_pad4": ("demo_problem", {}, 4),
    "ragged_dense": ("demo_problem", dict(num_stages=4, stopping_time=4), 1),
    "mass_spring_chain": ("mass_spring_problem",
                          dict(num_stages=5, stopping_time=2), 1),
    "random_network": ("random_network_problem",
                       dict(num_states=6, num_inputs=3, num_modes=3,
                            num_stages=4, stopping_time=4), 1),
    "soc_network_pad4": ("soc_network_problem",
                         dict(num_states=4, num_inputs=2, num_modes=2,
                              num_stages=4, stopping_time=2), 4),
}


def _pair(name, branch="default"):
    family, kwargs, pad = FIXTURES[name]
    port_spec, x0 = getattr(port_models, family)(**kwargs)
    jax_spec, _ = getattr(jax_models, family)(**kwargs)
    port = build_stacked(port_spec, dtype=torch.float64, pad_multiple=pad)
    ref = jax_build(jax_spec, dtype=jnp.float64, pad_multiple=pad)
    if branch != "default":
        # force L / L' onto the fused-modal or the unfused branch
        none = tuple(None for _ in port.qr_fwd)
        changes = dict(qr_fwd=none, qr_bwd=none)
        if branch == "unfused":
            changes["QRm"] = None
        port = dataclasses.replace(port, **changes)
        ref = dataclasses.replace(ref, **changes)
    return port, ref, x0


def _to_port(tree, cls):
    return cls(*(T(v) for v in tree))


def _to_jax(tree, cls):
    return cls(*(jnp.asarray(np.asarray(v)) for v in tree))


CASES = [("demo", "default"), ("demo_pad4", "default"),
         ("ragged_dense", "default"), ("mass_spring_chain", "default"),
         ("random_network", "default"), ("random_network", "modal"),
         ("random_network", "unfused"), ("demo", "unfused"),
         ("soc_network_pad4", "default")]


@pytest.mark.parametrize("name,branch", CASES)
def test_ell_and_adjoint_match_jax(name, branch):
    sp, jsp, _ = _pair(name, branch)
    rng = np.random.default_rng(3)
    z = random_primal(jsp, rng)
    eta = random_dual(jsp, rng)
    Lz = ell(sp, _to_port(z, Primal))
    Lt = ell_t(sp, _to_port(eta, Dual))
    want_z, want_t = jax.jit(lambda jsp, z, eta: (jop.ell(jsp, z),
                                                  jop.ell_t(jsp, eta)))(
        jsp, _to_jax(z, JPrimal), _to_jax(eta, JDual))
    for got, want in zip(Lz, want_z):
        close(got, want)
    for got, want in zip(Lt, want_t):
        close(got, want)
    lhs = sum(float(torch.vdot(a.reshape(-1), T(b).reshape(-1)))
              for a, b in zip(Lz, eta))
    rhs = sum(float(torch.vdot(T(a).reshape(-1), b.reshape(-1)))
              for a, b in zip(z, Lt))
    assert lhs == pytest.approx(rhs, rel=1e-12, abs=1e-10)


@pytest.mark.parametrize("name", ["demo", "demo_pad4", "ragged_dense",
                                  "mass_spring_chain", "random_network",
                                  "soc_network_pad4"])
def test_prox_maps_match_jax(name):
    sp, jsp, x0 = _pair(name)
    rng = np.random.default_rng(4)
    z = random_primal(jsp, rng)
    eta = random_dual(jsp, rng)
    alpha = 0.37
    scaled = Dual(*(3.0 * v for v in eta))

    @jax.jit                     # one compile instead of many eager ops
    def reference(jsp, z, eta, scaled, x0):
        return (jprox.prox_f(jsp, z, alpha, x0),
                jprox.g_conj_projections(jsp, scaled),
                jprox.prox_g_conj(jsp, eta, alpha))

    want_f, want_g, want_gc = reference(
        jsp, _to_jax(z, JPrimal), _to_jax(eta, JDual),
        _to_jax(scaled, JDual), jnp.asarray(x0))
    got = prox_f(sp, _to_port(z, Primal), alpha, T(x0))
    for g, w in zip(got, want_f):
        close(g, w)
    # ghost rows stay zero
    assert torch.all(got.x[sp.num_nodes:] == 0)
    assert torch.all(got.u[sp.num_nonleaf:] == 0)
    for g, w in zip(g_conj_projections(sp, _to_port(scaled, Dual)), want_g):
        close(g, w)
    for g, w in zip(prox_g_conj(sp, _to_port(eta, Dual), alpha), want_gc):
        close(g, w)
    for g, w in zip(half_shift_dual(sp), jprox.half_shift_dual(jsp)):
        close(g, w)

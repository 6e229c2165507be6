"""The ball sets of BASELINE config 3 on both sides: the reference's
projection against the port's ``Ball.project``, its Moreau combine against
the prox of the ball's support function, a problem whose balls bind solved
by the system and judged by the reference, and the seed's signs under the
balls. At 40 nodes on the CPU."""

import numpy as np
import pytest
import torch

from benchmark import system
from benchmark.reference import problem as bp
from benchmark.reference.cp import DUAL, Reference, _ball
from benchmark.reference.judge import Judge
from benchmark.tests.conftest import TINY


def _config(**over):
    return dict(bp.load_config("config3_soc_network_3k"), **TINY, **over)


def _rows(seed=7, count=64, width=12):
    """Rows whose norms run from about 0.03 to 300."""
    g = torch.Generator().manual_seed(seed)
    v = torch.randn((count, width), generator=g, dtype=torch.float64)
    return v * torch.logspace(-2, 2, count, dtype=torch.float64)[:, None]


@pytest.mark.parametrize("radius", [0.5, 10.0])
def test_the_ball_projection_is_the_ports(radius):
    from raocp_tpu_torch import Ball, Nonleaf

    v = _rows()
    got = _ball(v, radius)
    ball = Ball(Nonleaf(), radius)
    want = np.stack([ball.project(row) for row in v.numpy()])
    assert np.allclose(got.numpy(), want, rtol=1e-14, atol=0.0)
    inside = torch.linalg.vector_norm(v, dim=1) <= radius
    assert inside.any() and (~inside).any()
    assert torch.equal(got[inside], v[inside])
    assert torch.allclose(torch.linalg.vector_norm(got[~inside], dim=1),
                          torch.full(((~inside).sum(),), radius,
                                     dtype=torch.float64), rtol=1e-14)


@pytest.mark.parametrize("alpha", [0.05, 0.3, 2.0])
def test_the_moreau_combine_is_the_prox_of_the_support_function(alpha):
    """g's part on e7 and e14 is the ball's indicator, whose conjugate is
    r ||.||: prox of alpha r ||.|| shrinks a row's norm by alpha r, and a
    row of norm alpha r or less goes to 0."""
    radius = 0.5
    ref = Reference(_config(radius=radius), bp.plant(_config()),
                    bp.config_tree(_config()), "cpu", torch.float64)
    g = torch.Generator().manual_seed(11)
    e = {k: 3.0 * torch.randn(v.shape, generator=g, dtype=torch.float64)
         for k, v in ref.zero_dual().items()}
    for key in ("e7", "e14"):              # rows inside and outside
        e[key] *= torch.logspace(-3, 1, len(e[key]),
                                 dtype=torch.float64)[:, None]
    out = ref.prox_g_conj({k: v.clone() for k, v in e.items()}, alpha)
    assert set(out) == set(DUAL)
    for key in ("e7", "e14"):
        v = e[key]
        norm = torch.linalg.vector_norm(v, dim=1, keepdim=True)
        want = v * torch.clamp_min(1.0 - alpha * radius / norm, 0.0)
        assert torch.allclose(out[key], want, rtol=1e-12, atol=1e-14)
        # Moreau: v = prox_{alpha h*}(v) + alpha P(v / alpha)
        assert torch.allclose(out[key] + alpha * _ball(v / alpha, radius),
                              v, rtol=1e-12, atol=1e-14)
        shrunk = torch.linalg.vector_norm(out[key], dim=1)
        assert (shrunk == 0).any() and (shrunk > 0).any()


def _solve(config, x0, **kw):
    pl = bp.plant(config)
    solver = system.make_solver(system.build_problem(config, pl, pl.v),
                                config, "cpu", [])
    return solver.solve(x0, tol=1e-3, max_iters=20000, check_every=25,
                        **kw)


def test_a_binding_ball_is_judged_by_its_own_set():
    """With a radius a little above |x0| the nonleaf ball binds at the
    root: the system's answer sits on the sphere, the reference with the
    same ball passes it, and the reference with a larger ball (another
    problem) does not."""
    cfg = _config()
    x0 = 0.5 * bp.plant(cfg).x0
    radius = 1.05 * float(np.linalg.norm(x0))
    cfg = _config(radius=radius)
    res = _solve(cfg, x0)
    assert res.status == 0
    n = cfg["num_states"]
    tree = bp.config_tree(cfg)
    xu = np.concatenate([res.primal.x[:tree.num_nonleaf, :n],
                         res.primal.u[:tree.num_nonleaf, :cfg["num_inputs"]]],
                        axis=1)
    assert np.linalg.norm(xu, axis=1).max() == pytest.approx(radius,
                                                             rel=1e-3)
    answer = dict(primal=res.primal._asdict(), dual=res.dual._asdict())
    own = Judge(cfg, 1e-3, "cpu").numbers(answer, x0)
    other = Judge(_config(radius=2 * radius), 1e-3, "cpu").numbers(answer,
                                                                    x0)
    assert own["xi_ratio"] <= 1.5
    assert other["xi_ratio"] > 5.0


def test_a_seed_changes_the_inputs_and_not_the_work_under_balls():
    """x0 and -x0 take the same iterations and mirrored answers, bit for
    bit: balls centred at 0 keep the problem symmetric under x -> -x."""
    cfg = _config()
    x0 = 0.5 * bp.plant(cfg).x0
    cfg = _config(radius=1.05 * float(np.linalg.norm(x0)))
    a, b = (_solve(cfg, s * x0) for s in (1.0, -1.0))
    assert a.num_iters == b.num_iters
    assert np.array_equal(a.primal.x, -b.primal.x)
    assert np.array_equal(a.primal.u, -b.primal.u)
    assert np.array_equal(a.primal.s, b.primal.s)

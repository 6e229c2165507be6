"""Batched conic projections on tensors (counterpart of
:mod:`raocp_tpu.ops.cones`).

Elementwise max/clamp for the orthant and box, a select-based three-case
formula for the second-order cone, and a masked orthant+identity map for the
(padded) risk ambiguity dual cone. Every projection takes [..., rows, cols]
(a leading lane axis included) and broadcasts the per-row tables. All are
safe under padding: zero inputs map to zero outputs, and no select branch
that is not taken can put a NaN into the result.
"""

import torch

__all__ = ["nonneg_project", "box_project", "ball_project",
           "constraint_project", "soc_project", "soc_project_parts",
           "risk_dual_project"]


def nonneg_project(v):
    """Projection onto R^n_+ (self-dual)."""
    return torch.clamp_min(v, 0)


def ball_project(v, c, r):
    """Projection onto the Euclidean ball ||v - c|| <= r over the last axis.

    ``r = +inf`` rows are the identity (inactive), and the zero-vector /
    zero-padding rows stay zero — both via selects, no NaNs."""
    dv = v - c
    norm = torch.sqrt(torch.sum(dv * dv, dim=-1))
    safe = torch.where(norm > 0, norm, torch.ones_like(norm))
    scale = torch.where(norm > r, r / safe, torch.ones_like(norm))
    return c + dv * scale[..., None]


def box_project(v, lo, hi):
    """Projection onto the box [lo, hi] (+-inf entries = unbounded)."""
    return torch.minimum(torch.maximum(v, lo), hi)


def constraint_project(v, lo, hi, c, r):
    """Per-node constraint-set projection: rows with finite ``r`` are
    Euclidean balls (``Ball``), the rest boxes (``Rectangle``; +-inf
    bounds = unconstrained/identity). One batched select."""
    return torch.where(torch.isfinite(r)[..., None],
                       ball_project(v, c, r),
                       box_project(v, lo, hi))


def soc_project_parts(x, t):
    """Projection onto the second-order cone {(x, t): ||x|| <= t}.

    ``x``: [..., k] head, ``t``: [...] tail. Returns (proj_x, proj_t).
    Three-case formula (parity: reference ``cones.py:113-135``) with
    selects."""
    nx = torch.sqrt(torch.sum(x * x, dim=-1))
    in_cone = nx <= t
    in_polar = nx <= -t
    half = 0.5 * (nx + t)
    # guard the 0/0 at the origin (the origin is in the cone)
    safe_nx = torch.where(nx > 0, nx, torch.ones_like(nx))
    scale = torch.where(in_cone, torch.ones_like(nx), half / safe_nx)
    scale = torch.where(in_polar, torch.zeros_like(nx), scale)
    proj_x = x * scale[..., None]
    proj_t = torch.where(in_cone, t,
                         torch.where(in_polar, torch.zeros_like(t), half))
    return proj_x, proj_t


def soc_project(v):
    """SOC projection of stacked [..., k] vectors (last coordinate = t)."""
    proj_x, proj_t = soc_project_parts(v[..., :-1], v[..., -1])
    return torch.cat([proj_x, proj_t[..., None]], dim=-1)


def risk_dual_project(v, free_rows, zero_rows, soc_rows=None, soc_tail=None):
    """Projection onto the dual of each node's risk ambiguity cone.

    The cone is any Cartesian product of NnOC / Zero / Real rows plus at
    most one SecondOrderCone block, described by per-node boolean row masks
    ([nl_pad, Y], natural row order): ``free_rows`` marks Zero-cone rows
    (dual = R, projection = identity), ``zero_rows`` marks Real-cone rows
    (dual = {0}, projection = 0); all other non-SOC rows are NnOC
    (max(0, .)). ``soc_rows`` / ``soc_tail`` (both None when no node has an
    SOC block) mark the member / radial rows of the node's SOC block,
    projected jointly with the three-case formula (self-dual).
    """
    zero = torch.zeros_like(v)
    rowwise = torch.where(free_rows, v,
                          torch.where(zero_rows, zero, torch.clamp_min(v, 0)))
    if soc_rows is None:
        return rowwise
    x = v * soc_rows                                        # member rows
    nx = torch.sqrt(torch.sum(x * x, dim=-1))               # [..., NL]
    t = torch.sum(v * soc_tail, dim=-1)                     # radial
    inside = nx <= t
    polar = nx <= -t
    t_half = 0.5 * (nx + t)
    one, nil = torch.ones_like(nx), torch.zeros_like(nx)
    tiny = torch.finfo(v.dtype).tiny
    x_coef = torch.where(inside, one,
                         torch.where(polar, nil,
                                     t_half / torch.clamp_min(nx, tiny)))
    t_new = torch.where(inside, t, torch.where(polar, nil, t_half))
    return torch.where(soc_rows, x_coef[..., None] * v,
                       torch.where(soc_tail, t_new[..., None], rowwise))

"""Subtree partition: replicated-spine SPMD execution of the CP loop
(counterpart of :mod:`raocp_tpu.parallel.subtree`).

Layout. Pick a frontier stage ``f``:

* stages ``[0, f)`` (the spine) are replicated on every rank, a few nodes
  computed redundantly;
* stage ``f`` is padded to a multiple of the rank count D with ghost
  subtree roots, and every stage ``k >= f`` is split into D equal
  contiguous chunks. The tree is stage-major and branching below the
  frontier is uniform, so rank d's chunk of stage ``k+1`` is exactly the
  children of its chunk of stage ``k``: each rank owns complete subtrees,
  and every child reduction and parent expansion below the frontier is
  rank-local. Ghost rows carry zero data and stay zero through every op.

The one exchange of a sweep is the frontier crossing: the child reductions
from stage ``f`` to its replicated stage-``f-1`` parents complete with an
all-reduce (``ops.operator._frontier_psum``); the residual max-norms and
the power iteration's inner products reduce with one more each.

Execution model. One process a rank (``torch.distributed``), each holding
only its own block on its device: :func:`build_subtree_problem` builds the
global problem on the host and uploads this rank's rows. The block is a
:class:`~raocp_tpu_torch.core.stacked.StackedProblem` whose ``frontier`` /
``spmd_group`` / ``spmd_ndev`` turn the collective hooks on; the solver's
ops run on it unchanged. :func:`subtree_plan` computes every index array of
every rank on the host alone, so a test can hold it against the JAX
package's partition in one process.
"""

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from raocp_tpu_torch.core.modal import ModalMatrix, upload
from raocp_tpu_torch.core.stacked import (StackedProblem, _torch_dtype,
                                          build_stacked, default_dtype)
from raocp_tpu_torch.core.variables import Dual, Primal
from raocp_tpu_torch.parallel.sharding import AXIS, gather_rows, mesh_device

__all__ = ["SubtreePlan", "SubtreeProblem", "build_subtree_problem",
           "choose_frontier", "subtree_eligible", "subtree_plan"]

# field -> node space of its rows
_NP_FIELDS = ("nz_mask", "A", "B", "P", "Abar", "riccati_cls")
_NL_FIELDS = ("b_pad", "y_mask", "risk_free_rows", "risk_zero_rows",
              "risk_soc_rows", "risk_soc_tail", "nl_lo", "nl_hi",
              "nl_active", "nl_ball_c", "nl_ball_r", "Rinv", "K", "sumAPB",
              "Pi")
_LF_FIELDS = ("l_lo", "l_hi", "l_active", "l_ball_c", "l_ball_r")
_MODAL_NP = ("Am", "Bm", "ABm", "sqrtQ", "sqrtR", "QRm")
_MODAL_LF = ("sqrtP",)
_STAGE_FIELDS = ("ab_fwd", "ab_bwd", "qr_fwd", "qr_bwd", "k_s", "rinv_s",
                 "sumapb_s", "k_ms", "rinv_ms", "sumapb_ms")
# the four stage-stacked mode blocks are forced ragged (None) at the
# frontier, so it takes the masked gather and the all-reduce
_FRONTIER_RAGGED = ("ab_fwd", "ab_bwd", "qr_fwd", "qr_bwd")

# per-field ghost-row fill (default 0; bounds stay inactive on ghosts)
_FILLS = {"nl_lo": -np.inf, "nl_hi": np.inf, "nl_ball_r": np.inf,
          "l_lo": -np.inf, "l_hi": np.inf, "l_ball_r": np.inf}

_PRIMAL_SPACES = dict(x="np", u="nl", y="nl", tau="np", s="np")
_DUAL_SPACES = dict(e1="nl", e2="nl", e3="np", e4="np", e5="np", e6="np",
                    e7="nl", e11="lf", e12="lf", e13="lf", e14="lf")


def _stage_structure(obj):
    """(num_stages, stage_start, stage_child) of a StackedProblem, a bare
    ScenarioTree, or an RAOCP spec: frontier eligibility is a function of
    the stage structure alone, so a Solver decides the partition before
    paying for a stacked build."""
    src = obj.tree if hasattr(obj, "tree") else obj
    return (src.num_stages, tuple(int(v) for v in src.stage_start),
            tuple(src.stage_child))


def _frontier_candidates(obj):
    """Stages f such that branching is uniform from stage f-1 down (the
    position arithmetic of the padded forest needs it); spine stages above
    may be arbitrarily ragged."""
    ns, _, sc = _stage_structure(obj)
    ok_from = ns - 1                     # smallest j with sc[j:] all uniform
    for j in range(ns - 2, -1, -1):
        if sc[j] is None:
            break
        ok_from = j
    return [f for f in range(1, ns) if f - 1 >= ok_from]


def subtree_eligible(obj) -> bool:
    """True when the tree (or built problem, or spec) admits a frontier."""
    return bool(_frontier_candidates(obj))


def choose_frontier(obj, num_devices: int) -> Optional[int]:
    """The frontier minimising total per-rank work: replicated spine nodes
    plus the padded subtree forest's share. None when no stage admits a
    uniform-branching frontier."""
    ns, ss, sc = _stage_structure(obj)
    widths = [ss[k + 1] - ss[k] for k in range(ns)]
    total = sum(widths)
    best, best_cost = None, None
    for f in _frontier_candidates(obj):
        W = -(-widths[f] // num_devices) * num_devices
        padded = 0
        for k in range(f, ns):
            if k > f:
                W = W * sc[k - 1]
            padded += W
        cost = (num_devices * sum(widths[:f]) + padded) / total
        if best is None or cost < best_cost - 1e-12:
            best, best_cost = f, cost
    return best


def _gather(arr, ids, fill=0.0):
    """Host gather ``arr[ids]`` with ``fill`` at ids == -1 (ghost rows)."""
    a = np.asarray(arr)
    flat = ids.reshape(-1)
    out = np.full((flat.size,) + a.shape[1:],
                  False if a.dtype == bool else np.asarray(fill).astype(
                      a.dtype), dtype=a.dtype)
    valid = flat >= 0
    out[valid] = a[flat[valid]]
    return out


def _host(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


@dataclasses.dataclass
class SubtreePlan:
    """Every index array of the partition, for all ranks (host NumPy).

    Local (per-rank) stage widths ``lw`` and starts ``ls``; ``np_ids`` [D,
    l_np] maps each rank's local row to its global node id (-1 on ghosts),
    ``nl_ids`` / ``lf_ids`` likewise on the nonleaf / leaf spaces; ``anc``,
    ``child_rank`` [D, l_np] and ``child_idx``, ``child_mask`` [D, l_nl,
    d_max] are each rank's local index plans; ``to_np`` / ``to_nl`` /
    ``to_lf`` map a global id to its row of the [D * local, ...] block
    layout (spine rows: rank 0's)."""

    num_devices: int
    frontier: int
    lw: tuple
    ls: tuple
    np_ids: np.ndarray
    anc: np.ndarray
    child_rank: np.ndarray
    child_idx: np.ndarray
    child_mask: np.ndarray
    to_np: np.ndarray
    to_nl: np.ndarray
    to_lf: np.ndarray
    num_nonleaf: int

    @property
    def l_np(self) -> int:
        return self.ls[-1]

    @property
    def l_nl(self) -> int:
        return self.ls[-2]

    @property
    def l_lf(self) -> int:
        return self.lw[-1]

    @property
    def nl_ids(self) -> np.ndarray:
        return self.np_ids[:, :self.l_nl]

    @property
    def lf_ids(self) -> np.ndarray:
        ids = self.np_ids[:, self.l_nl:]
        return np.where(ids >= 0, ids - self.num_nonleaf, -1)

    def ids(self, space: str) -> np.ndarray:
        """[D, local rows] global ids of the ``"np"``, ``"nl"`` or ``"lf"``
        space."""
        return {"np": self.np_ids, "nl": self.nl_ids,
                "lf": self.lf_ids}[space]


def subtree_plan(obj, num_devices: int,
                 frontier: Optional[int] = None) -> SubtreePlan:
    """The partition of a tree (or an RAOCP spec) over ``num_devices``
    ranks (JAX ``parallel/subtree.py:321-403`` and ``:522-543``): pure
    host code. Raises ValueError when no frontier exists."""
    tree = obj.tree if hasattr(obj, "tree") else obj
    D = int(num_devices)
    f = choose_frontier(tree, D) if frontier is None else int(frontier)
    if f is None:
        raise ValueError(
            "no subtree frontier exists (branching is ragged in every "
            "suffix of stages)")
    ns, ss, sc = _stage_structure(tree)
    widths = [ss[k + 1] - ss[k] for k in range(ns)]
    if any(sc[j] is None for j in range(f - 1, ns - 1)):
        raise ValueError(f"frontier {f} needs uniform branching from stage "
                         f"{f - 1} down")
    lw = []
    for k in range(ns):
        if k < f:
            lw.append(widths[k])
        elif k == f:
            lw.append(-(-widths[f] // D))
        else:
            lw.append(lw[-1] * sc[k - 1])
    ls = [0]
    for w in lw:
        ls.append(ls[-1] + w)
    L_np, L_nl, L_lf = ls[ns], ls[ns - 1], lw[ns - 1]
    N, NL = tree.num_nodes, tree.num_nonleaf_nodes

    # per-rank global-id map (-1 = ghost)
    np_ids = np.full((D, L_np), -1, np.int64)
    for k in range(ns):
        sl = slice(ls[k], ls[k + 1])
        if k < f:
            np_ids[:, sl] = np.arange(ss[k], ss[k + 1])[None, :]
        else:
            pos = np.arange(D)[:, None] * lw[k] + np.arange(lw[k])[None, :]
            np_ids[:, sl] = np.where(pos < widths[k], ss[k] + pos, -1)

    # remapped index plans
    anc_g = np.asarray(tree.ancestors).copy()
    anc_g[0] = 0
    cr_g = np.asarray(tree.child_rank)
    anc_l = np.zeros((D, L_np), np.int64)
    cr_l = np.zeros((D, L_np), np.int64)
    for k in range(1, ns):
        sl = slice(ls[k], ls[k + 1])
        if k < f:
            # spine rows: local row == global id, so global tables apply
            anc_l[:, sl] = anc_g[ss[k]:ss[k + 1]][None, :]
            cr_l[:, sl] = cr_g[ss[k]:ss[k + 1]][None, :]
        elif k == f:
            ids_k = np_ids[:, sl]
            safe = np.clip(ids_k, 0, None)
            # parents are spine rows; ghosts point at the first stage-(f-1)
            # row and are masked where it matters
            anc_l[:, sl] = np.where(ids_k >= 0, anc_g[safe], ss[f - 1])
            cr_l[:, sl] = np.where(ids_k >= 0, cr_g[safe], 0)
        else:
            c = sc[k - 1]
            pos = np.arange(lw[k])
            anc_l[:, sl] = (ls[k - 1] + pos // c)[None, :]
            cr_l[:, sl] = (pos % c)[None, :]

    d_max = tree.max_branching
    ci_g = np.asarray(tree.children_padded)
    cm_g = np.asarray(tree.children_mask, dtype=np.float64)
    ci_l = np.zeros((D, L_nl, d_max), np.int64)
    cm_l = np.zeros((D, L_nl, d_max))
    for k in range(ns - 1):
        sl = slice(ls[k], ls[k + 1])
        if k < f - 1:
            ci_l[:, sl] = ci_g[ss[k]:ss[k + 1]][None]
            cm_l[:, sl] = cm_g[ss[k]:ss[k + 1]][None]
        elif k == f - 1:
            # frontier parents (replicated): each rank masks in only the
            # stage-f children it owns; the all-reduce completes the sum
            c = sc[f - 1]
            pos = (np.arange(widths[f - 1])[:, None] * c
                   + np.arange(c)[None, :])              # global stage-f pos
            for d in range(D):
                owned = (pos >= d * lw[f]) & (pos < (d + 1) * lw[f])
                ci_l[d, sl, :c] = np.where(owned, ls[f] + pos - d * lw[f], 0)
                cm_l[d, sl, :c] = owned
        else:
            c = sc[k]
            loc = (ls[k + 1] + np.arange(lw[k])[:, None] * c
                   + np.arange(c)[None, :])              # local child rows
            ci_l[:, sl, :c] = loc[None]
            for d in range(D):
                cm_l[d, sl, :c] = d * lw[k + 1] + (loc - ls[k + 1]) \
                    < widths[k + 1]

    # global id -> row of the [D * local, ...] block layout
    to_np = np.zeros(N, np.int64)
    to_nl = np.zeros(NL, np.int64)
    to_lf = np.zeros(N - NL, np.int64)
    for k in range(ns):
        gl = np.arange(ss[k], ss[k + 1])
        if k < f:
            to_np[gl] = gl                               # rank 0's rows
            if k < ns - 1:
                to_nl[gl] = gl
        else:
            p = gl - ss[k]
            d = p // lw[k]
            to_np[gl] = d * L_np + ls[k] + (p - d * lw[k])
            if k < ns - 1:
                to_nl[gl] = d * L_nl + ls[k] + (p - d * lw[k])
        if k == ns - 1:
            p = gl - ss[k]
            d = p // lw[k]
            to_lf[gl - NL] = d * L_lf + (p - d * lw[k])

    return SubtreePlan(
        num_devices=D, frontier=f, lw=tuple(lw), ls=tuple(ls),
        np_ids=np_ids, anc=anc_l, child_rank=cr_l, child_idx=ci_l,
        child_mask=cm_l, to_np=to_np, to_nl=to_nl, to_lf=to_lf,
        num_nonleaf=NL)


@dataclasses.dataclass
class SubtreeProblem:
    """This rank's block of a partitioned RAOCP, and the maps between the
    global node layout and the [D * local, ...] block layout."""

    sp: StackedProblem          # this rank's block, on its device
    rank: int
    plan: SubtreePlan

    @property
    def group(self):
        return self.sp.spmd_group

    @property
    def frontier(self) -> int:
        return self.plan.frontier

    # -- iterate repacking ---------------------------------------------------

    def _to_global(self, tree, spaces):
        maps = {"np": self.plan.to_np, "nl": self.plan.to_nl,
                "lf": self.plan.to_lf}
        return type(tree)(**{
            k: gather_rows(v, self.group)[maps[spaces[k]]]
            for k, v in tree._asdict().items()})

    def primal_to_global(self, z) -> Primal:
        """The global-layout primal (NumPy) from every rank's block
        (collective: every rank calls it and receives the same arrays)."""
        return self._to_global(Primal(*z), _PRIMAL_SPACES)

    def dual_to_global(self, eta) -> Dual:
        return self._to_global(Dual(*eta), _DUAL_SPACES)

    def _to_local(self, tree, spaces):
        return type(tree)(**{
            k: _gather(_host(v), self.plan.ids(spaces[k])[self.rank])
            for k, v in tree._asdict().items()})

    def primal_to_local(self, z) -> Primal:
        """This rank's block (NumPy) of a global-layout primal."""
        return self._to_local(Primal(*z), _PRIMAL_SPACES)

    def dual_to_local(self, eta) -> Dual:
        return self._to_local(Dual(*eta), _DUAL_SPACES)

    def _zero_block_layout(self, tree):
        D = self.plan.num_devices
        return type(tree)(**{
            k: np.zeros((D * v.shape[0],) + tuple(v.shape[1:]),
                        _host(v).dtype)
            for k, v in tree._asdict().items()})

    def zero_primal_global_layout(self) -> Primal:
        """Host zeros in the [D * local, ...] block layout (every rank's
        block stacked, the layout ``primal_to_global`` maps from)."""
        return self._zero_block_layout(self.sp.zero_primal())

    def zero_dual_global_layout(self) -> Dual:
        return self._zero_block_layout(self.sp.zero_dual())

    # -- the solver on the block ---------------------------------------------

    def power_iteration(self):
        """lambda_max(L'L) by SPMD power iteration over the ranks (the same
        value on every rank)."""
        from raocp_tpu_torch.solver import _power_iteration
        return _power_iteration(self.sp)

    def run_cp(self, z0, eta0, x0, alpha1, alpha2, tol, max_iters: int,
               check_every: int = 1, unroll: int = 1,
               adaptive: bool = False, relax: float = 1.0,
               log_every=None, k0: int = 0):
        """The CP loop on this rank's block: iterates in, iterates out, in
        the block layout; every host branch reads all-reduced values, so
        the ranks take the same branches."""
        from raocp_tpu_torch.solver import _run_cp_host
        return _run_cp_host(self.sp, z0, eta0, x0, alpha1, alpha2, tol,
                            max_iters, check_every, unroll, adaptive, relax,
                            log_every, k0)


def build_subtree_problem(spec, mesh, dtype=None, offline: str = "host",
                          frontier: Optional[int] = None,
                          prebuilt: Optional[StackedProblem] = None
                          ) -> SubtreeProblem:
    """Partition a problem over a 1-D mesh with the replicated-spine
    subtree layout (module docstring). The global problem is built on the
    host (``prebuilt`` reuses one: a ``pad_multiple=1`` build on the CPU in
    the working dtype); only this rank's block goes to its device. Raises
    ValueError when the tree has no uniform-branching frontier."""
    device = mesh_device(mesh, mesh.device_type)
    dtype = default_dtype(device) if dtype is None else _torch_dtype(dtype)
    g = prebuilt if prebuilt is not None else build_stacked(
        spec, dtype=dtype, pad_multiple=1, offline=offline, device="cpu")
    group = mesh.get_group(AXIS)
    rank = dist.get_rank(group)
    plan = subtree_plan(spec, mesh.size(), frontier)
    f, ns = plan.frontier, g.num_stages
    ids = {space: plan.ids(space)[rank] for space in ("np", "nl", "lf")}
    shared = {}

    def up(arr, dt=None):
        return upload(arr, dt, device)

    def on_device(t):
        """A replicated host tensor on the device, uploaded once (identical
        stage blocks stay one tensor, so stage groups still form)."""
        if t is None:
            return None
        if id(t) not in shared:
            shared[id(t)] = t.to(device)
        return shared[id(t)]

    values = dict(
        anc=up(plan.anc[rank]), child_rank=up(plan.child_rank[rank]),
        child_idx=up(plan.child_idx[rank]),
        child_mask=up(plan.child_mask[rank], dtype),
        node_mask=up((ids["np"] >= 0).astype(np.float64), dtype),
        lf_half_mask=up((ids["lf"] >= 0).astype(np.float64), dtype))
    for names, space in ((_NP_FIELDS, "np"), (_NL_FIELDS, "nl"),
                         (_LF_FIELDS, "lf")):
        for name in names:
            arr = getattr(g, name)
            values[name] = None if arr is None else up(
                _gather(_host(arr), ids[space], _FILLS.get(name, 0.0)))
    for names, space in ((_MODAL_NP, "np"), (_MODAL_LF, "lf")):
        for name in names:
            mm = getattr(g, name)
            values[name] = None if mm is None else ModalMatrix(
                dense_m=None if mm.dense_m is None else
                up(_gather(_host(mm.dense_m), ids[space])),
                modes=on_device(mm.modes),
                idx=None if mm.idx is None else
                up(_gather(_host(mm.idx), ids[space], 0)))
    for name in _STAGE_FIELDS:
        values[name] = tuple(
            None if (name in _FRONTIER_RAGGED and k == f - 1)
            else on_device(t) for k, t in enumerate(getattr(g, name)))
    for name in ("nl_G", "l_G"):
        values[name] = on_device(getattr(g, name))

    sc = g.stage_child
    local = StackedProblem(
        n=g.n, m=g.m, num_nodes=plan.l_np, num_nonleaf=plan.l_nl,
        num_leaf=plan.l_lf, d_max=g.d_max, num_stages=ns,
        stage_start=plan.ls,
        stage_child=tuple(None if k == f - 1 else sc[k]
                          for k in range(ns - 1)),
        np_pad=plan.l_np, nl_pad=plan.l_nl, lf_pad=plan.l_lf,
        y_dim=g.y_dim, frontier=f, spmd_group=group,
        spmd_ndev=plan.num_devices, **values)
    return SubtreeProblem(sp=local, rank=rank, plan=plan)

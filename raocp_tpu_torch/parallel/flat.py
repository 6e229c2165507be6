"""Flat node partition: an even row split of every node space, with halo
exchanges planned on the host (counterpart of the JAX package's
``partition="flat"``, :mod:`raocp_tpu.parallel.sharding`).

Layout. The stacked problem is built with every node space padded to a
multiple of the rank count D; rank r holds rows [r P, (r+1) P) of every
all-node field and iterate, [r Q, (r+1) Q) of every nonleaf one and
[r R, (r+1) R) of every leaf one (P = np_pad / D, Q = nl_pad / D,
R = lf_pad / D). Ghost rows sit at the end of the last blocks, carry zero
data and stay zero. Any tree splits so, ragged ones included.

Exchanges. JAX's GSPMD inserts a reshard wherever a stage op reads another
shard's rows (about 140 collectives a CP step). PyTorch inserts nothing
around an index gather, so the port plans every such read once, here, on
the host. The tree is stage-major: a contiguous range of parents has a
contiguous range of children and vice versa, so every read is one
contiguous window of global rows per rank (a :class:`Pull`). A rank reads
its windows through :func:`raocp_tpu_torch.parallel.sharding.exchange`,
several windows in one ``all_to_all_single``:

* L: one exchange (the nonleaf and leaf views of x and s, the parents'
  x and u of the rank's rows);
* L': two (the children's e3 / e4 rows; then the nonleaf and leaf parts of
  x and s back to the all-node block);
* prox_f: two a nonleaf stage. The dynamics sweep computes a nonleaf
  stage's rows where their u lives (the nonleaf block) and the leaf stage's
  where their x lives; its stages depend on each other, so the backward
  pass exchanges once a stage (the children's q), the forward pass once a
  stage (the parents' [x; u]). The first exchange also carries the kernel
  projection's child slots, the last one its parent slots and the nonleaf
  x back to the all-node block.

So a CP step makes ``2 (num_stages - 1) + 3`` exchanges, and a residual
check two more (its L') and one all-reduce, whatever the node count. No
rank holds a whole node-leading iterate or field on its device: its blocks,
its windows, and the halo tables of :func:`flat_plan` (the per-node mode
indices of the rows its windows cover).
"""

import dataclasses
import numpy as np
import torch

from raocp_tpu_torch.core.modal import ModalMatrix
from raocp_tpu_torch.core.variables import Dual, Primal
from raocp_tpu_torch.parallel.sharding import (_host, _overlap, exchange,
                                               gather_rows)

__all__ = ["Pull", "FlatPlan", "FlatProblem", "flat_plan"]

# the node space of each iterate leaf
_PRIMAL_SPACES = dict(x="np", u="nl", y="nl", tau="np", s="np")
_DUAL_SPACES = dict(e1="nl", e2="nl", e3="np", e4="np", e5="np", e6="np",
                    e7="nl", e11="lf", e12="lf", e13="lf", e14="lf")

_EMPTY = (0, 0)


@dataclasses.dataclass(frozen=True)
class Pull:
    """One window of an exchange, for every rank: ``need[d]`` are the
    global rows [lo, hi) that rank d reads, ``have[s]`` the rows that rank
    s's source tensor holds (its row 0 is ``have[s][0]``). Both are rows of
    one node space; the ``have`` ranges increase with the rank and cover
    every ``need``, so a window is its pieces in rank order."""

    need: tuple
    have: tuple


@dataclasses.dataclass
class FlatPlan:
    """A rank's view of the flat partition: its blocks, its real rows, the
    windows of every exchange (for all ranks) and the halo tables it
    reads. Built on the host by :func:`flat_plan`, the same on every rank
    but for ``rank`` and the tables."""

    ranks: int
    rank: int
    start: dict          # space -> first global row of this rank's block
    real: dict           # space -> this rank's real rows (lo, hi)
    real_count: dict     # space -> real rows of the whole space
    stage_rows: tuple    # per nonleaf stage: this rank's rows (lo, hi)
    child_rows: tuple    # this rank's real non-root all-node rows
    leaf_rows: tuple     # this rank's real leaf-stage all-node rows
    pulls: dict          # name -> Pull
    tables: dict         # halo tables on the device
    child_first: np.ndarray
    child_count: np.ndarray

    def window(self, name: str) -> tuple:
        """The global rows [lo, hi) of this rank's window ``name``."""
        return self.pulls[name].need[self.rank]

    def children(self, lo: int, hi: int) -> tuple:
        """The all-node rows of the children of nonleaf rows [lo, hi)."""
        return _children(self.child_first, self.child_count, (lo, hi))

    def exchange(self, sp, items) -> list:
        """The windows of ``items`` [(pull name, source tensor), ...], in
        one exchange over the problem's group."""
        return exchange([(self.pulls[name], t) for name, t in items],
                        self.rank, sp.spmd_group)

    def block(self, space: str, arr: np.ndarray, rows: int) -> np.ndarray:
        """This rank's block (``rows`` rows) of a global-layout host array
        of ``space``: its real rows, zero-padded to the padded layout."""
        real = self.real_count[space]
        a = np.asarray(arr)[:real]
        out = np.zeros((self.ranks * rows,) + a.shape[1:], a.dtype)
        out[:real] = a
        return out[self.rank * rows:(self.rank + 1) * rows]


def _children(first, count, rows) -> tuple:
    """The all-node rows of the children of nonleaf rows [lo, hi) (stage-
    major: contiguous), from each node's first child and child count."""
    lo, hi = rows
    if hi <= lo:
        return _EMPTY
    return int(first[lo]), int(first[hi - 1] + count[hi - 1])


def _ranges(size: int, block: int, ranks: int):
    """Each rank's real rows of a space with ``size`` real rows split in
    blocks of ``block``."""
    return tuple((d * block, max(d * block, min((d + 1) * block, size)))
                 for d in range(ranks))


def flat_plan(sp, ranks: int, rank: int, device) -> FlatPlan:
    """The flat partition of a host-built problem over ``ranks`` ranks,
    for ``rank`` (pure host code, but for the halo tables it puts on
    ``device``). ``sp`` is the global problem, every space padded to a
    multiple of ``ranks``."""
    ss = sp.stage_start
    ns = sp.num_stages
    N, NL, LF = sp.num_nodes, sp.num_nonleaf, sp.num_leaf
    P, Q, R = sp.np_pad // ranks, sp.nl_pad // ranks, sp.lf_pad // ranks
    anc = sp.anc.cpu().numpy()
    first = sp.child_idx[:, 0].cpu().numpy()
    count = sp.child_mask.sum(dim=1).cpu().numpy().astype(np.int64)

    def children(r):
        return _children(first, count, r)

    def parents(r):
        lo, hi = r
        if hi <= lo:
            return _EMPTY
        return int(anc[lo]), int(anc[hi - 1]) + 1

    npr, nlr, lfr = _ranges(N, P, ranks), _ranges(NL, Q, ranks), \
        _ranges(LF, R, ranks)
    nonroot = tuple(_overlap(r, (1, N)) for r in npr)
    stage = [tuple(_overlap(r, (ss[k], ss[k + 1])) for r in nlr)
             for k in range(ns - 1)]
    leaf = tuple(_overlap(r, (NL, N)) for r in npr)

    def pull(need, have):
        return Pull(need=tuple(need), have=tuple(have))

    pulls = {
        # L: the nonleaf / leaf views of [x | s], the parents' x and u
        "np>nl": pull(nlr, npr),
        "np>lf": pull(((NL + lo, NL + hi) for lo, hi in lfr), npr),
        "np>par": pull(map(parents, nonroot), npr),
        "nl>par": pull(map(parents, nonroot), nlr),
        # L' and the kernel projection: the children of the nonleaf rows
        "np>child": pull(map(children, nlr), npr),
        # L' and prox_f: nonleaf / leaf rows back to the all-node block
        "nl>np": pull((_overlap(r, (0, NL)) for r in npr), nlr),
        "lf>np": pull(((lo - NL, hi - NL) if hi > lo else _EMPTY
                       for lo, hi in leaf), lfr),
        # the sweep: the leaves below the last nonleaf stage, then the
        # children's q (backward) and the parents' [x; u] (forward) of
        # every other stage, and the leaf stage's parents
        "np>child_last": pull(map(children, stage[ns - 2]), npr),
        "xu_last": pull(map(parents, leaf), stage[ns - 2]),
    }
    for k in range(ns - 2):
        pulls[f"q{k}"] = pull(map(children, stage[k]), stage[k + 1])
        pulls[f"xu{k}"] = pull(map(parents, stage[k + 1]), stage[k])

    # halo tables: the per-node mode indices (or dense stacks) of the
    # all-node rows this rank's windows cover
    cw = children(nlr[rank])
    nl_lo, nl_hi = nlr[rank]

    def window_rows(mm, lo, hi):
        if mm is None:
            return None
        return ModalMatrix(
            dense_m=None if mm.dense_m is None
            else mm.dense_m[lo:hi].to(device).contiguous(),
            modes=None if mm.modes is None else mm.modes.to(device),
            idx=None if mm.idx is None
            else mm.idx[lo:hi].to(device).contiguous())

    tables = {
        "QRm_c": window_rows(sp.QRm, *cw),
        "sqrtQ_c": window_rows(sp.sqrtQ, *cw),
        "sqrtR_c": window_rows(sp.sqrtR, *cw),
        "ABm_c": window_rows(sp.ABm, *cw),
        "ABm_nl": window_rows(sp.ABm, nl_lo, nl_hi),
        "anc_nl": sp.anc[rank * Q:(rank + 1) * Q].to(device),
        "riccati_cls_nl": None if sp.riccati_cls is None
        else sp.riccati_cls[rank * Q:(rank + 1) * Q].to(device),
    }
    return FlatPlan(
        ranks=ranks, rank=rank,
        start=dict(np=rank * P, nl=rank * Q, lf=rank * R),
        real=dict(np=npr[rank], nl=nlr[rank], lf=lfr[rank]),
        stage_rows=tuple(s[rank] for s in stage),
        child_rows=nonroot[rank], leaf_rows=leaf[rank], pulls=pulls,
        tables=tables, child_first=first, child_count=count,
        real_count=dict(np=N, nl=NL, lf=LF))


@dataclasses.dataclass
class FlatProblem:
    """This rank's block of a flat-partitioned RAOCP, and the maps between
    the global node layout (real rows only, as a single-device solve's
    results) and the rank's blocks."""

    sp: object                  # this rank's StackedProblem, sp.flat set

    @property
    def plan(self) -> FlatPlan:
        return self.sp.flat

    @property
    def rank(self) -> int:
        return self.plan.rank

    @property
    def group(self):
        return self.sp.spmd_group

    def _rows(self, space: str) -> int:
        return {"np": self.sp.np_pad, "nl": self.sp.nl_pad,
                "lf": self.sp.lf_pad}[space]

    def _to_global(self, tree, spaces):
        # x and e1 are [rows, cols] on their own, [B, rows, cols] in a batch
        lanes = np.ndim(tree[0]) == 3
        out = {}
        for k, v in tree._asdict().items():
            v = torch.as_tensor(v)
            rows = v.transpose(0, 1) if lanes else v
            g = gather_rows(rows.contiguous(), self.group)
            g = g[:self.plan.real_count[spaces[k]]]
            out[k] = np.moveaxis(g, 0, 1) if lanes else g
        return type(tree)(**out)

    def primal_to_global(self, z) -> Primal:
        """The global-layout primal (NumPy, real rows) from every rank's
        block (tensors or host arrays); with a leading lane axis, per lane
        (collective: every rank calls it and receives the same arrays)."""
        return self._to_global(Primal(*z), _PRIMAL_SPACES)

    def dual_to_global(self, eta) -> Dual:
        return self._to_global(Dual(*eta), _DUAL_SPACES)

    def _to_local(self, tree, spaces):
        return type(tree)(**{
            k: self.plan.block(spaces[k], _host(v), self._rows(spaces[k]))
            for k, v in tree._asdict().items()})

    def primal_to_local(self, z) -> Primal:
        """This rank's block (NumPy) of a global-layout primal (its real
        rows are read; padding of any length is ignored)."""
        return self._to_local(Primal(*z), _PRIMAL_SPACES)

    def dual_to_local(self, eta) -> Dual:
        return self._to_local(Dual(*eta), _DUAL_SPACES)

    def power_start(self, rng) -> Primal:
        """The power iteration's start on this rank: the single-device
        draws (one per leaf, in leaf order, at the global real shapes)
        cut to this rank's block, so the partition starts where a
        single-device solve does."""
        sp = self.sp
        real = self.plan.real_count
        shapes = dict(x=(real["np"], sp.n), u=(real["nl"], sp.m),
                      y=(real["nl"], sp.Y), tau=(real["np"],),
                      s=(real["np"],))
        return Primal(**{k: torch.as_tensor(
            self.plan.block(_PRIMAL_SPACES[k], rng.standard_normal(shape),
                            self._rows(_PRIMAL_SPACES[k])),
            dtype=sp.dtype, device=sp.device) for k, shape in shapes.items()})

"""benchmark/work.py: the count of work from a configuration's sizes."""

import json

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import work
from benchmark.reference import problem as bp
from benchmark.reference.cp import Reference
from benchmark.tests.conftest import ROOT, TINY, TINY_STOPPED


def _config(**over):
    cfg = json.loads((ROOT / "benchmark" / "configs"
                      / "config4_network_1e4.json").read_text())
    cfg.update(TINY)
    cfg.update(over)
    return cfg


def test_hand_count_of_a_three_node_tree():
    # a root and two leaves, n = 2, m = 1, two modes, float32
    cfg = dict(num_states=2, num_inputs=1, num_modes=2, dtype="float32",
               nodes_per_stage=[1, 2])
    # dynamics: each child 4 n (n + m) = 24; the root 2 m^2 + 6 m n = 14
    assert work.project_dynamics(cfg)["flop"] == 2 * 24 + 14
    # x, u in and out (2 * (3 * 2 + 1)) and x0 (2); A, B of two modes
    # (2 * 2 * 3) and one stage's factors (2 * 1 * 2 + 1)
    assert work.project_dynamics(cfg)["bytes"] == 4 * (14 + 2 + 12 + 5)
    # L: sqrt(Q), sqrt(R) at the two children, sqrt(P) at the two leaves
    assert work.ell(cfg)["flop"] == 2 * 2 * (4 + 1) + 2 * 2 * 4
    # the kernel: c = 2, D = 9: 2 (2 c D + c^2)
    assert work.project_kernel(cfg)["flop"] == 2 * (36 + 4)
    assert work.cp_step(cfg)["flop"] == 62 + 80 + 2 * 36


@pytest.mark.parametrize("shape", [TINY, TINY_STOPPED],
                         ids=["one_count", "stopped"])
@pytest.mark.parametrize("which", ["project_dynamics", "cp_step"])
def test_count_is_what_the_reference_multiplies(which, shape):
    """The reference's own products, counted by torch, equal the count:
    on a tree of one child count, and on a stopped one."""
    cfg = _config(dtype="float64", **shape)
    ref = Reference(cfg, bp.plant(cfg), bp.config_tree(cfg), "cpu",
                    torch.float64)
    z, e = ref.zero_primal(), ref.zero_dual()
    x0 = torch.zeros(cfg["num_states"], dtype=torch.float64)
    Lz, Lte = ref.L(z), ref.Lt(e)
    with FlopCounterMode(display=False) as fc:
        if which == "project_dynamics":
            ref.project_dynamics(z["x"], z["u"], x0)
        else:
            ref.step(z, e, Lz, Lte, 0.1, x0)
    assert fc.get_total_flops() == getattr(work, which)(cfg)["flop"]


def test_count_ignores_the_ports_padding_and_mode_grouping():
    """The port's own count moves with its padding and its mode-grouped
    products; the benchmark's, read from the real sizes, does not."""
    from benchmark import system
    from raocp_tpu_torch.core.stacked import build_stacked
    from raocp_tpu_torch.ops import work as port_work

    cfg = _config(dtype="float64")
    pl = bp.plant(cfg)
    spec = system.build_problem(cfg, pl, pl.v)
    ours, theirs = set(), set()
    for pad in (1, 8):
        sp = build_stacked(spec, dtype=torch.float64, pad_multiple=pad,
                           device="cpu")
        per = [int(b - a) for a, b in zip(sp.stage_start[:-1],
                                          sp.stage_start[1:])]
        real = dict(cfg, nodes_per_stage=per[:sp.num_stages],
                    num_states=sp.n, num_inputs=sp.m)
        ours.add(json.dumps(work.cp_step(real)))
        theirs.add(json.dumps(port_work.cp_step(sp)))
    assert len(ours) == 1
    assert json.loads(ours.pop()) == work.cp_step(cfg)
    assert len(theirs) == 2


def test_hand_count_of_the_dual_update_at_the_tiny_tree():
    """At 40 nodes (13 nonleaf, 27 leaves, 3 children a node), n = 4, m =
    2, three modes, float64."""
    box = _config(dtype="float64")
    ball = dict(box, constraint="ball", radius=10.0)
    # the dual: e1 13 x 7, e2 13, e7 13 x 6; e3 40 x 4, e4 40 x 2, e5, e6
    # 40 each; e11 27 x 4, e12, e13 27 each, e14 27 x 4
    D = 13 * (7 + 1 + 6) + 40 * (4 + 2 + 2) + 27 * (4 + 2 + 4)
    assert D == 772
    # eta and eta+ whole, L z and L z+ without e6 (40) and e13 (27)
    io = 2 * D + 2 * (D - 40 - 27)
    # the risk cone's 7 rows of three modes; a box's bounds on [x; u] and
    # on x, or a ball's centre and radius on each
    assert work.dual_update(box) == dict(
        flop=0, bytes=8 * (io + 3 * 7 + 2 * 6 + 2 * 4))
    assert work.dual_update(ball) == dict(
        flop=0, bytes=8 * (io + 3 * 7 + (6 + 1) + (4 + 1)))
    assert work.dual_update(dict(box, dtype="float32"))["bytes"] == \
        work.dual_update(box)["bytes"] // 2


def test_the_configs_sizes_are_their_trees():
    for name in ("config4_network_1e4", "config5_network_mpc_1e5",
                 "config3_soc_network_3k"):
        cfg = bp.load_config(name)
        s = work.sizes(cfg)
        assert s["N"] == cfg["num_nodes"]
        tree_sizes = [3 ** k for k in range(cfg["num_stages"] + 1)]
        assert s["per"] == tree_sizes


# the counts of the configurations of one child count, as they were before
# the count went stage by stage
PINNED = {
    "config3_soc_network_3k": dict(
        project_dynamics=dict(flop=8534144, bytes=1224608),
        project_kernel=dict(flop=190182, bytes=227344),
        ell=dict(flop=4792512, bytes=2559760),
        dual_update=dict(flop=0, bytes=7260360),
        cp_step=dict(flop=18309350, bytes=5140120)),
    "config4_network_1e4": dict(
        project_dynamics=dict(flop=160064000, bytes=4580200),
        project_kernel=dict(flop=570720, bytes=341120),
        ell=dict(flop=89877000, bytes=8980508),
        dual_update=dict(flop=0, bytes=26007652),
        cp_step=dict(flop=340388720, bytes=18035132)),
    "config5_network_mpc_1e5": dict(
        project_dynamics=dict(flop=5763084800, bytes=80858480),
        project_kernel=dict(flop=5137176, bytes=3070496),
        ell=dict(flop=3235850400, bytes=157366844),
        dual_update=dict(flop=0, bytes=460818084),
        cp_step=dict(flop=12239922776, bytes=315106804)),
}


@pytest.mark.parametrize("name", sorted(PINNED))
def test_the_counts_of_one_child_count_stay(name):
    cfg = bp.load_config(name)
    assert {part: getattr(work, part)(cfg) for part in PINNED[name]} == \
        PINNED[name]


# a stopped tree at config 4's widths: three children a node to stage 6,
# then one, to stage 24
STOPPED_24 = dict(num_stages=24, stopping_time=6,
                  nodes_per_stage=[3 ** k for k in range(7)] + [729] * 18,
                  num_nodes=14215)


def test_hand_count_of_the_stopped_tree_stage_by_stage():
    """Config 4 on :data:`STOPPED_24`: 6 branching stages (364 nodes, 3
    children each, 7 risk rows) and 18 chain stages (729 nodes each, one
    child, 3 risk rows, one set of factors a mode); n = 50, m = 20,
    float32."""
    cfg = dict(bp.load_config("config4_network_1e4"), **STOPPED_24)
    s = work.sizes(cfg)
    n, m, N, NL, LF = 50, 20, 14215, 13486, 729
    assert (s["N"], s["NL"], s["LF"]) == (N, NL, LF)
    assert s["kids"] == [3] * 6 + [1] * 18
    assert s["sets"] == [1] * 6 + [3] * 18
    tree = bp.config_tree(cfg)
    assert np.bincount(tree.stage).tolist() == s["per"]
    branch, chain = 1 + 3 + 9 + 27 + 81 + 243, 18 * 729
    assert branch + chain == NL
    rows = branch * 7 + chain * 3
    factors = (6 + 18 * 3) * (2 * m * n + m * m)
    assert work.project_dynamics(cfg) == dict(
        flop=(N - 1) * 4 * n * (n + m) + NL * (2 * m * m + 6 * m * n),
        bytes=4 * (2 * (N * n + NL * m) + n + 3 * n * (n + m) + factors))
    # M has c_k rows and D = 4 c_k + 1 columns
    assert work.project_kernel(cfg) == dict(
        flop=branch * 2 * (2 * 3 * 13 + 9) + chain * 2 * (2 * 1 * 5 + 1),
        bytes=4 * 2 * (branch * 13 + chain * 5))
    primal = N * n + NL * m + rows + 2 * N
    dual = rows + NL * (1 + n + m) + N * (n + m + 2) + LF * (2 * n + 2)
    risk = 3 * (7 + 3)                     # b, a mode and child count
    assert work.ell(cfg) == dict(
        flop=(N - 1) * 2 * (n * n + m * m) + LF * 2 * n * n,
        bytes=4 * (primal + dual + 3 * (n * n + m * m) + risk + n * n))
    boxes = 2 * (n + m) + 2 * n
    assert work.dual_update(cfg) == dict(
        flop=0, bytes=4 * (2 * dual + 2 * (dual - N - LF) + risk + boxes))
    assert work.cp_step(cfg) == dict(
        flop=(work.project_dynamics(cfg)["flop"]
              + work.project_kernel(cfg)["flop"] + 2 * work.ell(cfg)["flop"]),
        bytes=4 * (2 * (primal + dual) + n
                   + 3 * (n * (n + m) + n * n + m * m) + risk + n * n
                   + factors))

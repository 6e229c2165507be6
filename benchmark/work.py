"""The work the algorithm must do, counted from a configuration's own sizes
(frozen: the yardstick of the roofline metrics, whatever kernels carry the
work out). It imports nothing of the system under test.

The sizes are the nodes per stage, n, m, the modes, the children of each
nonleaf stage and the rows of the constraints and risk cones. Each count is
a dict:

* ``flop``: the algorithm's own products, 2 a b for a matrix [a, b] times
  a vector, on the real rows of the tree and on each node's own mode only
  (an implementation that computes every mode and selects, or pads rows,
  does more, and that work is not counted). Elementwise work is not
  counted: it is O(n) a row where the products are O(n^2).
* ``bytes``: the compulsory traffic: each input read once and each output
  written once, in the configuration's element size; the tables (per mode
  A, B and the cost square roots; per nonleaf stage the factors of the
  dynamics projection; per mode the risk vector b) each once.

:func:`least_time` is the larger of the operations over the card's peak
rate and the bytes over its memory rate (NVIDIA H100 SXM data sheet, at its
full 700 W: 67 TFLOP/s in float32 and in float64, 3.35 TB/s).

A CP step is one evaluation of the CP map (the residual check of every
``check_every``-th step is not counted): prox_f (the dynamics projection,
the kernel projection), one apply of L and one of L', the dual prox.
:func:`dual_update` counts the dual prox's pass alone.
"""

PEAK_FLOPS = {4: 67e12, 8: 67e12}
PEAK_BYTES = 3.35e12
ESIZE = {"float32": 4, "float64": 8}


def sizes(config: dict) -> dict:
    """The tree's sizes: nodes per stage, and per nonleaf stage the
    children of each of its nodes (uniform within a stage)."""
    per = [int(v) for v in config["nodes_per_stage"]]
    kids = [per[k + 1] // per[k] for k in range(len(per) - 1)]
    if any(per[k] * kids[k] != per[k + 1] for k in range(len(kids))):
        raise ValueError("every node of a nonleaf stage needs the same "
                         "number of children")
    n, m = config["num_states"], config["num_inputs"]
    N, LF = sum(per), per[-1]
    return dict(N=N, NL=N - LF, LF=LF, n=n, m=m, per=per, kids=kids,
                modes=config["num_modes"], stages=len(kids),
                esize=ESIZE[config["dtype"]])


def project_dynamics(config: dict) -> dict:
    """The dynamics projection (prox_f's sweep): per non-root node j,
    B_j'q_j and A_j'q_j up the tree and A_j x_i + B_j u_i down it; per
    nonleaf node i, d_i = H_i^-1 (...), K_i'(...), S_i d_i and K_i x_i."""
    s = sizes(config)
    n, m, N, NL = s["n"], s["m"], s["N"], s["NL"]
    flop = (N - 1) * 4 * n * (n + m) + NL * (2 * m * m + 6 * m * n)
    tables = (s["modes"] * n * (n + m)
              + s["stages"] * (2 * m * n + m * m))
    io = 2 * (N * n + NL * m) + n
    return dict(flop=flop, bytes=s["esize"] * (io + tables))


def _primal(s) -> int:
    Y = 2 * max(s["kids"]) + 1
    return s["N"] * s["n"] + s["NL"] * (s["m"] + Y) + 2 * s["N"]


def _dual(s) -> int:
    N, NL, LF, n, m = s["N"], s["NL"], s["LF"], s["n"], s["m"]
    Y = 2 * max(s["kids"]) + 1
    return (NL * (Y + 1 + n + m) + N * (n + m + 2)
            + LF * (2 * n + 2))


def ell(config: dict) -> dict:
    """One apply of L (or of L', the same products): sqrt(Q_j), sqrt(R_j)
    at every non-root node, sqrt(P) at every leaf (b_i'y_i is
    elementwise)."""
    s = sizes(config)
    n, m = s["n"], s["m"]
    Y = 2 * max(s["kids"]) + 1
    flop = (s["N"] - 1) * 2 * (n * n + m * m) + s["LF"] * 2 * n * n
    return dict(flop=flop,
                bytes=s["esize"] * (_primal(s) + _dual(s)
                                    + s["modes"] * (n * n + m * m + Y)
                                    + n * n))


def project_kernel(config: dict) -> dict:
    """(y_i, tau_children, s_children) onto ker [E', -I, -I]: per nonleaf
    node, M v, (M M')^-1 (M v) and M' w, with M of c rows and 2c+1+2c
    columns."""
    s = sizes(config)
    c = max(s["kids"])
    D = 4 * c + 1
    return dict(flop=s["NL"] * 2 * (2 * c * D + c * c),
                bytes=s["esize"] * 2 * s["NL"] * D)


def dual_update(config: dict) -> dict:
    """The dual update (the prox of g* in Moreau form and the step into
    it), as one pass: eta, L z and L z+ read, eta+ written; L z's e6 and
    e13 are its e5 and e12 (tau/2 and s/2), read once; the tables once:
    per mode the risk cone's rows, and the state-input sets' parameters (a
    box's two bounds, or a ball's centre and radius) at nonleaf nodes and
    at leaves. Its operations are elementwise: not counted."""
    s = sizes(config)
    n, m = s["n"], s["m"]
    D = _dual(s)
    Dz = D - s["N"] - s["LF"]
    if config["constraint"] == "ball":
        sets = (n + m + 1) + (n + 1)
    else:
        sets = 2 * (n + m) + 2 * n
    tables = s["modes"] * (2 * max(s["kids"]) + 1) + sets
    return dict(flop=0, bytes=s["esize"] * (2 * D + 2 * Dz + tables))


def cp_step(config: dict) -> dict:
    """One CP step, as one pass: z and eta read, z+ and eta+ written, the
    tables once."""
    s = sizes(config)
    dyn, ker, L = project_dynamics(config), project_kernel(config), \
        ell(config)
    flop = dyn["flop"] + ker["flop"] + 2 * L["flop"]
    n, m = s["n"], s["m"]
    Y = 2 * max(s["kids"]) + 1
    tables = (s["modes"] * (n * (n + m) + n * n + m * m + Y) + n * n
              + s["stages"] * (2 * m * n + m * m))
    io = 2 * (_primal(s) + _dual(s)) + n
    return dict(flop=flop, bytes=s["esize"] * (io + tables))


def least_time(work: dict, config: dict) -> float:
    """Seconds: the larger of the operations over the peak rate and the
    bytes over the memory rate."""
    esize = ESIZE[config["dtype"]]
    return max(work["flop"] / PEAK_FLOPS[esize], work["bytes"] / PEAK_BYTES)

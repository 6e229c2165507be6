"""Result plotting (a copy of :mod:`raocp_tpu.utils.plots`). matplotlib is
imported only inside the two plotting functions; the pgfplots writers need
nothing but NumPy.

Parity: reference ``solver.py:187-253`` — residual curves and per-scenario
state/input trajectory fans (the reference additionally exports tikz via
tikzplotlib; here figures are saved directly).
"""

from typing import Optional

import numpy as np

__all__ = ["plot_residuals", "plot_solution", "save_residuals_tex",
           "save_solution_tex"]


def plot_residuals(result, filename: Optional[str] = None, show: bool = True):
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots()
    for idx, label in enumerate(("xi_0", "xi_1", "xi_2")):
        ax.semilogy(result.xi_history[:, idx], linewidth=2, label=label)
    ax.set_title("Residual values of Chambolle-Pock algorithm iterations")
    ax.set_ylabel("log(residual value)", fontsize=12)
    ax.set_xlabel("iteration", fontsize=12)
    ax.legend()
    if filename is not None:
        fig.savefig(filename)
    if show:
        plt.show()
    return fig


def plot_solution(tree, result, filename: Optional[str] = None,
                  show: bool = True):
    import matplotlib.pyplot as plt

    x = np.asarray(result.primal.x)
    u = np.asarray(result.primal.u)
    n, m = x.shape[1], u.shape[1]
    num_stages = tree.num_stages
    fig, axs = plt.subplots(2, max(n, m), sharex="all", sharey="row",
                            squeeze=False)
    fig.set_size_inches(15, 8)

    leaves = tree.nodes_at_stage(num_stages - 1)
    for element in range(n):
        for leaf in leaves:
            path, j = [], leaf
            while j >= 0:
                path.append((tree.stage_of(j), x[j, element]))
                j = tree.ancestor_of(j)
            path = np.asarray(path, dtype=float)
            axs[0, element].plot(path[:, 0], path[:, 1])
        axs[0, element].set_title(f"state element, x_{element}(t)")
    for element in range(m):
        for leaf in leaves:
            path, j = [], tree.ancestor_of(leaf)
            while j >= 0:
                path.append((tree.stage_of(j), u[j, element]))
                j = tree.ancestor_of(j)
            path = np.asarray(path, dtype=float)
            axs[1, element].plot(path[:, 0], path[:, 1])
        axs[1, element].set_title(f"control element, u_{element}(t)")
    for ax in axs.flat:
        ax.set(xlabel="stage, t", ylabel="value")
        ax.label_outer()
    fig.tight_layout()
    if filename is not None:
        fig.savefig(filename)
    if show:
        plt.show()
    return fig


def save_residuals_tex(result, filename: str) -> None:
    """Write the residual curves as a standalone pgfplots .tex file.

    Parity with the reference's tikzplotlib export of the residual plot
    (reference ``solver.py:199`` writes '4-3-residuals.tex'); implemented
    directly (tikzplotlib is not a dependency) as a semilog axis with one
    addplot per curve.
    """
    hist = result.xi_history
    names = ("xi_0", "xi_1", "xi_2")
    lines = [
        "\\begin{tikzpicture}",
        "\\begin{semilogyaxis}[",
        "xlabel={iteration $k$}, ylabel={residual},",
        "legend entries={$\\xi_0$,$\\xi_1$,$\\xi_2$}]",
    ]
    for c in range(3):
        lines.append(f"\\addplot+[mark=none] coordinates {{%  {names[c]}")
        for k in range(hist.shape[0]):
            lines.append(f"({k},{hist[k, c]:.6e})")
        lines.append("};")
    lines += ["\\end{semilogyaxis}", "\\end{tikzpicture}", ""]
    with open(filename, "w") as fh:
        fh.write("\n".join(lines))


def _scenario_paths(tree, values, from_parent: bool):
    """One (stage, value) polyline per leaf scenario, walking ancestors
    (the reference's trajectory-fan construction, ``solver.py:218-242``).
    ``from_parent`` starts each walk at the leaf's parent (controls live on
    nonleaf nodes)."""
    leaves = tree.nodes_at_stage(tree.num_stages - 1)
    paths = []
    for leaf in leaves:
        j = int(tree.ancestor_of(leaf)) if from_parent else int(leaf)
        pts = []
        while j >= 0:
            pts.append((int(tree.stage_of(j)), float(values[j])))
            j = int(tree.ancestor_of(j))
        paths.append(list(reversed(pts)))
    return paths


def save_solution_tex(tree, result, filename: str) -> None:
    """Write the solution trajectory fans as a standalone pgfplots .tex
    file — one groupplot per state/control element, one addplot per leaf
    scenario.

    Parity with the reference's tikzplotlib export of the solution plot
    (reference ``solver.py:202-253`` writes 'python-solution.tex');
    implemented directly since tikzplotlib is not a dependency.
    """
    x = np.asarray(result.primal.x)
    u = np.asarray(result.primal.u)
    n, m = x.shape[1], u.shape[1]
    cols = max(n, m)
    lines = [
        "\\begin{tikzpicture}",
        "\\begin{groupplot}[group style={group size="
        f"{cols} by 2}},",
        "xlabel={stage $t$}, ylabel={value}]",
    ]

    def emit(paths, title):
        lines.append(f"\\nextgroupplot[title={{{title}}}]")
        for pts in paths:
            lines.append("\\addplot+[mark=none] coordinates {")
            for t, v in pts:
                lines.append(f"({t},{v:.6e})")
            lines.append("};")

    for element in range(cols):
        if element < n:
            emit(_scenario_paths(tree, x[:, element], from_parent=False),
                 f"$x_{{{element}}}(t)$")
        else:
            lines.append("\\nextgroupplot[hide axis]")
    for element in range(cols):
        if element < m:
            emit(_scenario_paths(tree, u[:, element], from_parent=True),
                 f"$u_{{{element}}}(t)$")
        else:
            lines.append("\\nextgroupplot[hide axis]")
    lines += ["\\end{groupplot}", "\\end{tikzpicture}", ""]
    with open(filename, "w") as fh:
        fh.write("\n".join(lines))

"""The plain reference: the risk-averse optimal control problem's
Chambolle-Pock (CP) map, written from the problem's definition in plain
PyTorch, node by node in batches, with none of the system under test's
layouts, tables or kernels (it imports nothing of it).

The problem, per nonleaf node i with children j and leaf l (the upstream
project's formulation, AVaR risks, box or ball constraints):

  primal z = (x [N, n], u [NL, m], y [NL, Y], tau [N], s [N])
  L z:  e1_i = y_i            e2_i = s_i - b_i'y_i
        e3_j = sqrt(Q_j) x_i  e4_j = sqrt(R_j) u_i   e5_j = e6_j = tau_j/2
        e7_i = [x_i; u_i]     e11_l = sqrt(P) x_l    e12_l = e13_l = s_l/2
        e14_l = x_l
  f: s_0 (the objective) plus the indicators of the dynamics
     {x_0 = x0, x_j = A_j x_i + B_j u_i} and of ker [E_i', -I, -I] on
     (y_i, tau_children, s_children)
  g: the indicators of the dual risk cone (e1), the orthant (e2), the
     second-order cones ||(e3, e4, e5 - 1/2)|| <= e6 + 1/2 and
     ||(e11, e12 - 1/2)|| <= e13 + 1/2, and the state-input sets: by the
     configuration's ``constraint`` the boxes |x| <= x_limit, |u| <=
     u_limit (e7) and |x| <= x_limit (e14), or the balls ||e7|| <= radius
     and ||e14|| <= radius, centred at 0.

:class:`Reference` holds one problem on a device in a dtype: ``L``, ``Lt``
(its adjoint), the proximal maps, one CP step, the residuals of a point,
the step size (a power iteration on L'L) and a plain CP loop (the control
of :mod:`benchmark.judge` runs it in a lower precision). The dynamics
projection is the dynamic-programming sweep derived from the value
functions V_j(x) = x'P_j x / 2 + q_j'x, its factors worked out here once
a problem.
"""

import math

import numpy as np
import torch

PRIMAL = ("x", "u", "y", "tau", "s")
DUAL = ("e1", "e2", "e3", "e4", "e5", "e6", "e7", "e11", "e12", "e13",
        "e14")
# rows of the dynamics factorisation's parents a block
BLOCK = 2048


def _mv(mats, v):
    """Batched matrix-vector products: mats [W, a, b], v [W, b] -> [W, a]."""
    return torch.einsum("wab,wb->wa", mats, v)


def _soc(head, tail):
    """Projection onto {(h, t): ||h|| <= t}, row by row."""
    nh = torch.linalg.vector_norm(head, dim=-1)
    half = 0.5 * (nh + tail)
    inside = nh <= tail
    polar = nh <= -tail
    scale = torch.where(nh > 0, half / torch.where(nh > 0, nh, 1.0), 0.0)
    ph = torch.where(inside[:, None], head,
                     torch.where(polar[:, None], 0.0, scale[:, None] * head))
    pt = torch.where(inside, tail, torch.where(polar, 0.0, half))
    return ph, pt


def _ball(v, radius):
    """Projection onto {v: ||v|| <= radius}, row by row: a row outside is
    scaled onto the sphere, a row inside is left as it is."""
    norm = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    return v * (radius / norm.clamp_min(radius))


def inf_norm(tree: dict) -> float:
    return max(float(v.abs().max()) for v in tree.values() if v.numel())


class Reference:
    """One problem: ``config`` (sizes, costs, sets, AVaR level), its
    ``plant`` and ``tree`` (:mod:`benchmark.reference.problem`), on
    ``device`` in ``dtype``."""

    def __init__(self, config: dict, plant, tree, device, dtype):
        self.device, self.dtype = torch.device(device), dtype
        n, m = config["num_states"], config["num_inputs"]
        self.n, self.m = n, m
        N, NL = tree.num_nodes, tree.num_nonleaf
        self.N, self.NL, self.LF = N, NL, N - NL
        counts = np.unique(tree.child_count)
        if len(counts) != 1:
            raise NotImplementedError("the reference takes trees whose "
                                      "nonleaf nodes have equal child counts")
        c = int(counts[0])
        self.c, self.Y = c, 2 * c + 1

        def t(a, dt=dtype):
            return torch.as_tensor(np.asarray(a), dtype=dt, device=device)

        self.anc = t(tree.anc, torch.int64)
        self.stage_start = np.searchsorted(tree.stage,
                                           np.arange(tree.num_stages + 2))
        self.first = tree.child_first
        self.kids = t(tree.child_first[:, None] + np.arange(c), torch.int64)
        self.mode = tree.mode
        self.A, self.B = t(plant.A), t(plant.B)
        eye = np.eye(n)
        self.sqrtQ = t(math.sqrt(config["Q"]) * eye)
        self.sqrtR = t(math.sqrt(config["R"]) * np.eye(m))
        self.sqrtP = t(math.sqrt(config["P"]) * eye)
        self.radius = None
        if config["constraint"] == "ball":
            self.radius = float(config["radius"])
        else:
            x_lim, u_lim = config["x_limit"], config["u_limit"]
            self.lo7 = t(np.r_[-x_lim * np.ones(n), -u_lim * np.ones(m)])
            self.lo14 = t(-x_lim * np.ones(n))
        # AVaR_alpha: E = [alpha I; -I; 1'], b = [pi; 0; 1], cone
        # NnOC(2c) x Zero(1), whose dual cone is NnOC(2c) x R
        alpha = config["alpha"]
        cond = tree.cond_prob()
        pi = cond[tree.child_first[:, None] + np.arange(c)]
        self.b = t(np.concatenate([pi, np.zeros((NL, c)), np.ones((NL, 1))],
                                  axis=1))
        E = np.concatenate([alpha * np.eye(c), -np.eye(c), np.ones((1, c))])
        M = np.concatenate([E.T, -np.eye(c), -np.eye(c)], axis=1)
        self.M = t(M)
        self.MMt_inv = torch.linalg.inv(self.M @ self.M.T)
        self._sel = {}
        self._factorise()
        self.lam = None

    # -- the spaces -------------------------------------------------------

    def zero_primal(self):
        z = lambda *s: torch.zeros(s, dtype=self.dtype, device=self.device)
        return dict(x=z(self.N, self.n), u=z(self.NL, self.m),
                    y=z(self.NL, self.Y), tau=z(self.N), s=z(self.N))

    def zero_dual(self):
        z = lambda *s: torch.zeros(s, dtype=self.dtype, device=self.device)
        N, NL, LF, n, m = self.N, self.NL, self.LF, self.n, self.m
        return dict(e1=z(NL, self.Y), e2=z(NL), e3=z(N, n), e4=z(N, m),
                    e5=z(N), e6=z(N), e7=z(NL, n + m), e11=z(LF, n),
                    e12=z(LF), e13=z(LF), e14=z(LF, n))

    # -- L and its adjoint ------------------------------------------------

    def L(self, z):
        NL, n = self.NL, self.n
        par = self.anc[1:]
        e3 = torch.zeros_like(z["x"])
        e3[1:] = z["x"][par] @ self.sqrtQ.T
        e4 = z["x"].new_zeros((self.N, self.m))
        e4[1:] = z["u"][par] @ self.sqrtR.T
        half_tau = 0.5 * z["tau"]
        half_tau[0] = 0.0
        x_leaf = z["x"][NL:]
        half_s = 0.5 * z["s"][NL:]
        return dict(e1=z["y"].clone(),
                    e2=z["s"][:NL] - (self.b * z["y"]).sum(-1),
                    e3=e3, e4=e4, e5=half_tau, e6=half_tau.clone(),
                    e7=torch.cat([z["x"][:NL], z["u"]], dim=1),
                    e11=x_leaf @ self.sqrtP.T, e12=half_s,
                    e13=half_s.clone(), e14=x_leaf.clone())

    def Lt(self, e):
        NL, n = self.NL, self.n
        par = self.anc[1:]
        x = torch.empty((self.N, n), dtype=self.dtype, device=self.device)
        x[:NL] = e["e7"][:, :n].index_add(0, par, e["e3"][1:] @ self.sqrtQ)
        x[NL:] = e["e11"] @ self.sqrtP + e["e14"]
        u = e["e7"][:, n:].index_add(0, par, e["e4"][1:] @ self.sqrtR)
        tau = 0.5 * (e["e5"] + e["e6"])
        tau[0] = 0.0
        s = torch.cat([e["e2"], 0.5 * (e["e12"] + e["e13"])])
        return dict(x=x, u=u, y=e["e1"] - self.b * e["e2"][:, None],
                    tau=tau, s=s)

    # -- prox of f --------------------------------------------------------

    def _factorise(self):
        """Per nonleaf node i: H_i = I + sum_j B_j'P_jB_j, K_i =
        -H_i^-1 sum_j B_j'P_jA_j, and S_i = sum_j Abar_j'P_jB_j with Abar_j
        = A_j + B_jK_i; P_i = I + K_i'K_i + sum_j Abar_j'P_jAbar_j (P = I
        at the leaves), stage by stage from the leaves, in blocks of
        parents."""
        n, m, NL = self.n, self.m, self.NL
        dt, dev = self.dtype, self.device
        self.K = torch.empty((NL, m, n), dtype=dt, device=dev)
        self.Hinv = torch.empty((NL, m, m), dtype=dt, device=dev)
        self.S = torch.empty((NL, n, m), dtype=dt, device=dev)
        mode = torch.as_tensor(self.mode, device=dev)
        eye_n = torch.eye(n, dtype=dt, device=dev)
        eye_m = torch.eye(m, dtype=dt, device=dev)
        ss = self.stage_start
        P_next = None                 # P of the stage below (None: I)
        for k in range(len(ss) - 3, -1, -1):
            a, b = int(ss[k]), int(ss[k + 1])
            P_k = torch.empty((b - a, n, n), dtype=dt, device=dev)
            for p0 in range(a, b, BLOCK):
                p1 = min(b, p0 + BLOCK)
                c0 = int(self.first[p0])
                c1 = c0 + (p1 - p0) * self.c
                par = self.anc[c0:c1] - p0
                Ac, Bc = self.A[mode[c0:c1]], self.B[mode[c0:c1]]
                if P_next is None:
                    PB, PA = Bc, Ac
                else:
                    Pc = P_next[c0 - int(ss[k + 1]):c1 - int(ss[k + 1])]
                    PB, PA = Pc @ Bc, Pc @ Ac
                Bt = Bc.transpose(1, 2)
                W = p1 - p0
                H = eye_m + torch.zeros((W, m, m), dtype=dt,
                                        device=dev).index_add(0, par, Bt @ PB)
                G = torch.zeros((W, m, n), dtype=dt,
                                device=dev).index_add(0, par, Bt @ PA)
                Hinv = torch.linalg.inv(H)
                K = -Hinv @ G
                Abar = Ac + Bc @ K[par]
                At = Abar.transpose(1, 2)
                self.K[p0:p1], self.Hinv[p0:p1] = K, Hinv
                self.S[p0:p1] = torch.zeros((W, n, m), dtype=dt,
                                            device=dev).index_add(
                    0, par, At @ PB)
                APA = At @ (Abar if P_next is None else Pc @ Abar)
                P_k[p0 - a:p1 - a] = (eye_n + K.transpose(1, 2) @ K
                                      + torch.zeros((W, n, n), dtype=dt,
                                                    device=dev).index_add(
                                          0, par, APA))
                del Ac, Bc, PB, PA, Abar, APA
            P_next = P_k
        del P_next

    def _stage_modes(self, k):
        """Stage k's children by mode: per mode, (rows among the stage's
        children, their parents among the stage's nodes)."""
        if k not in self._sel:
            a, a2, b2 = (int(self.stage_start[i]) for i in (k, k + 1, k + 2))
            mode = torch.as_tensor(self.mode[a2:b2], device=self.device)
            par = self.anc[a2:b2] - a
            self._sel[k] = [(rows, par[rows]) for rows in
                            (torch.nonzero(mode == w).flatten()
                             for w in range(self.A.shape[0]))]
        return self._sel[k]

    def project_dynamics(self, xh, uh, x0):
        """The Euclidean projection of (xh, uh) onto the dynamics: the
        linear terms q_i of the value functions from the leaves up (q = -xh
        at a leaf), u_i = K_i x_i + d_i, then the states from the root
        down."""
        n, m = self.n, self.m
        ss = self.stage_start
        q = -xh
        d = torch.empty_like(uh)
        for k in range(len(ss) - 3, -1, -1):
            a, b = int(ss[k]), int(ss[k + 1])
            qc = q[int(ss[k + 1]):int(ss[k + 2])]
            Btq = xh.new_zeros((b - a, m))
            Atq = xh.new_zeros((b - a, n))
            for w, (rows, par) in enumerate(self._stage_modes(k)):
                Btq.index_add_(0, par, qc[rows] @ self.B[w])
                Atq.index_add_(0, par, qc[rows] @ self.A[w])
            d[a:b] = _mv(self.Hinv[a:b], uh[a:b] - Btq)
            q = torch.cat([q[:a], -xh[a:b]
                           + _mv(self.K[a:b].transpose(1, 2),
                                 d[a:b] - uh[a:b] + Btq)
                           + _mv(self.S[a:b], d[a:b]) + Atq, q[b:]])
        x = torch.empty_like(xh)
        u = torch.empty_like(uh)
        x[0] = x0
        for k in range(len(ss) - 2):
            a, b = int(ss[k]), int(ss[k + 1])
            u[a:b] = _mv(self.K[a:b], x[a:b]) + d[a:b]
            x[int(ss[k + 1]):int(ss[k + 2])] = self._children(k, x, u)
        return x, u

    def _children(self, k, x, u):
        """A_j x_i + B_j u_i for the children j of stage k's nodes i."""
        a, b = int(self.stage_start[k]), int(self.stage_start[k + 1])
        xc = x.new_empty((int(self.stage_start[k + 2]) - b, self.n))
        for w, (rows, par) in enumerate(self._stage_modes(k)):
            xc[rows] = x[a:b][par] @ self.A[w].T + u[a:b][par] @ self.B[w].T
        return xc

    def project_kernel(self, y, tau, s):
        """Project (y_i, tau_children, s_children) onto ker [E', -I, -I]
        at every nonleaf node."""
        Y, c = self.Y, self.c
        v = torch.cat([y, tau[self.kids], s[self.kids]], dim=1)
        w = (v @ self.M.T) @ self.MMt_inv.T
        v = v - w @ self.M
        tau, s = tau.clone(), s.clone()
        tau[self.kids] = v[:, Y:Y + c]
        s[self.kids] = v[:, Y + c:]
        return v[:, :Y], tau, s

    def prox_f(self, z, alpha, x0):
        s = z["s"].clone()
        s[0] -= alpha
        x, u = self.project_dynamics(z["x"], z["u"], x0)
        y, tau, s = self.project_kernel(z["y"], z["tau"], s)
        return dict(x=x, u=u, y=y, tau=tau, s=s)

    # -- prox of g* (Moreau) ------------------------------------------------

    def prox_g_conj(self, e, alpha):
        n, m, c = self.n, self.m, self.c
        mod = {k: v / alpha for k, v in e.items()}
        mod["e5"][1:] -= 0.5                  # the root has no stage cost
        mod["e6"][1:] += 0.5
        mod["e12"] = mod["e12"] - 0.5
        mod["e13"] = mod["e13"] + 0.5
        p1 = torch.cat([mod["e1"][:, :2 * c].clamp_min(0),
                        mod["e1"][:, 2 * c:]], dim=1)
        head, tail = _soc(torch.cat([mod["e3"], mod["e4"],
                                     mod["e5"][:, None]], dim=1), mod["e6"])
        lhead, ltail = _soc(torch.cat([mod["e11"], mod["e12"][:, None]],
                                      dim=1), mod["e13"])
        if self.radius is None:
            e7 = torch.minimum(torch.maximum(mod["e7"], self.lo7), -self.lo7)
            e14 = torch.minimum(torch.maximum(mod["e14"], self.lo14),
                                -self.lo14)
        else:
            e7 = _ball(mod["e7"], self.radius)
            e14 = _ball(mod["e14"], self.radius)
        proj = dict(e1=p1, e2=mod["e2"].clamp_min(0), e3=head[:, :n],
                    e4=head[:, n:n + m], e5=head[:, -1], e6=tail, e7=e7,
                    e11=lhead[:, :n], e12=lhead[:, -1], e13=ltail, e14=e14)
        return {k: alpha * (mod[k] - proj[k]) for k in DUAL}

    # -- the CP map -------------------------------------------------------

    def step_size(self, iters: int = 1000, rtol: float = 1e-10) -> float:
        """0.999 / lambda_max(L'L), by a power iteration from a fixed
        start."""
        if self.lam is None:
            g = torch.Generator(device="cpu").manual_seed(0)
            z = {k: torch.randn(v.shape, generator=g, dtype=torch.float64)
                 .to(self.device, self.dtype)
                 for k, v in self.zero_primal().items()}
            lam = 0.0
            for _ in range(iters):
                norm = math.sqrt(sum(float((v * v).sum())
                                     for v in z.values()))
                z = self.Lt(self.L({k: v / norm for k, v in z.items()}))
                new = math.sqrt(sum(float((v * v).sum())
                                    for v in z.values()))
                if abs(new - lam) <= rtol * new:
                    lam = new
                    break
                lam = new
            self.lam = lam
        return 0.999 / self.lam

    def step(self, z, e, Lz, Lte, alpha, x0):
        """One CP step from (z, e) with L z and L'e given: (z+, e+, L z+,
        L'e+)."""
        zn = self.prox_f({k: z[k] - alpha * Lte[k] for k in PRIMAL},
                         alpha, x0)
        Lzn = self.L(zn)
        en = self.prox_g_conj({k: e[k] + alpha * (2 * Lzn[k] - Lz[k])
                               for k in DUAL}, alpha)
        return zn, en, Lzn, self.Lt(en)

    def residuals(self, z, e, zn, en, Lz, Lte, Lzn, Lten, alpha):
        """[xi_0, xi_1, xi_2]: the max-norms of xi_1 = (z - z+)/alpha -
        L'(e - e+), xi_2 = (e - e+)/alpha + L(z+ - z) and xi_0 = xi_1 +
        L' xi_2."""
        xi1 = {k: (z[k] - zn[k]) / alpha - (Lte[k] - Lten[k])
               for k in PRIMAL}
        xi2 = {k: (e[k] - en[k]) / alpha + (Lzn[k] - Lz[k]) for k in DUAL}
        Lt2 = self.Lt(xi2)
        xi0 = {k: xi1[k] + Lt2[k] for k in PRIMAL}
        return [inf_norm(xi0), inf_norm(xi1), inf_norm(xi2)]

    def residual_at(self, z, e, x0) -> list:
        """The residuals of one CP step from the point (z, e)."""
        alpha = self.step_size()
        Lz, Lte = self.L(z), self.Lt(e)
        zn, en, Lzn, Lten = self.step(z, e, Lz, Lte, alpha, x0)
        return self.residuals(z, e, zn, en, Lz, Lte, Lzn, Lten, alpha)

    def dynamics_gap(self, z, x0) -> float:
        """max |x_j - A_j x_i - B_j u_i| and |x_0 - x0| over max(1, |x|)."""
        x, u, ss = z["x"], z["u"], self.stage_start
        gap = float((x[0] - x0).abs().max())
        for k in range(len(ss) - 2):
            off = x[int(ss[k + 1]):int(ss[k + 2])] - self._children(k, x, u)
            gap = max(gap, float(off.abs().max()))
        return gap / max(1.0, float(x.abs().max()))

    def solve(self, x0, tol, max_iters, check_every=25, relax=1.0,
              warm_start=None):
        """Plain CP from zero (x_0 = x0) or ``warm_start`` (z, e) until the
        residuals of a checked step are at most ``tol`` or ``max_iters``
        steps ran; ``relax`` over-relaxes each step. Returns (z, e,
        iterations, the last residuals)."""
        x0 = torch.as_tensor(x0, dtype=self.dtype, device=self.device)
        alpha = self.step_size()
        if warm_start is None:
            z, e = self.zero_primal(), self.zero_dual()
            z["x"][0] = x0
        else:
            z, e = warm_start
        Lz, Lte = self.L(z), self.Lt(e)
        k, xi = 0, [math.inf] * 3
        while k < max_iters and max(xi) > tol:
            zn, en, Lzn, Lten = self.step(z, e, Lz, Lte, alpha, x0)
            k += 1
            if k % check_every == 0:
                xi = self.residuals(z, e, zn, en, Lz, Lte, Lzn, Lten, alpha)
            if relax != 1.0:
                z, e, Lz, Lte = ({key: a[key] + relax * (b[key] - a[key])
                                  for key in a}
                                 for a, b in ((z, zn), (e, en), (Lz, Lzn),
                                              (Lte, Lten)))
            else:
                z, e, Lz, Lte = zn, en, Lzn, Lten
        return z, e, k, xi

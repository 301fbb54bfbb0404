"""
Plain masked-lattice SKI GP regression: the benchmark's reference for the
``ski_masked_rbf`` configuration.

Written from the model's equations, in plain PyTorch, for any dtype and
device; the benchmark runs it in float64 with TF32 off. It imports nothing
of the program under test. It reads the scan (a grid with NaN at the cells
not measured) and derives the mask, the hyperparameters' bounds and initial
values, the probes, the preconditioner and every kernel factor itself. One
input comes from the program's job: the lengths of the training segments,
at whose starts the preconditioner is rebuilt, because they follow the
program's realized CG iterations.

Model (GPim's ``skreconstructor``, structured-kernel route, on the data
lattice): a grid of shape (g_1, ..., g_d) with axis k at 0, ..., g_k - 1;
M the 0/1 mask of the n measured cells of G; y the scan.

    K = v K_1 (x) K_2 (x) ... (x) K_d,  K_k[i, j] = exp(-0.5 (i - j)^2 / l_k^2)
    A = M K M + s I,  s = noise + jitter,  yc = M (y - mu)
    loss = 0.5 yc^T A^-1 yc + 0.5 logdet A + 0.5 n log 2 pi
           - 0.5 (G - n) log s - log J(l)

A cell not measured is a noise-only row of A; the fourth term takes its
log-determinant out again. l = h sigmoid(u_l) with h = mean(grid shape) / 2
and log J the log-Jacobian of that map; v = softplus(u_v), noise =
softplus(u_n), mu = u_mu. Initial values: l at a tenth of h, v = noise = 1,
mu = 0. Adam by hand (lr, b1 0.9, b2 0.999, eps 1e-8).

The estimator (the configuration's, exact in expectation):
- The preconditioner P = s I + L L^T, L = M Phi diag(sqrt(lam)). Phi's
  columns are Kronecker products of the factors' eigenvectors, those whose
  eigenvalue products lam are the ``rank`` largest among the products of
  each axis's top min(g_k, rank, cap) eigenvalues, ties to the lower index
  in C order over the axes' descending spectra; cap = max(16, ceil(4
  rank^(1/d))) in training, none in prediction. L^T L = V diag(lam_n) V^T,
  with every lam_n below 1e-6 of the largest dropped. With the orthonormal
  Q = L V diag(lam_n)^-1/2, P = s I + Q diag(lam_n) Q^T and
  P^-1/2 = I / sqrt(s) + Q diag(1 / sqrt(lam_n + s) - 1 / sqrt(s)) Q^T.
  P is built at the parameters of the first step of each training segment
  and held through the segment.
- The probes z_1 .. z_p = ``numpy.random.default_rng(seed).choice([-1, 1],
  (p, G))``, probes of B = P^-1/2 A P^-1/2.
- CG on B from P^-1/2 yc and from each z_i, each column run until its
  residual is within 100 eps of its right-hand side (eps of the dtype), at
  most ``MAX_CG`` iterations; alpha = A^-1 yc, s_i = P^-1/2 x_i = A^-1
  P^1/2 z_i for the solution x_i, w_i = P^-1/2 z_i.
- logdet A ~ logdet P + (1/p) sum_i |z_i|^2 e1^T log(T_i) e1, T_i the
  Lanczos tridiagonal of z_i's CG run (stochastic Lanczos quadrature).
- The gradient is that of alpha^T yc - 0.5 alpha^T A alpha
  + (1/2p) sum_i s_i^T A w_i with alpha, s_i and w_i held fixed, plus the
  exact terms of the loss: -0.5 alpha^T (dA) alpha + alpha^T (d yc)
  + (1/2p) sum_i s_i^T (dA) w_i.

Prediction at every cell of the lattice, at the trained parameters, with
the prediction's P: mean = K M alpha + mu for alpha = A^-1 yc, and

    var = v - |rows of (K Phi) diag(lam)^-1/2 V D|^2 + noise,
    D = diag(sqrt(lam_n / (lam_n + s))),

the first two terms clamped at 0 (lam clamped at 1e-12 of its largest).

Departures from the exact GP, as the configuration states them: the loss
and its gradient are the stochastic estimator's, not the exact marginal
likelihood's; the variance is the Nystrom estimator of the rank-``rank``
root, not the exact posterior variance, which would take G solves.
"""

import contextlib
import math

import numpy as np
import torch

__all__ = ["MAX_CG", "Lattice", "tf32", "initial_u", "hyperparams",
           "factors", "Preconditioner", "estimate", "train", "predict"]

# a bound on each CG run, so that a solve that cannot converge (the float32
# control) ends; the float64 runs converge long before it
MAX_CG = 1000
_BLOCK_BYTES = 256 * 1024 * 1024
_LOG_2PI = math.log(2.0 * math.pi)


@contextlib.contextmanager
def tf32(enabled):
    """TF32 for float32 products on the card inside the block, on or off
    (on: the lower-precision control of a float32 configuration)."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = bool(enabled)
    torch.backends.cudnn.allow_tf32 = bool(enabled)
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


class Lattice:
    """The scan ``R`` (NaN where not measured) on ``device`` in ``dtype``:
    ``shape``, ``G``, ``n``, ``mask`` and ``y`` (G,) in C order, and the
    bound ``h`` of the lengthscales."""

    def __init__(self, R, dtype, device):
        R = np.asarray(R, np.float64)
        self.shape = tuple(R.shape)
        self.G = R.size
        keep = ~np.isnan(R).reshape(-1)
        self.n = int(keep.sum())
        t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa
        self.mask = t(keep.astype(np.float64))
        self.y = t(np.nan_to_num(R).reshape(-1))
        self.axes = [t(np.arange(g, dtype=np.float64)) for g in self.shape]
        self.h = float(np.mean(self.shape)) / 2.0
        self.dtype, self.device = dtype, device


def _softplus(u):
    return torch.logaddexp(u, torch.zeros_like(u))


def initial_u(lat):
    """{l (d,), v, noise, mu}, unconstrained: l at a tenth of its interval,
    v = noise = 1, mu = 0."""
    d = len(lat.shape)
    t = lambda x: torch.tensor(x, dtype=lat.dtype, device=lat.device)  # noqa
    one = 1.0 + math.log(-math.expm1(-1.0))             # softplus^-1 (1)
    return {"l": t([math.log(0.1 / 0.9)] * d), "v": t(one),
            "noise": t(one), "mu": t(0.0)}


def _constrain(u, lat):
    return (lat.h * torch.sigmoid(u["l"]), _softplus(u["v"]),
            _softplus(u["noise"]), u["mu"])


def hyperparams(u, lat):
    """{lengthscale (d,), variance, noise, mean} as float64 numpy."""
    ls, v, noise, mu = _constrain(u, lat)
    return {"lengthscale": ls.detach().cpu().double().numpy(),
            "variance": float(v), "noise": float(noise), "mean": float(mu)}


def factors(ls, v, axes):
    """The 1D factors K_k (g_k, g_k); ``v`` multiplies the first."""
    out = []
    for k, a in enumerate(axes):
        diff = (a[:, None] - a[None, :]) / ls[k]
        f = torch.exp(-0.5 * diff * diff)
        out.append(v * f if k == 0 else f)
    return out


def _mode(t, F, k):
    """F (m, g_k) applied along grid axis k of t (b, g_1, ..., g_d)."""
    return torch.movedim(torch.tensordot(t, F, dims=([k + 1], [1])), -1,
                         k + 1)


def _kron(fs, V, shape):
    """((x)_k fs[k]) applied to each row of V (b, prod(shape))."""
    t = V.reshape((V.shape[0],) + tuple(shape))
    for k, F in enumerate(fs):
        t = _mode(t, F, k)
    return t.reshape(V.shape[0], -1)


def _apply_A(fs, s, V, lat):
    """A V for the rows of V: M K (M V) + s V."""
    return lat.mask * _kron(fs, V * lat.mask, lat.shape) + s * V


def _top_modes(fs, rank, cap):
    """(lam (r,), eigenvector tables [(g_k, g_k)] in descending order,
    index [(r,)] of each selected mode's eigenvector on each axis)."""
    lams, vecs = [], []
    for F in fs:
        lam, U = torch.linalg.eigh(F)
        lams.append(lam.flip(0)[:min(F.shape[0], rank, cap or F.shape[0])])
        vecs.append(U.flip(1))
    prod = lams[0]
    for lam in lams[1:]:
        prod = (prod[:, None] * lam[None, :]).reshape(-1)
    rank = min(rank, prod.shape[0])
    val, order = torch.sort(prod, descending=True, stable=True)
    idx, rem = [], order[:rank]
    for lam in reversed(lams):
        idx.append(rem % lam.shape[0])
        rem = torch.div(rem, lam.shape[0], rounding_mode="floor")
    return val[:rank].clamp_min(0.0), vecs, idx[::-1]


def _rows(tables, cells, shape):
    """Rows (len(cells), r) of the Kronecker products of the columns of
    ``tables`` [(g_k, r)] at the flat ``cells``."""
    out, rem = None, cells
    for k in range(len(shape) - 1, -1, -1):
        part = tables[k].index_select(0, rem % shape[k])
        rem = torch.div(rem, shape[k], rounding_mode="floor")
        out = part if out is None else out * part
    return out


class Preconditioner:
    """P = s I + Q diag(lam_n) Q^T of the factors ``fs`` on ``lat``'s mask,
    with the ``rank`` top Kronecker modes under ``cap`` (None: uncapped)."""

    def __init__(self, fs, lat, rank, cap):
        self.lam, self.vecs, self.idx = _top_modes(fs, rank, cap)
        self.sel = [U.index_select(1, i) for U, i in zip(self.vecs,
                                                         self.idx)]
        strides = np.cumprod((1,) + lat.shape[::-1])[::-1][1:]
        self.flat = sum(int(st) * i for st, i in zip(strides, self.idx))
        r = self.lam.shape[0]
        rl = self.lam.sqrt()
        # L^T L over the measured cells, a block of rows at a time
        obs = torch.nonzero(lat.mask).squeeze(1)
        nb = max(1, _BLOCK_BYTES // (r * self.lam.element_size()))
        N = self.lam.new_zeros((r, r))
        for i in range(0, obs.shape[0], nb):
            rows = _rows(self.sel, obs[i:i + nb], lat.shape) * rl
            N += rows.mT @ rows
        lam_n, V = torch.linalg.eigh(N)
        lam_n = lam_n.clamp_min(0.0)
        keep = lam_n > 1e-6 * lam_n.max()
        self.lam_n, self.V = lam_n[keep], V[:, keep]
        self.rl, self.lat = rl, lat
        self.C = self.V * self.lam_n.rsqrt()                 # (r, r')

    def _QT(self, X):
        lat = self.lat
        t = _kron([U.mT for U in self.vecs], X * lat.mask, lat.shape)
        return (t.index_select(1, self.flat) * self.rl) @ self.C

    def _Q(self, W):
        lat = self.lat
        t = W.new_zeros((W.shape[0], lat.G))
        t.index_copy_(1, self.flat, (W @ self.C.mT) * self.rl)
        return lat.mask * _kron(self.vecs, t, lat.shape)

    def inv_sqrt(self, s):
        """X -> P^-1/2 X for the rows of X."""
        d = (self.lam_n + s).rsqrt() - s.rsqrt()
        return lambda X: X * s.rsqrt() + self._Q(self._QT(X) * d)

    def logdet(self, s):
        return self.lat.G * torch.log(s) + torch.log1p(self.lam_n / s).sum()


def _cg(op, B):
    """CG on the SPD ``op`` for each row of B; returns (X, the most
    iterations a row took, [the Lanczos tridiagonal (diag, off) of each
    row, float64 numpy])."""
    eps = torch.finfo(B.dtype).eps
    X = torch.zeros_like(B)
    R = B.clone()
    D = R.clone()
    rr = (R * R).sum(1)
    tol = rr * (100.0 * eps) ** 2
    live = rr > tol
    alphas, betas, lives = [], [], []
    for k in range(MAX_CG):
        if k % 8 == 0 and not bool(live.any()):
            break
        OD = op(D)
        a = torch.where(live, rr / (D * OD).sum(1), torch.zeros_like(rr))
        X = X + a[:, None] * D
        R = R - a[:, None] * OD
        rr_new = (R * R).sum(1)
        b = torch.where(live, rr_new / rr, torch.zeros_like(rr))
        D = torch.where(live[:, None], R + b[:, None] * D, D)
        alphas.append(a)
        betas.append(b)
        lives.append(live)
        rr = torch.where(live, rr_new, rr)
        live = live & (rr_new > tol)
    if not alphas:
        return X, 0, [(np.zeros(0), np.zeros(0))] * B.shape[0]
    a = torch.stack(alphas).double().cpu().numpy()
    b = torch.stack(betas).double().cpu().numpy()
    m = torch.stack(lives).sum(0).cpu().numpy()
    tri = []
    for j in range(B.shape[0]):
        aj, bj = a[:m[j], j], b[:m[j], j]
        diag = 1.0 / aj
        diag[1:] += bj[:-1] / aj[:-1]
        tri.append((diag, np.sqrt(bj[:-1]) / aj[:-1]))
    return X, int(m.max()), tri


def _quadrature(diag, off):
    """e1^T log(T) e1 for the tridiagonal T."""
    if diag.size == 0:
        return 0.0
    lam, U = np.linalg.eigh(np.diag(diag) + np.diag(off, 1)
                            + np.diag(off, -1))
    return float((U[0] ** 2 * np.log(np.maximum(lam, 1e-300))).sum())


def _probes(lat, p, seed):
    z = np.random.default_rng(seed).choice([-1.0, 1.0], size=(p, lat.G))
    return torch.as_tensor(z, dtype=lat.dtype, device=lat.device)


def estimate(u, lat, pre, Z, jitter):
    """The loss and its gradient {key: tensor} at ``u`` by the estimator
    with the preconditioner ``pre`` and the probes ``Z`` (p, G); returns
    (loss, gradient, CG iterations, the probes' terms |z_i|^2 e1^T
    log(T_i) e1 (p,) numpy)."""
    w = {k: v.detach().clone().requires_grad_(True) for k, v in u.items()}
    ls, v, noise, mu = _constrain(w, lat)
    s = noise + jitter
    fs = factors(ls, v, lat.axes)
    yc = lat.mask * (lat.y - mu)
    with torch.no_grad():
        fs0, s0 = [f.detach() for f in fs], s.detach()
        ph = pre.inv_sqrt(s0)
        X, its, tri = _cg(lambda D: ph(_apply_A(fs0, s0, ph(D), lat)),
                          torch.cat([ph(yc.detach()[None]), Z]))
        X = ph(X)
        alpha, S, W = X[:1], X[1:], ph(Z)
        zz = (Z * Z).sum(1).double().cpu().numpy()
        terms = zz * np.array([_quadrature(*t) for t in tri[1:]])
        logdet = float(pre.logdet(s0)) + float(terms.mean())
    exact = (0.5 * lat.n * _LOG_2PI - 0.5 * (lat.G - lat.n) * torch.log(s)
             - (math.log(lat.h) + torch.nn.functional.logsigmoid(w["l"])
                + torch.nn.functional.logsigmoid(-w["l"])).sum())
    surrogate = ((alpha[0] * yc).sum()
                 - 0.5 * (alpha * _apply_A(fs, s, alpha, lat)).sum()
                 + 0.5 * (S * _apply_A(fs, s, W, lat)).sum() / Z.shape[0])
    grads = torch.autograd.grad(surrogate + exact, list(w.values()))
    loss = (0.5 * float((yc.detach() * alpha[0]).sum()) + 0.5 * logdet
            + float(exact.detach()))
    return loss, dict(zip(w, grads)), its, terms


def train(R, segments, *, lr, jitter, n_probes, rank, seed=0,
          dtype=torch.float64, device="cpu"):
    """Adam over the training segments ``segments`` (their lengths) from
    the initial values; returns {"u", "losses" (steps,) the loss before
    each update, "lengthscale" (steps, d) and "noise" (steps,) after it,
    "max_cg" the most CG iterations of a step, "lat"}."""
    lat = Lattice(R, dtype, device)
    d = len(lat.shape)
    cap = max(16, int(np.ceil(4.0 * rank ** (1.0 / d))))
    Z = _probes(lat, n_probes, seed)
    u = initial_u(lat)
    m = {k: torch.zeros_like(v) for k, v in u.items()}
    v2 = {k: torch.zeros_like(v) for k, v in u.items()}
    losses, ls_traj, noise_traj, max_cg, t = [], [], [], 0, 0
    for steps in segments:
        with torch.no_grad():
            ls, var, _, _ = _constrain(u, lat)
            pre = Preconditioner(factors(ls, var, lat.axes), lat, rank, cap)
        for _ in range(steps):
            t += 1
            loss, g, its, _ = estimate(u, lat, pre, Z, jitter)
            losses.append(loss)
            max_cg = max(max_cg, its)
            for k in u:
                m[k] = 0.9 * m[k] + 0.1 * g[k]
                v2[k] = 0.999 * v2[k] + 0.001 * g[k] * g[k]
                mhat = m[k] / (1.0 - 0.9 ** t)
                vhat = v2[k] / (1.0 - 0.999 ** t)
                u[k] = u[k] - lr * mhat / (torch.sqrt(vhat) + 1e-8)
            hp = hyperparams(u, lat)
            ls_traj.append(hp["lengthscale"])
            noise_traj.append(hp["noise"])
    return {"u": u, "losses": np.array(losses),
            "lengthscale": np.array(ls_traj), "noise": np.array(noise_traj),
            "max_cg": max_cg, "lat": lat}


@torch.no_grad()
def predict(lat, u, *, jitter, rank):
    """Predictive mean and sd (observation noise included) at every cell
    of the lattice, shaped like it; and the CG iterations of the solve."""
    ls, v, noise, mu = _constrain(u, lat)
    s = noise + jitter
    fs = factors(ls, v, lat.axes)
    pre = Preconditioner(fs, lat, rank, None)
    ph = pre.inv_sqrt(s)
    yc = lat.mask * (lat.y - mu)
    x, its, _ = _cg(lambda D: ph(_apply_A(fs, s, ph(D), lat)), ph(yc[None]))
    alpha = ph(x)
    mean = _kron(fs, alpha * lat.mask, lat.shape)[0] + mu
    # the Nystrom variance: the rows of (K Phi) a block of the first axis
    # at a time
    lam = pre.lam.clamp_min(1e-12 * pre.lam.max())
    Bm = lam.rsqrt()[:, None] * (pre.V * (pre.lam_n / (pre.lam_n + s))
                                 .sqrt())
    T = [F @ S for F, S in zip(fs, pre.sel)]
    rest = lat.G // lat.shape[0]
    tb = max(1, _BLOCK_BYTES // (lam.shape[0] * rest * lam.element_size()))
    sq = []
    for i in range(0, lat.shape[0], tb):
        cells = torch.arange(i * rest, min(lat.G, (i + tb) * rest),
                             device=lat.device)
        sq.append(((_rows(T, cells, lat.shape) @ Bm) ** 2).sum(1))
    var = (v - torch.cat(sq)).clamp_min(0.0) + noise
    return (mean.reshape(lat.shape), var.sqrt().reshape(lat.shape), its)

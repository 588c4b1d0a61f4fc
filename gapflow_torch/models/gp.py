"""Gaussian-process surrogate engine and active-learning orchestration.

Counterpart of :mod:`gapflow_tpu.models.gp`: an anisotropic Matern-3/2
kernel over linearly scaled inputs, exact Cholesky inference on the
inverse factor, the negative log marginal likelihood with its closed-form
gradient, and a scipy-BFGS trainer.  The formulas and their order follow
the JAX package, so the two agree at float64 to rounding.

Training always runs in float64 on the CPU (small matrices, one scipy
iteration per objective call).  Inference over the grid (means, variance,
sound speed) runs in float64 on the Problem's device; only the padded
step buffers (:mod:`gapflow_torch.models.al_jit`) take the working dtype.

The :class:`GaussianProcessSurrogate` base class implements the
train/infer/active-learn protocol of the reference: variance-tolerance
trust test, argmax-variance acquisition into the shared Database, retrain
caps with pause, hyperparameter history, and cumulative timers.
"""

import math
from datetime import datetime

import numpy as np
import scipy.optimize
import torch

from ..utils import echo

_F64 = torch.float64
_CPU = torch.device("cpu")
_SQRT3 = math.sqrt(3.)


# ---------------------------------------------------------------------------
# Pure GP math (params: {"log_amp": 0-d tensor, "log_scale": (d,) tensor})
# ---------------------------------------------------------------------------

def kernel_fn(params, X1, X2):
    """amp * Matern32(L2 distance of per-dimension scaled inputs).

    The pairwise distance is the Gram form |a|^2 + |b|^2 - 2 a.b, with
    1e-14 under the square root (as in the JAX package)."""
    amp = torch.exp(params["log_amp"])
    inv_scale = torch.exp(-params["log_scale"])
    A = X1 * inv_scale
    B = X2 * inv_scale
    r2 = (torch.sum(A * A, dim=1)[:, None]
          + torch.sum(B * B, dim=1)[None, :]
          - 2. * (A @ B.T))
    r = torch.sqrt(torch.clamp(r2, min=0.) + 1e-14)
    arg = _SQRT3 * r
    return amp * (1. + arg) * torch.exp(-arg)


def kernel_gram(params, X):
    """Train-train kernel matrix, exactly symmetric with the exact
    stationary diagonal (amp)."""
    K = kernel_fn(params, X, X)
    K = 0.5 * (K + K.T)
    amp = torch.exp(params["log_amp"])
    i = torch.arange(X.shape[0], device=X.device)
    K[i, i] = amp
    return K


def kernel_diag(params, X):
    """Diagonal of the kernel matrix (constant = amp for stationary kernels)."""
    amp = torch.exp(params["log_amp"])
    return amp.expand(X.shape[0])


def cholesky(A):
    """Lower Cholesky factor of ``A``, all NaN where ``A`` is not
    positive definite (as the JAX package's factorization returns; the
    BFGS line search then backs off such a step instead of failing)."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where(info == 0, L, torch.full_like(L, float("nan")))


def _invert_cholesky(L):
    """Explicit inverse of the lower-triangular Cholesky factor."""
    eye = torch.eye(L.shape[0], dtype=L.dtype, device=L.device)
    return torch.linalg.solve_triangular(L, eye, upper=False)


def _weights_from_inv(Linv, Y):
    """alpha = K^{-1} Y from the inverse factor: two matmuls, no solves."""
    Y2 = Y if Y.ndim == 2 else Y[:, None]
    a = Linv @ Y2
    alpha = Linv.T @ a
    return (alpha if Y.ndim == 2 else alpha[:, 0]), a


def _outputs_first(mean):
    """(ntest, m) -> (m, ntest); a single output (ntest,) stays as it is."""
    return mean.T if mean.ndim == 2 else mean


def _eye_like(K):
    return torch.eye(K.shape[0], dtype=K.dtype, device=K.device)


def gp_condition(params, X, Y, yerr):
    """Inverse Cholesky factor and weights for training data.

    Y may be (n,) or (n, m) for m outputs sharing one kernel.  Returns the
    cache (Linv, alpha, yerr2) with Linv = L^{-1} of the noisy gram
    B = K + yerr^2 I."""
    K = kernel_gram(params, X)
    yerr2 = torch.as_tensor(yerr, dtype=K.dtype, device=K.device) ** 2
    L = cholesky(K + yerr2 * _eye_like(K))
    Linv = _invert_cholesky(L)
    alpha, _ = _weights_from_inv(Linv, Y)
    return Linv, alpha, yerr2


def gp_predict_mean(params, X, cache, Xtest):
    """Predictive mean(s) at Xtest from cached weights; (m, ntest) or (ntest,)."""
    _, alpha, _ = cache
    return _outputs_first(kernel_fn(params, X, Xtest).T @ alpha)


def gp_predict_mean_var(params, X, cache, Xtest):
    """Predictive mean(s) and (shared) variance at Xtest, observation
    noise included."""
    Linv, alpha, yerr2 = cache
    Ks = kernel_fn(params, X, Xtest)
    mean = Ks.T @ alpha
    v = Linv @ Ks
    var = kernel_diag(params, Xtest) + yerr2 - torch.sum(v * v, dim=0)
    return _outputs_first(mean), var


def nlml(params, X, Y, yerr):
    """Negative log marginal likelihood; multi-output Y sums over columns.
    Differentiable through :mod:`gapflow_torch.ops.cholesky` (its custom
    backward passes; the blocked kernels where that module's gate allows
    them)."""
    from ..ops.cholesky import cholesky as chol, tril_solve
    K = kernel_gram(params, X)
    n = X.shape[0]
    yerr2 = torch.as_tensor(yerr, dtype=K.dtype, device=K.device) ** 2
    L = chol(K + yerr2 * _eye_like(K))
    Y2 = Y if Y.ndim == 2 else Y[:, None]
    a = tril_solve(L, Y2)
    m = Y2.shape[1]
    quad = 0.5 * torch.sum(a * a)
    logdet = m * torch.sum(torch.log(torch.diagonal(L)))
    const = 0.5 * m * n * math.log(2. * math.pi)
    return quad + logdet + const


def _nlml_core(params, X, Y, yerr):
    """Closed-form NLML value and gradient (Rasmussen & Williams eq. 5.9)
    for the scaled Matern-3/2:

        dNLML/dtheta = 0.5 tr((m B^{-1} - alpha alpha^T) dK/dtheta),
        dK/dlog_amp     = K,
        dK/dlog_scale_j = 3 amp e^{-sqrt(3) r} D_j,

    with the D_j contraction as row sums plus one (n, d) matmul.  Returns
    (value, grad_dict, (L, Linv, alpha, yerr2))."""
    n = X.shape[0]
    amp = torch.exp(params["log_amp"])
    inv_scale = torch.exp(-params["log_scale"])
    Xs = X * inv_scale
    sq = torch.sum(Xs * Xs, dim=1)
    r2 = sq[:, None] + sq[None, :] - 2. * (Xs @ Xs.T)
    r = torch.sqrt(torch.clamp(0.5 * (r2 + r2.T), min=0.) + 1e-14)
    arg = _SQRT3 * r
    E = torch.exp(-arg)
    i = torch.arange(n, device=X.device)
    K = amp * (1. + arg) * E
    K[i, i] = amp                                  # pure kernel, diag = amp

    yerr2 = torch.as_tensor(yerr, dtype=K.dtype, device=K.device) ** 2
    eye = _eye_like(K)
    L = cholesky(K + yerr2 * eye)
    Linv = _invert_cholesky(L)
    alpha, a = _weights_from_inv(Linv, Y)

    Y2 = Y if Y.ndim == 2 else Y[:, None]
    m = Y2.shape[1]
    val = (0.5 * torch.sum(a * a)
           + m * torch.sum(torch.log(torch.diagonal(L)))
           + 0.5 * m * n * math.log(2. * math.pi))

    alpha2 = alpha if alpha.ndim == 2 else alpha[:, None]
    Binv = Linv.T @ Linv
    G = m * Binv - alpha2 @ alpha2.T

    g_amp = 0.5 * torch.sum(G * K)
    W = (1.5 * amp) * E * G                 # 0.5 * G * (3 amp E), symmetric
    rowsum = torch.sum(W, dim=1)
    WX = W @ Xs
    g_scale = 2. * (torch.sum(rowsum[:, None] * Xs * Xs, dim=0)
                    - torch.sum(Xs * WX, dim=0))
    grad = {"log_amp": g_amp, "log_scale": g_scale}
    return val, grad, (L, Linv, alpha, yerr2)


def nlml_value_and_grad(params, X, Y, yerr):
    """Analytic NLML value and gradient."""
    val, grad, _ = _nlml_core(params, X, Y, yerr)
    return val, grad


def gp_append(params, X, cache, Y_new, x_new, yerr):
    """Grow the conditioning cache by one training point in O(n^2).

    With K_new = [[K, k], [k^T, knn]] and L_new = [[L, 0], [w^T, d]],
    w = L^{-1} k, d = sqrt(knn + yerr^2 - w^T w), the inverse factor
    extends as L_new^{-1} = [[Linv, 0], [-(Linv^T w)^T / d, 1/d]].
    Returns (X_new, cache_new)."""
    Linv, _, yerr2 = cache

    k_vec = kernel_fn(params, X, x_new[None, :])[:, 0]
    knn = torch.exp(params["log_amp"])

    w = Linv @ k_vec
    d = torch.sqrt(torch.clamp(knn + yerr2 - w @ w, min=1e-12))
    bottom = -(Linv.T @ w) / d

    n = X.shape[0]
    Linv_new = Linv.new_zeros((n + 1, n + 1))
    Linv_new[:n, :n] = Linv
    Linv_new[n, :n] = bottom
    Linv_new[n, n] = 1. / d

    alpha_new, _ = _weights_from_inv(Linv_new, Y_new)
    X_new = torch.cat([X, x_new[None, :]])
    return X_new, (Linv_new, alpha_new, yerr2)


def _cpu64(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


def params_to_torch(params, dtype=_F64, device=_CPU):
    return {k: torch.as_tensor(np.array(v), dtype=dtype, device=device)
            for k, v in params.items()}


def fit_hyperparameters(params0, X, Y, yerr, method="BFGS"):
    """NLML minimization with scipy on the closed-form value and gradient,
    in float64 on the CPU.  The flat parameter vector is
    [log_amp, log_scale...] (sorted keys, as the JAX package ravels its
    dict).  Returns (params, final_objective); params as float64 CPU
    tensors."""
    X, Y = _cpu64(X), _cpu64(Y)
    yerr = float(yerr)
    keys = sorted(params0)
    sizes = [int(np.size(params0[k])) for k in keys]
    shapes = [np.shape(params0[k]) for k in keys]

    def unravel(flat):
        out, i = {}, 0
        for k, s, sh in zip(keys, sizes, shapes):
            out[k] = torch.as_tensor(flat[i:i + s]).reshape(sh)
            i += s
        return out

    def fun(flat):
        val, grad = nlml_value_and_grad(unravel(flat), X, Y, yerr)
        gflat = np.concatenate([np.atleast_1d(grad[k].numpy()) for k in keys])
        return float(val), gflat.astype(np.float64)

    flat0 = np.concatenate([np.atleast_1d(np.asarray(params0[k],
                                                     dtype=np.float64))
                            for k in keys])
    res = scipy.optimize.minimize(fun, flat0, jac=True, method=method)
    return unravel(np.asarray(res.x, dtype=np.float64)), float(res.fun)


def state_from_numpy(state, dtype=_F64, device=_CPU):
    """A padded GP step state (the layout of ``core.gp_step``) from numpy
    arrays, e.g. the JAX package's: ``Xscale``; per surrogate k in
    {z, x, y} ``params_k`` (a dict of arrays), ``Xfit_k``, ``alpha_k``,
    ``Yscale_k``.  Returns the same dict of tensors in ``dtype`` on
    ``device``; a database is carried over with :meth:`db.Database.load`."""
    out = {}
    for k, v in state.items():
        if isinstance(v, dict):
            out[k] = params_to_torch(v, dtype, device)
        else:
            out[k] = torch.as_tensor(np.asarray(v), dtype=dtype,
                                     device=device)
    return out


# ---------------------------------------------------------------------------
# Surrogate orchestration
# ---------------------------------------------------------------------------

class GaussianProcessSurrogate:
    """Base class: GP training, cached inference and active learning.

    Subclasses (Pressure / WallStress) provide the data plumbing through
    ``Xtrain``, ``Ytrain``, ``Xtest``, ``Yscale``, ``Yerr``.  Host
    protocol as :class:`gapflow_tpu.models.gp.GaussianProcessSurrogate`.
    ``self.device`` is where inference over the grid runs (float64).
    """

    name: str
    is_gp_model: bool

    def _gp_init(self, database):
        self._step = 0
        if self.is_gp_model:
            self.cond_gp = None      # inference cache (cleared to force resolve)
            self._database = database
            self._last_fit_train_size = 0
            self._pause = 0
            self.params = None
            self.maximum_variance = None
            self.variance_tol = None
            self._predictive_var = None

            ref = datetime.now()
            self._cumtime_train = ref - ref
            self._cumtime_infer = ref - ref

            self.history = {
                "step": [], "database_size": [], "variance": [],
                "obs_stddev": [], "maximum_variance": [], "variance_tol": [],
            }
            for li in self.active_dims:
                self.history[f"lengthscale_{li}"] = []

    # -- convenience --------------------------------------------------------
    def init_database(self, dim):
        if self.is_gp_model:
            self._database.initialize(self._features_host(), dim)

    @property
    def database(self):
        return self._database

    @property
    def last_fit_train_size(self):
        return self._last_fit_train_size

    def _features_host(self):
        """Feature matrix of every grid point, (N, n_features) float64
        numpy: (rho, jx, jy, h, hx, hy, extra...)."""
        feats = np.vstack([np.asarray(self.solution),
                           np.asarray(self.height_and_slopes),
                           np.asarray(self.extra)])
        return feats.reshape(self._database.num_features, -1).T

    @property
    def _Xtest(self):
        """The feature matrix in float64 on the inference device."""
        return torch.as_tensor(self._features_host(), dtype=_F64,
                               device=self.device)

    @property
    def Xtest(self):
        scale = torch.as_tensor(self.database.X_scale, dtype=_F64,
                                device=self.device)
        return (self._Xtest / scale)[:, list(self.active_dims)]

    @property
    def Xtrain(self):
        # sliced to the last fit size: the shared database may have grown
        # through another surrogate's active learning since our fit
        n = self.last_fit_train_size or self.database.size
        return self.database.Xtrain[:n, list(self.active_dims)]

    @property
    def Ytrain(self):
        return self._Ytrain / self.Yscale

    @property
    def trusted(self):
        return self.maximum_variance < self.variance_tol

    @property
    def kernel_variance(self):
        return float(torch.exp(self.params["log_amp"]))

    @property
    def kernel_lengthscale(self):
        return torch.exp(self.params["log_scale"]).numpy()

    @property
    def obs_stddev(self):
        return self.Yerr

    @property
    def cumtime_train(self):
        return self._cumtime_train

    @property
    def cumtime_infer(self):
        return self._cumtime_infer

    def _init_params(self):
        self.params_init = {
            "log_amp": np.log(1.),
            "log_scale": np.log(np.std(self.Xtrain, axis=0)),
        }

    # -- logging ------------------------------------------------------------
    def write(self):
        if not self.is_gp_model:
            return
        self.history["step"].append(self._step)
        self.history["database_size"].append(self._database.size)
        self.history["variance"].append(self.kernel_variance)
        self.history["obs_stddev"].append(float(self.obs_stddev))
        self.history["maximum_variance"].append(float(self.maximum_variance))
        self.history["variance_tol"].append(float(self.variance_tol))
        for i, li in enumerate(self.active_dims):
            self.history[f"lengthscale_{li}"].append(
                float(self.kernel_lengthscale[i]))

    def _print_opt_summary(self, obj):
        echo(f"# Objective    : {obj:.5g}")
        echo("# Hyperparam   :", end=" ")
        echo(f"{self.kernel_variance:.5e}", end=" ")
        echo(f"{float(self.obs_stddev):.5e}", end=" ")
        for li in np.atleast_1d(self.kernel_lengthscale):
            echo(f"{li:.5e}", end=" ")
        echo()

    # -- training & inference ----------------------------------------------
    def _train(self, reason=0):
        tic = datetime.now()
        self._last_fit_train_size = int(self._database.size)

        echo("#" + 17 * "-" + f"GP TRAINING ({self.name.upper()})" + 17 * "-")
        echo("# Timestep     :", self._step)
        echo("# Reason       :", ["DB", "AL"][reason])
        echo("# Database size:", self._database.size)

        self.params, obj = fit_hyperparameters(
            self.params_init, self.Xtrain, self.Ytrain, self.Yerr)
        self._print_opt_summary(obj)

        if self._step > 0:
            self.write()
        if reason == 0:
            echo("#" + 50 * "-")

        # force a fresh conditioning with the new data/hyperparameters
        self.cond_gp = None
        self._cumtime_train += datetime.now() - tic

    def _ensure_conditioned(self):
        """Condition in float64 on the CPU, then move the cache (and the
        inputs and hyperparameters it goes with) to the inference device."""
        if self.cond_gp is None:
            X = _cpu64(self.Xtrain)
            cache = gp_condition(self.params, X, _cpu64(self.Ytrain),
                                 float(self.Yerr))
            to = self.device
            self._X_at_fit = X.to(to)
            self._params_dev = {k: v.to(to) for k, v in self.params.items()}
            self.cond_gp = tuple(c.to(to) for c in cache)

    def _grid_shape(self):
        return np.asarray(self.solution).shape[-2:]

    def _infer_mean(self):
        self._ensure_conditioned()
        m = gp_predict_mean(self._params_dev, self._X_at_fit, self.cond_gp,
                            self.Xtest)
        return (m.reshape(-1, *self._grid_shape()).squeeze(0)
                * float(self.Yscale))

    def _infer_mean_var(self):
        self._ensure_conditioned()
        m, v = gp_predict_mean_var(self._params_dev, self._X_at_fit,
                                   self.cond_gp, self.Xtest)
        shape = self._grid_shape()
        ys = float(self.Yscale)
        return (m.reshape(-1, *shape).squeeze(0) * ys,
                v.reshape(shape) * ys ** 2)

    def _tolerance(self):
        ys = float(self.Yscale)
        return max(self.atol * float(self.Yerr) * ys, self.rtol * ys) ** 2

    def _infer(self, compute_var=True):
        tic = datetime.now()
        if compute_var:
            mean, self._predictive_var = self._infer_mean_var()
            self.maximum_variance = float(torch.max(self._predictive_var))
            self.variance_tol = self._tolerance()
        else:
            mean = self._infer_mean()
        self._cumtime_infer += datetime.now() - tic
        return mean, self._predictive_var

    # -- active learning ----------------------------------------------------
    def _candidate_indices(self):
        """Acquisition candidate subset (strided) when ``al_candidates`` is
        set (None = all cells, reference behavior)."""
        k = getattr(self, "al_candidates", 0)
        n = int(np.prod(self._grid_shape()))
        if not k or k >= n:
            return None
        stride = max(1, n // k)
        return np.arange(0, n, stride)

    def _infer_subset_var(self, idx):
        """Predictive variance on a candidate subset (for acquisition)."""
        tic = datetime.now()
        self._ensure_conditioned()
        Xt = self.Xtest[torch.as_tensor(idx, device=self.device)]
        _, v = gp_predict_mean_var(self._params_dev, self._X_at_fit,
                                   self.cond_gp, Xt)
        v = v * float(self.Yscale) ** 2
        self.maximum_variance = float(torch.max(v))
        self.variance_tol = self._tolerance()
        self._cumtime_infer += datetime.now() - tic
        return v

    def _active_learning(self, var, idx=None):
        flat = int(torch.argmax(torch.as_tensor(var).reshape(-1)))
        imax = int(flat if idx is None else idx[flat])
        Xnew = self._features_host()[imax, :][None, :]
        self._database.add_data(Xnew)

    def predict(self, predictor=True, compute_var=True):
        """Predict mean/variance, retraining and acquiring data as needed."""
        if predictor:
            self._step += 1
            self._pause = max(-1, self._pause - 1)
            if self._last_fit_train_size < self._database.size:
                self._train(reason=0)

        idx = self._candidate_indices() if self.use_active_learning else None

        if idx is not None and predictor:
            m, _ = self._infer(compute_var=compute_var and predictor)
            if compute_var:
                v = self._predictive_var.reshape(-1)[
                    torch.as_tensor(idx, device=self.device)]
                self.maximum_variance = float(torch.max(v))
            else:
                v = self._infer_subset_var(idx)
        else:
            m, v = self._infer(compute_var=(
                (compute_var or self.use_active_learning) and predictor))

        if self.use_active_learning and predictor and self._pause < 0:
            counter = 0
            before = self.maximum_variance / self.variance_tol

            while not self.trusted and counter < self.max_steps:
                counter += 1
                self._active_learning(v, idx=idx)
                self._train(reason=1)
                if idx is not None:
                    m, _ = self._infer(compute_var=False)
                    v = self._infer_subset_var(idx)
                else:
                    m, v = self._infer(compute_var=True)

                after = self.maximum_variance / self.variance_tol
                echo(f"# AL {counter:2d}/{self.max_steps:2d}     : "
                     f"{float(before):.3f} --> {float(after):.3f}")
                echo("#" + 50 * "-")

            if counter == self.max_steps:
                echo("# Active learning loop missed uncertainty threshold")
                echo(f"# Pause for {self.pause_steps} steps...")
                echo("#" + 50 * "-")
                self._pause = self.pause_steps

        return m, self._predictive_var

    # -- misc ---------------------------------------------------------------
    @property
    def gp(self):
        """Human-readable kernel/hyperparameter summary (for gp_*.txt)."""
        if self.params is None:
            return "<untrained GP>"
        ls = ", ".join(f"{v:.5e}" for v in
                       np.atleast_1d(self.kernel_lengthscale))
        return (f"GP(kernel=amp * Matern32(L2), "
                f"amp={self.kernel_variance:.5e}, lengthscales=[{ls}], "
                f"obs_stddev={float(self.obs_stddev):.5e}, "
                f"n_train={self._last_fit_train_size})")

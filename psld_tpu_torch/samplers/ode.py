"""Probability-flow ODE samplers (``psld_tpu/samplers/ode.py``).

* ``rk_ode``: fixed-grid Euler, Heun or RK4 (1, 2 or 4 NFE a step).
* ``ei_ode``: the exponential integrator of the PSLD phase-space system
  (of the scalar system, for the VP-SDE), orders 1 to 3 at one NFE a
  step; ``cc_ei_ode`` adds classifier guidance in eps space.
* ``adaptive_ode``: Dormand--Prince 5(4) with SciPy's error norm and step
  controller, the state on the device and the controller on the host.
* ``bb_ode``: SciPy's ``solve_ivp`` on the host, the drift on the device.

Each is a Python loop over a float64 time grid on the host, as the SDE
samplers are; all are deterministic, so they take the generator and the
``noise`` hook of the sampler interface and ignore both. Each counts the
network evaluations it makes in ``nfe`` (cumulative over ``sample``
calls). The JAX package's segment protocol (``evaluation.nfe_per_dispatch``)
and the adaptive solver's bounded dispatches exist for a per-dispatch
watchdog of its TPU runtime and are not ported.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from psld_tpu_torch.parallel import spatial
from psld_tpu_torch.registry import register_module
from psld_tpu_torch.samplers.base import Sampler
from psld_tpu_torch.samplers.sde_samplers import (
    ClassCondEulerMaruyamaSampler, _in_dtype, clf_time_convention)
from psld_tpu_torch.sde.psld import join_xm, split_xm

logger = logging.getLogger(__name__)


def _pf_drift(sde, score_fn, x, t: float):
    """The reverse probability-flow drift at sampler time ``t``."""
    tv = sde.timestep_vector(t, x.shape[0], x.device)
    f, _ = sde.reverse_sde(x, tv, score_fn, probability_flow=True)
    return f


class _ODESampler(Sampler):
    """Shared bookkeeping: ``nfe`` counts network evaluations over every
    ``sample`` call, ``mean_nfe`` is that over the calls made."""

    def __init__(self, config, sde, score_fn, corrector_fn=None):
        super().__init__(config, sde, score_fn, corrector_fn=corrector_fn)
        self.nfe = 0
        self._counter = 0

    @property
    def mean_nfe(self) -> float:
        if self._counter == 0:
            raise ValueError("Run .sample() to compute mean_nfe")
        return self.nfe / self._counter

    def _drift(self, x, t: float):
        self.nfe += 1
        return _pf_drift(self.sde, self.score_fn, x, t)

    def _denoise(self, x, eps: float):
        """The mean-only microstep over [T - eps, T]."""
        return x + self._drift(x, self.sde.T - eps) * _in_dtype(eps, x)


@register_module(category="samplers", name="bb_ode")
class BBODESampler(_ODESampler):
    """SciPy's ``solve_ivp`` (``evaluation.sampler.solver``, default RK45,
    with ``rtol`` and ``atol``) over [0, T - eps] on the host in float64:
    each right-hand side copies the state to the device, evaluates the
    drift there and copies it back, one float64 tensor each way. Needs
    SciPy, and raises without it."""

    def __init__(self, config, sde, score_fn, corrector_fn=None):
        super().__init__(config, sde, score_fn, corrector_fn=corrector_fn)
        scfg = config.evaluation.sampler
        self.rtol = float(scfg.rtol)
        self.atol = float(scfg.atol)
        self.solver = str(scfg.get("solver", "RK45"))

    def sample(self, generator, batch, ts, n_discrete_steps, denoise=True,
               eps=1e-3, noise=None):
        try:
            from scipy.integrate import solve_ivp
        except ImportError as e:
            raise ImportError("bb_ode runs SciPy's solve_ivp, and SciPy is "
                              "not installed") from e
        del generator, ts, n_discrete_steps, noise
        # under spatial parallelism every rank of the group integrates the
        # whole state on the host, alike, and evaluates its rows' drift
        x = spatial.gather(batch, 1)
        shape, dtype, device = x.shape, x.dtype, x.device
        self._counter += 1

        def rhs(t, y):
            xt = torch.from_numpy(y.reshape(shape)).to(device).to(dtype)
            drift = self._drift(spatial.height_slice(xt), t)
            return spatial.gather(drift, 1).double().cpu().numpy().ravel()

        sol = solve_ivp(rhs, (0.0, self.sde.T - eps),
                        x.double().cpu().numpy().ravel(), method=self.solver,
                        rtol=self.rtol, atol=self.atol)
        x = torch.from_numpy(sol.y[:, -1].reshape(shape)).to(device).to(dtype)
        x = spatial.height_slice(x)
        return self._denoise(x, eps) if denoise else x


# Dormand--Prince 5(4) tableau (FSAL: the 7th stage is the next step's
# first); E = b5 - b4 is the embedded error estimate
_DP_C = [0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0]
_DP_A = [
    [],
    [1 / 5],
    [3 / 40, 9 / 40],
    [44 / 45, -56 / 15, 32 / 9],
    [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729],
    [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656],
    [35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84],
]
_DP_B5 = [35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0]
_DP_E = [71 / 57600, 0.0, -71 / 16695, 71 / 1920, -17253 / 339200,
         22 / 525, -1 / 40]


def _combine(coefs, ks):
    """sum_j coefs[j] * ks[j] over the nonzero coefficients, each rounded
    to the stages' dtype (a Python float scalar is)."""
    terms = [k * c for c, k in zip(coefs, ks) if c != 0.0]
    out = terms[0]
    for term in terms[1:]:
        out = out + term
    return out


@register_module(category="samplers", name="adaptive_ode")
class AdaptiveODESampler(_ODESampler):
    """Dormand--Prince 5(4) over [0, T - eps] with SciPy's RK45 error norm
    (the RMS over the whole batch of err / (atol + rtol * max(|y|,
    |y_new|)), NaN read as inf), its initial-step heuristic (one extra NFE;
    the probe clamped inside the interval, a non-finite step replaced by
    (T - eps) / 1000) and its controller (safety 0.9, factor clipped to
    [0.2, 10]), at most ``evaluation.sampler.max_steps`` controller
    iterations (default 100,000).

    The state and the stages live on the device in the batch's dtype; the
    time ``t`` and the step ``h`` are Python floats (float64) on the host.
    The error norm and the step factor are computed on the device in the
    state's dtype and read in one host transfer per controller iteration
    (6 NFE): the accept decision needs them there.
    """

    MAX_FACTOR = 10.0
    MIN_FACTOR = 0.2
    SAFETY = 0.9

    def __init__(self, config, sde, score_fn, corrector_fn=None):
        super().__init__(config, sde, score_fn, corrector_fn=corrector_fn)
        scfg = config.evaluation.sampler
        self.rtol = float(scfg.rtol)
        self.atol = float(scfg.atol)
        self.max_steps = int(scfg.get("max_steps", 100_000))
        solver = str(scfg.get("solver", "RK45"))
        if solver not in ("RK45", "dopri5"):
            raise ValueError(f"adaptive_ode runs RK45 (dopri5), not {solver}")
        # the RMS norms' mean; lockstep sampling takes it over every rank
        self.batch_mean = torch.mean

    def _norm_and_factor(self, err, y_old, y_new):
        """(error norm, step factor) as two host floats: the one read of a
        controller iteration."""
        scale = self.atol + self.rtol * torch.maximum(y_old.abs(),
                                                      y_new.abs())
        norm = torch.sqrt(self.batch_mean(torch.square(err / scale)))
        norm = torch.where(torch.isnan(norm), torch.full_like(norm, np.inf),
                           norm)
        raw = self.SAFETY * norm ** -0.2
        factor = torch.where(
            norm == 0.0, torch.full_like(norm, self.MAX_FACTOR),
            torch.where(norm <= 1.0, torch.clamp(raw, max=self.MAX_FACTOR),
                        torch.clamp(raw, min=self.MIN_FACTOR)))
        norm, factor = torch.stack([norm, factor]).tolist()
        return norm, factor

    def _initial_step(self, y0, f0, t0: float, t_end: float) -> float:
        """SciPy's ``_select_initial_step`` for order 4 (one NFE). The host
        arithmetic is numpy float64, so a NaN or an inf propagates to the
        final guard as it does in IEEE arithmetic."""
        scale = self.atol + self.rtol * y0.abs()
        d0, d1 = (np.float64(v) for v in torch.stack([
            torch.sqrt(self.batch_mean(torch.square(y0 / scale))),
            torch.sqrt(self.batch_mean(torch.square(f0 / scale)))]).tolist())
        span = np.float64(t_end - t0)
        with np.errstate(all="ignore"):
            h0 = np.float64(1e-6) if d0 < 1e-5 or d1 < 1e-5 \
                else 0.01 * d0 / d1
            # the probe stays inside the interval: the drift diverges at
            # its end (t_phys -> 0), and a probe beyond it poisons the step
            h0 = np.minimum(h0, 0.5 * span)
            f1 = self._drift(y0 + _in_dtype(float(h0), y0) * f0,
                             t0 + float(h0))
            d2 = np.float64(float(torch.sqrt(self.batch_mean(torch.square(
                (f1 - f0) / scale))))) / h0
            dmax = np.maximum(d1, d2)
            h1 = np.maximum(1e-6, h0 * 1e-3) if dmax <= 1e-15 \
                else (0.01 / dmax) ** 0.2
            h = np.minimum(np.minimum(100 * h0, h1), span)
        return float(h) if np.isfinite(h) else float(span * 1e-3)

    def sample(self, generator, batch, ts, n_discrete_steps, denoise=True,
               eps=1e-3, noise=None):
        del generator, ts, n_discrete_steps, noise
        self._counter += 1
        y = batch
        t, t_end = 0.0, self.sde.T - eps
        k1 = self._drift(y, t)
        h = self._initial_step(y, k1, t, t_end)
        steps = 0
        while t < t_end and steps < self.max_steps:
            h_c = min(h, t_end - t)
            h_y = _in_dtype(h_c, y)
            ks = [k1]
            for i in range(1, 7):
                yi = y + h_y * _combine(_DP_A[i], ks)
                ks.append(self._drift(yi, t + _DP_C[i] * h_c))
            y_new = y + h_y * _combine(_DP_B5, ks)
            err = h_y * _combine(_DP_E, ks)
            norm, factor = self._norm_and_factor(err, y, y_new)
            h = h_c * factor
            if norm <= 1.0:
                y, k1, t = y_new, ks[6], t + h_c
            steps += 1
        if t < t_end:
            logger.warning("adaptive_ode stopped at t=%.6g of %.6g after "
                           "max_steps=%d controller iterations", t, t_end,
                           self.max_steps)
        return self._denoise(y, eps) if denoise else y


def _gl_panel_grid(n_panels: int, n_nodes: int, refine: float = 0.25):
    """Gauss--Legendre nodes and weights on [0, 1], composited over
    ``n_panels`` panels refined geometrically toward 1 (the small-``t_phys``
    end of a step, where the eps coefficient ``L^{-T}`` grows like
    1/sqrt(s)). Returns ([Q], [Q]) float64 numpy arrays."""
    edges = 1.0 - refine ** np.arange(n_panels + 1)
    edges[0], edges[-1] = 0.0, 1.0
    xs, ws = np.polynomial.legendre.leggauss(n_nodes)
    xs, ws = (xs + 1.0) / 2.0, ws / 2.0
    lo, hi = edges[:-1, None], edges[1:, None]
    nodes = (lo + (hi - lo) * xs[None, :]).ravel()
    weights = ((hi - lo) * ws[None, :]).ravel()
    return nodes, weights


def _mat2(a, b):
    """Product of two 2x2 matrices given as row-major 4-tuples."""
    a11, a12, a21, a22 = a
    b11, b12, b21, b22 = b
    return (a11 * b11 + a12 * b21, a11 * b12 + a12 * b22,
            a21 * b11 + a22 * b21, a21 * b12 + a22 * b22)


@register_module(category="samplers", name="ei_ode")
class EIODESampler(_ODESampler):
    """Exponential-integrator probability-flow sampler (the
    construction and its operating envelope are in the JAX package's
    ``EIODESampler`` docstring). The ODE is linear plus an eps term,

        du/dtau = -(beta/2) A u - (beta/2) G^2 L^{-T}(t) eps_hat(u, t),

    and each step ``[tau_k, tau_{k+1}]`` transports the linear part
    exactly and integrates the eps term by quadrature::

        u_{k+1} = E_k u_k - Psi0_k eps_k - Psi1_k (eps_k - eps_{k-1}) / dtau_{k-1}

    (``order`` 2; 1 holds eps constant; 3 adds a quadratic Newton term
    weighted by ``Psi2``). The 2x2 tables E, Psi0, Psi1 (and Psi2) of the
    whole grid are computed once, in float64 on the host, by
    Gauss--Legendre quadrature (``quad_panels`` panels of ``quad_nodes``
    nodes); a step is one network forward and a few scalar-times-tensor
    passes over the two phase-space halves. Documented regime: NFE >= 20
    at order 2, NFE >= 30 at order 3.

    For the VP-SDE the system is scalar: ``A`` is 1, ``W(t) = beta(t) /
    (2 std(t))``, the transport over ``s = int beta`` is ``exp(s / 2)``,
    and every table holds its [0] entry (the others are zero).
    """

    def __init__(self, config, sde, score_fn, corrector_fn=None):
        super().__init__(config, sde, score_fn, corrector_fn=corrector_fn)
        scfg = config.evaluation.sampler
        self.order = int(scfg.get("order", 2))
        if self.order not in (1, 2, 3):
            raise ValueError(f"ei_ode order must be 1, 2 or 3; got "
                             f"{self.order}")
        self.quad_panels = int(scfg.get("quad_panels", 6))
        self.quad_nodes = int(scfg.get("quad_nodes", 16))

    # -- coefficient tables (float64, once per grid) --------------------------
    def _w_entries(self, t_phys):
        """W(t) = (beta/2) G^2 L^{-T}(t) as 4 row-major entries. In the
        reduced-output modes the zero row of G^2 and the zero of L^{-T}
        annihilate exactly the entries that would read the zero-filled
        half of eps."""
        sde = self.sde
        c11, c12, c21, c22 = sde.get_inv_coeff(sde._cov(0.0, sde.mm_0,
                                                        t_phys))
        hb = 0.5 * sde.beta_t(t_phys)
        gx, gm = sde.gamma, sde.m * sde.nu
        return hb * gx * c11, hb * gx * c12, hb * gm * c21, hb * gm * c22

    def _tables(self, ts: torch.Tensor):
        """(E, Psi0, Psi1[, Psi2]) of the grid ``ts``: float64 [n, 4] each,
        rows row-major 2x2 matrices (for the VP-SDE, zero but for [0])."""
        sde = self.sde
        ts = ts.to(torch.float64)
        ta, tb = ts[:-1], ts[1:]
        dtau = tb - ta
        rel_x, rel_w = (torch.from_numpy(a) for a in _gl_panel_grid(
            self.quad_panels, self.quad_nodes))
        taus = ta[:, None] + dtau[:, None] * rel_x[None, :]   # [n, Q]
        wq = dtau[:, None] * rel_w[None, :]
        t_phys = sde.T - taus
        if sde.is_augmented:
            s_rem = sde.b_t(t_phys) - sde.b_t(sde.T - tb)[:, None]
            integrand = _mat2(sde._exp_half_As(-s_rem),
                              self._w_entries(t_phys))
            s_full = sde.b_t(sde.T - ta) - sde.b_t(sde.T - tb)
            e_full = torch.stack(sde._exp_half_As(-s_full), dim=-1)
        else:
            s_rem = _vpsde_b(sde, t_phys) - _vpsde_b(sde, sde.T - tb)[:, None]
            w = 0.5 * sde.beta_t(t_phys) / sde._std(t_phys)
            ew = torch.exp(0.5 * s_rem) * w
            zero = torch.zeros_like(ew)
            integrand = (ew, zero, zero, zero)
            e0 = torch.exp(0.5 * (_vpsde_b(sde, sde.T - ta)
                                  - _vpsde_b(sde, sde.T - tb)))
            e_full = torch.stack([e0] + 3 * [torch.zeros_like(e0)], dim=-1)

        def quad(extra):
            return torch.stack([(wq * extra * m).sum(dim=1)
                                for m in integrand], dim=-1)

        lag = taus - ta[:, None]
        tables = [e_full, quad(torch.ones_like(wq)), quad(lag)]
        if self.order == 3:
            tables.append(quad(lag ** 2))
        return tuple(tables)

    # -- state ---------------------------------------------------------------
    def _apply(self, c, z):
        """The 2x2 matrix ``c`` (4 host floats, row-major) applied to the
        phase-space halves of ``z`` (for the VP-SDE its [0] entry to the
        whole of ``z``); each entry is rounded to ``z``'s dtype."""
        if not self.sde.is_augmented:
            return z * c[0]
        x, m = split_xm(z)
        return join_xm(x * c[0] + m * c[1], x * c[2] + m * c[3])

    def _pad_eps(self, eps_hat):
        """Zero-fill the half the network does not predict in PSLD's
        reduced-output modes, as ``get_score`` does."""
        sde = self.sde
        if not sde.is_augmented:
            return eps_hat
        if sde.decomp_mode == "lower" and sde.mode == "score_m":
            return join_xm(torch.zeros_like(eps_hat), eps_hat)
        if sde.decomp_mode == "upper" and sde.mode == "score_x":
            return join_xm(eps_hat, torch.zeros_like(eps_hat))
        return eps_hat

    def _eps_eval(self, u, tau: float):
        """One network forward at sampler time ``tau``, padded, in ``u``'s
        dtype; the guided subclass adds its guidance here, so the
        extrapolation and the quadrature apply to the guided eps."""
        self.nfe += 1
        tv = self.sde.timestep_vector(self.sde.T - tau, u.shape[0], u.device)
        return self._pad_eps(self.score_fn(u.float(), tv.float())).to(u.dtype)

    def sample(self, generator, batch, ts, n_discrete_steps, denoise=True,
               eps=1e-3, noise=None):
        del generator, n_discrete_steps, noise
        self._counter += 1
        rows = list(zip(*(tab.tolist() for tab in self._tables(ts))))
        taus = ts.tolist()
        u, hist = batch, []   # hist: (eps, dtau) of the last two steps
        for k, (tau, tau_next) in enumerate(zip(taus[:-1], taus[1:])):
            e_row, p0, p1 = rows[k][:3]
            eps_hat = self._eps_eval(u, tau)
            u_new = self._apply(e_row, u) - self._apply(p0, eps_hat)
            if self.order >= 2 and hist:
                e_p, h1 = hist[-1]
                d1 = (eps_hat - e_p) * _in_dtype(1.0 / h1, u)
                if self.order == 3 and len(hist) == 2:
                    e_pp, h2 = hist[-2]
                    d1p = (e_p - e_pp) * _in_dtype(1.0 / h2, u)
                    d2 = (d1 - d1p) * _in_dtype(1.0 / (h1 + h2), u)
                    c1 = d1 + _in_dtype(h1, u) * d2
                    u_new = (u_new - self._apply(p1, c1)
                             - self._apply(rows[k][3], d2))
                else:
                    u_new = u_new - self._apply(p1, d1)
            hist = (hist + [(eps_hat, tau_next - tau)])[-2:]
            u = u_new
        return self._denoise(u, eps) if denoise else u


@register_module(category="samplers", name="cc_ei_ode")
class ClassCondEIODESampler(EIODESampler):
    """``ei_ode`` with classifier guidance in eps space: score + temp *
    grad with score = -L^{-T} eps gives ``eps_eff = eps_hat - L^T(t)
    grad``, and the identity W L^T = (beta/2) G^2 lets the Psi tables
    integrate the guidance term too. ``L^T`` is taken at physical time;
    only the classifier's conditioning time follows
    ``clf_time_convention``. The mean-only denoise microstep stays
    unguided. The guidance takes its gradient as ``cc_em_sde`` does:
    run under ``no_grad``, not ``inference_mode``."""

    guided = True

    def __init__(self, config, sde, score_fn, clf_fn, corrector_fn=None,
                 y=None):
        super().__init__(config, sde, score_fn, corrector_fn=corrector_fn)
        self.clf_fn = clf_fn
        self.y = int(config.clf.evaluation.label_to_sample if y is None
                     else y)
        self.clf_temp = float(config.clf.evaluation.clf_temp)
        self.clf_time_convention = clf_time_convention(config)

    def _lt_entries(self, t_phys: float):
        """L^T(t) as 4 row-major host floats: the transpose of the kernel
        factor ``get_coeff`` (for the VP-SDE, the std)."""
        sde = self.sde
        t = torch.tensor([t_phys], dtype=torch.float64)
        if not sde.is_augmented:
            return float(sde._std(t)), 0.0, 0.0, 0.0
        l11, l12, l21, l22 = (float(c) for c in sde.get_coeff(
            sde._cov(0.0, sde.mm_0, t)))
        return l11, l21, l12, l22

    def _eps_eval(self, u, tau: float):
        eps_hat = super()._eps_eval(u, tau)
        t_phys = self.sde.T - tau
        t_clf = tau if self.clf_time_convention == "reference" else t_phys
        grad = ClassCondEulerMaruyamaSampler._guidance(self, u, t_clf)
        return eps_hat - self._apply(self._lt_entries(t_phys),
                                     grad.to(u.dtype))


def _vpsde_b(sde, t):
    """int_0^t beta of the VP-SDE, from its own schedule: b(t) = -2 log
    a(t), so the transport tables follow ``_log_mean_coeff``."""
    return -2.0 * sde._log_mean_coeff(t)


@register_module(category="samplers", name="rk_ode")
class RKODESampler(_ODESampler):
    """Fixed-grid probability-flow integrator: ``evaluation.sampler.solver``
    euler, heun (default) or rk4, 1, 2 or 4 NFE a step, then the mean-only
    denoise microstep."""

    def __init__(self, config, sde, score_fn, corrector_fn=None):
        super().__init__(config, sde, score_fn, corrector_fn=corrector_fn)
        self.method = str(config.evaluation.sampler.get("solver",
                                                        "heun")).lower()
        if self.method not in ("euler", "heun", "rk4"):
            raise ValueError(f"rk_ode solver must be euler, heun or rk4; "
                             f"got {self.method}")

    def _step(self, x, t: float, t_next: float):
        dt = t_next - t
        dt_c = _in_dtype(dt, x)
        k1 = self._drift(x, t)
        if self.method == "euler":
            return x + dt_c * k1
        if self.method == "heun":
            k2 = self._drift(x + dt_c * k1, t_next)
            return x + dt_c * 0.5 * (k1 + k2)
        half = t + dt / 2
        k2 = self._drift(x + 0.5 * dt_c * k1, half)
        k3 = self._drift(x + 0.5 * dt_c * k2, half)
        k4 = self._drift(x + dt_c * k3, t_next)
        return x + dt_c / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)

    def sample(self, generator, batch, ts, n_discrete_steps, denoise=True,
               eps=1e-3, noise=None):
        del generator, n_discrete_steps, noise
        self._counter += 1
        ts = ts.tolist()
        x = batch
        for t, t_next in zip(ts[:-1], ts[1:]):
            x = self._step(x, t, t_next)
        return self._denoise(x, eps) if denoise else x

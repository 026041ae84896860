"""Reverse-SDE samplers (``psld_tpu/samplers/sde_samplers.py``):
Euler--Maruyama, classifier-guided EM, inpainting EM, SDEdit editing EM,
and the symmetric splitting samplers SSCS and SSCS-2M.

Randomness comes from an explicit ``torch.Generator`` on the batch's
device. ``noise(k, like)``, when given, supplies the standard normal draw
named ``k``, shaped like ``like``, instead; the parity tests hand in the
JAX key stream's draws through it. The names:

- predictor draws are integers: EM draws once per noisy grid row (k = the
  row), SSCS and SSCS-2M twice per step (k = 2 * step + j for the j-th
  analytical half-step);
- ``("corrector", i, j)`` is the corrector's draw for its j-th step after
  grid row (EM) or step (SSCS) i;
- ``"prior_x"`` and ``"prior_m"`` draw the inpainter's prior, ``"init_m"``
  (PSLD's DSM only) and ``"init_eps"`` forward-diffuse the known image
  (to T) or the guide (to ``edit_t0``), and ``("known_m", i)`` (DSM
  only) and ``("known_eps", i)`` forward-diffuse the known image at grid
  row i.

Without a corrector a sampler asks for its integer draws alone, in the
same order as with one.

The time grid and every SDE coefficient stay float64 until the edge of
the image tensor.
"""

from __future__ import annotations

import math

import torch

from psld_tpu_torch.registry import register_module
from psld_tpu_torch.samplers.base import Sampler
from psld_tpu_torch.sde.psld import join_xm, split_xm
from psld_tpu_torch.utils.numerics import to_edge


def _in_dtype(dt: float, like: torch.Tensor) -> torch.Tensor:
    """A host float64 step rounded to ``like``'s dtype, as the JAX package
    casts ``dt`` before use."""
    return torch.tensor(dt, dtype=torch.float64).to(like.dtype)


def _em_update(sde, score_fn, x, t: float, dt: float, noise=None,
               flag: float = 1.0, guidance=None):
    """One Euler--Maruyama step at host-side float64 ``t``/``dt``.
    ``noise=None`` gives the mean-only step; ``guidance(x)``, when given,
    adds ``g^2 * guidance(x)`` to the reverse drift."""
    tv = sde.timestep_vector(t, x.shape[0], x.device)
    f, g = sde.reverse_sde(x, tv, score_fn)
    if guidance is not None:
        f = f + g * g * guidance(x).to(x.dtype)
    dt_c = _in_dtype(dt, x)
    x_mean = x + f * dt_c
    if noise is None:
        return x_mean, x_mean
    return x_mean + flag * g * torch.sqrt(dt_c) * noise, x_mean


def _step_grid(sde, ts: torch.Tensor, denoise: bool, eps: float):
    """(t, dt, noise_flag) rows as Python floats; with ``denoise`` the
    final mean-only step at t = T - eps, dt = eps is appended."""
    ts = ts.tolist()
    rows = [(t0, t1 - t0, 1.0) for t0, t1 in zip(ts[:-1], ts[1:])]
    if denoise:
        rows.append((sde.T - eps, eps, 0.0))
    return rows


def _normal(generator, noise, k, like, shape=None):
    """The draw named ``k`` of a trajectory, shaped like ``like`` (or
    ``shape``, in ``like``'s dtype and device): injected, or from
    ``generator``."""
    if shape is not None:
        like = like.new_empty(shape)
    if noise is not None:
        return noise(k, like)
    return torch.randn(like.shape, generator=generator, dtype=like.dtype,
                       device=like.device)


def _corrector_draws(generator, noise, i: int):
    """The draw function a keyed corrector gets after row or step ``i``."""
    return lambda j, like: _normal(generator, noise, ("corrector", i, j),
                                   like)


@register_module(category="samplers", name="em_sde")
class EulerMaruyamaSampler(Sampler):
    def _step(self, x, t, dt, z, flag):
        return _em_update(self.sde, self.score_fn, x, t, dt, z, flag)[0]

    def _trajectory(self, generator, x, rows, noise):
        """EM over the (t, dt, flag) ``rows``; the corrector follows every
        noisy row and skips the mean-only denoise row."""
        for i, (t, dt, flag) in enumerate(rows):
            z = _normal(generator, noise, i, x) if flag else None
            x = self._step(x, t, dt, z, flag)
            if flag and self.corrector_fn is not None:
                x = self.corrector_update_fn(
                    x, t, dt, _corrector_draws(generator, noise, i))[0]
        return x

    def sample(self, generator, batch, ts, n_discrete_steps, denoise=True,
               eps=1e-3, noise=None):
        """Run the reverse SDE from the prior draw ``batch`` (NHWC)."""
        del n_discrete_steps  # len(ts) - 1
        return self._trajectory(generator, batch,
                                _step_grid(self.sde, ts, denoise, eps), noise)


def clf_time_convention(config) -> str:
    """The time the classifier is conditioned on during guided sampling
    (``evaluation.sampler.clf_time_convention``): ``diffusion`` (default)
    gives it ``T - t``, the time it was trained on; ``reference`` gives
    it the raw sampler time ``t``, as the reference implementation's
    guided sampler does."""
    sampler_cfg = config.evaluation.get("sampler") or {}
    conv = str(sampler_cfg.get("clf_time_convention", "diffusion"))
    if conv not in ("diffusion", "reference"):
        raise ValueError(
            "evaluation.sampler.clf_time_convention must be 'diffusion' or "
            f"'reference'; got {conv!r}")
    return conv


@register_module(category="samplers", name="cc_em_sde")
class ClassCondEulerMaruyamaSampler(EulerMaruyamaSampler):
    """EM with classifier guidance: the reverse drift gains ``g^2 *
    clf_temp * grad_x log softmax(clf(x, t_clf))[y]``, and the final
    denoise row is a full guided step that keeps the mean.

    ``clf_fn(x, t) -> logits`` is the classifier bound to its weights,
    which should not require grad: the gradient goes into the input only.
    The score network runs under the caller's ``no_grad``; the guidance
    takes its gradient under ``enable_grad`` on a detached copy of the
    state, so the sampler must not run under ``torch.inference_mode``,
    whose tensors can never require grad."""

    guided = True

    def __init__(self, config, sde, score_fn, clf_fn, corrector_fn=None,
                 y=None):
        super().__init__(config, sde, score_fn, corrector_fn=corrector_fn)
        self.clf_fn = clf_fn
        self.y = int(config.clf.evaluation.label_to_sample if y is None
                     else y)
        self.clf_temp = float(config.clf.evaluation.clf_temp)
        self.clf_time_convention = clf_time_convention(config)

    def _guidance(self, x, t_clf: float):
        """``clf_temp`` times the gradient of the summed log-probability of
        class ``y`` with respect to ``x``."""
        if torch.is_inference_mode_enabled():
            raise RuntimeError("classifier guidance takes a gradient: run "
                               "it under no_grad, not inference_mode")
        with torch.enable_grad():
            xg = x.detach().float().requires_grad_()
            tv = torch.full((x.shape[0],), float(t_clf), dtype=torch.float32,
                            device=x.device)
            logp = torch.log_softmax(self.clf_fn(xg, tv).float(), dim=-1)
            (grad,) = torch.autograd.grad(logp[:, self.y].sum(), xg)
        return grad * self.clf_temp

    def _step(self, x, t, dt, z, flag):
        t_clf = t if self.clf_time_convention == "reference" \
            else self.sde.T - t
        return _em_update(self.sde, self.score_fn, x, t, dt, z, flag,
                          guidance=lambda xx: self._guidance(xx, t_clf))[0]


def _require_phase_space(sde, name: str) -> None:
    """SSCS, SSCS-2M and inpainting act on PSLD's (x, m) halves: an SDE
    without a momentum half (the VP-SDE) is refused where the sampler is
    built."""
    if not sde.is_augmented:
        raise ValueError(f"{name} runs on PSLD's phase space; {sde.type} "
                         "has no momentum half")


def _forward_diffuse(sampler, generator, noise, x_0, t: float, names):
    """Forward-diffuse ``x_0`` to time ``t`` through the training kernel.
    The VP-SDE draws eps (C channels) alone. PSLD: HSM takes m_0 = 0 with
    kernel variance ``mm_0``, DSM draws m_0 ~ N(0, mm_0 I) with none, and
    eps has 2C channels. ``names`` are the (m_0, eps) draws' names.
    Returns (z_t, mean)."""
    sde = sampler.sde
    name_m, name_eps = names
    tv = sde.timestep_vector(t, x_0.shape[0], x_0.device)
    if not sde.is_augmented:
        eps = _normal(generator, noise, name_eps, x_0)
        return sde.perturb_data(x_0, tv, eps), \
            sde.cond_marginal_prob(x_0, tv)[0]
    if str(sampler.config.training.mode) == "hsm":
        m_0, mm_0 = torch.zeros_like(x_0), sde.mm_0
    else:
        m_0 = math.sqrt(sde.mm_0) * _normal(generator, noise, name_m, x_0)
        mm_0 = 0.0
    eps = _normal(generator, noise, name_eps, x_0,
                  shape=x_0.shape[:-1] + (2 * x_0.shape[-1],))
    z_t, mu_t, _ = sde.perturb_data(x_0, m_0, 0.0, mm_0, tv, eps)
    return z_t, mu_t


@register_module(category="samplers", name="ip_em_sde")
class EulerMaruyamaInpainter(EulerMaruyamaSampler):
    """RePaint-style phase-space inpainting: the state starts as the prior
    with the known region (mask 1) stitched in, forward-diffused to T;
    after each EM step both the x and the m halves of the known region are
    overwritten with the known image forward-diffused to the step's time.
    On the mean-only denoise row the stitched region is the kernel's mean.
    ``batch`` is ``(x_0, mask)``, NHWC with C channels each. No corrector
    runs, as in the JAX package's ``inpaint``."""

    def __init__(self, config, sde, score_fn, corrector_fn=None):
        _require_phase_space(sde, "ip_em_sde")
        super().__init__(config, sde, score_fn, corrector_fn=corrector_fn)

    @staticmethod
    def _stitch(z, z_known, mask):
        x_c, m_c = split_xm(z)
        x_k, m_k = split_xm(z_known)
        return join_xm(x_c * (1 - mask) + x_k * mask,
                       m_c * (1 - mask) + m_k * mask)

    def sample(self, generator, batch, ts, n_discrete_steps, denoise=True,
               eps=1e-3, noise=None):
        del n_discrete_steps  # len(ts) - 1
        x_0, mask = batch
        sde = self.sde
        p_x = _normal(generator, noise, "prior_x", x_0)
        p_m = _normal(generator, noise, "prior_m", x_0) * math.sqrt(sde.m)
        u_k, _ = _forward_diffuse(self, generator, noise, x_0, sde.T,
                                  ("init_m", "init_eps"))
        x = self._stitch(join_xm(p_x, p_m), u_k, mask)
        for i, (t, dt, flag) in enumerate(_step_grid(sde, ts, denoise,
                                                     eps)):
            z = _normal(generator, noise, i, x) if flag else None
            x = self._step(x, t, dt, z, flag)
            u_k, mu_k = _forward_diffuse(
                self, generator, noise, x_0, sde.T - t,
                (("known_m", i), ("known_eps", i)))
            known = mu_k.to(x.dtype) + flag * (u_k - mu_k).to(x.dtype)
            x = self._stitch(x, known, mask)
        return x


@register_module(category="samplers", name="edit_em_sde")
class EditEulerMaruyamaSampler(EulerMaruyamaSampler):
    """SDEdit-style editing: the guide image ``batch`` (NHWC, C channels)
    is forward-diffused to ``t0 = evaluation.sampler.edit_t0`` (the edit
    strength) through the training kernel (PSLD: with the momentum as the
    loss draws it, HSM: m_0 = 0 with kernel variance ``mm_0``; DSM: m_0 ~
    N(0, mm_0 I)), and the reverse EM runs over [T - t0, T - eps] only:
    the caller's [0, T - eps] grid is mapped onto it affinely, so its
    stride shape is kept."""

    def __init__(self, config, sde, score_fn, corrector_fn=None):
        super().__init__(config, sde, score_fn, corrector_fn=corrector_fn)
        self.edit_t0 = float(config.evaluation.sampler.get("edit_t0", 0.5))
        if not 0.0 < self.edit_t0 <= float(sde.T):
            raise ValueError(
                f"evaluation.sampler.edit_t0 must be in (0, T={sde.T}]; "
                f"got {self.edit_t0}")

    def _edit_ts(self, ts: torch.Tensor, eps: float) -> torch.Tensor:
        """The affine map of the [0, T - eps] grid onto [T - t0, T - eps],
        float64."""
        t0 = self.edit_t0
        return (self.sde.T - t0) + ts * ((t0 - eps) / (self.sde.T - eps))

    def sample(self, generator, batch, ts, n_discrete_steps, denoise=True,
               eps=1e-3, noise=None):
        del n_discrete_steps  # len(ts) - 1
        x, _ = _forward_diffuse(self, generator, noise, batch, self.edit_t0,
                                ("init_m", "init_eps"))
        return self._trajectory(
            generator, x,
            _step_grid(self.sde, self._edit_ts(ts, eps), denoise, eps),
            noise)


@register_module(category="samplers", name="sscs_sde")
class SSCSSampler(Sampler):
    """Symmetric Splitting CLD Sampler for PSLD: analytical OU half-step,
    Euler score step, analytical OU half-step, with the closed forms of
    :meth:`psld_tpu_torch.sde.psld.PSLD.sscs_transition`; then, with
    ``denoise``, one mean-only EM step at ``T - eps``. Both half-steps of
    an interval are taken at its start time ``t``, as in the JAX
    package."""

    def __init__(self, config, sde, score_fn, corrector_fn=None):
        _require_phase_space(sde, type(self).__name__)
        super().__init__(config, sde, score_fn, corrector_fn=corrector_fn)

    def _coeffs(self, u, t: float, dt: float):
        """The half-step's mean map and covariance at sampler time ``t``
        over ``dt``, float64 [B] each."""
        tv = self.sde.timestep_vector(t, u.shape[0], u.device)
        return self.sde.sscs_transition(tv, dt)

    @staticmethod
    def _map(u, c11, c12, c21, c22):
        """``[[c11, c12], [c21, c22]]`` applied to (x, m), the float64
        coefficients cast at the edge."""
        x, m = split_xm(u)
        c11, c12, c21, c22 = (to_edge(c, x) for c in (c11, c12, c21, c22))
        return join_xm(c11 * x + c12 * m, c21 * x + c22 * m)

    def analytical_dynamics(self, u, t: float, dt: float, eps):
        """Mean map plus the covariance factor times the draw ``eps``."""
        mean_map, var = self._coeffs(u, t, dt)
        return self._map(u, *mean_map) + self._map(
            eps, *self.sde.get_coeff(var))

    def score_term(self, u, t: float):
        """Drift of the split score sub-flow, at diffusion time ``T - t``:
        ``[gamma beta (score_x + x), M nu beta (score_m + m / M)]``."""
        sde = self.sde
        tv = sde.timestep_vector(sde.T - t, u.shape[0], u.device)
        beta = to_edge(sde.beta_t(tv), u)
        x, m = split_xm(u)
        eps_pred = self.score_fn(u.float(), tv.float())
        score = sde.get_score(eps_pred, 0.0, sde.mm_0, tv).to(u.dtype)
        score_x, score_m = split_xm(score)
        return join_xm(sde.gamma * beta * (score_x + x),
                       sde.m * sde.nu * beta * (score_m + sde.m_inv * m))

    def euler_score_dynamics(self, u, t: float, dt: float):
        return u + _in_dtype(dt, u) * self.score_term(u, t)

    def predictor_update_fn(self, u, t: float, dt: float, eps1, eps2):
        u = self.analytical_dynamics(u, t, dt / 2, eps1)
        u = self.euler_score_dynamics(u, t, dt)
        return self.analytical_dynamics(u, t, dt / 2, eps2)

    def _finalize(self, u, denoise: bool, eps: float):
        if not denoise:
            return u
        return _em_update(self.sde, self.score_fn, u, self.sde.T - eps, eps)[0]

    def sample(self, generator, batch, ts, n_discrete_steps, denoise=True,
               eps=1e-3, noise=None):
        del n_discrete_steps  # len(ts) - 1
        ts = ts.tolist()
        u = batch
        for i, (t, t_next) in enumerate(zip(ts[:-1], ts[1:])):
            eps1 = _normal(generator, noise, 2 * i, u)
            eps2 = _normal(generator, noise, 2 * i + 1, u)
            u = self.predictor_update_fn(u, t, t_next - t, eps1, eps2)
            u = self.corrector_update_fn(
                u, t, t_next - t, _corrector_draws(generator, noise, i))[0]
        return self._finalize(u, denoise, eps)


@register_module(category="samplers", name="sscs2m_sde")
class SSCS2MSampler(SSCSSampler):
    """Second-order multistep SSCS (an extension of the JAX package with no
    reference counterpart): the score stage of each interval is an
    exponential Adams--Bashforth-2 step. The previous interval's score
    term is carried to the current frame through the analytical OU mean
    maps and combined with weights ``(1 + rho/2, -rho/2)``, ``rho = dt_k /
    dt_{k-1}``. The OU half-steps and their draws are SSCS's, and the
    first interval, which has no history, is exactly one SSCS step."""

    def _linear_mean(self, v, t: float, dt: float):
        """The reverse-time OU mean map over [t, t+dt] applied to ``v``:
        ``analytical_dynamics`` without the draw."""
        return self._map(v, *self._coeffs(v, t, dt)[0])

    def sample(self, generator, batch, ts, n_discrete_steps, denoise=True,
               eps=1e-3, noise=None):
        del n_discrete_steps  # len(ts) - 1
        ts = ts.tolist()
        u, prev, dt_prev = batch, None, None
        for i, (t, t_next) in enumerate(zip(ts[:-1], ts[1:])):
            dt = t_next - t
            u = self.analytical_dynamics(u, t, dt / 2,
                                         _normal(generator, noise, 2 * i, u))
            nterm = self.score_term(u, t)
            if prev is None:
                d = nterm
            else:
                prev = self._linear_mean(prev, t, dt / 2)
                rho = float(_in_dtype(dt / dt_prev, u))
                d = nterm + (rho / 2.0) * (nterm - prev)
            u = u + _in_dtype(dt, u) * d
            prev, dt_prev = self._linear_mean(nterm, t, dt / 2), dt
            u = self.analytical_dynamics(
                u, t, dt / 2, _normal(generator, noise, 2 * i + 1, u))
            u = self.corrector_update_fn(
                u, t, dt, _corrector_draws(generator, noise, i))[0]
        return self._finalize(u, denoise, eps)

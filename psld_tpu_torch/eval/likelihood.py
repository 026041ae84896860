"""Likelihood through the probability-flow ODE
(``psld_tpu/eval/likelihood.py``).

The forward probability-flow ODE

    dz/dt = f(z, t) - 1/2 g(t)^2 score(z, t),
    d log p/dt = -div_z [f - 1/2 g^2 score](z, t)

is integrated from ``t = eps`` to ``T`` on a fixed grid (Euler, Heun or
RK4), and ``log p(x) = prior_logp(z_T) + int div``. The divergence is
the Hutchinson estimator with Rademacher probes drawn once per
trajectory, one vector-Jacobian product per probe through the score
network (reverse mode, into the input only), or the exact Jacobian trace
for small shapes.

For the VP-SDE the NLL is ``-log p(x)`` itself. For the augmented PSLD
state the joint density ``p(x, m)`` is exact, and ``augmented_nll_bound``
makes it the variational upper bound on the data NLL: with ``q(m) =
N(0, mm_0 I)``,

    -log p(x) <= E_{m~q}[-log p(x, m)] - H(q).

Time grids are float64 on the host; the state stays in its dtype and the
log-density terms accumulate in float64.
"""

from __future__ import annotations

import logging
import math
import time

import numpy as np
import torch

from psld_tpu_torch.samplers.sde_samplers import _in_dtype

logger = logging.getLogger(__name__)


def _pf_drift(sde, score_fn, z, t: float):
    """Forward-time probability-flow drift at physical time ``t``: the
    negation of ``reverse_sde``'s, which takes time from the prior end."""
    tv = sde.timestep_vector(sde.T - t, z.shape[0], z.device)
    f_bar, _ = sde.reverse_sde(z, tv, score_fn, probability_flow=True)
    return -f_bar


def _divergence_hutchinson(drift_fn, z, probes):
    """(drift, divergence estimate): one forward with the graph kept, then
    one vector-Jacobian product per probe, ``v^T J v = (J^T v) . v``,
    averaged over the probes ``[n_probes, *z.shape]``."""
    with torch.enable_grad():
        zg = z.detach().requires_grad_()
        out = drift_fn(zg)
        divs = []
        for i, v in enumerate(probes):
            (jtv,) = torch.autograd.grad(out, zg, v,
                                         retain_graph=i + 1 < len(probes))
            divs.append((v * jtv).sum(tuple(range(1, z.ndim))))
    return out.detach(), torch.stack(divs).mean(0)


def _divergence_exact(drift_fn, z, row_chunk: int = 32):
    """Exact per-sample divergence, the Jacobian's trace row by row.

    The batch Jacobian is block-diagonal (each sample's drift depends on
    that sample alone), so ``row_chunk`` trace rows are read at once from
    ``row_chunk`` copies of the batch: copy j carries the cotangent of row
    i_j, and one backward pass gives each copy's row ``J^T e_{i_j}``. At
    most ``row_chunk`` copies of the batch are live at a time; the full
    Jacobian never is."""
    b = z.shape[0]
    d = math.prod(z.shape[1:])
    div = torch.zeros(b, dtype=z.dtype, device=z.device)
    for start in range(0, d, row_chunk):
        rows = torch.arange(start, min(start + row_chunk, d),
                            device=z.device)
        k = rows.numel()
        with torch.enable_grad():
            zg = z.detach().repeat((k,) + (1,) * (z.ndim - 1))
            zg.requires_grad_()
            out = drift_fn(zg)
            cot = torch.zeros(k, b, d, dtype=z.dtype, device=z.device)
            cot[torch.arange(k), :, rows] = 1
            (jte,) = torch.autograd.grad(out, zg, cot.reshape(zg.shape))
        picked = jte.reshape(k, b, d)[torch.arange(k), :, rows]   # [k, b]
        div = div + picked.sum(0)
    return div


def rademacher(generator, n_probes: int, like: torch.Tensor):
    """``[n_probes, *like.shape]`` of +-1 in ``like``'s dtype and device,
    from ``generator``."""
    bits = torch.randint(0, 2, (n_probes,) + tuple(like.shape),
                         generator=generator, device=like.device)
    return (2 * bits - 1).to(like.dtype)


def make_likelihood_fn(sde, score_fn, *, n_steps: int = 100,
                       eps: float = 1e-5, method: str = "rk4",
                       n_probes: int = 1, exact_div: bool = False,
                       exact_chunk: int = 32, stride: str = "quadratic"):
    """``fn(generator, x, probes=None) -> dict`` of per-sample ``logp``
    (nats, of the state as given: the joint (x, m) for an augmented state),
    ``prior_logp``, ``delta_logp`` (float64 each), the terminal latent
    ``z_T`` and ``nfe``. The Hutchinson probes are drawn from ``generator``
    once per trajectory unless given; the exact trace draws none.

    ``stride='quadratic'`` puts grid points near ``t = eps``, where the
    drift is stiff (the momentum's variance starts at ``kappa * M``)."""
    if method not in ("euler", "heun", "rk4"):
        raise ValueError(f"likelihood solver must be euler, heun or rk4; "
                         f"got {method}")
    if stride not in ("uniform", "quadratic"):
        raise ValueError(f"likelihood stride must be uniform or quadratic; "
                         f"got {stride}")
    order = {"euler": 1, "heun": 2, "rk4": 4}[method]

    def rhs(z, t: float, probes):
        def drift_fn(zz):
            return _pf_drift(sde, score_fn, zz, t)

        if exact_div:
            return drift_fn(z), _divergence_exact(drift_fn, z, exact_chunk)
        return _divergence_hutchinson(drift_fn, z, probes)

    u = np.linspace(0.0, 1.0, n_steps + 1, dtype=np.float64)
    if stride == "quadratic":
        u = u * u
    ts = (eps + (sde.T - eps) * u).tolist()

    def fn(generator, x, probes=None):
        if probes is None and not exact_div:
            probes = rademacher(generator, n_probes, x)
        z = x
        logdet = torch.zeros(x.shape[0], dtype=torch.float64,
                             device=x.device)
        for t, t_next in zip(ts[:-1], ts[1:]):
            dt = t_next - t
            dt_c = _in_dtype(dt, z)
            k1, d1 = rhs(z, t, probes)
            if method == "euler":
                z_n = z + dt_c * k1
                ld = logdet + dt * d1.double()
            elif method == "heun":
                k2, d2 = rhs(z + dt_c * k1, t_next, probes)
                z_n = z + dt_c * 0.5 * (k1 + k2)
                ld = logdet + dt * 0.5 * (d1 + d2).double()
            else:
                half = t + dt / 2
                k2, d2 = rhs(z + 0.5 * dt_c * k1, half, probes)
                k3, d3 = rhs(z + 0.5 * dt_c * k2, half, probes)
                k4, d4 = rhs(z + dt_c * k3, t_next, probes)
                z_n = z + dt_c / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)
                ld = logdet + dt / 6.0 * (d1 + 2 * d2 + 2 * d3 + d4).double()
            z, logdet = z_n, ld
        prior = sde.prior_logp(z).double()
        # along dz/dt = f_pf, d log p_t(z_t)/dt = -div f_pf, so
        # log p_eps(x) = log p_T(z_T) + int_eps^T div f_pf dt
        return {"logp": prior + logdet, "prior_logp": prior,
                "delta_logp": logdet, "z_T": z,
                "nfe": (1 if exact_div else n_probes) * order * n_steps}

    return fn


def bits_per_dim(nll_nats, data_dim: int, n_bits: int = 8):
    """Continuous-space NLL (nats per sample, data in [-1, 1]) as discrete
    bits/dim of ``n_bits`` data: a quantization bin is 2 / 2^n_bits wide."""
    return nll_nats / (data_dim * math.log(2.0)) + (n_bits - 1.0)


def augmented_draw(sde, generator, x, m=None):
    """The bound's momentum draw ``m ~ q = N(0, mm_0 I)`` (``m`` when
    given), joined to ``x`` in phase space."""
    if m is None:
        m = torch.randn(x.shape, generator=generator, dtype=x.dtype,
                        device=x.device) * math.sqrt(sde.mm_0)
    return torch.cat([x, m.to(x)], dim=-1)


def augmented_entropy_q(sde, x_shape) -> float:
    """Entropy of the momentum proposal q, nats per sample."""
    dim_m = math.prod(x_shape[1:])
    return 0.5 * dim_m * (math.log(2.0 * math.pi * sde.mm_0) + 1.0)


def augmented_nll_bound(sde, likelihood_fn, generator, x, m=None,
                        probes=None):
    """The variational upper bound on the data NLL of an augmented
    (phase-space) SDE: the joint NLL at ``(x, m)``, ``m`` drawn from q
    (before the probes, from the same generator) unless given, less the
    entropy of q. Returns (nll bound [B] float64, the likelihood dict)."""
    z = augmented_draw(sde, generator, x, m)
    out = likelihood_fn(generator, z, probes=probes)
    return -out["logp"] - augmented_entropy_q(sde, x.shape), out


def evaluate_nll(config, max_batches: int | None = None):
    """Dataset NLL in bits/dim from a checkpoint, on one device.

    The score network comes from ``evaluation.chkpt_path`` (EMA or online
    weights per ``evaluation.sample_from``) onto ``evaluation.device``
    (default ``cuda``), its weights frozen, so the divergence's
    vector-Jacobian products run into the input alone. The dataset is
    walked unshuffled in batches of ``evaluation.batch_size``, the last
    partial batch dropped; ``evaluation.n_samples`` caps the batches at
    ``n_samples // batch_size`` (at least one). Batch ``i`` draws its
    momentum and its probes from its own generator, seeded from
    (``evaluation.seed``, i) as the samplers seed theirs. For PSLD the
    number is the variational upper bound of :func:`augmented_nll_bound`;
    for the VP-SDE it is ``-logp`` of the data, with no momentum draw and
    no entropy term.

    ``evaluation.likelihood`` (all optional): n_steps (100), solver
    (rk4 | heun | euler), n_probes (1), exact_div (False), exact_chunk
    (32), eps (1e-5), stride (quadratic). ``steps_per_dispatch`` is
    accepted and has no effect: the JAX package splits the integral for
    a per-dispatch watchdog of its TPU runtime.

    Returns (bits/dim, one dict a batch: ``batch``, ``samples``,
    ``bits_per_dim``, ``nfe``, ``seconds``, ``nonfinite``)."""
    from psld_tpu_torch.data.datasets import batch_generator
    from psld_tpu_torch.data.loader import EpochLoader, get_dataset
    from psld_tpu_torch.eval.generate import (build_sde, eval_bf16,
                                              load_eval_state, make_score_fn)

    ecfg = config.evaluation
    device = torch.device(str(ecfg.get("device", "cuda")))
    sde = build_sde(config)
    net = load_eval_state(config).requires_grad_(False).to(device)
    lcfg = ecfg.get("likelihood") or {}
    lik = make_likelihood_fn(
        sde, make_score_fn(net, bf16=eval_bf16(config)),
        n_steps=int(lcfg.get("n_steps", 100)),
        eps=float(lcfg.get("eps", 1e-5)),
        method=str(lcfg.get("solver", "rk4")),
        n_probes=int(lcfg.get("n_probes", 1)),
        exact_div=bool(lcfg.get("exact_div", False)),
        exact_chunk=int(lcfg.get("exact_chunk", 32)),
        stride=str(lcfg.get("stride", "quadratic")))
    per_step = int(ecfg.batch_size)
    loader = EpochLoader(get_dataset(config), per_step, shuffle=False,
                         drop_last=True, hflip=False)
    n_cap = int(ecfg.get("n_samples", 0) or 0)
    if n_cap:
        cap = max(1, n_cap // per_step)
        max_batches = cap if max_batches is None else min(max_batches, cap)
    seed = int(ecfg.seed)
    nlls, batches = [], []
    with torch.no_grad():
        for i, batch in enumerate(loader):
            if max_batches is not None and i >= max_batches:
                break
            t0 = time.perf_counter()
            x = torch.from_numpy(batch).to(device)
            gen = batch_generator(seed, i, device)
            if sde.is_augmented:
                nll, out = augmented_nll_bound(sde, lik, gen, x)
            else:
                out = lik(gen, x)
                nll = -out["logp"]
            nll = nll.cpu().numpy()
            dim = math.prod(x.shape[1:])
            nlls.append(nll)
            batches.append({
                "batch": i, "samples": len(nll),
                "bits_per_dim": float(np.mean(bits_per_dim(nll, dim))),
                "nfe": out["nfe"], "seconds": time.perf_counter() - t0,
                "nonfinite": int(nll.size - np.isfinite(nll).sum())})
            if (i + 1) % 10 == 0:
                logger.info("nll: %d batches, %.4f bits/dim", i + 1,
                            float(np.mean(bits_per_dim(
                                np.concatenate(nlls), dim))))
    nll = np.concatenate(nlls)
    bpd = float(np.mean(bits_per_dim(nll, dim)))
    logger.info("final: %.4f bits/dim over %d samples", bpd, nll.size)
    return bpd, batches

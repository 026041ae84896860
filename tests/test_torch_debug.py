"""The port's numerics guards (``psld_tpu_torch/utils/debug.py``) against
``tests/test_debug.py``'s contract for the JAX package's: with
``PSLD_DEBUG_NUMERICS=1`` the PSLD covariance factorizations raise
"Numerical precision error." where the JAX package's do; unset, a NaN
flows through and nothing is read from the tensors."""

import torch_cpu  # noqa: F401  (one intra-op thread: torch_cpu.py)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psld_tpu.utils.debug import check_finite as j_check_finite
from psld_tpu_torch.config import ConfigDict
from psld_tpu_torch.sde.psld import PSLD
from psld_tpu_torch.utils import debug
from test_sde_psld import make_sde


@pytest.fixture
def debug_numerics(monkeypatch):
    monkeypatch.setenv("PSLD_DEBUG_NUMERICS", "1")


def port_sde(decomp="lower"):
    """The port's SDE of ``test_sde_psld.make_sde``'s config."""
    jsde = make_sde(decomp=decomp)
    cfg = ConfigDict({"model": {"sde": {
        "name": "psld", "beta_min": float(jsde.beta_0),
        "beta_max": float(jsde.beta_1), "nu": float(jsde.nu),
        "gamma": float(jsde.gamma), "kappa": float(jsde.kappa),
        "decomp_mode": decomp, "numerical_eps": float(jsde.eps),
        "n_timesteps": 1000}}})
    return PSLD(cfg), jsde


SINGULAR = ([1e-12], [1.0], [1e-12])          # mm - l21^2 < 0
NEGATIVE_DET = ([1.0], [2.0], [1.0])


def _t(values):
    return tuple(torch.tensor(v, dtype=torch.float64) for v in values)


def test_disabled_is_silent_and_reads_nothing(monkeypatch):
    monkeypatch.delenv("PSLD_DEBUG_NUMERICS", raising=False)
    sde, jsde = port_sde()
    out = sde.get_coeff(_t(SINGULAR))
    assert torch.isnan(out[3]).all()
    assert np.isnan(np.asarray(jsde.get_coeff(tuple(
        jnp.asarray(v) for v in SINGULAR))[3])).all()

    class Untouchable:
        def __getattr__(self, name):
            raise AssertionError("read a tensor with the guard off")

    debug.check_finite("no read", Untouchable())
    assert not debug.numerics_debug_enabled()


@pytest.mark.parametrize("decomp,method,var", [
    ("lower", "get_coeff", SINGULAR), ("upper", "get_coeff", SINGULAR),
    ("lower", "get_inv_coeff", NEGATIVE_DET),
    ("upper", "get_inv_coeff", NEGATIVE_DET)])
def test_raises_where_the_jax_package_does(debug_numerics, decomp, method,
                                           var):
    sde, jsde = port_sde(decomp)
    with pytest.raises(Exception, match="Numerical precision error"):
        getattr(jsde, method)(tuple(jnp.asarray(v) for v in var))
    with pytest.raises(ValueError, match=r"^Numerical precision error\."):
        getattr(sde, method)(_t(var))


def test_healthy_covariance_passes_unchanged(debug_numerics, monkeypatch):
    sde, _ = port_sde()
    var = sde._cov(0.0, sde.mm_0, torch.tensor([0.5], dtype=torch.float64))
    got = sde.get_coeff(var)
    monkeypatch.delenv("PSLD_DEBUG_NUMERICS")
    for g, w in zip(got, sde.get_coeff(var)):
        assert torch.equal(g, w)


def test_guard_in_a_loop_names_its_site(debug_numerics):
    """A sampler-loop shape: the guard at each step, the site named."""
    c = torch.tensor([1.0])
    for _ in range(4):
        debug.check_finite("loop step", c)
        c = c * 2.0
    assert float(c) == 16.0
    j_check_finite("loop step", jnp.asarray([1.0]))  # traces, no raise
    with pytest.raises(ValueError, match="loop step"):
        debug.check_finite("loop step", torch.tensor([float("nan")]))

"""psld-tpu-torch: the PyTorch/CUDA port of psld-tpu for NVIDIA Hopper.

The JAX package ``psld_tpu`` is the reference; this package mirrors its
module names so each counterpart is easy to find. It imports ``torch`` and
nothing of ``jax``. Of ``psld_tpu`` it uses only the jax-free config
composer ``psld_tpu.config`` and the YAML tree under ``psld_tpu/configs``.

Layout: public functions take NHWC tensors, as the JAX package does. Inside
the network, activations are NCHW-logical tensors in ``channels_last``
memory, so the NHWC view the hand-written kernels read is a free permute.

Kernels (forward only so far): GroupNorm+act in Triton
(``ops/group_norm.py``) and single-head attention in CUDA C++
(``csrc/attention.cu``, bound in ``ops/attention.py``). On a CPU tensor
each op runs its plain PyTorch version; on a CUDA tensor it launches the
kernel or raises.
"""

__version__ = "0.1.0"

from psld_tpu_torch.registry import get_module, register_module  # noqa: F401


def import_modules_into_registry() -> None:
    """Import the component packages so their ``@register_module``
    decorators fill the port's registry."""
    import psld_tpu_torch.data  # noqa: F401
    import psld_tpu_torch.models  # noqa: F401
    import psld_tpu_torch.samplers  # noqa: F401
    import psld_tpu_torch.sde  # noqa: F401

from psld_tpu_torch.samplers.base import Sampler, make_timesteps  # noqa: F401
from psld_tpu_torch.samplers.sde_samplers import (  # noqa: F401
    EulerMaruyamaSampler,
)

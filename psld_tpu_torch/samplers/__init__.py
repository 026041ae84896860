from psld_tpu_torch.samplers.base import Sampler, make_timesteps  # noqa: F401
from psld_tpu_torch.samplers.correctors import (  # noqa: F401
    LangevinCorrector,
    build_corrector,
)
from psld_tpu_torch.samplers.sde_samplers import (  # noqa: F401
    ClassCondEulerMaruyamaSampler,
    EditEulerMaruyamaSampler,
    EulerMaruyamaInpainter,
    EulerMaruyamaSampler,
    SSCS2MSampler,
    SSCSSampler,
)
from psld_tpu_torch.samplers.ode import (  # noqa: F401
    AdaptiveODESampler,
    BBODESampler,
    ClassCondEIODESampler,
    EIODESampler,
    RKODESampler,
)

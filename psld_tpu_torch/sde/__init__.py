from psld_tpu_torch.sde.base import SDE  # noqa: F401
from psld_tpu_torch.sde.psld import PSLD, join_xm, split_xm  # noqa: F401
from psld_tpu_torch.sde.vpsde import VPSDE  # noqa: F401

from psld_tpu_torch.ops.attention import (  # noqa: F401
    attention,
    attention_plain,
)
from psld_tpu_torch.ops.group_norm import (  # noqa: F401
    group_norm_act,
    group_norm_act_plain,
)
from psld_tpu_torch.ops.upfirdn import (  # noqa: F401
    conv_downsample_2d,
    downsample_2d,
    naive_downsample_2d,
    naive_upsample_2d,
    setup_kernel,
    upfirdn2d,
    upsample_2d,
    upsample_conv_2d,
)

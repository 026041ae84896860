from psld_tpu_torch.ops.attention import (  # noqa: F401
    attention,
    attention_backward,
    attention_fits,
    attention_plain,
)
from psld_tpu_torch.ops.dropout import (  # noqa: F401
    hash_dropout,
    hash_dropout_plain,
)
from psld_tpu_torch.ops.fused_act import (  # noqa: F401
    fused_leaky_relu,
    fused_leaky_relu_backward,
    fused_leaky_relu_backward_plain,
    fused_leaky_relu_plain,
)
from psld_tpu_torch.ops.group_norm import (  # noqa: F401
    group_norm_act,
    group_norm_act_backward,
    group_norm_act_backward_plain,
    group_norm_act_plain,
    group_norm_act_split,
    group_norm_fits,
    group_norm_split_apply,
    group_norm_split_dx,
    group_norm_split_fits,
    group_norm_split_partials,
    group_norm_split_stats,
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

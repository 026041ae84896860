from psld_tpu_torch.interop.from_flax import (  # noqa: F401
    flax_to_state_dict,
    load_flax_params,
)

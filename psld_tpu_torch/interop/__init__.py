from psld_tpu_torch.interop.from_flax import (  # noqa: F401
    flax_to_state_dict,
    inception_state_dict,
    load_flax_params,
    train_state_from_flax,
)

from psld_tpu_torch.eval.fid.inception import (  # noqa: F401
    FID_DIM,
    N_LOGITS,
    FIDInception,
    extract_features,
    load_torch_checkpoint,
    logits_from_features,
    make_feature_fn,
    make_feature_logits_fn,
    random_params,
)
from psld_tpu_torch.eval.fid.metrics import (  # noqa: F401
    isc_from_logits,
    kid_from_features,
    polynomial_mmd2_unbiased,
)
from psld_tpu_torch.eval.fid.stats import (  # noqa: F401
    FeatureMoments,
    frechet_distance,
    load_stats,
    save_stats,
)

"""The FID-against-NFE sweep (``eval/sweep.py``): one checkpoint sampled
under every (sampler, NFE, stride), one JSON line each.

    python -m psld_tpu_torch.cli.sweep_fid_nfe \\
        --samplers em_sde,ei_ode --nfes 20,50,100,1000 \\
        --strides uniform,quadratic --out-dir sweep \\
        [--ref-dir CIFAR_PNGS] [--ref-stats stats.npz] [--weights pt.pth] \\
        [--swd] [--kid] +dataset=cifar10/cifar10_vpsde \\
        dataset.diffusion.data.root=... \\
        dataset.diffusion.evaluation.chkpt_path=... \\
        dataset.diffusion.evaluation.n_samples=1024

The sweep's flags and the config's overrides mix freely. Sampling and
the Inception features run on ``cuda`` unless
``+dataset.diffusion.evaluation.device=cpu``.
"""

from __future__ import annotations

import argparse
import sys

from psld_tpu_torch.cli._common import bootstrap


def main(argv=None) -> list:
    """Run the sweep; returns its records."""
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--samplers",
                        default="em_sde,sscs_sde,sscs2m_sde,rk_ode")
    parser.add_argument("--nfes", default="20,50,100,1000")
    parser.add_argument("--strides", default="uniform,quadratic")
    parser.add_argument("--out-dir", required=True)
    parser.add_argument("--ref-dir", default=None,
                        help="directory of real images (pixel stats + FID)")
    parser.add_argument("--ref-stats", default=None,
                        help="precomputed FID stats .npz for the data side")
    parser.add_argument("--weights", default=None,
                        help="pt_inception-2015-12-05 .pth (enables FID)")
    parser.add_argument("--fid-batch", type=int, default=64)
    parser.add_argument("--swd", action="store_true",
                        help="add the multi-scale sliced Wasserstein "
                             "distance against --ref-dir")
    parser.add_argument("--kid", action="store_true",
                        help="add the Kernel Inception Distance (needs "
                             "--weights and --ref-dir)")
    args, overrides = parser.parse_known_args(
        sys.argv[1:] if argv is None else list(argv))
    cfg = bootstrap(overrides)

    from psld_tpu_torch.eval.sweep import run_sweep

    return run_sweep(
        cfg.dataset.diffusion,
        samplers=[s for s in args.samplers.split(",") if s],
        nfes=[int(x) for x in args.nfes.split(",") if x],
        strides=[s for s in args.strides.split(",") if s],
        out_dir=args.out_dir, ref_dir=args.ref_dir,
        ref_stats=args.ref_stats, weights=args.weights,
        fid_batch=args.fid_batch, swd=args.swd, kid=args.kid)


if __name__ == "__main__":
    main()

"""FID, KID and the Inception Score of image sets, as torch-fidelity's
``fidelity --fid --kid --isc --input1 A --input2 B`` computes them
(``psld_tpu/cli/fid.py``).

    python -m psld_tpu_torch.cli.fid --input1 DIR_OR_NPZ \\
        [--input2 DIR_OR_NPZ] \\
        [--weights pt_inception-2015-12-05-6726825d.pth] [--batch 64] \\
        [--fid] [--kid] [--isc] [--save-stats1 out.npz] [--device cpu]

With no metric flag, ``--fid`` is implied. An input is a directory of
PNG/JPEG images or a ``.npz`` of FID statistics (``mu``, ``sigma``,
``count``; KID and ISC need images). ISC is reported for ``--input1``.
Without ``--weights`` (or ``FID_WEIGHTS``) a network with random weights
runs: the pipeline works, and its values are no scores. The features run
on ``cuda`` unless ``--device cpu``; the metrics on the host.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from psld_tpu_torch.eval.pixel_stats import image_files
from psld_tpu_torch.utils.images import load_images_rgb


def iter_image_batches(path: str, batch: int):
    """The images under ``path`` as NHWC float32 batches in [0, 1]."""
    files = image_files(path)
    if not files:
        raise ValueError(f"No images under {path}")
    for start in range(0, len(files), batch):
        yield load_images_rgb(files[start: start + batch]).astype(
            np.float32) / 255.0


def collect(path: str, feature_fn, batch: int, want_feats: bool,
            want_logits: bool):
    """One pass over an image directory: (FID moments, features or None,
    logits or None). ``feature_fn`` returns features, or (features,
    logits); the moments always stream, and the raw features are kept
    only when KID or ISC asks for them."""
    from psld_tpu_torch.eval.fid import FID_DIM, FeatureMoments

    moments = FeatureMoments.zeros(FID_DIM)
    feats_out, logits_out = [], []
    for imgs in iter_image_batches(path, batch):
        out = feature_fn(imgs)
        feats, logits = out if isinstance(out, tuple) else (out, None)
        moments = moments.update(feats)
        if want_feats:
            feats_out.append(feats)
        if want_logits:
            logits_out.append(logits)
    return (moments,
            np.concatenate(feats_out) if feats_out else None,
            np.concatenate(logits_out) if logits_out else None)


def input_stats(path: str, feature_fn, batch: int, save_to: str | None):
    """(mu, sigma) of a directory or a stats file; a directory's moments
    are saved to ``save_to`` when given."""
    from psld_tpu_torch.eval.fid import load_stats, save_stats

    if path.endswith(".npz"):
        return load_stats(path)
    moments, _, _ = collect(path, feature_fn, batch, False, False)
    if save_to:
        save_stats(save_to, moments)
    return moments.finalize()


def inception(weights: str | None, with_fc: bool, device):
    """The FID network of ``weights``, or with random weights drawn from
    seed 0 (a warning is printed) when none are given."""
    from psld_tpu_torch.eval.fid import (FIDInception, load_torch_checkpoint,
                                         random_params)

    if weights:
        params = load_torch_checkpoint(weights)
    else:
        print("WARNING: no --weights; using random Inception weights "
              "(values are NOT comparable scores)")
        params = random_params(torch.Generator().manual_seed(0),
                               with_fc=with_fc)
    return FIDInception.from_params(params, device=device)


def main(argv=None) -> dict:
    """Compute and print the metrics asked for; returns them by
    torch-fidelity's names."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--input1", required=True)
    parser.add_argument("--input2")
    parser.add_argument("--weights", default=os.environ.get("FID_WEIGHTS"))
    parser.add_argument("--batch", type=int, default=64)
    parser.add_argument("--fid", action="store_true")
    parser.add_argument("--kid", action="store_true")
    parser.add_argument("--isc", action="store_true")
    parser.add_argument("--kid-subsets", type=int, default=100)
    parser.add_argument("--kid-subset-size", type=int, default=1000)
    parser.add_argument("--isc-splits", type=int, default=10)
    parser.add_argument("--save-stats1")
    parser.add_argument("--save-stats2")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    if not (args.fid or args.kid or args.isc):
        args.fid = True
    if (args.fid or args.kid) and not args.input2:
        parser.error("--fid/--kid need --input2")
    if (args.kid or args.isc) and (args.input1.endswith(".npz") or
                                   (args.input2 or "").endswith(".npz")):
        parser.error(".npz stats carry only FID moments; KID/ISC need "
                     "image directories")

    from psld_tpu_torch.eval.fid import (frechet_distance, isc_from_logits,
                                         kid_from_features, make_feature_fn,
                                         make_feature_logits_fn, save_stats)

    net = inception(args.weights, args.isc, torch.device(args.device))
    results = {}
    if args.kid or args.isc:
        feature_fn = (make_feature_logits_fn(net) if args.isc
                      else make_feature_fn(net))
        m1, f1, l1 = collect(args.input1, feature_fn, args.batch,
                             want_feats=args.kid, want_logits=args.isc)
        if args.save_stats1:
            save_stats(args.save_stats1, m1)
        if args.input2:
            m2, f2, _ = collect(args.input2, feature_fn, args.batch,
                                want_feats=args.kid, want_logits=False)
            if args.save_stats2:
                save_stats(args.save_stats2, m2)
        if args.fid:
            results["frechet_inception_distance"] = frechet_distance(
                *m1.finalize(), *m2.finalize())
        if args.kid:
            kid_mean, kid_std = kid_from_features(
                f1, f2, subsets=args.kid_subsets,
                subset_size=args.kid_subset_size)
            results["kernel_inception_distance_mean"] = kid_mean
            results["kernel_inception_distance_std"] = kid_std
        if args.isc:
            isc_mean, isc_std = isc_from_logits(l1, splits=args.isc_splits)
            results["inception_score_mean"] = isc_mean
            results["inception_score_std"] = isc_std
    else:
        feature_fn = make_feature_fn(net)
        mu1, s1 = input_stats(args.input1, feature_fn, args.batch,
                              args.save_stats1)
        mu2, s2 = input_stats(args.input2, feature_fn, args.batch,
                              args.save_stats2)
        results["frechet_inception_distance"] = frechet_distance(
            mu1, s1, mu2, s2)

    for name, value in results.items():
        print(f"{name}: {value:.6f}")
    return results


if __name__ == "__main__":
    main()

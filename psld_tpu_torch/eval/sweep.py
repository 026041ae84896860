"""The speed-against-quality sweep: sampler x NFE x stride -> JSONL
(``psld_tpu/eval/sweep.py``), the paper's FID-against-NFE study.

One call samples one checkpoint under every (sampler, NFE, stride) and
writes one JSON line each: throughput, and the quality the host can
compute (FID, and KID with ``kid``, when Inception weights are given;
pixel statistics, and SWD with ``swd``, against a reference directory).
The checkpoint loads once, the Inception network is built once and the
reference side's moments are read once. The records carry the JAX
package's keys, and ``includes_compile`` marks the same records as the
JAX package's: the first stride of each (sampler, NFE), whose time there
holds that program's compile. The port compiles nothing per point: its
kernels build once per process, at their first launch, so only the
sweep's first record holds the builds, and a later marked record holds
no more than its sampler's first use. A quality computation that fails
is written into its record as ``quality_error``, and the sweep goes on.
"""

from __future__ import annotations

import json
import logging
import os
import time

import torch

logger = logging.getLogger(__name__)


def _make_quality_fn(ref_dir, ref_stats, weights, batch, swd=False,
                     kid=False, device="cuda"):
    """The per-directory quality function, built once: the Inception
    network on ``device`` and the reference side's moments (and features,
    for KID) do not change across the sweep."""
    if not (ref_dir or weights):
        return lambda gen_dir: {}

    from psld_tpu_torch.cli.fid import collect, inception
    from psld_tpu_torch.eval.fid import (frechet_distance, kid_from_features,
                                         load_stats, make_feature_fn)

    feature_fn = mu2 = cov2 = ref_feats = None
    if weights:
        feature_fn = make_feature_fn(inception(weights, False, device))
        if kid and not ref_dir:
            raise ValueError("KID needs --ref-dir (raw features, not .npz "
                             "moments)")
        if ref_stats and not kid:
            mu2, cov2 = load_stats(ref_stats)
        elif ref_dir:
            m2, ref_feats, _ = collect(ref_dir, feature_fn, batch,
                                       want_feats=kid, want_logits=False)
            mu2, cov2 = m2.finalize()
        else:
            raise ValueError("FID needs --ref-dir or --ref-stats")

    def quality(gen_dir):
        out = {}
        if ref_dir:
            from psld_tpu_torch.eval.pixel_stats import compare_dirs

            out["pixel_stats"] = compare_dirs(gen_dir, ref_dir)
            if swd:
                from psld_tpu_torch.eval.swd import swd_dirs

                out["swd"] = swd_dirs(gen_dir, ref_dir)
        if feature_fn is not None:
            m1, gen_feats, _ = collect(gen_dir, feature_fn, batch,
                                       want_feats=kid, want_logits=False)
            out["fid"] = float(frechet_distance(*m1.finalize(), mu2, cov2))
            if kid:
                out["kid"], out["kid_std"] = kid_from_features(gen_feats,
                                                               ref_feats)
        return out

    return quality


def run_sweep(config, samplers, nfes, strides, out_dir, ref_dir=None,
              ref_stats=None, weights=None, fid_batch=64, swd=False,
              kid=False) -> list:
    """Sample ``config``'s checkpoint, loaded once, under every
    combination; returns the records, which are also appended to
    ``<out_dir>/sweep.jsonl`` and printed. Sampling and the Inception
    features run on ``evaluation.device`` (default ``cuda``)."""
    from psld_tpu_torch.config import ConfigDict
    from psld_tpu_torch.eval.generate import load_eval_state, sample

    ecfg = config.evaluation
    if str(ecfg.save_mode) != "image":
        raise ValueError("the sweep's quality metrics read PNG directories;"
                         " set evaluation.save_mode=image")
    device = torch.device(str(ecfg.get("device", "cuda")))
    net = load_eval_state(config)
    quality = _make_quality_fn(ref_dir, ref_stats, weights, fid_batch,
                               swd=swd, kid=kid, device=device)
    os.makedirs(out_dir, exist_ok=True)
    jsonl = os.path.join(out_dir, "sweep.jsonl")
    results, seen = [], set()
    for sampler_name in samplers:
        for nfe in nfes:
            for stride in strides:
                cfg = ConfigDict(config.to_dict())
                ecfg = cfg.evaluation
                ecfg.sampler.name = sampler_name
                ecfg.n_discrete_steps = int(nfe)
                ecfg.stride_type = stride
                tag = f"{sampler_name}_nfe{nfe}_{stride}"
                ecfg.save_path = os.path.join(out_dir, tag)
                first = (sampler_name, int(nfe)) not in seen
                seen.add((sampler_name, int(nfe)))
                logger.info("sweep: %s", tag)
                t0 = time.time()
                n = sum(b["samples"] for b in sample(cfg, preloaded=net))
                elapsed = time.time() - t0
                rec = {
                    "sampler": sampler_name,
                    "nfe": int(nfe),
                    "stride": stride,
                    "n_samples": int(n),
                    "elapsed_s": round(elapsed, 3),
                    "img_per_s": round(n / elapsed, 4) if elapsed else None,
                    "includes_compile": first,
                }
                gen_dir = ecfg.save_path
                if str(ecfg.path_prefix):
                    gen_dir = os.path.join(gen_dir, str(ecfg.path_prefix))
                try:
                    rec.update(quality(os.path.join(gen_dir, "images")))
                except Exception as e:  # best effort, as the JAX sweep
                    logger.exception("sweep: quality of %s failed", tag)
                    rec["quality_error"] = str(e)
                results.append(rec)
                with open(jsonl, "a") as f:
                    f.write(json.dumps(rec) + "\n")
                print(json.dumps(rec), flush=True)
    return results

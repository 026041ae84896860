"""Sample-quality sanity metrics, without weights, between two image
directories (``eval/pixel_stats.py``; ``--swd`` adds the sliced
Wasserstein distance of ``eval/swd.py``). Runs on the host alone.

    python -m psld_tpu_torch.cli.pixel_stats --input1 DIR --input2 DIR \\
        [--limit N] [--swd]

Prints one JSON object.
"""

from __future__ import annotations

import argparse
import json


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--input1", required=True)
    p.add_argument("--input2", required=True)
    p.add_argument("--limit", type=int, default=None,
                   help="cap the number of images read per directory")
    p.add_argument("--swd", action="store_true",
                   help="also compute the multi-scale sliced Wasserstein "
                        "distance (ProGAN protocol; values x1e3)")
    args = p.parse_args(argv)

    from psld_tpu_torch.eval.pixel_stats import compare_dirs

    out = compare_dirs(args.input1, args.input2, args.limit)
    if args.swd:
        from psld_tpu_torch.eval.swd import swd_dirs

        out["swd"] = swd_dirs(args.input1, args.input2, args.limit)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()

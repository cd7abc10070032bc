"""DSTC2/DSTC3 preprocessing CLI -- the port of ``tools/run_etl.py``.

Parity surface: `python helpers/process_dstc2_with_SEP.py --data_dir ...
--out_dir ...` (reference README.md:18-22, argparse at :433-440).  Emits
train/valid/test shards + memory.json + a stats log under
<out_dir>/processed_data/raw/, byte-equal to the JAX tool's.

Usage:
  python -m nbest_asr_tpu_torch.tools.run_etl --data_dir <dstc2_dir>
      --out_dir <out> [--dstc3] [--augment] [--upsample_count 3]
"""

from __future__ import annotations

import argparse
import os

from ..data.etl import SPLIT_MAP, SPLIT_MAP_DSTC3, run_etl


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--data_dir", required=True,
                    help="raw DSTC2 directory (scripts/config + ori_data)")
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("--dstc3", action="store_true",
                    help="use the DSTC3 act/slot split map")
    ap.add_argument("--augment", action="store_true",
                    help="transcript-upsample augmentation of the train "
                         "split (trans-as-asr copies; the reference's "
                         "dormant path, process_dstc2_with_SEP.py:250-253)")
    ap.add_argument("--upsample_count", type=int, default=3,
                    help="extra transcript copies per turn with --augment")
    args = ap.parse_args(argv)

    split_map = SPLIT_MAP_DSTC3 if args.dstc3 else SPLIT_MAP
    run_etl(args.data_dir, args.out_dir, split_map=split_map,
            augment=args.augment, upsample_count=args.upsample_count)
    out = os.path.join(args.out_dir, "processed_data", "raw")
    print(f"wrote shards + memory.json under {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

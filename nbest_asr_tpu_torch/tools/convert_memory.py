"""Migrate a reference-format `memory.pt` (torch pickle,
`process_dstc2_with_SEP.py:427`) to this framework's `memory.json` -- the
port of ``tools/convert_memory.py``.

Usage: python -m nbest_asr_tpu_torch.tools.convert_memory <memory.pt>
           [memory.json]
"""

from __future__ import annotations

import os
import sys

from ..data.vocab import Memory


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    src = argv[0]
    dst = argv[1] if len(argv) > 1 else \
        os.path.join(os.path.dirname(src), "memory.json")
    mem = Memory.from_torch_pt(src)
    mem.save(dst)
    arr = mem.arrays()
    print(f"wrote {dst}: {len(mem.word2idx)} words, {mem.n_bottom} labels,"
          f" {mem.n_top} top groups"
          f" ({int(arr.is_multi_top.sum())} multi-bottom)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

#!/usr/bin/env python
"""Phase 3 of ``chip_smoke.py`` for the named kernels only: each of their
cases held against its plain version and timed beside its library call and
its bound, as the smoke does, then the per-kernel summary as one JSON line.

``--root DIR`` takes ``chip_smoke.py`` and the port from another checkout
(the parent commit unpacked with ``git archive`` into a directory that
``.gitignore`` lists), so that two versions are timed in one call on one
card, in turns.  Needs an NVIDIA GPU.  Run from the repository root:
``python3 tools/phase3_kernels_torch.py [--root DIR] NAME ...`` with the
names of ``chip_smoke.MAIN_SHAPE`` (e.g. ``flash_attention_bidir``).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent),
                    help="the checkout whose chip_smoke.py and port to run")
    ap.add_argument("names", nargs="+", help="kernel names (chip_smoke.MAIN_SHAPE's keys)")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    import chip_smoke as C

    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    unknown = sorted(set(args.names) - set(C.MAIN_SHAPE))
    if unknown:
        raise SystemExit(f"unknown kernels {unknown}; known: {sorted(C.MAIN_SHAPE)}")
    print(C.gpu_name_and_power(), flush=True)
    every = C.kernel_cases
    C.kernel_cases = lambda dev, *rest: (c for c in every(dev, *rest) if c.name in args.names)
    print(json.dumps(C.check_kernels(torch.device("cuda", 0))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python
"""In-kernel int4 unpack schedules on one NVIDIA GPU: the PyTorch/CUDA
counterpart of ``tools/exp_int4_unpack.py``.

Every schedule computes ``y = bf16(x) @ (decode(packed) · s)`` at the
flagship MLP's decode shape (M, K, N) = (8, 4096, 11008), G = 64, with the
half-plane K packing, through ``ops/int4_unpack_probe.py`` (the kernel
``csrc/int4_unpack_probe.cu``); they differ in how a nibble becomes a
weight (that module's docstring): ``a`` int mask and shift with f32 scales,
``d`` biased bytes with bf16 scales and the bias corrected per group in the
kernel, ``e`` signed nibbles by arithmetic shifts, ``f`` the port's
mixed-plane layout with its +8 correction outside the kernel.

Operands are drawn and packed as the JAX tool's ``main`` does, from
``np.random.default_rng(0)``.  Prints each schedule's max relative error
against the f32 product ``x @ (q · s)`` (x unrounded), its time per call
(CUDA events around ``--reps`` back-to-back calls) and the GB/s of the
weight stream (K·N/2 bytes a call), with the card's name and power limit.

Usage, from the repository root:
    python tools/exp_int4_unpack_torch.py [--reps 200]
    python tools/exp_int4_unpack_torch.py --device cpu --shape 8,512,256
(on the CPU the wrapper takes the plain versions and the times are the
host's, not the card's).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SHAPE = (8, 4096, 11008)
G = 64


def run(dev, shape=SHAPE, group: int = G, reps: int = 200) -> list:
    """Every schedule: one dict (schedule, rel, us, gbs, launches: its calls
    of the wrapper, each a kernel launch on the card)."""
    import torch

    from licv_vqa_tpu_torch.ops import int4_unpack_probe as P
    from licv_vqa_tpu_torch.utils.profiling import per_call_us

    m, k, n = shape
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(dev)
    q = torch.from_numpy(rng.integers(-7, 8, size=(k, n)).astype(np.int8)).to(dev)
    s = torch.from_numpy(rng.random((k // group, n)).astype(np.float32) * 0.01 + 0.001).to(dev)
    w = (q.float().reshape(k // group, group, n) * s.reshape(k // group, 1, n)).reshape(k, n)
    ref = x @ w
    del w
    rows = []
    for schedule in P.SCHEDULES:
        packed, table = P.probe_operands(q, s, schedule)

        def fn(packed=packed, table=table, schedule=schedule):
            return P.int4_unpack_probe(x, packed, table, group, schedule)

        rel = ((fn() - ref).abs().max() / (ref.abs().max() + 1e-9)).item()
        us = per_call_us(fn, reps, dev)
        # a rate of the card's from a card's time only
        gbs = k * n / 2 / (us * 1e-6) / 1e9 if dev.type == "cuda" else None
        # the check, the warm call and the reps
        rows.append(dict(schedule=schedule, rel=rel, us=us, gbs=gbs, launches=2 + reps))
        rate = f"{gbs:.0f} GB/s weight stream" if gbs is not None else "host time"
        print(f"{schedule}: max rel err {rel:.2e}; {us:.2f} us  ({rate})", flush=True)
    return rows


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--shape", default=",".join(map(str, SHAPE)), help="M,K,N")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("exp_int4_unpack_torch: no CUDA device (use --device cpu)", file=sys.stderr)
        return 1
    from licv_vqa_tpu_torch.utils.profiling import card

    shape = tuple(int(v) for v in args.shape.split(","))
    print(f"device: {card(dev)}; (M, K, N) = {shape}, G = {G}"
          + ("" if dev.type == "cuda" else " (host times on the CPU: not device metrics)"),
          flush=True)
    run(dev, shape, G, args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python
"""Cluster plans of the masked KL kernels (``csrc/masked_kl.cu``) on one
NVIDIA GPU: for each of ``chip_smoke.py`` phase 3's KL shapes and row
weights, the clusters the card runs at once for each split of a row
(``masked_kl_max_clusters``), the split the wrappers choose
(``launch_plan``), and the device time per call of the forward and the
backward at every split that fits a block.

Times: CUDA events around calls queued behind a spin kernel
(``chip_smoke.queued_ms``: the device's work and the gaps between its
kernels, not the host's launch cost), with the card's name and power
limit.  Needs an NVIDIA GPU.  Run from the repository root:
``python3 tools/exp_kl_clusters_torch.py [--root DIR]`` (``--root``: the
port and ``chip_smoke.py`` of another checkout, for two versions in one
call).
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

# (rows, columns, weights): phase 3's cases
SHAPES = ((128, 32000, "70%"), (128, 32000, "all"), (512, 32000, "70%"), (128, 32002, "train"))
CALLS = 20


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent),
                    help="the checkout whose chip_smoke.py and port to run")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    import chip_smoke as C
    from licv_vqa_tpu_torch.ops import masked_kl_kernel as K

    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    print(C.gpu_name_and_power(), flush=True)
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    chosen = K._card_plan
    for n, v, kind in SHAPES:
        stu = torch.randn((n, v), generator=g, device=dev) * 3
        tea = torch.randn((n, v), generator=g, device=dev) * 3
        if kind == "train":  # phase 5's answer rows at bs=2 x 64 (chip_smoke's stand-in)
            w = torch.zeros((n,), device=dev)
            for row, (lo, hi) in enumerate(C.KL_TRAIN_MASK_STAND_IN):
                w[row * 64 + lo:row * 64 + hi] = 1.0
        elif kind == "all":
            w = torch.ones((n,), device=dev)
        else:
            w = (torch.rand((n,), generator=g, device=dev) < 0.7).float()
        gw = w / w.sum()
        _, lse_s, lse_t = K.rowwise_kl_reference(stu, tea, C.KL_EPS, w)
        plans = sorted({K._split(v, c) for c in K.KL_CLUSTERS}, key=lambda pl: pl.cluster)
        print(f"({n},{v}) {kind}: {int((w != 0).sum())} of {n} rows weighted; wrappers' plan "
              f"fwd {chosen(stu, False)}, bwd {chosen(stu, True)}", flush=True)
        for plan in plans:
            at_once = [K._max_clusters(0, plan.width, plan.cluster, bwd) for bwd in (False, True)]
            if min(at_once) == 0:
                print(f"  cluster {plan.cluster} width {plan.width}: does not fit", flush=True)
                continue
            K._card_plan = lambda x, backward, plan=plan, a=at_once: dataclasses.replace(
                plan, clusters=min(a[backward], x.shape[0]))
            try:
                fwd = C.queued_ms(lambda: K.rowwise_kl_forward(stu, tea, C.KL_EPS, w), CALLS)
                bwd = C.queued_ms(lambda: K.rowwise_kl_backward(
                    stu, tea, lse_s, lse_t, gw, C.KL_EPS, w), CALLS)
            finally:
                K._card_plan = chosen
            print(f"  cluster {plan.cluster} width {plan.width}: clusters at once fwd "
                  f"{at_once[0]}, bwd {at_once[1]}; fwd {fwd * 1e3:.2f} us, bwd "
                  f"{bwd * 1e3:.2f} us", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python
"""Split-K plans of the int8 decode matmul, the w8a8 matmul's
weight-streaming tile and the int4 unpack probe on one NVIDIA GPU: the
device time per call at each cluster size, beside the plan the wrappers
choose.

- int8 (``csrc/int8_matmul.cu``): a beam step's projections, a 64-row
  block and the head (N = 32000 on TMA, 32002 on the plain loads), each at
  1, 2, 4, 6 and 8 split-K blocks a cluster (the C entry takes the count),
  then through its wrapper;
- w8a8 (``csrc/w8a8_matmul.cu``, the pre-quantized entry point): run A's
  prefill and bind shapes, each at 1, 2, 3, 4 and 6
  split-K blocks a cluster (the C entry takes the count; it uses fewer
  where the K stages run out), then the planned call of each entry point,
  and the device time of each kernel one fused call launches (the row pass
  and the matmul, from ``torch.profiler``);
- the probe (``csrc/int4_unpack_probe.cu``) at the tool's (8, 4096, 11008),
  G = 64, each schedule at 1, 2, 4 and 8 splits, then through its wrapper.

Times: CUDA events around calls queued behind a spin kernel
(``chip_smoke.queued_ms``: the device's work and the gaps between its
kernels, not the host's launch cost), with the card's name and power
limit.  Needs an NVIDIA GPU.  Run from the repository root:
``python3 tools/exp_quant_splits_torch.py [--root DIR] [--kernels int8,w8a8,probe]``
(``--root``: the port and ``chip_smoke.py`` of another checkout, for two
versions in one call; ``--kernels``: which sweeps, all by default).
"""

from __future__ import annotations

import argparse
import ctypes
import sys
from pathlib import Path

INT8_SHAPES = ((3, 4096, 4096), (3, 4096, 11008), (3, 11008, 4096), (64, 4096, 4096),
               (3, 4096, 32000), (3, 4096, 32002))
INT8_SPLITS = (1, 2, 4, 6, 8)
W8A8_SHAPES = ((64, 4096, 4096), (64, 4096, 11008), (64, 11008, 4096), (64, 1280, 4096),
               (512, 4096, 4096), (321, 1280, 1536))
W8A8_SPLITS = (1, 2, 3, 4, 6)
PROBE_SHAPE = (8, 4096, 11008, 64)
PROBE_SPLITS = (1, 2, 4, 8)


def kernel_times(fn, calls: int = 20) -> str:
    """Mean device µs of each kernel one call of ``fn`` launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.name.replace("void (anonymous namespace)::", "").split("<")[0]
            by_name.setdefault(name.split("(")[0][:40], []).append(
                e.time_range.end - e.time_range.start)
    return "; ".join(f"{k} x{len(v) / calls:g} {sum(v) / len(v):.2f}" for k, v in by_name.items())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent),
                    help="the checkout whose port and chip_smoke.py to run")
    ap.add_argument("--kernels", default="int8,w8a8,probe",
                    help="comma-separated sweeps to run: int8, w8a8, probe")
    args = ap.parse_args()
    kernels = set(args.kernels.split(","))
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    import chip_smoke as C
    from licv_vqa_tpu_torch.ops import int4_unpack_probe as P
    from licv_vqa_tpu_torch.ops import int8_matmul as I8

    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    print(C.gpu_name_and_power(), f"root {args.root}", flush=True)
    dev = torch.device("cuda", 0)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    g = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream

    if "int8" in kernels:
        int8_sweep(C, I8, dev, g, n_sm, stream)
    if "w8a8" in kernels:
        w8a8_sweep(C, I8, dev, g, n_sm, stream)
    if "probe" in kernels:
        probe_sweep(C, P, dev, g, n_sm, stream)
    return 0


def int8_sweep(C, I8, dev, g, n_sm: int, stream) -> None:
    import torch

    from licv_vqa_tpu_torch.csrc import load_library

    fn = load_library("int8_matmul.cu").int8_matmul_bf16
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    for m, k, n in INT8_SHAPES:
        x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
        q = torch.randint(-127, 128, (k, n), generator=g, device=dev, dtype=torch.int8)
        s = torch.rand(n, generator=g, device=dev)
        out = torch.empty((m, n), dtype=torch.float32, device=dev)
        tma = I8.tma_path(k, n, x.data_ptr(), q.data_ptr())
        stages = -(-k // I8.INT8_STAGE_ROWS)
        sweep = []
        for splits in INT8_SPLITS:
            per = -(-stages // splits) * I8.INT8_STAGE_ROWS
            def call(per=per):
                err = fn(x.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(), m, k, n,
                         -(-k // per), per, int(tma), 1, stream)
                if err:
                    raise RuntimeError(f"cudaError {err}")
            sweep.append(f"{splits}: {C.queued_ms(call, 50) * 1e3:.2f}")
        plan = I8.launch_plan(m, k, n, n_sm)[0]
        wrapper = C.queued_ms(lambda: I8.int8_matmul(x, q, s, torch.float32), 50) * 1e3
        print(f"int8 ({m},{k},{n}) {'TMA' if tma else 'plain loads'} splits µs "
              f"{', '.join(sweep)}; plan {plan}: wrapper {wrapper:.2f}", flush=True)


def w8a8_sweep(C, I8, dev, g, n_sm: int, stream) -> None:
    import torch

    from licv_vqa_tpu_torch.csrc import load_library

    pre = load_library("w8a8_matmul.cu").w8a8_matmul_prequantized
    pre.restype = ctypes.c_int
    pre.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    for m, k, n in W8A8_SHAPES:
        xq = torch.randint(-127, 128, (m, k), generator=g, device=dev, dtype=torch.int8)
        q = torch.randint(-127, 128, (k, n), generator=g, device=dev, dtype=torch.int8)
        xs = torch.rand(m, generator=g, device=dev)
        s = torch.rand(n, generator=g, device=dev)
        x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
        out = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
        sweep = []
        for splits in W8A8_SPLITS:
            def call(splits=splits):
                err = pre(xq.data_ptr(), None, xs.data_ptr(), q.data_ptr(), s.data_ptr(),
                          out.data_ptr(), m, k, n, 0, 0, splits, 0, stream)
                if err:
                    raise RuntimeError(f"cudaError {err}")
            sweep.append(f"{splits}: {C.queued_ms(call, 50) * 1e3:.2f}")
        plan = I8._w8a8_splits(m, k, n, I8._w8a8_tile(None), n_sm)
        planned = C.queued_ms(lambda: I8.w8a8_matmul_prequantized(xq, xs, q, s, torch.bfloat16),
                              50) * 1e3
        fused = C.queued_ms(lambda: I8.w8a8_matmul(x, q, s, torch.bfloat16), 50) * 1e3
        kernels = kernel_times(lambda: I8.w8a8_matmul(x, q, s, torch.bfloat16))
        print(f"w8a8 ({m},{k},{n}) splits µs {', '.join(sweep)}; plan {plan}: pre-quantized "
              f"{planned:.2f}, fused {fused:.2f} ({kernels})", flush=True)


def probe_sweep(C, P, dev, g, n_sm: int, stream) -> None:
    import torch

    from licv_vqa_tpu_torch.csrc import load_library

    m, k, n, group = PROBE_SHAPE
    probe = load_library("int4_unpack_probe.cu").int4_unpack_probe
    probe.restype = ctypes.c_int
    probe.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    x = torch.randn((m, k), generator=g, device=dev)
    xb = x.to(torch.bfloat16)
    q4 = torch.randint(-7, 8, (k, n), generator=g, device=dev).to(torch.int8)
    s4 = torch.rand((k // group, n), generator=g, device=dev) * 0.01 + 0.001
    out = torch.empty((m, n), device=dev)
    for sched in P.SCHEDULES:
        packed, table = P.probe_operands(q4, s4, sched)
        sweep = []
        for splits in PROBE_SPLITS:
            per = -(-k // 2 // splits // 64) * 64
            def call(splits=splits, per=per):
                err = probe(xb.data_ptr(), packed.data_ptr(), table.data_ptr(), out.data_ptr(),
                            m, k, n, group, splits, per, P.SCHEDULES.index(sched), stream)
                if err:
                    raise RuntimeError(f"cudaError {err}")
            sweep.append(f"{splits}: {C.queued_ms(call, 50) * 1e3:.2f}")
        plan = P.launch_plan(m, k // 2, n, group, n_sm)[0]
        wrapper = C.queued_ms(lambda: P.int4_unpack_probe(x, packed, table, group, sched), 50)
        print(f"probe {sched} ({m},{k},{n}) G={group} splits µs {', '.join(sweep)}; plan {plan}: "
              f"wrapper {wrapper * 1e3:.2f}", flush=True)


if __name__ == "__main__":
    sys.exit(main())

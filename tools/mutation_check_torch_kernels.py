#!/usr/bin/env python
"""Broken copies of the port's training kernels, read by ``chip_smoke.py``'s
own checks: where a wrong kernel lands against their limits.

Each mutation is applied to a copy of the tree in a temporary directory
(never to the checkout), and the kernel-vs-plain error ratio (max-abs error
over the plain output's max-abs, worst output) of every ICV-backward and
masked-KL case of ``chip_smoke.kernel_cases`` is printed from that copy,
beside the case's limit.  For the ICV-backward mutation, the full-width
gradient check (``chip_smoke.gradient_check``, Idefics-9B with random
weights, ~18 GB on the card) is run from the copy too, against
``chip_smoke.REL_L2_TOL``.  Needs an NVIDIA GPU.  Run from the repository
root: ``python3 tools/mutation_check_torch_kernels.py``.
"""

from __future__ import annotations

import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
ICV = "licv_vqa_tpu_torch/ops/icv_inject.py"
KL = "licv_vqa_tpu_torch/ops/masked_kl_kernel.py"
# name: (file, the kernel's line, its broken form, run the gradient check)
MUTATIONS = {
    "icv_bwd_no_norm_term": (
        ICV, "        dh = ds + (gs / n_s) * (h / n_h)\n", "        dh = ds\n", True),
    "kl_bwd_no_q_term": (
        KL, "ds = g * (p * c - q * (p / (p + eps)))", "ds = g * (p * c)", False),
    "kl_bwd_no_mean_a": (KL, "dt = g * (q * (a - ea))", "dt = g * (q * a)", False),
    "kl_fwd_max_never_updated": (
        KL, "            m_s = ms_new\n", "            m_s = m_s\n", False),
}
PROBE = """
import torch, chip_smoke as C
for c in C.kernel_cases(torch.device("cuda")):
    if c.name in ("icv_inject_bwd", "masked_kl_fwd", "masked_kl_bwd"):
        try:
            _, ratio = C.compare(c.kernel, c.plain)
            print(f"  {c.name} {c.label}: ratio {ratio:.3e} (limit {c.tol})", flush=True)
        except AssertionError as e:
            print(f"  {c.name} {c.label}: {e}", flush=True)
"""
GRADIENT_PROBE = """
import tempfile, torch, chip_smoke as C
from pathlib import Path
with tempfile.TemporaryDirectory() as tmp:
    C.write_training_split(Path(tmp))
    r = C.gradient_check(C.training_inputs(torch.device("cuda", 0)))
print(f"  full-width gradient check: {r} (limit {C.REL_L2_TOL})", flush=True)
"""


def main() -> int:
    with tempfile.TemporaryDirectory(prefix="mutation_check_") as tmp:
        for name, (path, line, broken, gradient) in MUTATIONS.items():
            dst = Path(tmp) / name
            shutil.copytree(REPO, dst, ignore=shutil.ignore_patterns(
                ".git", "_archive", "*_out", "_build", "__pycache__"))
            f = dst / path
            text = f.read_text()
            if text.count(line) != 1:
                raise RuntimeError(f"{name}: the line to break is not in {path} once")
            f.write_text(text.replace(line, broken))
            print(name, flush=True)
            for probe in (PROBE, GRADIENT_PROBE) if gradient else (PROBE,):
                r = subprocess.run([sys.executable, "-c", probe], cwd=dst, text=True,
                                   capture_output=True, timeout=600)
                print(r.stdout, end="", flush=True)
                if r.returncode:
                    print(r.stderr[-2000:], flush=True)
                    return r.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())

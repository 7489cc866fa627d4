"""``chip_smoke.py``'s checks as written, read on the CPU: the work each
kernel case's bound counts, the limit each case is held to, the device-busy
union the training profile reports, and the kernel lines that
``tools/mutation_check_torch_kernels.py`` breaks (so a change to a kernel
cannot silently leave the mutation check with nothing to break)."""

import importlib.util
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent


def _load(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, REPO / path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod  # dataclasses look their module up there
    spec.loader.exec_module(mod)
    return mod


C = _load("chip_smoke.py", "chip_smoke")
T = _load("tools/mutation_check_torch_kernels.py", "mutation_check_torch_kernels")


@pytest.fixture(scope="module")
def cases():
    return {(c.name, c.label): c for c in C.kernel_cases(torch.device("cpu"))}


@pytest.mark.parametrize("name", list(T.MUTATIONS))
def test_mutation_line_is_in_its_kernel_once(name):
    path, line, broken, _ = T.MUTATIONS[name]
    assert line != broken
    assert (REPO / path).read_text().count(line) == 1


@pytest.mark.parametrize("layout,vnumel", [
    ("row", 4096), ("batch", 2 * 4096), ("batch1", 2 * 4096), ("per_pos", 2 * 64 * 4096),
])
def test_icv_backward_bound_counts_the_functions_bytes(cases, layout, vnumel):
    """h and g read, dh written, the shift read and its gradient written,
    all bf16: the kernel's per-row f32 ds is not part of the function."""
    c = cases["icv_inject_bwd", f"(2,64,4096) shift={layout}"]
    n = 2 * 64 * 4096
    assert c.bytes_moved == 6 * n + 4 * vnumel
    ms, by = c.bound()
    assert by == "bytes" and ms == pytest.approx(c.bytes_moved / C.HBM_BYTES_PER_S * 1e3)


def test_each_case_is_held_to_its_outputs_limit(cases):
    """The f32 KL outputs to ``F32_REL_TOL``, the bf16 outputs to ``REL_TOL``."""
    for (name, label), c in cases.items():
        want = C.F32_REL_TOL if name.startswith("masked_kl") else C.REL_TOL
        assert c.tol == want, (name, label)
    assert C.F32_REL_TOL < C.REL_TOL
    assert {name for name, _ in cases} == set(C.MAIN_SHAPE)


def test_busy_ms_is_the_union_of_device_intervals():
    def ev(start, end):
        return SimpleNamespace(time_range=SimpleNamespace(start=start, end=end))

    events = [ev(20, 30), ev(0, 10), ev(5, 15), ev(15, 16)]
    assert C.busy_ms(events) == pytest.approx(0.026)  # µs 0-16 and 20-30
    assert C.busy_ms([]) == 0.0

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
    path, line, broken = T.MUTATIONS[name][:3]
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
    """The f32 outputs (the KL's, the quantized matmuls') to ``F32_REL_TOL``,
    the bf16 outputs to ``REL_TOL``."""
    for (name, label), c in cases.items():
        f32 = name.startswith("masked_kl") or label.endswith("f32 out")
        assert c.tol == (C.F32_REL_TOL if f32 else C.REL_TOL), (name, label)
    assert C.F32_REL_TOL < C.REL_TOL
    assert {name for name, _ in cases} == set(C.MAIN_SHAPE)


def test_busy_ms_is_the_union_of_device_intervals():
    def ev(start, end):
        return SimpleNamespace(time_range=SimpleNamespace(start=start, end=end))

    events = [ev(20, 30), ev(0, 10), ev(5, 15), ev(15, 16)]
    assert C.busy_ms(events) == pytest.approx(0.026)  # µs 0-16 and 20-30
    assert C.busy_ms([]) == 0.0


def test_quantized_cases_bound_the_functions_bytes(cases):
    """int8: activations, the int8 plane, f32 column scales, the output;
    int4: the packed nibbles and bf16 group scales (G=64) in its place."""
    m, k, n = 3, 4096, 4096
    c8 = cases["int8_matmul", "(3,4096,4096) bf16 out"]
    c4 = cases["int4_matmul", "(3,4096,4096) bf16 out"]
    assert c8.bytes_moved == m * k * 2 + k * n + n * 4 + m * n * 2
    assert c4.bytes_moved == m * k * 2 + k * n // 2 + (k // 64) * n * 2 + m * n * 2
    for c in (c8, c4):
        ms, by = c.bound()
        assert by == "bytes" and ms == pytest.approx(c.bytes_moved / C.HBM_BYTES_PER_S * 1e3)
    for n in (32000, 32002):
        head = cases["int8_matmul", f"(3,4096,{n}) f32 out"]
        assert head.bytes_moved == m * k * 2 + k * n + n * 4 + m * n * 4
        assert ("int4_matmul", f"(3,4096,{n}) f32 out") not in cases  # the head is int8 only


@pytest.mark.parametrize("name,label", [
    # a beam step's projections and MLP, for both kernels
    ("int8_matmul", "(3,4096,4096) bf16 out"), ("int8_matmul", "(3,4096,11008) f32 out"),
    ("int8_matmul", "(3,11008,4096) f32 out"), ("int4_matmul", "(3,4096,4096) bf16 out"),
    ("int4_matmul", "(3,4096,11008) f32 out"), ("int4_matmul", "(3,11008,4096) f32 out"),
    # the int8 head at a beam step and at run A's prefill
    ("int8_matmul", "(3,4096,32002) f32 out"), ("int8_matmul", "(1,4096,32002) f32 out"),
    # run B's 64-row prefill: attention, MLP, and the bind-time K/V
    ("int4_matmul", "(64,4096,4096) bf16 out"), ("int4_matmul", "(64,4096,11008) f32 out"),
    ("int4_matmul", "(64,11008,4096) f32 out"), ("int4_matmul", "(64,1280,4096) bf16 out"),
])
def test_quantized_cases_cover_the_main_paths_shapes(cases, name, label):
    """Phase 3 holds each quantized kernel against its plain version at
    every shape the quantized runs launch it with."""
    assert (name, label) in cases


def test_quantized_launch_prediction_at_full_width():
    """Per question at Idefics-9B width (bs=1, beam-3, 5 new tokens): run A
    (w8a8 prefill) launches the int8 kernel at the 4 beam steps (32 layers x
    7 + 8 blocks x 5) and for the head at every forward; run B (int4, bf16
    head) also at the 64-row prefill and the bind-time K/V."""
    from licv_vqa_tpu_torch.models.idefics import IdeficsConfig

    mc = IdeficsConfig.idefics_9b()
    (_, opts_a, _), (_, opts_b, _) = C.QUANT_RUNS
    step = 32 * 7 + 8 * 5
    for s_prompt, n_img in ((64, 1), (512, 33)):
        got = C.predicted_quantized_launches(mc, "int8", opts_a, 1, s_prompt, n_img, 3, 5)
        assert got == {"int8_matmul": 4 * step + 5, "int4_matmul": 0}
    got = C.predicted_quantized_launches(mc, "int4", opts_b, 1, 64, 1, 3, 5)
    assert got == {"int8_matmul": 0, "int4_matmul": step + 4 * step + 2 * 8}


def test_quantized_phase_counts_match_prediction_on_tiny_idefics(tmp_path, monkeypatch):
    """Phase 6 on the CPU at tiny size, with the kernel wrappers counted
    where ``qdot`` calls them: every run's counts equal
    ``predicted_quantized_launches`` (the phase checks it and raises)."""
    import importlib

    from licv_vqa_tpu_torch.models import decoder as PD
    from licv_vqa_tpu_torch.ops import int4_matmul as I4
    from licv_vqa_tpu_torch.ops import int8_matmul as I8

    iv = importlib.import_module("licv_vqa_tpu_torch.ops.icv_inject")

    def counting(fn):
        def wrapper(*a, **k):
            wrapper.launches += 1
            return fn(*a, **k)
        wrapper.launches = 0
        return wrapper

    for mod, name in ((I8, "int8_matmul"), (I4, "int4_matmul"), (iv, "icv_inject")):
        monkeypatch.setattr(mod, name, counting(getattr(mod, name)))
    monkeypatch.setattr(PD, "icv_inject", iv.icv_inject)
    for name in ("synchronize", "reset_peak_memory_stats", "max_memory_allocated"):
        monkeypatch.setattr(torch.cuda, name, lambda *a: 0)
    for key in ("RESULT_DIR", "MODEL_CPK_DIR", "VQAV2_PATH", "COCO_PATH", "OKVQA_PATH"):
        monkeypatch.setenv(key, str(tmp_path))  # restored after; the phase sets its own
    monkeypatch.setattr(C, "N_ICV_Q", 2)
    monkeypatch.setattr(C, "N_ICL_Q", 1)
    monkeypatch.chdir(REPO)
    for mode, opts, paths in C.QUANT_RUNS:
        got = C.quantized_path(torch.device("cpu"), tmp_path / mode, mode, opts, paths,
                               lmm="tiny-idefics")
        assert got[f"{mode}_matmul"] > 0 and got["icv_inject"] == 4 * 2 * C.MAX_NEW

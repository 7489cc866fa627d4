"""``chip_smoke.py``'s checks as written, read on the CPU: the work each
kernel case's bound counts, the limit each case is held to, the device-busy
union the training profile reports, the launch counts phases 6, 7 and 8
predict (rehearsed at tiny size), and the kernel lines that
``tools/mutation_check_torch_kernels.py`` breaks (so a change to a kernel
cannot silently leave the mutation check with nothing to break)."""

import functools
import importlib.util
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
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
    all bf16: the kernel's f32 partials of the gradient are not part of
    the function."""
    c = cases["icv_inject_bwd", f"(2,64,4096) shift={layout}"]
    n = 2 * 64 * 4096
    assert c.bytes_moved == 6 * n + 4 * vnumel
    ms, by = c.bound()
    assert by == "bytes" and ms == pytest.approx(c.bytes_moved / C.HBM_BYTES_PER_S * 1e3)


def test_each_case_is_held_to_its_outputs_limit(cases):
    """The f32 outputs (the KL's, the quantized matmuls', the int4 probe's,
    the f32 ViT entry's) to ``F32_REL_TOL``, the bf16 outputs to
    ``REL_TOL``, and the w8a8 kernel's, whatever their dtype, to equality."""
    for (name, label), c in cases.items():
        f32 = (name.startswith(("masked_kl", "int4_unpack_probe", "vit_attention_f32"))
               or label.endswith("f32 out"))
        want = 0.0 if name == "w8a8_matmul" else C.F32_REL_TOL if f32 else C.REL_TOL
        assert c.tol == want, (name, label)
    assert C.F32_REL_TOL < C.REL_TOL
    assert {name for name, _ in cases} == set(C.MAIN_SHAPE)


def test_bidir_cases_cover_phase_7_and_bound_the_visible_pairs(cases):
    """The tower's three shapes and a ragged S with pads; bytes: q, k, v
    read and the output written (bf16) and the int32 validity; operations:
    QK^T and PV over the pairs the segment rule leaves visible, bound by
    operations at these sizes."""
    labels = {label for name, label in cases if name == "flash_attention_bidir"}
    assert labels == {
        "(1,4900,16,72) all valid",
        "(1,1920,16,72) valid 34x45 of 40x48",
        "(33,1920,16,72) valid 34x45,30x45,27x35 of 40x48",
        "(2,1100,16,72) valid 20x30,15x55 of 20x55",
    }
    ragged = cases["flash_attention_bidir", "(2,1100,16,72) valid 20x30,15x55 of 20x55"]
    assert ragged.ops == 4 * 16 * 72 * (600 ** 2 + 500 ** 2 + 825 ** 2 + 275 ** 2)
    c = cases["flash_attention_bidir", "(1,1920,16,72) valid 34x45 of 40x48"]
    n = 1920 * 16 * 72
    assert c.bytes_moved == 4 * n * 2 + 1920 * 4
    assert c.ops == 4 * 16 * 72 * (1530 ** 2 + 390 ** 2)
    full = cases["flash_attention_bidir", "(1,4900,16,72) all valid"]
    assert full.ops == 4 * 16 * 72 * 4900 ** 2
    for case in (c, full):
        ms, by = case.bound()
        assert by == "operations" and ms == pytest.approx(case.ops / 989e12 * 1e3)


def test_idefics2_launch_prediction_at_full_width():
    """Per bs=1 question at Idefics2-8B width on the card: the tower's
    kernel at its 27 layers (a 640x480 image is 40x48 = 1920 patches); the
    causal kernel at the 32 layers of a prefill of >= 256 tokens only; the
    ICV at the 32 layers of each of the 5 forwards."""
    from licv_vqa_tpu_torch.models.idefics2 import Idefics2Config

    mc, cuda = Idefics2Config.idefics2_8b(), torch.device("cuda")
    icv = C.predicted_idefics2_launches(mc, 128, 1920, True, cuda)
    assert icv == {"flash_attention_bidir": 27, "vit_attention": 0, "flash_attention_fwd": 0,
                   "icv_inject": 160}
    icl = C.predicted_idefics2_launches(mc, 2752, 1920, False, cuda)
    assert icl == {"flash_attention_bidir": 27, "vit_attention": 0, "flash_attention_fwd": 32,
                   "icv_inject": 0}
    assert C.predicted_idefics2_launches(mc, 2752, 1920, False, torch.device("cpu")) == dict.fromkeys(
        icl, 0)


def test_openflamingo_launch_prediction_at_full_width():
    """Per bs=1 question at OpenFlamingo-9B width on the card: the fused ViT
    kernel at the tower's 24 layers (s=257, Dh 64); the ALiBi kernel at the
    32 layers of a prefill of >= 128 tokens only; the ICV at the 32 layers
    of each of the 5 forwards; the rope flash kernel never."""
    from licv_vqa_tpu_torch.models.openflamingo import OpenFlamingoConfig

    mc, cuda = OpenFlamingoConfig.openflamingo_9b(), torch.device("cuda")
    icv = C.predicted_openflamingo_launches(mc, 64, True, cuda)
    assert icv == {"vit_attention": 24, "flash_alibi_attention": 0, "flash_attention_fwd": 0,
                   "icv_inject": 160}
    icl = C.predicted_openflamingo_launches(mc, 384, False, cuda)
    assert icl == {"vit_attention": 24, "flash_alibi_attention": 32, "flash_attention_fwd": 0,
                   "icv_inject": 0}
    assert C.predicted_openflamingo_launches(mc, 384, False, torch.device("cpu")) == dict.fromkeys(
        icl, 0)


def test_alibi_and_vit_cases_cover_phase_8_and_bound_the_visible_pairs(cases):
    """ALiBi: MPT-7B's shapes with both paddings, compared on the rows with
    a visible key; operations over the visible pairs (k <= q, valid[k]),
    bytes q, k, v, out (bf16), valid (int32) and the slopes.  ViT: ViT-L's
    and ViT-H's shapes, a key mask, S = 1024; bound by the bytes at the
    towers' s=257."""
    alibi = {label for name, label in cases if name == "flash_alibi_attention"}
    assert alibi == {"(1,512,32,128) left pad 39", "(1,512,32,128) right pad 61",
                     "(1,2048,32,128) left pad 301", "(1,2048,32,128) right pad 250"}
    c = cases["flash_alibi_attention", "(1,512,32,128) left pad 39"]
    assert c.bytes_moved == 4 * 512 * 32 * 128 * 2 + 512 * 4 + 32 * 4
    assert c.ops == 4 * 32 * 128 * (473 * 474 / 2)
    assert int(c.rows.sum()) == 473 and not bool(c.rows[0, :39].any())
    assert c.bound()[1] == "bytes"
    c = cases["flash_alibi_attention", "(1,2048,32,128) right pad 250"]
    assert c.ops == 4 * 32 * 128 * (1798 * 1799 / 2 + 250 * 1798)
    assert bool(c.rows.all()) and c.bound()[1] == "operations"
    vit = {label for name, label in cases if name == "vit_attention"}
    assert vit == {"(1,257,16,64) all valid", "(33,257,16,64) all valid",
                   "(33,257,16,80) all valid", "(4,257,16,80) masked", "(2,1024,16,80) masked",
                   "(33,257,8,80) all valid"}  # the last: a rank's heads at tp = 2
    for label, h, dh in (("(33,257,16,64) all valid", 16, 64),
                         ("(33,257,16,80) all valid", 16, 80), ("(33,257,8,80) all valid", 8, 80)):
        c = cases["vit_attention", label]
        assert c.bytes_moved == 4 * 33 * 257 * h * dh * 2
        assert c.ops == 4 * h * dh * 33 * 257 ** 2
        assert c.bound()[1] == "bytes" and c.rows is None


def test_vit_f32_cases_cover_rice_and_bound_the_bytes(cases):
    """The f32 ViT entry at the RICE batch (8, 50, 12, 64): 4.92 MB moved,
    1.47 us at 3.35 TB/s, over its 61.4 MFLOP at 67 TFLOP/s (0.92 us);
    the batch of 64; and 7 keys of each image masked (their pairs not
    counted, the int32 validity read)."""
    vit = {label for name, label in cases if name == "vit_attention_f32"}
    assert vit == {"(8,50,12,64) f32 all valid", "(64,50,12,64) f32 all valid",
                   "(8,50,12,64) f32 masked 7"}
    c = cases["vit_attention_f32", "(8,50,12,64) f32 all valid"]
    assert c.bytes_moved == 4 * 8 * 50 * 12 * 64 * 4 == 4_915_200
    assert c.ops == 4 * 12 * 64 * 50 * 8 * 50 == 61_440_000
    assert c.bound() == pytest.approx((4_915_200 / 3.35e9, "bytes"))
    assert cases["vit_attention_f32", "(64,50,12,64) f32 all valid"].bytes_moved == 39_321_600
    c = cases["vit_attention_f32", "(8,50,12,64) f32 masked 7"]
    assert c.ops == 4 * 12 * 64 * 50 * 8 * 43
    assert c.bytes_moved == 4_915_200 + 8 * 50 * 4
    assert c.library is not None and c.tol == C.F32_REL_TOL


def test_vit_f32_case_holds_its_plain_version_on_cpu(cases):
    for (name, label), c in cases.items():
        if name == "vit_attention_f32":
            got, want = c.kernel(), c.plain()
            assert got.dtype == torch.float32 and torch.equal(got, want), label


def test_probe_bounds_of_the_kernels_still_to_port(cases):
    """PERF.md rows 9 and 10, now ported, at their tools' shapes: each of
    the int4 probe's schedules moves about 25.8 MB (bound by the bytes), the
    w8a8 kernel does 369 GOP of int8 products (bound by the operations at
    1979 TOP/s) from either entry point."""
    nbytes = 8 * 4096 * 2 + 2048 * 11008 + 64 * 11008 * 4 + 8 * 11008 * 4
    for sched in ("a", "d", "e", "f"):
        c = cases["int4_unpack_probe", f"{sched} (8,4096,11008) G=64"]
        assert c.bytes_moved == nbytes and c.ops == 2 * 8 * 4096 * 11008
        ms, by = c.bound()
        assert by == "bytes" and ms == pytest.approx(nbytes / C.HBM_BYTES_PER_S * 1e3)
    cold = cases["int4_unpack_probe",
                 f"cold a (8,4096,11008) G=64, {C.INT4_PROBE_COLD_COPIES} weight copies"]
    assert cold.bytes_moved == nbytes and cold.bound()[1] == "bytes"
    for shape in ("(4096,4096,11008)", "(4096,11008,4096)"):
        for entry in ("fused", "prequantized"):
            ms, by = cases["w8a8_matmul", f"{entry} {shape} bf16 out"].bound()
            assert by == "operations"
            assert ms == pytest.approx(2 * 4096 * 4096 * 11008 / 1979e12 * 1e3)
    # run A's test_icl prefill: at 512 rows about 1000 operations a weight
    # byte, past the card's ridge (~590): bound by the operations
    for shape, out in (("(512,4096,4096)", 2), ("(512,4096,11008)", 4), ("(512,11008,4096)", 4)):
        m, k, n = (int(v) for v in shape[1:-1].split(","))
        c = cases["w8a8_matmul", f"fused {shape} {'f32' if out == 4 else 'bf16'} out"]
        assert c.bytes_moved == m * k * 2 + k * n + n * 4 + m * n * out
        assert c.bound() == (pytest.approx(2 * m * k * n / 1979e12 * 1e3), "operations")
    for copies, (m, k, n), out in ((8, (64, 4096, 4096), 2), (4, (64, 4096, 11008), 4)):
        label = f"cold fused ({m},{k},{n}) {'f32' if out == 4 else 'bf16'} out, {copies} weight copies"
        c = cases["w8a8_matmul", label]
        assert c.bytes_moved == m * k * 2 + k * n + n * 4 + m * n * out
        assert c.bound() == (pytest.approx(c.bytes_moved / C.HBM_BYTES_PER_S * 1e3), "bytes")
    m, k, n = 64, 4096, 4096
    fused = cases["w8a8_matmul", "fused (64,4096,4096) bf16 out"]
    pre = cases["w8a8_matmul", "prequantized (64,4096,4096) bf16 out"]
    assert fused.bytes_moved == m * k * 2 + k * n + n * 4 + m * n * 2
    assert pre.bytes_moved == m * k + m * 4 + k * n + n * 4 + m * n * 2
    assert not hasattr(C, "PROBE_WORK") and not hasattr(C, "probe_bounds")


@pytest.mark.parametrize("label", [
    "fused (64,4096,4096) bf16 out", "prequantized (64,11008,4096) f32 out",
    "fused (321,1280,1536) bf16 out",
])
def test_w8a8_case_equals_its_plain_version_on_cpu(cases, label, monkeypatch):
    """The case as phase 3 runs it, on CPU tensors: the wrappers take the
    plain versions, so the comparison reads exactly 0 (phase 3's limit)."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    c = cases["w8a8_matmul", label]
    assert C.compare(c.kernel, c.plain) == (0.0, 0.0)


def test_int4_probe_case_holds_its_plain_version_on_cpu(cases, monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    c = cases["int4_unpack_probe", "d (8,4096,11008) G=64"]
    err, ratio = C.compare(c.kernel, c.plain)
    assert err == 0.0 and ratio == 0.0


def test_int4_cold_library_builds_every_layout_before_the_timed_calls(monkeypatch):
    """The cold case's library call converts each weight copy's layout at
    its first call: all of them at the case's first call (``library_runs``,
    untimed), none in the calls that ``device_times`` profiles, which go to
    the copies in turn."""
    built, called = [], []

    def fake_library(operands, group):
        i = fake_library.made
        fake_library.made += 1
        state = {"built": False}

        def call():
            if not state["built"]:
                state["built"] = True
                built.append(i)
            called.append(i)

        return call

    fake_library.made = 0
    monkeypatch.setattr(C, "int4pack_library", fake_library)
    c = C.int4_cold_case(torch.device("cpu"))
    assert fake_library.made == C.INT4_COLD_COPIES and built == []
    c.library()
    assert sorted(built) == list(range(C.INT4_COLD_COPIES))
    for _ in range(3 * C.INT4_COLD_COPIES):
        c.library()
    assert len(built) == C.INT4_COLD_COPIES
    assert sorted(called[-C.INT4_COLD_COPIES:]) == list(range(C.INT4_COLD_COPIES))


def test_mean_ratio_of_equal_outputs_is_zero(monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    x = torch.randn((4, 8), generator=torch.Generator().manual_seed(0))
    assert C.mean_ratio(lambda: x.clone(), lambda: x) == 0.0


def test_mean_ratio_reads_only_the_given_rows(monkeypatch):
    """One row off by 0.1 in a (2, 2, 3) output of ones: 0.1 · 3 / 12 over
    every row; 0 on the rows that hold no error."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    want = torch.ones((2, 2, 3))
    got = want.clone()
    got[0, 1] += 0.1
    assert C.mean_ratio(lambda: got, lambda: want) == pytest.approx(0.1 * 3 / 12)
    rows = torch.tensor([[True, False], [True, True]])
    assert C.mean_ratio(lambda: got, lambda: want, rows) == 0.0


def test_mean_ratio_takes_the_worst_output(monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    want = (torch.ones(8), 2 * torch.ones(8))
    got = (torch.ones(8) + 0.01, 2 * torch.ones(8) + 0.1)
    assert C.mean_ratio(lambda: got, lambda: want) == pytest.approx(0.05)


@pytest.mark.parametrize("b,s,h,dh,masked", C.VIT_SHAPES)
def test_vit_case_holds_the_mean_limit_on_cpu(cases, b, s, h, dh, masked, monkeypatch):
    """Every fused-ViT case (and no other) carries the mean-error limit;
    on CPU tensors the wrapper takes the plain version, so it reads 0."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    c = cases["vit_attention", f"({b},{s},{h},{dh}) {'masked' if masked else 'all valid'}"]
    assert c.mean_tol == C.VIT_MEAN_TOL
    assert all(other.mean_tol is None for (name, _), other in cases.items()
               if name != "vit_attention")
    assert C.mean_ratio(c.kernel, c.plain, c.rows) == 0.0


def test_w8a8_and_probe_cases_cover_their_shapes(cases):
    """Run A's 64-token prefill, its 32-shot ``test_icl`` prefill in the
    512-token bucket, its bind-time K/V and perceiver calls at K = 1280 and
    the tool's two shapes, both entry points, each held to equality and
    called twice for equal bits; the fused entry point cold at run A's
    projection and MLP-in, on copies well past the 50 MB L2; the int4
    probe's four schedules, and schedule a cold."""
    for (m, k, n), out in C.W8A8_SHAPES:
        for entry in ("fused", "prequantized"):
            c = cases["w8a8_matmul", f"{entry} ({m},{k},{n}) {out} out"]
            assert c.tol == 0.0 and c.deterministic
    shapes = {s for s, _ in C.W8A8_SHAPES}
    assert {(64, 4096, 4096), (64, 4096, 11008), (64, 11008, 4096), (512, 4096, 4096),
            (512, 4096, 11008), (512, 11008, 4096), (4096, 4096, 11008),
            (4096, 11008, 4096)} <= shapes and any(k == 1280 for _, k, _ in shapes)
    cold = {(m, k, n): copies for (m, k, n), _, copies in C.W8A8_COLD_SHAPES}
    assert set(cold) == {(64, 4096, 4096), (64, 4096, 11008)}
    for (m, k, n), out, copies in C.W8A8_COLD_SHAPES:
        c = cases["w8a8_matmul", f"cold fused ({m},{k},{n}) {out} out, {copies} weight copies"]
        assert copies * (k * n + n * 4) > 2.5 * 50e6  # the copies pass the L2
        assert c.tol == 0.0 and c.deterministic and c.library is not None
    probe = sorted(label for name, label in cases if name == "int4_unpack_probe")
    copies = C.INT4_PROBE_COLD_COPIES
    assert probe == sorted([f"{s} (8,4096,11008) G=64" for s in "adef"] + [
        f"cold a (8,4096,11008) G=64, {copies} weight copies"])
    assert copies * (2048 * 11008 + 64 * 11008 * 4) > 2.5 * 50e6


def test_cold_cases_cycle_through_equal_copies(cases, monkeypatch):
    """The cold cases (CPU tensors take the plain versions): each call
    takes the next copy, and every copy gives the same output, so the
    first call compares equal inputs and two calls give equal bits."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    for (name, label), c in cases.items():
        if not label.startswith("cold") or name == "int4_matmul":
            continue
        first, second = c.kernel(), c.kernel()
        assert torch.equal(first, second) and torch.equal(first, c.plain()), label


def test_kernels_line_has_twelve_rows_each_naming_its_tpu_kernel():
    """One row a kernel: the ten of slices 1-6, the two probes and the fused
    ViT kernel's f32 entry; every source is in the repository,
    every TPU kernel's file:line reaches ``pallas_call`` or names the
    probe's ``main``/``make_fn``."""
    assert len(C.KERNEL_SOURCES) == 13
    assert set(C.KERNEL_SOURCES) == (set(C.MAIN_SHAPE) - {"masked_kl_fwd", "masked_kl_bwd"}
                                     | {"masked_kl"})
    for name, (route, source, replaces) in C.KERNEL_SOURCES.items():
        assert route in ("cuda", "triton") and (REPO / source).is_file(), name
        path, line = replaces.split(":")
        assert (REPO / path).is_file() and int(line) <= len((REPO / path).read_text().splitlines())
    assert C.KERNEL_SOURCES["w8a8_matmul"][2] == "tools/exp_w8a8_tuning.py:36"
    assert C.KERNEL_SOURCES["int4_unpack_probe"][2] == "tools/exp_int4_unpack.py:111"
    assert {"w8a8_matmul.cu", "int4_unpack_probe.cu", "vit_attention_f32.cu"} <= set(
        C.CUDA_SOURCES)
    assert C.KERNEL_SOURCES["vit_attention_f32"][2] == C.KERNEL_SOURCES["vit_attention"][2]


def test_busy_ms_is_the_union_of_device_intervals():
    def ev(start, end):
        return SimpleNamespace(time_range=SimpleNamespace(start=start, end=end))

    events = [ev(20, 30), ev(0, 10), ev(5, 15), ev(15, 16)]
    assert C.busy_ms(events) == pytest.approx(0.026)  # µs 0-16 and 20-30
    assert C.busy_ms([]) == 0.0


def test_a_profiler_without_device_activity_leaves_the_times_to_events(monkeypatch):
    """Work on the CPU gives the profiler no device kernel, as a machine
    whose profiler records nothing does: ``device_events`` returns the wall
    and no events after three sessions instead of failing the run, and
    ``device_times`` then times every function of a case from CUDA events
    (``queued_ms``)."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(C, "_profiler_works", True)
    queued = []
    monkeypatch.setattr(C, "queued_ms", lambda fn, calls: queued.append(calls) or 0.5)
    ran = []
    wall, events = C.device_events(lambda: ran.append(torch.ones(4).sum()))
    assert events is None and wall >= 0 and not C._profiler_works
    assert len(ran) == 4  # three profiled sessions, then one for the wall
    times, timed_by = C.device_times([lambda: None] * 3, 20)
    assert times == [0.5] * 3 and timed_by == "events" and queued == [20] * 3


def test_a_session_that_lost_kernels_leaves_the_times_to_events(monkeypatch):
    """A profiled session of ``calls`` calls that holds fewer kernels than
    ``calls`` times one call's (a reading under the bound) is not used: every
    function of the case is timed from CUDA events; a complete session is
    summed over all its kernels (each call's row pass and matmul)."""
    def ev(start, end):
        return SimpleNamespace(time_range=SimpleNamespace(start=start, end=end))

    monkeypatch.setattr(C, "_profiler_works", True)
    queued = []
    monkeypatch.setattr(C, "queued_ms", lambda fn, calls: queued.append(calls) or 0.5)
    lost = []  # kernels the profiler drops from a session of several calls

    def fake_events(fn):
        ran = []
        fn_calls = fn()  # one call returns None, a session returns its calls' results
        n = len(fn_calls) if isinstance(fn_calls, list) else 1
        ran.extend([ev(0, 3), ev(3, 10)] * n)  # the row pass and the matmul, µs
        return 1.0, ran[:len(ran) - (lost[0] if n > 1 and lost else 0)]

    monkeypatch.setattr(C, "device_events", fake_events)
    times, by = C.device_times([lambda: None], 4)
    assert by == "profiler" and times == [pytest.approx(10 / 1e3)] and not queued
    lost.append(3)
    times, by = C.device_times([lambda: None, lambda: None], 4)
    assert by == "events" and times == [0.5, 0.5] and queued == [4, 4]


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
    # run A's continuous engine: a decode step of its 8-row pool
    ("int8_matmul", "(8,4096,4096) bf16 out"), ("int8_matmul", "(8,4096,11008) f32 out"),
    ("int8_matmul", "(8,11008,4096) f32 out"), ("int8_matmul", "(8,4096,32002) f32 out"),
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
    # run A's w8a8: the prefill's projections, the bind-time K/V (2 a block)
    # and the perceiver's 6 a layer (the 316 `_int_mm` calls of PERF.md §5)
    w8a8 = step + 2 * 8 + 6 * 6
    assert w8a8 == 316
    for s_prompt, n_img in ((64, 1), (512, 33)):
        got = C.predicted_quantized_launches(mc, "int8", opts_a, 1, s_prompt, n_img, 3, 5)
        assert got == {"int8_matmul": 4 * step + 5, "int4_matmul": 0, "w8a8_matmul": w8a8}
    got = C.predicted_quantized_launches(mc, "int4", opts_b, 1, 64, 1, 3, 5)
    assert got == {"int8_matmul": 0, "int4_matmul": step + 4 * step + 2 * 8, "w8a8_matmul": 0}
    # without w8a8 the prefill's 64 rows take the int8 kernel
    got = C.predicted_quantized_launches(mc, "int8", ["lmm.quantize=int8"], 1, 64, 1, 3, 5)
    assert got == {"int8_matmul": 5 * step + 2 * 8, "int4_matmul": 0, "w8a8_matmul": 0}


def _counting(fn):
    def wrapper(*a, **k):
        wrapper.launches += 1
        return fn(*a, **k)
    wrapper.launches = 0
    return wrapper


def _stub_cuda(monkeypatch, tmp_path):
    for name in ("synchronize", "reset_peak_memory_stats", "max_memory_allocated"):
        monkeypatch.setattr(torch.cuda, name, lambda *a: 0)
    for key in ("RESULT_DIR", "MODEL_CPK_DIR", "VQAV2_PATH", "COCO_PATH", "OKVQA_PATH"):
        monkeypatch.setenv(key, str(tmp_path))  # restored after; the phase sets its own
    monkeypatch.setattr(C, "N_ICV_Q", 2)
    monkeypatch.setattr(C, "N_ICL_Q", 1)
    monkeypatch.chdir(REPO)


def test_idefics2_phase_counts_match_prediction_on_tiny_idefics2(tmp_path, monkeypatch):
    """Phase 7 on the CPU at tiny size: the two flash gates take the CPU
    (the tower's at any length, the causal one at >= 256 tokens, as on the
    card), the wrappers are counted where the model calls them, and every
    path's counts equal ``predicted_idefics2_launches`` (the phase checks it
    and raises): the tower's kernel in each bind, the causal one in the
    32-shot prefills, the ICV in every test_icv forward."""
    import importlib

    from licv_vqa_tpu_torch.models import decoder as PD
    from licv_vqa_tpu_torch.models import layers as PL

    iv = importlib.import_module("licv_vqa_tpu_torch.ops.icv_inject")
    for mod, name in ((PL, "flash_attention_bidir"), (PL, "flash_attention"),
                      (iv, "icv_inject")):
        monkeypatch.setattr(mod, name, _counting(getattr(mod, name)))
    monkeypatch.setattr(PD, "icv_inject", iv.icv_inject)
    monkeypatch.setattr(PL, "flash_bidir_usable", lambda s, device: True)
    monkeypatch.setattr(PL, "flash_attention_usable", lambda cfg, s, dh, device: s >= 256)
    _stub_cuda(monkeypatch, tmp_path)
    # phase 7b has its own rehearsal (below): these are phase 7's counts,
    # and 7b's counters (zero here) join them
    monkeypatch.setattr(C, "idefics2_serving_path",
                        lambda e: dict.fromkeys(C.engine_counters(), 0))
    got = C.idefics2_path(torch.device("cpu"), tmp_path / "idefics2", lmm="tiny-idefics2")
    # 2 test_icv and 1 test_icl questions: a bind each, 2 vision layers,
    # 4 decoder layers, 5 forwards a question
    assert got == {"flash_attention_bidir": 2 * 3, "vit_attention": 0,
                   "flash_attention_fwd": 4 * 1, "icv_inject": 4 * 2 * C.MAX_NEW,
                   "flash_alibi_attention": 0}


def test_openflamingo_phase_counts_match_prediction_on_tiny_flamingo(tmp_path, monkeypatch):
    """Phase 8 on the CPU at tiny size: the two gates take the CPU (the
    fused ViT one at s <= 1024, the ALiBi one at >= 128 tokens, as on the
    card), the wrappers are counted where the model calls them, and every
    path's counts equal ``predicted_openflamingo_launches`` (the phase
    checks it and raises): the tower's kernel in each bind, the ALiBi one in
    the 32-shot prefills, the ICV in every test_icv forward."""
    import importlib

    from licv_vqa_tpu_torch.models import decoder as PD
    from licv_vqa_tpu_torch.models import layers as PL
    from licv_vqa_tpu_torch.ops import flash_alibi as FA

    iv = importlib.import_module("licv_vqa_tpu_torch.ops.icv_inject")
    for mod, name in ((PL, "vit_attention"), (FA, "flash_alibi_attention"),
                      (iv, "icv_inject")):
        monkeypatch.setattr(mod, name, _counting(getattr(mod, name)))
    monkeypatch.setattr(PD, "icv_inject", iv.icv_inject)
    monkeypatch.setattr(PD, "flash_alibi_attention", FA.flash_alibi_attention)
    monkeypatch.setattr(PL, "vit_attention_usable", lambda s, dh, device: s <= 1024)
    for mod in (PD, FA):
        monkeypatch.setattr(mod, "flash_alibi_usable", lambda cfg, s, dh, device: s >= 128)
    _stub_cuda(monkeypatch, tmp_path)
    # phase 8b has its own rehearsal (below): these are phase 8's counts,
    # and 8b's counters (zero here) join them
    monkeypatch.setattr(C, "openflamingo_serving_path",
                        lambda e: dict.fromkeys(C.engine_counters(), 0))
    got = C.openflamingo_path(torch.device("cpu"), tmp_path / "openflamingo",
                              lmm="tiny-flamingo")
    # 2 test_icv and 1 test_icl questions: a bind each, 2 tower layers, 4
    # decoder layers, 5 forwards a question
    assert got == {"vit_attention": 2 * 3, "flash_alibi_attention": 4 * 1,
                   "flash_attention_fwd": 0, "icv_inject": 4 * 2 * C.MAX_NEW,
                   "flash_attention_bidir": 0}


def test_quantized_phase_counts_match_prediction_on_tiny_idefics(tmp_path, monkeypatch):
    """Phase 6 on the CPU at tiny size, with the kernel wrappers counted
    where ``qdot`` calls them: every run's counts equal
    ``predicted_quantized_launches`` (the phase checks it and raises), run
    A's engine run (phase 4d (d)) and pooled chain (phase 4e (d)) included."""
    import importlib

    from licv_vqa_tpu_torch.models import decoder as PD
    from licv_vqa_tpu_torch.ops import int4_matmul as I4
    from licv_vqa_tpu_torch.ops import int8_matmul as I8

    iv = importlib.import_module("licv_vqa_tpu_torch.ops.icv_inject")

    for mod, name in ((I8, "int8_matmul"), (I4, "int4_matmul"), (I8, "w8a8_matmul"),
                      (iv, "icv_inject")):
        monkeypatch.setattr(mod, name, _counting(getattr(mod, name)))
    monkeypatch.setattr(PD, "icv_inject", iv.icv_inject)
    _stub_cuda(monkeypatch, tmp_path)
    for mode, opts, paths in C.QUANT_RUNS:
        got = C.quantized_path(torch.device("cpu"), tmp_path / mode, mode, opts, paths,
                               lmm="tiny-idefics")
        # run A adds phase 4d (d): the engine's 2 questions in one admission
        # and 12 decode steps (5 tokens, chunks of 4, one lagged chunk); and
        # phase 4e (d): one chain of the 2 questions, a prologue and 2 + P
        # merged forwards of two lanes each
        icv_engine = 4 * (1 + 12) if mode == "int8" else 0
        icv_pooled = 4 * (1 + 2 * (2 + C.MAX_NEW - 1)) if mode == "int8" else 0
        assert got[f"{mode}_matmul"] > 0
        assert got["icv_inject"] == 4 * 2 * C.MAX_NEW + icv_engine + icv_pooled
        assert (got["w8a8_matmul"] > 0) == (mode == "int8")


def test_flash_backward_cases_bound_the_visible_pairs(cases):
    """Phase 3's three backward shapes, right-padded, and the flagship
    student's with every row valid; bytes: q, k, v, o, do read and dq, dk,
    dv written (bf16), the f32 log-sum-exp and the int32 validity;
    operations: five products over the visible pairs (a real query sees
    the real keys up to it, a pad the pads up to it)."""
    got = {label: c for (name, label), c in cases.items() if name == "flash_attention_bwd"}
    assert sorted(got) == sorted([
        "(4,256,32,128) lengths 256,201,150,77", "(4,256,32,128) all valid",
        "(4,512,8,128) lengths 512,400,512,100", "(1,2048,32,128) lengths 1798",
    ])
    tri = lambda m: m * (m + 1) // 2  # noqa: E731
    assert got["(4,256,32,128) all valid"].ops == 5 * 2 * 128 * 32 * 4 * tri(256)
    # the kernels line reads the ragged case, phase 9's
    assert not "(4,256,32,128) all valid".startswith(C.MAIN_SHAPE["flash_attention_bwd"])
    c = got["(4,512,8,128) lengths 512,400,512,100"]
    n = 4 * 512 * 8 * 128
    assert c.bytes_moved == 8 * n * 2 + 4 * 8 * 512 * 4 + 4 * 512 * 4
    pairs = 2 * tri(512) + tri(400) + tri(112) + tri(100) + tri(412)
    assert c.ops == 5 * 2 * 128 * 8 * pairs
    # the bounds without padding: 20.1 µs (bytes) at the flagship
    # student's shape, 86.9 µs (operations) at one 2048-token row
    valid = torch.ones((1, 2048), dtype=torch.int32)
    assert C.causal_segment_pairs(valid) == tri(2048)
    ms, by = got["(4,256,32,128) lengths 256,201,150,77"].bound()
    assert by == "bytes" and ms == pytest.approx(20.06e-3, rel=1e-3)


def test_flash_backward_case_holds_its_plain_version_on_cpu(cases):
    """The case as phase 3 runs it, on CPU tensors: the wrapper takes the
    plain backward, so the comparison reads 0, and the log-sum-exp check
    passes."""
    c = cases["flash_attention_bwd", "(4,256,32,128) lengths 256,201,150,77"]
    got, want = c.kernel(), c.plain()
    assert len(got) == 3
    for a, b in zip(got, want, strict=True):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)


def test_flagship_launch_prediction_at_full_width():
    """Phase 9's prediction at the flagship (Idefics-9B, s_tea 2048, s_stu
    256, bs 4, one image a row) on the card: the teacher's 32 flash
    forwards, the student's 2·32 under inner and 3·32 − 8 under both, the
    backward at 31 layers, the ICV backward at 32, the ViT-H tower in two
    binds, and no int8 kernel (1024 and 256 rows)."""
    from licv_vqa_tpu_torch.models.idefics import IdeficsConfig

    mc = IdeficsConfig.idefics_9b()
    cuda = torch.device("cuda")
    for mode, runs in (("inner", 64), ("both", 88)):
        assert C.predicted_flagship_launches(mc, mode, 2048, 256, 4, 1, True, cuda) == {
            "flash_attention_fwd": 32 + runs, "flash_attention_bwd": 31, "icv_inject": runs,
            "icv_inject_bwd": 32, "vit_attention": 64, "int8_matmul": 0,
        }
    # under the 256-token gate the student takes no flash kernel
    got = C.predicted_flagship_launches(mc, "both", 2048, 128, 4, 1, True, cuda)
    assert got["flash_attention_fwd"] == 32 and got["flash_attention_bwd"] == 0


def test_flagship_phase_counts_match_prediction_on_tiny_idefics(monkeypatch):
    """Phase 9 on the CPU at the bench tool's tiny shape, with the flash gate
    opened for every length (under ``attention_impl=flash``) and the wrappers counted where the model and
    the Functions call them (the ICV through an autograd Function whose
    backward is the wrapper, as on the card): every mode's counts equal
    ``predicted_flagship_launches`` (the phase checks it and raises), and
    the gradient check, which takes the flash Function's plain forward and
    backward against plain attention, reads within its limit on the
    model's first layers (and is printed at full depth)."""
    import importlib

    from licv_vqa_tpu_torch.models import decoder as PD
    from licv_vqa_tpu_torch.models import layers as PL

    iv = importlib.import_module("licv_vqa_tpu_torch.ops.icv_inject")
    bwd = _counting(iv.icv_inject_backward)
    fwd = _counting(iv.icv_inject_reference)

    class Inject(torch.autograd.Function):
        @staticmethod
        def forward(ctx, h, shift):
            ctx.save_for_backward(h, shift)
            return fwd(h, shift)

        @staticmethod
        def backward(ctx, g):
            return bwd(*ctx.saved_tensors, g)

    inject = lambda h, v: Inject.apply(h, v)  # noqa: E731
    inject.launches = 0
    fwd.launches = 0
    monkeypatch.setattr(iv, "icv_inject", inject)
    monkeypatch.setattr(iv, "icv_inject_backward", bwd)
    monkeypatch.setattr(PD, "icv_inject", inject)
    for name in ("flash_attention", "flash_attention_backward"):
        monkeypatch.setattr(PL, name, _counting(getattr(PL, name)))
    monkeypatch.setattr(PL, "flash_attention_usable",
                        lambda cfg, s, dh, device: cfg.attention_impl == "flash")
    for name in ("synchronize", "reset_peak_memory_stats", "max_memory_allocated"):
        monkeypatch.setattr(torch.cuda, name, lambda *a: 0)

    def count_inject(counters):
        # the forward count lives on the wrapped plain injection
        counters["icv_inject"] = fwd
        return counters

    real = C._counters
    monkeypatch.setattr(C, "_counters", lambda: count_inject(real()))
    monkeypatch.setattr(C, "FLAGSHIP_GRAD_LAYERS", 2)  # checked on one group of two
    got = C.flagship_train_path(torch.device("cpu"), shape="tiny")
    # tiny-idefics: 4 layers in 2 groups, 3 steps a mode
    assert got["flash_attention_fwd"] == 3 * ((4 + 8) + (4 + 10))
    assert got["flash_attention_bwd"] == 3 * 3 * 2
    assert got["icv_inject"] == 3 * (8 + 10) and got["icv_inject_bwd"] == 3 * 4 * 2


def test_tools_phase_counts_match_the_tools_tallies_on_cpu(monkeypatch):
    """Phase 10 on the CPU at tiny shapes, with the wrappers counted where
    the tools call them (the pre-quantized entry point on the w8a8 kernel's
    counter, as on the card): the counts equal the tools' tallies (the
    phase checks it and raises), and every variant's check passed."""
    from licv_vqa_tpu_torch.ops import int4_unpack_probe as P
    from licv_vqa_tpu_torch.ops import int8_matmul as I8

    w8a8 = _counting(I8.w8a8_matmul)
    pre = I8.w8a8_matmul_prequantized

    def counted_pre(*a, **k):
        w8a8.launches += 1
        return pre(*a, **k)

    monkeypatch.setattr(I8, "w8a8_matmul", w8a8)
    monkeypatch.setattr(I8, "w8a8_matmul_prequantized", counted_pre)
    monkeypatch.setattr(P, "int4_unpack_probe", _counting(P.int4_unpack_probe))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    got = C.tools_path(torch.device("cpu"), w8a8_shapes=((24, 96, 40),),
                       int4_shape=(8, 256, 64), reps=2)
    # w8a8: b and a d and an e variant a tile, each checked, warmed and run
    # twice
    variants = 1 + 2 * len(I8.W8A8_TILES)
    assert got == {"w8a8_matmul": variants * 4, "int4_unpack_probe": 4 * 4}


def test_speculative_and_rice_phases_on_tiny_idefics(tmp_path, monkeypatch):
    """Phases 4b and 4c on the CPU at tiny size (tiny-idefics, the tiny CLIP
    config, a 32-row index over 16 images): the speculative run's ICV
    count equals layers x target forwards + draft layers x draft forwards
    and its tokens greedy's (the phase checks both and raises); the RICE
    phase's f32 fused-ViT count (the wrapper counted, its gate opened)
    equals the tiny tower's layers x batches, the kernel path equals the
    plain one, ties go to the lower index, the cache reloads, the text
    tower never takes the route, and the retrieved shots decode."""
    import importlib

    from licv_vqa_tpu_torch.models import decoder as PD
    from licv_vqa_tpu_torch.models import layers as PL
    from licv_vqa_tpu_torch.models.clip import ClipConfig

    iv = importlib.import_module("licv_vqa_tpu_torch.ops.icv_inject")
    monkeypatch.setattr(iv, "icv_inject", _counting(iv.icv_inject))
    monkeypatch.setattr(PD, "icv_inject", iv.icv_inject)
    vit = PL.vit_attention

    def counted_vit(q, *a, **k):
        if q.dtype == torch.float32:
            counted_vit.launches_f32 += 1
        else:
            counted_vit.launches += 1
        return vit(q, *a, **k)

    counted_vit.launches = counted_vit.launches_f32 = 0
    monkeypatch.setattr(PL, "vit_attention", counted_vit)
    monkeypatch.setattr(PL, "vit_attention_usable", lambda s, dh, device: True)
    for name, value in (("RICE_IMAGES", 16), ("RICE_INDEX_ROWS", 32), ("RICE_TEST_ROWS", 8),
                        ("RICE_TEXT_ROWS", 4)):
        monkeypatch.setattr(C, name, value)
    _stub_cuda(monkeypatch, tmp_path)
    dev = torch.device("cpu")
    e = C.eval_setup(dev, tmp_path / "eval", [], lmm="tiny-idefics")
    spec = C.speculative_path(e, dev, 0.0)
    assert spec["icv_inject"] > 4 * C.N_ICV_Q
    got = C.rice_path(e, dev, tmp_path / "rice", cfg=ClipConfig.tiny())
    # (32 + 8) images in batches of 8, 2 tower layers
    assert got == {"vit_attention_f32": 2 * 5}


@pytest.fixture()
def one_thread():
    """One intra-op thread: the tiny tensors gain nothing from more, and
    beside the suite's other workers more only spin.  Restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _count_engine_kernels(monkeypatch):
    """Phase 4d's counted wrappers, with the gates of its card run opened
    for the CPU: the fused ViT at any length, the causal flash at >= 256
    tokens."""
    import importlib

    from licv_vqa_tpu_torch.models import decoder as PD
    from licv_vqa_tpu_torch.models import layers as PL
    from licv_vqa_tpu_torch.ops import int8_matmul as I8

    iv = importlib.import_module("licv_vqa_tpu_torch.ops.icv_inject")
    for mod, name in ((PL, "vit_attention"), (PL, "flash_attention"), (iv, "icv_inject"),
                      (I8, "int8_matmul")):
        monkeypatch.setattr(mod, name, _counting(getattr(mod, name)))
    monkeypatch.setattr(PD, "icv_inject", iv.icv_inject)
    monkeypatch.setattr(PL, "vit_attention_usable", lambda s, dh, device: True)
    monkeypatch.setattr(PL, "flash_attention_usable", lambda cfg, s, dh, device: s >= 256)


def test_continuous_phase_counts_match_prediction_on_tiny_idefics(tmp_path, monkeypatch,
                                                                  one_thread):
    """Phase 4d on the CPU at tiny size (tiny-idefics; its bf16 card run's
    gates opened for the CPU: the fused ViT at any length, the causal flash
    at >= 256 tokens): in (a)-(c) the ICV, fused ViT and causal flash counts
    equal ``predicted_engine_launches`` and the tokens the static path's
    (the phase checks both and raises); the 32-shot requests of (c) take the
    flash route.  Then (d) on the int8 build of run A's options: the int8
    launches at the pool's 8 rows equal the decode steps times the per-step
    term.  Last, the static beam search's decision margin, which the beam
    near-tie rule reads where tokens differ, is a finite f32 gap."""
    _count_engine_kernels(monkeypatch)
    _stub_cuda(monkeypatch, tmp_path)
    monkeypatch.setattr(C, "CONT_ICL_SHOTS", (1, 32))  # (c) cut to one of each bucket
    dev = torch.device("cpu")
    e = C.eval_setup(dev, tmp_path / "eval", [], lmm="tiny-idefics")
    got = C.continuous_path(e)
    assert got["icv_inject"] > 0 and got["icv_inject"] % 4 == 0
    assert got["vit_attention"] > 0 and got["vit_attention"] % 2 == 0
    # (c)'s 32-shot request: one group of a bucket >= 256, 4 layers
    assert got["flash_attention_fwd"] == 4

    mode, opts, _ = C.QUANT_RUNS[0]
    e8 = C.eval_setup(dev, tmp_path / mode, opts, lmm="tiny-idefics")
    got8 = C.continuous_int8(e8, opts)
    assert got8["icv_inject"] > 0 and got8["flash_attention_fwd"] == 0

    margin = C.beam_min_margin(e, e.gen_kwargs, C.icv_prompt(e, 1), e.icv_scaled)
    assert 0.0 <= margin < float("inf")


def test_continuous_phase_tie_rules_on_an_altered_static_decode(tmp_path, monkeypatch, capsys,
                                                                one_thread):
    """Phase 4d's token rules where the static tokens differ (on tiny f32,
    engine and static agree, so the static decode of question 0 is altered
    at its second token): the greedy and beam rules read the static
    decode's gap or decision margin there and either count a near tie or
    refuse; the int8 rule refuses it (no static batch drift in f32), and
    prints the engine's logits for that token equal to the static decode's
    along the same first token."""
    _count_engine_kernels(monkeypatch)
    _stub_cuda(monkeypatch, tmp_path)
    dev = torch.device("cpu")
    real = C.decoded_tokens

    def altered(*a, **kw):
        out = real(*a, **kw)
        out[0] = out[0].clone()
        out[0][1] = (out[0][1] + 1) % 100
        return out

    e = C.eval_setup(dev, tmp_path / "eval", [], lmm="tiny-idefics")
    prompts = [C.icv_prompt(e, q) for q in (1, 2)]
    for kw in (dict(e.gen_kwargs, num_beams=1), e.gen_kwargs):
        static = real(e, kw, prompts, e.icv_scaled)
        engine = altered(e, kw, prompts, e.icv_scaled)
        try:
            if kw["num_beams"] == 1:
                n = C.near_tie_check(e, "greedy", prompts, static, engine, e.icv_scaled)
            else:
                n = C.beam_near_tie_check(e, "beam", kw, prompts, static, engine, e.icv_scaled)
        except AssertionError as err:
            assert "near tie" in str(err)
        else:
            assert n == 1
    assert "question 0 differs" in capsys.readouterr().out

    mode, opts, _ = C.QUANT_RUNS[0]
    e8 = C.eval_setup(dev, tmp_path / mode, opts, lmm="tiny-idefics")
    monkeypatch.setattr(C, "decoded_tokens", altered)
    with pytest.raises(AssertionError, match="batch drift"):
        C.continuous_int8(e8, opts)
    out = capsys.readouterr().out
    line = next(x for x in out.splitlines() if "continuous int8: question 0 differs" in x)
    # in f32 the static batch drift is nil, and the engine's logits for the
    # token are the static decode's along the same first token
    assert float(line.split("max-abs ")[1].split(",")[0]) < 1e-4
    assert float(line.split("the engine's: rel. L2 ")[1].split(";")[0]) < 1e-5


def test_pooled_phase_counts_match_prediction_on_tiny_idefics(tmp_path, monkeypatch,
                                                              one_thread):
    """Phase 4e on the CPU at tiny size (the card run's gates opened as for
    4d): in (a) and (b) the ICV, fused ViT and causal flash counts equal
    ``predicted_pooled_launches`` and the tokens the static beam's (the
    phase checks both and raises); (a)'s 8 questions run as two chains of
    4 and then as one of 8, (b)'s 32-shot question in a chain whose
    prologue and merged forwards take the flash route; (c) the engine's
    merged admission admits into an occupied pool and plain admission
    never does, both against the prediction of 4d.
    Then (d) on the int8 build of run A's options, w8a8 off: the int8
    launches (every packed projection over P·K + 64 rows off the kernel)
    equal the prediction, no w8a8."""
    _count_engine_kernels(monkeypatch)
    from licv_vqa_tpu_torch.ops import int8_matmul as I8

    monkeypatch.setattr(I8, "w8a8_matmul", _counting(I8.w8a8_matmul))
    _stub_cuda(monkeypatch, tmp_path)
    monkeypatch.setattr(C, "N_ICV_Q", 4)
    monkeypatch.setattr(C, "CONT_ICL_SHOTS", (1, 32))
    dev = torch.device("cpu")
    e = C.eval_setup(dev, tmp_path / "eval", [], lmm="tiny-idefics")
    got = C.pooled_path(e, 0.0)
    assert got["icv_inject"] > 0 and got["icv_inject"] % 4 == 0
    # (b)'s 32-shot chain: 1 question, its prologue and 1 + 4 merged forwards
    assert got["flash_attention_fwd"] == 4 * 6

    mode, opts, _ = C.QUANT_RUNS[0]
    e8 = C.eval_setup(dev, tmp_path / mode, opts, lmm="tiny-idefics")
    got8 = C.pooled_int8(e8, opts)
    assert got8["int8_matmul"] > 0 and got8["w8a8_matmul"] == 0


def test_pooled_phase_tie_rule_on_an_altered_static_decode(tmp_path, monkeypatch, capsys,
                                                           one_thread):
    """Phase 4e's token rule where the static tokens differ (on tiny f32 the
    chain and the static beam agree, so the static decode of question 0 is
    altered at its second token): the rule finds the chain's beam along the
    static answer's first token and reads its log-probabilities there,
    equal to the static decode's at bs 1 in f32 (and the static path's own
    drift at bs 2 nil), then counts the question or refuses it."""
    from licv_vqa_tpu_torch.infer.runner import icv_inference_pooled

    _count_engine_kernels(monkeypatch)
    _stub_cuda(monkeypatch, tmp_path)
    dev = torch.device("cpu")
    e = C.eval_setup(dev, tmp_path / "eval", [], lmm="tiny-idefics")
    real = C.decoded_tokens

    def altered(*a, **kw):
        out = real(*a, **kw)
        out[0] = out[0].clone()
        out[0][1] = (out[0][1] + 1) % 100
        return out

    monkeypatch.setattr(C, "decoded_tokens", altered)
    rows = e.val[1:3]
    try:
        n = C.pooled_run(e, "pooled", lambda: icv_inference_pooled(
            rows, e.bundle, e.pm, e.gen_kwargs, e.instruction, e.icv_scaled, False, 2),
            [C.row_prompt(e, r) for r in rows], e.icv_scaled, C.engine_counters())
    except AssertionError as err:
        assert "near tie" in str(err)
    else:
        assert n["icv_inject"] > 0
    out = capsys.readouterr().out
    line = next(x for x in out.splitlines() if "pooled: question 0 differs" in x)
    assert "at token 1 " in line
    assert float(line.split("max-abs ")[1].split(",")[0]) < 1e-4
    assert float(line.split("at bs 2: ")[1].split(";")[0]) < 1e-4


def test_serving_distribution_phase_on_tiny_idefics(tmp_path, monkeypatch, one_thread):
    """Phase 11 (h) on the CPU at tiny size: the references of phases 4
    and 8 (``serving_references``: beam-3 and merged greedy engine runs and
    the pooled chain, one process; ``family_serving_reference``: greedy on
    tiny-flamingo cut to 2 of its 4 layers), then two gloo ranks
    (``smoke_serving_rank``) run them again through the phase's own rank
    functions, beam, pooled and the family at dp = 2 and merged greedy at
    tp = 2, which hold the tokens, the schedule and each rank's launches to
    one process's and raise."""
    from tests.torch_dist_common import run_ranks, smoke_serving_rank

    _count_engine_kernels(monkeypatch)
    _stub_cuda(monkeypatch, tmp_path)
    e = C.eval_setup(torch.device("cpu"), tmp_path / "eval", [], lmm="tiny-idefics")
    refs = C.serving_references(e)
    assert refs["greedy"]["merged_admits"] > 0 and refs["beam"]["merged_admits"] == 0
    monkeypatch.setattr(C, "SP_FAMILY_LAYERS", 2)
    refs["family"] = C.family_serving_reference(C.eval_setup(
        torch.device("cpu"), tmp_path / "flamingo", [], lmm="tiny-flamingo"))
    torch.save(refs, tmp_path / "refs.pt")
    ranks = run_ranks(smoke_serving_rank, 2, tmp_path, str(tmp_path / "refs.pt"),
                      ["lmm=tiny-idefics", "device=cpu", "run_name=phase11", "bs=1"],
                      ["lmm=tiny-flamingo", "device=cpu", "run_name=phase11", "bs=1"], 2)
    for got in ranks:
        for run in ("beam", "pooled", "greedy", "family"):
            assert got[run]["icv_inject"] > 0 and got[run]["vit_attention"] > 0, run
    # every rank prefills every admission group and every chain its own
    for run in ("beam", "greedy", "family"):
        assert ranks[0][run] == ranks[1][run], run
    assert ranks[0]["family"]["icv_inject"] % 2 == 0  # 2 layers a forward
    # more requests than slots: later groups admit into slots the gathered
    # harvest freed
    assert len(refs["family"]["admissions"]) > 1
    # the family run again with the dp gather's token rows misplaced: the
    # rank holding a misplaced request refuses it
    assert any(got["misplaced"] and "misplaced a row" in got["misplaced"] for got in ranks), \
        [got["misplaced"] for got in ranks]

    # the beam rule where a rank's tokens differ (here one process's altered
    # at the second token): it reads the static search's margin there and
    # counts a near tie or refuses
    ref = refs["beam"]
    want = dict(ref["tokens"])
    uid = ref["requests"][0]["uid"]
    want[uid] = want[uid].copy()
    want[uid][1] = (want[uid][1] + 1) % 100
    try:
        n = C.serving_tie_check("beam", e.bundle, True, [(uid, ref["requests"][0])],
                                ref["tokens"], want, ref["gen_kwargs"], ref["icv"],
                                torch.device("cpu"))
    except AssertionError as err:
        assert "near tie" in str(err)
    else:
        assert n == 1


# the greedy token rule on made-up logits over 8 tokens (EOS 0): one
# process took 2 at token 1 (top-2 gap 0.1 over token 4), the rank 4;
# (token 0's bump: the layout's drift where the tokens agree, token 1's
# logits: the rank's there, min_new, what the rule says)
GREEDY_RULE_CASES = {
    "drift_covers_the_gap": (0.06, {4: 6.05}, 0, None),
    "drift_under_half_the_gap": (0.01, {4: 6.05}, 0, "near tie"),
    "the_whole_vector_off": (2.0, {4: 9.0}, 0, "near tie"),
    "not_the_ranks_argmax": (0.06, {}, 0, "misplaced a row"),
    "eos_suppressed_under_min_new": (0.06, {4: 6.05, 0: 6.3}, 2, None),
    "eos_not_suppressed": (0.06, {4: 6.05, 0: 6.3}, 1, "misplaced a row"),
}


@pytest.mark.parametrize("case", list(GREEDY_RULE_CASES))
def test_serving_greedy_token_rule(case):
    """(h)'s greedy rule at a rank's first differing token: its token the
    argmax of its engine's logits there (EOS suppressed under ``min_new``),
    those logits within rel. L2 ``REL_L2_TOL`` of one process's, and one
    process's top-2 gap under ``NEAR_TIE`` or twice the layout's drift
    where the tokens agree; a request another rank holds is that rank's."""
    bump, rank1, min_new, raises = GREEDY_RULE_CASES[case]
    one = [torch.full((8,), 5.0), torch.full((8,), 5.0)]
    one[0][1], one[1][2], one[1][4] = 6.0, 6.0, 5.9
    mine = [one[0].clone(), one[1].clone()]
    mine[0][3] += bump
    for k, v in rank1.items():
        mine[1][k] = v
    rec = {"logits": lambda uid, t: mine[t], "holds": lambda uid: uid == "u"}
    reqs = [("u", {"min_new": min_new}), ("v", {"min_new": 0})]
    got = {"u": np.array([1, 4, 3]), "v": np.array([1, 4])}
    want = {"u": np.array([1, 2, 3]), "v": np.array([1, 2])}  # "v": another rank's
    run = functools.partial(C.serving_tie_check, case, SimpleNamespace(eos_token_id=0), False,
                            reqs, got, want, {}, None, torch.device("cpu"), rec,
                            {"u": one, "v": one})
    if raises is None:
        assert run() == 2
    else:
        with pytest.raises(AssertionError, match=raises):
            run()


def test_world_one_engine_phase_on_tiny_idefics(tmp_path, monkeypatch, one_thread):
    """Phase 11 (a)'s engine run on the CPU at tiny size: the inference
    CLI's ``infer_engine=continuous`` beam-3 at ``infer_dp=1 infer_tp=1``
    in a launcher's world of one (gloo here), against the same CLI without
    a launcher: the phase holds the tokens, the answers and the launches
    (and, on the card, the synchronizing calls) and raises."""
    from licv_vqa_tpu_torch.models.idefics import IdeficsConfig
    from licv_vqa_tpu_torch.utils import compose

    _count_engine_kernels(monkeypatch)
    _stub_cuda(monkeypatch, tmp_path)
    C.set_env(tmp_path)
    args = ["lmm=tiny-idefics", "device=cpu", "bs=1", "test_icv=true",
            f"test_num={C.N_ICV_Q}", f"generate_kwargs.max_new_tokens={C.MAX_NEW}",
            "generate_kwargs.num_beams=3", "generate_kwargs.length_penalty=0.0",
            "data_cfg.task.datasets.max_train_size=-1"]
    C.write_training_split(tmp_path)
    cfg = compose(str(C.REPO / "config"), "inference", args + ["run_name=x"])
    g = torch.Generator().manual_seed(0)
    icv = {"icv_encoder.icv": torch.randn((1, 4, 64), generator=g) * 0.05,
           "icv_encoder.alpha": torch.full((1, 4), 0.5), "use_sigmoid": False,
           "lmm_args": {"total_layers": 4, "intervention_layer": -1,
                        "layer_format": str(cfg.lmm.layer_format)}}
    got = C.world_one_engine(cfg, args, icv, IdeficsConfig.tiny(dtype=torch.float32))
    # 2 requests, one admission group, 4 layers: the ICV in the prefill and
    # every step
    assert got["icv_inject"] > 0 and got["icv_inject"] % 4 == 0
    assert got["vit_attention"] == 2


def test_pooled_launch_prediction_at_full_width():
    """Idefics-9B, one chain of 4 one-image ``test_icv`` questions in the
    64-token bucket (P = 4, K = 3): 9 binds; the ICV at 32 layers of the
    prologue and both lanes of 8 merged forwards; under run A's int8 options
    with w8a8 off, a merged forward launches the int8 kernel for the decode
    lane's 8 cross-attention blocks (12 rows), the prefill lane's (64 rows),
    the bind's image K/V, the perceiver's latent projections and the head
    (13 rows), and none for the 7 packed projections of 32 layers (76 rows)."""
    from licv_vqa_tpu_torch.models.idefics import IdeficsConfig

    mc = IdeficsConfig.idefics_9b()
    cpu = torch.device("cpu")
    got = C.predicted_pooled_launches(mc, [(4, 64, 1, (224, 224))], True, cpu)
    assert got == {"icv_inject": 32 * (1 + 2 * 8), "vit_attention": 0,
                   "flash_attention_bidir": 0, "flash_attention_fwd": 0,
                   "flash_alibi_attention": 0}
    opts = [o for o in C.QUANT_RUNS[0][1] if o != "lmm.w8a8_prefill=true"]
    got = C.predicted_pooled_launches(mc, [(4, 64, 1, (224, 224))], False, cpu, opts)
    pro = C.predicted_quantized_launches(mc, "int8", opts, 1, 64, 1, 3, 1)["int8_matmul"]
    merged = 8 * 5 + 8 * 5 + 2 * 8 + 6 * 4 + 1
    assert got["int8_matmul"] == pro + 8 * merged and got["w8a8_matmul"] == 0


def test_idefics2_engine_and_chain_launch_prediction_at_full_width():
    """Idefics2-8B on the card: an admission group of 640x480 images (padded
    to 672x560, 48x40 patches) or a 672x672 chain's bind takes the
    bidirectional flash at the tower's 27 layers; a 32-shot bucket's
    admission the causal flash at 32 layers.  A chain of 8 questions: its
    prologue and 12 merged forwards, each a bind."""
    from types import SimpleNamespace

    from licv_vqa_tpu_torch.models.idefics2 import Idefics2Config

    mc, cuda = Idefics2Config.idefics2_8b(), torch.device("cuda")
    engine = SimpleNamespace(admissions=[(2, 128), (1, 128), (1, 2112)], steps_run=10)
    got = C.predicted_engine_launches(mc, engine, [(560, 672), (448, 672), (560, 672)], True,
                                      cuda)
    assert got == {"icv_inject": 32 * 13, "vit_attention": 0, "flash_attention_bidir": 27 * 3,
                   "flash_attention_fwd": 32, "flash_alibi_attention": 0}
    got = C.predicted_pooled_launches(mc, [(8, 128, 1, (672, 672))], True, cuda)
    assert got == {"icv_inject": 32 * (1 + 2 * 12), "vit_attention": 0,
                   "flash_attention_bidir": 27 * 13, "flash_attention_fwd": 0,
                   "flash_alibi_attention": 0}


def test_idefics2_serving_phase_counts_match_prediction_on_tiny_idefics2(tmp_path, monkeypatch,
                                                                         one_thread):
    """Phase 7b on the CPU at tiny size, with a NaViT processor (small
    variable-resolution images) in place of tiny-idefics2's fixed squares
    and the card run's gates opened (the tower's flash at any length, the
    causal one at >= 256 tokens): (a)-(d) each check their counts against
    the family's predictions (the tower's flash a bind), no mask in the
    chain's uniform images, and the token rules, and raise on a miss;
    (a)'s admissions split by mask shape; (b) merges and plain does not;
    the 32-shot request of (c) takes the causal flash."""
    import importlib

    from licv_vqa_tpu_torch.data.processor import SIGLIP_MEAN, SIGLIP_STD, ImageTransform
    from licv_vqa_tpu_torch.models import decoder as PD
    from licv_vqa_tpu_torch.models import layers as PL

    iv = importlib.import_module("licv_vqa_tpu_torch.ops.icv_inject")
    for mod, name in ((PL, "flash_attention_bidir"), (PL, "flash_attention"),
                      (PL, "vit_attention"), (iv, "icv_inject")):
        monkeypatch.setattr(mod, name, _counting(getattr(mod, name)))
    monkeypatch.setattr(PD, "icv_inject", iv.icv_inject)
    monkeypatch.setattr(PL, "flash_bidir_usable", lambda s, device: True)
    monkeypatch.setattr(PL, "flash_attention_usable", lambda cfg, s, dh, device: s >= 256)
    _stub_cuda(monkeypatch, tmp_path)
    # (width, height) padded to 112x112, 224x224 and 112x112
    monkeypatch.setattr(C, "COCO_SIZES", ((100, 50), (200, 150), (100, 100)))
    monkeypatch.setattr(C, "UNIFORM_SIZE", (112, 112))
    for name, value in (("IDEFICS2_ENGINE_Q", 4), ("MERGED_REQUESTS", 6), ("POOLED_ICV_Q", 4),
                        ("CONT_ICL_SHOTS", (1, 32))):
        monkeypatch.setattr(C, name, value)
    e = C.idefics2_setup(torch.device("cpu"), tmp_path / "idefics2", "tiny-idefics2")
    e.bundle.processor.image_transform = ImageTransform(
        28, SIGLIP_MEAN, SIGLIP_STD, variable_resolution=True, min_edge=14, max_edge=224)
    got = C.idefics2_serving_path(e)
    assert got["vit_attention"] == 0 and got["flash_attention_bidir"] % 2 == 0
    assert got["flash_attention_bidir"] > 0 and got["icv_inject"] > 0
    # (c)'s 32-shot request: one admission of a bucket >= 256, 4 layers
    assert got["flash_attention_fwd"] == 4

    # the token rules' static logits take the NaViT mask as the runner does:
    # in f32 they are the engine's own, token for token
    from licv_vqa_tpu_torch.infer.runner import icv_inference_continuous

    greedy = dict(e.gen_kwargs, num_beams=1)
    rows = C.synthetic_vqa(1, 0, seed=3, sizes=C.COCO_SIZES[1:2])
    prompt = C.row_prompt(e, rows[0])
    assert "pixel_attention_mask" in C.encoded(e.bundle, [prompt])[4]
    with C.engine_logits_recorder() as rec:
        icv_inference_continuous(rows, e.bundle, e.pm, greedy, e.instruction, e.icv_scaled,
                                 False, 2)
    static = C.decoded_tokens(e, greedy, [prompt], e.icv_scaled)[0]
    for t in range(3):
        want = C.forced_decode_logits(e, [prompt], [static[:t]], e.icv_scaled)[0]
        torch.testing.assert_close(rec["logits"](0, t), want, rtol=0, atol=1e-4)


def _count_openflamingo_kernels(monkeypatch):
    """Phase 8's counted wrappers with its card run's gates opened for the
    CPU: the fused ViT at any length, the ALiBi flash at >= 128 tokens."""
    import importlib

    from licv_vqa_tpu_torch.models import decoder as PD
    from licv_vqa_tpu_torch.models import layers as PL
    from licv_vqa_tpu_torch.ops import flash_alibi as FA

    iv = importlib.import_module("licv_vqa_tpu_torch.ops.icv_inject")
    for mod, name in ((PL, "vit_attention"), (FA, "flash_alibi_attention"),
                      (PL, "flash_attention"), (PL, "flash_attention_bidir"),
                      (iv, "icv_inject")):
        monkeypatch.setattr(mod, name, _counting(getattr(mod, name)))
    monkeypatch.setattr(PD, "icv_inject", iv.icv_inject)
    monkeypatch.setattr(PD, "flash_alibi_attention", FA.flash_alibi_attention)
    monkeypatch.setattr(PL, "vit_attention_usable", lambda s, dh, device: True)
    for mod in (PD, FA):
        monkeypatch.setattr(mod, "flash_alibi_usable", lambda cfg, s, dh, device: s >= 128)


def test_openflamingo_engine_and_chain_launch_prediction_at_full_width():
    """OpenFlamingo-9B on the card: an admission group's bind (224x224, 256
    patches and the class token) takes the fused ViT at the tower's 24
    layers; a bucket of >= 128 tokens the ALiBi flash at 32 layers, never
    the causal one (MPT has no rope).  A chain of 2 32-shot questions
    (bucket 512, 33 images): its prologue and 6 merged forwards, each a
    bind and an ALiBi prefill lane."""
    from types import SimpleNamespace

    from licv_vqa_tpu_torch.models.openflamingo import OpenFlamingoConfig

    mc, cuda = OpenFlamingoConfig.openflamingo_9b(), torch.device("cuda")
    engine = SimpleNamespace(admissions=[(2, 64), (1, 64), (1, 512)], steps_run=10)
    got = C.predicted_engine_launches(mc, engine, [(224, 224)] * 3, True, cuda)
    assert got == {"icv_inject": 32 * 13, "vit_attention": 24 * 3, "flash_attention_bidir": 0,
                   "flash_attention_fwd": 0, "flash_alibi_attention": 32}
    got = C.predicted_pooled_launches(mc, [(2, 512, 33, (224, 224))], False, cuda)
    assert got == {"icv_inject": 0, "vit_attention": 24 * 7, "flash_attention_bidir": 0,
                   "flash_attention_fwd": 0, "flash_alibi_attention": 32 * 7}


def test_quantized_openflamingo_launch_prediction_at_full_width():
    """Phase 6's OpenFlamingo-9B run a question (bs=1, beam-3, 5 new
    tokens; w8a8 prefill, the tied head bf16): the int8 kernel at the 4 beam
    steps, 32 MPT layers x 6 projections and 8 blocks x 4 (wq, wo at K =
    512, ff up and down); w8a8 at the prefill's and the bind's K/V (one
    wkv a block), 64 latents an image."""
    from licv_vqa_tpu_torch.models.openflamingo import OpenFlamingoConfig

    mc = OpenFlamingoConfig.openflamingo_9b()
    _, opts, _ = C.QUANT_FLAMINGO
    step = 32 * 6 + 8 * 4
    assert C.quant_matmuls(mc) == ([4096] * 5 + [16384], [4096, 512, 4096, 16384], 1, 8)
    for s_prompt, n_img in ((64, 1), (512, 33)):
        got = C.predicted_quantized_launches(mc, "int8", opts, 1, s_prompt, n_img, 3, 5)
        assert got == {"int8_matmul": 4 * step, "int4_matmul": 0, "w8a8_matmul": step + 8}
    got = C.predicted_quantized_launches(mc, "int4", ["lmm.quantize=int4"], 1, 64, 1, 3, 5)
    assert got == {"int8_matmul": 0, "int4_matmul": 5 * step + 8, "w8a8_matmul": 0}


def test_openflamingo_serving_phase_counts_match_prediction_on_tiny_flamingo(
        tmp_path, monkeypatch, one_thread):
    """Phase 8b on the CPU at tiny size (tiny-flamingo; the card run's gates
    opened: the fused ViT at any length, the ALiBi flash at >= 128 tokens):
    (a)-(d) each check their counts against the family's predictions, no
    sync and the token rules, and raise on a miss; (b) merges and plain
    does not; the 32-shot request of (c) and the 32-shot chain of (d) take
    the ALiBi flash (an admission; a prologue and 1 + P merged prefill
    lanes), never the causal one."""
    _count_openflamingo_kernels(monkeypatch)
    _stub_cuda(monkeypatch, tmp_path)
    for name, value in (("OPENFLAMINGO_ENGINE_Q", 4), ("MERGED_REQUESTS", 6),
                        ("POOLED_ICV_Q", 4), ("CONT_ICL_SHOTS", (1, 32))):
        monkeypatch.setattr(C, name, value)
    e = C.eval_setup(torch.device("cpu"), tmp_path / "openflamingo", [], lmm="tiny-flamingo")
    got = C.openflamingo_serving_path(e)
    assert got["vit_attention"] > 0 and got["vit_attention"] % 2 == 0
    assert got["flash_attention_fwd"] == 0 and got["flash_attention_bidir"] == 0
    assert got["icv_inject"] > 0 and got["icv_inject"] % 4 == 0
    assert got["flash_alibi_attention"] == 4 * (1 + 1 + 1 + C.MAX_NEW - 1)


def test_quantized_openflamingo_phase_counts_match_prediction_on_tiny_flamingo(
        tmp_path, monkeypatch, one_thread):
    """Phase 6's OpenFlamingo run on the CPU at tiny size (int8 weights, the
    int8 KV cache under ALiBi, w8a8 prefill), the kernel wrappers counted
    where ``qdot`` calls them: test_icv and one test_icl question, then the
    greedy engine under the int8 cache (its int8 launches at the pool's
    rows against the decode steps); each against
    ``predicted_quantized_launches`` (the phase raises on a miss)."""
    import importlib

    from licv_vqa_tpu_torch.models import decoder as PD
    from licv_vqa_tpu_torch.ops import int4_matmul as I4
    from licv_vqa_tpu_torch.ops import int8_matmul as I8

    iv = importlib.import_module("licv_vqa_tpu_torch.ops.icv_inject")
    for mod, name in ((I8, "int8_matmul"), (I4, "int4_matmul"), (I8, "w8a8_matmul"),
                      (iv, "icv_inject")):
        monkeypatch.setattr(mod, name, _counting(getattr(mod, name)))
    monkeypatch.setattr(PD, "icv_inject", iv.icv_inject)
    _stub_cuda(monkeypatch, tmp_path)
    mode, opts, paths = C.QUANT_FLAMINGO
    got = C.quantized_path(torch.device("cpu"), tmp_path / "int8_flamingo", mode, opts, paths,
                           lmm="tiny-flamingo", icl_q=C.QUANT_FLAMINGO_ICL_Q)
    assert got["int8_matmul"] > 0 and got["w8a8_matmul"] > 0 and got["int4_matmul"] == 0
    # test_icv's 2 questions, then the engine's one admission and 12 steps
    assert got["icv_inject"] == 4 * 2 * C.MAX_NEW + 4 * (1 + 12)

"""w8a8 (int8 activations x int8 weights, int32 sum): the port's plain
version against JAX's, bit for bit, on the CPU.

The port's ``quantize_act_rows`` and ``w8a8_matmul_reference`` (the plain
version of the ``w8a8_matmul`` kernel, ``csrc/w8a8_matmul.cu``) against
JAX's ``quantize_act_rows`` and ``_w8a8_dot`` as the JAX package runs them,
under ``jax.jit``: there XLA computes ``absmax / 127`` as ``absmax ·
f32(1/127)``, which eager JAX does not (the two differ by an ulp in some
rows, ``test_jit_scale_is_the_reciprocal_product``).  Inputs are seeded
numpy draws with rows whose values are exact .5 ties after scaling and an
all-zero row (the 1e-8 floor), in bf16 and f32, at M = 1, 17 and 64 and
K = 1280.  The limit is equality.  Last, the port's tuning tool on the CPU
at a tiny shape.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from licv_vqa_tpu.ops import int8_matmul as JI8
from licv_vqa_tpu.ops.quantize import quantize_array
from licv_vqa_tpu_torch.ops import int8_matmul as I8

REPO = Path(__file__).resolve().parent.parent
K, N = 1280, 384
DTYPES = {"bf16": (torch.bfloat16, jnp.bfloat16), "f32": (torch.float32, jnp.float32)}


def _acts(m: int, seed: int) -> np.ndarray:
    """Random rows of varied scale; with m > 1, row 0 is all zeros and row 1
    holds the ties ±(j + 0.5) beside 127 (so its scale is exactly 1)."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(m, K)) * rng.uniform(0.01, 30.0, size=(m, 1))).astype(np.float32)
    if m > 1:
        x[0] = 0.0
        ties = (rng.integers(0, 127, size=K) + 0.5) * rng.choice([-1.0, 1.0], size=K)
        ties[rng.integers(0, K)] = 127.0
        x[1] = ties
    return x


def _round_trip(x: np.ndarray, dtype: str) -> np.ndarray:
    """The values as the input dtype holds them, as f32 numpy."""
    return torch.from_numpy(x).to(DTYPES[dtype][0]).float().numpy()


@pytest.fixture(scope="module")
def weight():
    rng = np.random.default_rng(7)
    w = (rng.normal(size=(K, N)) * 0.02).astype(np.float32)
    leaf = quantize_array(jnp.asarray(w))
    return np.array(leaf["q"]), np.array(leaf["s"])  # writable copies for torch


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("m", [1, 17, 64])
def test_quantize_act_rows_is_bit_equal_to_jax(m, dtype):
    x = _round_trip(_acts(m, m), dtype)
    tdt, jdt = DTYPES[dtype]
    jq, js = jax.jit(JI8.quantize_act_rows)(jnp.asarray(x, jdt))
    q, s = I8.quantize_act_rows(torch.from_numpy(x).to(tdt))
    assert q.dtype == torch.int8 and s.dtype == torch.float32 and s.shape == (m, 1)
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert np.array_equal(s.numpy(), np.asarray(js))
    if m > 1:
        assert s[0].item() == np.float32(1e-8) * np.float32(1 / 127) and not q[0].any()
        # row 1 is all ties, each rounded to the even neighbour
        assert s[1].item() == 1.0
        want = np.clip(np.round(x[1]), -127, 127)  # numpy rounds half to even
        assert np.array_equal(q[1].numpy(), want.astype(np.int8))
        assert (np.abs(q[1].numpy().astype(np.float64) - x[1]) == 0.5).sum() == K - 1


@pytest.mark.parametrize("out", list(DTYPES))
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("m", [1, 17, 64])
def test_w8a8_plain_version_is_bit_equal_to_jax(weight, m, dtype, out):
    q, s = weight
    x = _round_trip(_acts(m, 100 + m), dtype)
    tdt, jdt = DTYPES[dtype]
    want = jax.jit(JI8._w8a8_dot, static_argnums=3)(
        jnp.asarray(x, jdt), jnp.asarray(q), jnp.asarray(s), DTYPES[out][1])
    got = I8.w8a8_matmul_reference(torch.from_numpy(x).to(tdt), torch.from_numpy(q),
                                   torch.from_numpy(s), DTYPES[out][0])
    assert got.dtype == DTYPES[out][0] and got.shape == (m, N)
    assert np.array_equal(got.float().numpy(), np.asarray(want, np.float32))


def test_jit_scale_is_the_reciprocal_product():
    """Why the port multiplies by f32(1/127): jitted JAX does, eager JAX
    divides, and on these rows the two differ."""
    x = jnp.asarray(_acts(256, 3))
    absmax = jnp.max(jnp.abs(x), axis=-1, keepdims=True)
    jitted = np.asarray(jax.jit(lambda a: jnp.maximum(a, 1e-8) / 127.0)(absmax))
    eager = np.asarray(jnp.maximum(absmax, 1e-8) / 127.0)
    recip = np.maximum(np.asarray(absmax), np.float32(1e-8)) * np.float32(1 / 127)
    assert np.array_equal(jitted, recip) and not np.array_equal(eager, recip)


def test_cpu_tensors_take_the_plain_versions(weight):
    """``w8a8_matmul`` (the route of ``qdot(a8=True)``) and the pre-quantized
    entry point launch nothing on the CPU and give their plain versions."""
    q, s = (torch.from_numpy(a) for a in weight)
    x = torch.from_numpy(_acts(17, 5)).to(torch.bfloat16)
    before = I8.w8a8_matmul.launches
    got = I8.w8a8_matmul(x, q, s, torch.float32)
    xq, xs = I8.quantize_act_rows(x)
    pre = I8.w8a8_matmul_prequantized(xq, xs, q, s, torch.float32)
    routed = I8.qdot(x, {"q": q, "s": s}, preferred_element_type=torch.float32, a8=True)
    assert I8.w8a8_matmul.launches == before
    want = I8.w8a8_matmul_reference(x, q, s, torch.float32)
    for t in (got, pre, routed):
        assert torch.equal(t, want)


def test_pad_rows_for_int_mm_pads_to_a_multiple_of_8_from_24():
    for m, want in ((1, 24), (17, 24), (24, 24), (25, 32), (64, 64)):
        xq = torch.ones((m, 8), dtype=torch.int8)
        p = I8.pad_rows_for_int_mm(xq)
        assert p.shape == (want, 8) and int(p.sum()) == 8 * m


def test_tuning_tool_on_cpu_prints_every_variant_and_b_equals_its_plain_version(capsys):
    spec = importlib.util.spec_from_file_location(
        "exp_w8a8_tuning_torch", REPO / "tools" / "exp_w8a8_tuning_torch.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    assert tool.main(["--device", "cpu", "--shape", "24,96,40", "--shape", "17,100,36",
                      "--reps", "1", "--wide"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("device: cpu;") and "== M=24 K=96 N=40 ==" in out
    names = ["a_bf16", "b_w8a8", "c_s8s8"] + [f"{v}_{t}" for v in ("d_kernel", "e_kernel_fused")
                                              for t in I8.W8A8_TILES]
    rows = tool.run(torch.device("cpu"), ((24, 96, 40),), I8.W8A8_TILES, (), 1)
    assert [r["name"] for r in rows] == names
    for r in rows:
        assert r["name"] in out and r["us"] > 0 and r["pct_peak"] is None
        assert r["launches"] == (0 if r["name"] in ("a_bf16", "c_s8s8") else 3)
        if r["name"] != "a_bf16":
            assert r["max_abs"] == 0.0  # on the CPU every route is the plain version
    first = I8.W8A8_TILES[0]
    assert tool.run(torch.device("cpu"), ((24, 96, 40),), (first,), ("d",), 1)[0]["name"] \
        == f"d_kernel_{first}"

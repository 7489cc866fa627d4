"""The int4 unpack-schedule probe (``licv_vqa_tpu_torch/ops/int4_unpack_probe.py``)
against the JAX tool's own Pallas kernel (``tools/exp_int4_unpack.py``),
run interpreted on the CPU at (M, K, N) = (8, 2048, 512), G = 64.

The tool's module globals ``M, K, N`` are reassigned inside the test (the
file is not edited), its operands are packed from a seeded numpy draw as
its ``main`` packs them, and ``f_full``'s correction is rebuilt here.

Tolerance: max-abs error <= ``TOL`` · max|JAX| (``chip_smoke.F32_REL_TOL``).
Both sides round the weights to bf16 at the same places, so they differ by
the f32 summation order only (about 1e-7 of the output here); a schedule
that rounds elsewhere reads about 1e-3 (``e`` against JAX's ``a``, checked
below), ten times the limit.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from licv_vqa_tpu_torch.ops import int4_unpack_probe as P

REPO = Path(__file__).resolve().parent.parent
SHAPE = (8, 2048, 512)
G = 64
TOL = 1e-4
BODIES = {"a": "body_a", "d": "body_d", "e": "body_e", "f": "body_f"}


def _tool():
    spec = importlib.util.spec_from_file_location(
        "exp_int4_unpack", REPO / "tools" / "exp_int4_unpack.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.M, mod.K, mod.N = SHAPE
    return mod


@pytest.fixture(scope="module")
def data():
    """x, q and s drawn as the tool's ``main`` draws them, and its packing."""
    m, k, n = SHAPE
    rng = np.random.default_rng(0)
    x = rng.normal(size=(m, k)).astype(np.float32)
    q = rng.integers(-7, 8, size=(k, n)).astype(np.int8)
    s = rng.random((k // G, n)).astype(np.float32) * 0.01 + 0.001
    k2 = k // 2
    qb = (q + 8).astype(np.uint8)
    qs = q.astype(np.uint8) & 0xF
    s_f = s.copy()
    s_f[k // G // 2:] /= 16.0
    packs = {
        "a": (qb[:k2] | (qb[k2:] << 4), s), "d": (qb[:k2] | (qb[k2:] << 4), s),
        "e": (qs[:k2] | (qs[k2:] << 4), s),
        "f": ((qb[:k2] & 15) | ((q[k2:].astype(np.uint8) & 0xF) << 4), s_f),
    }
    return x, q, s, packs


@pytest.fixture(scope="module")
def jax_outputs(data):
    """Each schedule's output from the tool's Pallas kernel, interpreted."""
    x, _, s, packs = data
    tool = _tool()
    m, k, n = SHAPE
    kt = k // 2 // tool.TK
    out = {}
    with pltpu.force_tpu_interpret_mode():
        for name, body in BODIES.items():
            pk, table = packs[name]
            s3 = jnp.asarray(table).reshape(2 * kt, tool.TK // G, n)
            y = np.asarray(tool.make_fn(getattr(tool, body))(jnp.asarray(x), jnp.asarray(pk), s3))
            if name == "f":  # f_full: the low plane's +8 outside the kernel
                xg = jnp.sum(jnp.asarray(x)[:, : k // 2].astype(jnp.bfloat16)
                             .reshape(m, k // 2 // G, G), axis=-1)
                s_lo = jnp.asarray(s[: k // 2 // G]).astype(jnp.bfloat16)
                y = y - 8.0 * np.asarray(jnp.dot(xg, s_lo, preferred_element_type=jnp.float32))
            out[name] = y
    return out


def _port(data, schedule):
    x, q, s, _ = data
    packed, table = P.probe_operands(torch.from_numpy(q), torch.from_numpy(s), schedule)
    return P.int4_unpack_probe_reference(torch.from_numpy(x), packed, table, G, schedule).numpy()


def _ratio(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("schedule", P.SCHEDULES)
def test_port_packs_as_the_tool_does(data, schedule):
    x, q, s, packs = data
    packed, table = P.probe_operands(torch.from_numpy(q), torch.from_numpy(s), schedule)
    pk, want = packs[schedule]
    assert packed.dtype == torch.uint8 and np.array_equal(packed.numpy(), pk)
    assert np.array_equal(table.numpy(), want)


@pytest.mark.parametrize("schedule", P.SCHEDULES)
def test_plain_schedule_matches_the_interpreted_pallas_kernel(data, jax_outputs, schedule):
    got = _port(data, schedule)
    assert got.dtype == np.float32 and got.shape == (SHAPE[0], SHAPE[2])
    assert _ratio(got, jax_outputs[schedule]) <= TOL


def test_tolerance_lies_below_the_gap_between_schedules(data, jax_outputs):
    """The port's ``e`` (weights rounded to bf16) against JAX's ``a`` (f32
    weights): the same function up to rounding, and it fails the limit."""
    gap = _ratio(_port(data, "e"), jax_outputs["a"])
    assert gap > 3 * TOL


def test_schedules_agree_with_the_f32_product(data, jax_outputs):
    """Every schedule computes x @ (q · s): within bf16 rounding of the f32
    reference, as the tool prints it."""
    x, q, s, _ = data
    m, k, n = SHAPE
    w = (q.astype(np.float32).reshape(k // G, G, n) * s.reshape(k // G, 1, n)).reshape(k, n)
    ref = x @ w
    for schedule in P.SCHEDULES:
        assert _ratio(_port(data, schedule), ref) < 2e-2, schedule


def test_cpu_tensors_take_the_plain_version(data):
    x, q, s, _ = data
    packed, table = P.probe_operands(torch.from_numpy(q), torch.from_numpy(s), "d")
    before = P.int4_unpack_probe.launches
    got = P.int4_unpack_probe(torch.from_numpy(x), packed, table, G, "d")
    assert P.int4_unpack_probe.launches == before
    assert torch.equal(got, P.int4_unpack_probe_reference(torch.from_numpy(x), packed, table,
                                                          G, "d"))


def test_unknown_schedule_raises(data):
    _, q, s, _ = data
    with pytest.raises(ValueError):
        P.probe_operands(torch.from_numpy(q), torch.from_numpy(s), "b")

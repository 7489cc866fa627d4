"""The causal flash attention's backward, plain versions on the CPU (f32).

- ``flash_attention_bwd_reference`` and ``flash_attention_lse_reference``
  against upstream JAX's ``mha_reference_bwd`` (the reference of the Pallas
  backward that ``flash_attention_tpu`` reaches), fed the ``l`` and ``m``
  of ``mha_reference_no_custom_vjp(..., save_residuals=True)`` with segment
  ids ``valid + 1`` and ``causal=True``.  That reference takes
  ``sm_scale == 1`` only, so q goes in pre-scaled and its dq comes back
  scaled once more.  Tolerance 1e-5 relative (max-abs error over max-abs
  value): both are f32 and differ by summation order.
- The plain backward against ``torch.autograd`` of
  ``flash_attention_reference`` (1e-5 relative), with right-padded and
  all-real rows; and ``flash_attention`` under autograd on CPU tensors,
  which runs the ``_FlashAttention`` Function's plain forward and plain
  backward, gives the same gradients.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas.ops.tpu import flash_attention as upstream

from licv_vqa_tpu_torch.models import layers as PL

SCALE = 0.3


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _inputs(seed, b, s, h, dh, lengths):
    """q, k, v, do (B, S, H, Dh) f32 and a right-padded (B, S) int32 valid
    (row i real up to ``lengths[i]``)."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.normal(size=(b, s, h, dh)).astype(np.float32) for _ in range(4))
    valid = np.zeros((b, s), np.int32)
    for i, n in enumerate(lengths):
        valid[i, :n] = 1
    return q, k, v, do, valid


CASES = {
    "right_padded": (2, 24, 3, 16, (17, 5)),
    "all_real": (2, 24, 3, 16, (24, 24)),
    "one_real_token": (1, 9, 2, 8, (1,)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_backward_and_lse_match_upstream_reference(case):
    b, s, h, dh, lengths = CASES[case]
    q, k, v, do, valid = _inputs(0, b, s, h, dh, lengths)
    bhsd = lambda x: jnp.asarray(x.transpose(0, 2, 1, 3))  # noqa: E731
    seg = upstream.SegmentIds(q=jnp.asarray(valid + 1), kv=jnp.asarray(valid + 1))
    qs = bhsd(q * SCALE)
    o, l, m = upstream.mha_reference_no_custom_vjp(
        qs, bhsd(k), bhsd(v), None, seg, causal=True, save_residuals=True)
    dq, dk, dv, _ = upstream.mha_reference_bwd(
        qs, bhsd(k), bhsd(v), None, seg, o, l, m, bhsd(do), causal=True)

    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    tvalid = torch.from_numpy(valid)
    lse = PL.flash_attention_lse_reference(tq, tk, tvalid, SCALE)
    assert _rel(lse.numpy(), np.asarray(m) + np.log(np.asarray(l))) <= 1e-5
    to = torch.from_numpy(np.asarray(o).transpose(0, 2, 1, 3).copy())
    got = PL.flash_attention_bwd_reference(tq, tk, tv, to, lse, tdo, tvalid, SCALE)
    want = (SCALE * np.asarray(dq), np.asarray(dk), np.asarray(dv))
    for name, g, w in zip(("dq", "dk", "dv"), got, want, strict=True):
        assert _rel(g.numpy(), w.transpose(0, 2, 1, 3)) <= 1e-5, name


def _autograd_reference(q, k, v, do, valid):
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = PL.flash_attention_reference(*leaves, torch.from_numpy(valid), SCALE)
    return out.detach(), torch.autograd.grad(out, leaves, torch.from_numpy(do))


@pytest.mark.parametrize("case", list(CASES))
def test_plain_backward_matches_autograd_of_the_plain_forward(case):
    b, s, h, dh, lengths = CASES[case]
    q, k, v, do, valid = _inputs(1, b, s, h, dh, lengths)
    out, want = _autograd_reference(q, k, v, do, valid)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    tvalid = torch.from_numpy(valid)
    lse = PL.flash_attention_lse_reference(tq, tk, tvalid, SCALE)
    got = PL.flash_attention_bwd_reference(tq, tk, tv, out, lse, tdo, tvalid, SCALE)
    for name, g, w in zip(("dq", "dk", "dv"), got, want, strict=True):
        assert _rel(g.numpy(), w.numpy()) <= 1e-5, name


@pytest.mark.parametrize("case", list(CASES))
def test_flash_attention_function_cpu_route_gives_the_plain_gradients(case):
    b, s, h, dh, lengths = CASES[case]
    q, k, v, do, valid = _inputs(2, b, s, h, dh, lengths)
    _, want = _autograd_reference(q, k, v, do, valid)
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = PL.flash_attention(*leaves, torch.from_numpy(valid), SCALE)
    assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"
    got = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    for name, g, w in zip(("dq", "dk", "dv"), got, want, strict=True):
        assert _rel(g.numpy(), w.numpy()) <= 1e-5, name
    # a .sum() hands the cotangent in with zero strides
    g_sum = torch.autograd.grad(PL.flash_attention(*leaves, torch.from_numpy(valid), SCALE).sum(),
                                leaves)
    ones = np.ones_like(do)
    want_sum = _autograd_reference(q, k, v, ones, valid)[1]
    for g, w in zip(g_sum, want_sum, strict=True):
        assert _rel(g.numpy(), w.numpy()) <= 1e-5


def test_flash_attention_without_a_gradient_takes_the_plain_forward():
    q, k, v, _, valid = _inputs(3, 1, 12, 2, 8, (9,))
    args = [torch.from_numpy(x) for x in (q, k, v)] + [torch.from_numpy(valid)]
    out = PL.flash_attention(*args, SCALE)
    assert out.grad_fn is None
    torch.testing.assert_close(out, PL.flash_attention_reference(*args, SCALE), rtol=0, atol=0)

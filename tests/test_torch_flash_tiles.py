"""The Hopper flash forward's tile arithmetic (``csrc/flash_fwd_sm90.cuh``)
emulated in plain torch on the CPU, held to the unchanged plain versions.

The emulation follows the kernel's schedule: 128-query tiles, 128-key tiles
up to the causal bound, the per-tile online softmax in base 2 (with no bias
the max of the raw q·k and the scale times log2(e) folded into the
exponent; ALiBi's scores scaled and biased first), the ``m = -inf``
guard (the exponent subtracts 0 while a row has seen no visible key), the
row sums of the f32 probabilities, P rounded to bf16 before P·V (f32 accumulation), 1/l at
the end (0 where l = 0) and the log-sum-exp ``(m + log2 l)·ln 2``.  It
lives here only: no code path of the package runs it.

Tolerances: with P kept in f32 and f32 inputs the emulation is the plain
function up to summation order and exp2 against exp (1e-5 of max|plain|);
with P rounded, against the plain version on bf16 inputs, phase 3's bf16
limit (2e-2 of max|plain|).  The log-sum-exp to 1e-5 of max|plain|.
"""

import math

import numpy as np
import pytest
import torch

from licv_vqa_tpu_torch.models import layers as L
from licv_vqa_tpu_torch.ops import flash_alibi as FA

BLOCK_M = BLOCK_N = 128
REL_TOL = 2e-2
TIGHT_TOL = 1e-5
SCALE = 128 ** -0.5
LOG2E = 1.0 / math.log(2.0)


def emulate(q, k, v, valid, scale, rule, slopes=None, round_p=True, guard=True):
    """``(out (B, S, H, Dh) f32, lse (B, H, S) f32)`` of the kernel's
    schedule; ``rule`` is "segment" or "valid_key", ``slopes`` the ALiBi
    slopes (None: no bias)."""
    b, s, h, _ = q.shape
    qf, kf, vf = (x.float().transpose(1, 2) for x in (q, k, v))  # (B, H, S, Dh)
    valid = valid.to(torch.int32)
    out = torch.zeros_like(qf)
    lse = torch.zeros((b, h, s))
    for m0 in range(0, s, BLOCK_M):
        rows = torch.arange(m0, min(m0 + BLOCK_M, s))
        m = torch.full((b, h, len(rows)), -math.inf)
        l = torch.zeros((b, h, len(rows)))
        o = torch.zeros((b, h, len(rows), qf.shape[-1]))
        kv_end = min(s, m0 + BLOCK_M)  # the causal bound
        for n0 in range(0, kv_end, BLOCK_N):
            keys = torch.arange(n0, min(n0 + BLOCK_N, s))
            # with no bias the raw q.k, its scale folded into the exponent
            x = qf[:, :, rows] @ kf[:, :, keys].transpose(-1, -2)
            to_log2 = scale * LOG2E
            if slopes is not None:
                x = x * to_log2 + (slopes.float() * LOG2E)[None, :, None, None] * (
                    keys[None, :] - rows[:, None]).float()
                to_log2 = 1.0
            vk, vq = valid[:, keys][:, None, :], valid[:, rows][:, :, None]
            same = vk != 0 if rule == "valid_key" else vk == vq
            visible = (keys[None, :] <= rows[:, None]) & same  # (B, R, N)
            x = x.masked_fill(~visible[:, None], -math.inf)
            m_new = torch.maximum(m, x.amax(-1) * to_log2)
            m_use = torch.where(m_new == -math.inf, 0.0, m_new) if guard else m_new
            alpha = torch.exp2(m - m_use)
            p = torch.exp2(x * to_log2 - m_use[..., None])
            l = l * alpha + p.sum(-1)
            pv = p.to(torch.bfloat16).float() if round_p else p
            o = o * alpha[..., None] + pv @ vf[:, :, keys]
            m = m_new
        out[:, :, rows] = o * torch.where(l > 0, 1.0 / l, 0.0)[..., None]
        lse[:, :, rows] = (m + torch.log2(l)) * math.log(2.0)
    return out.transpose(1, 2), lse


# (name, B=2 rows' validity at S = 300: a ragged tail past two 128-key tiles)
def _valid(kind: str) -> torch.Tensor:
    valid = torch.ones((2, 300), dtype=torch.int32)
    if kind == "ragged":
        valid[1, :37] = 0
    elif kind == "left_tile":  # a whole 128-key tile of left pad, and then some
        valid[0, :150] = 0
        valid[1, :128] = 0
    elif kind == "right":  # right-pad rows: ALiBi's attend the real keys
        valid[0, 239:] = 0
        valid[1, 100:] = 0
    return valid


KINDS = ("ragged", "left_tile", "right")


def _inputs(seed: int, dtype=torch.bfloat16):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((2, 300, 2, 128), dtype=np.float32)).to(dtype)
            for _ in range(3)]


def _assert_close(got, want, tol):
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * want.float().abs().max().item(), err


@pytest.mark.parametrize("kind", KINDS)
def test_segment_rule_tiles_match_plain(kind):
    """Every row (the segment rule lets each row see itself): exact up to
    summation order with P in f32, and within the bf16 limit with P
    rounded as the kernel rounds it."""
    valid = _valid(kind)
    q, k, v = _inputs(1)
    f32 = [x.float() for x in (q, k, v)]
    got, _ = emulate(*f32, valid, SCALE, "segment", round_p=False)
    _assert_close(got, L.flash_attention_reference(*f32, valid, SCALE), TIGHT_TOL)
    got, _ = emulate(q, k, v, valid, SCALE, "segment")
    assert torch.isfinite(got).all()
    _assert_close(got, L.flash_attention_reference(q, k, v, valid, SCALE), REL_TOL)


@pytest.mark.parametrize("kind", KINDS)
def test_segment_rule_lse_matches_plain(kind):
    valid = _valid(kind)
    q, k, _ = _inputs(2)
    _, lse = emulate(q, k, k, valid, SCALE, "segment")
    want = L.flash_attention_lse_reference(q, k, valid, SCALE)
    assert torch.isfinite(lse).all()
    _assert_close(lse, want, TIGHT_TOL)


@pytest.mark.parametrize("kind", KINDS)
def test_alibi_tiles_match_plain_on_rows_with_a_visible_key(kind):
    """The rows with a visible key (the function's); a row with none
    writes 0 (the plain version's uniform average there is garbage by
    contract)."""
    valid = _valid(kind)
    q, k, v = _inputs(3)
    slopes = L.alibi_slopes(2)
    rows = torch.cumsum(valid, dim=1) > 0
    f32 = [x.float() for x in (q, k, v)]
    got, _ = emulate(*f32, valid, SCALE, "valid_key", slopes, round_p=False)
    _assert_close(got[rows], FA.flash_alibi_reference(*f32, valid, slopes, SCALE)[rows],
                  TIGHT_TOL)
    got, _ = emulate(q, k, v, valid, SCALE, "valid_key", slopes)
    assert torch.isfinite(got).all()
    _assert_close(got[rows], FA.flash_alibi_reference(q, k, v, valid, slopes, SCALE)[rows],
                  REL_TOL)
    assert (got[~rows] == 0).all()


def test_alibi_right_pad_row_attends_the_real_keys():
    """A right-pad query under ALiBi sees every earlier real key and no
    pad: its output is the plain version's, and differs from the segment
    rule's (which would have it attend the pads)."""
    valid = _valid("right")
    q, k, v = (x.float() for x in _inputs(4))
    slopes = L.alibi_slopes(2)
    got, _ = emulate(q, k, v, valid, SCALE, "valid_key", slopes, round_p=False)
    want = FA.flash_alibi_reference(q, k, v, valid, slopes, SCALE)
    _assert_close(got[1, 250], want[1, 250], TIGHT_TOL)
    seg, _ = emulate(q, k, v, valid, SCALE, "segment", slopes, round_p=False)
    assert (seg[1, 250] - want[1, 250]).abs().max() > 0.1


def test_whole_tile_of_left_pad_needs_the_guard():
    """Under ALiBi the first key tile of a row with 150 left pads is all
    invalid: without the m = -inf guard its rows compute -inf - -inf and
    turn NaN; with it they write 0."""
    valid = _valid("left_tile")
    q, k, v = _inputs(5)
    slopes = L.alibi_slopes(2)
    bad, _ = emulate(q, k, v, valid, SCALE, "valid_key", slopes, guard=False)
    assert torch.isnan(bad[0, :128]).all()
    good, _ = emulate(q, k, v, valid, SCALE, "valid_key", slopes)
    assert (good[0, :150] == 0).all() and torch.isfinite(good).all()

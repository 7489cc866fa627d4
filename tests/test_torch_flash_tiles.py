"""The Hopper flash kernels' tile arithmetic emulated in plain torch on the
CPU, held to the unchanged plain versions: the causal forward
(``csrc/flash_fwd_sm90.cuh``), the towers' bidirectional forward
(``csrc/flash_attn_bidir.cu``), the causal backward
(``csrc/flash_attn_bwd.cu``) and the CLIP towers' fused attention
(``csrc/vit_attention.cu``: ``emulate_vit``, its one-pass and two-pass
schedules, the rounding point and the tail's term; tolerances by its tests).

The emulation follows the kernel's schedule: 128-query tiles, 128-key tiles
up to the causal bound, the per-tile online softmax in base 2 (with no bias
the max of the raw q·k and the scale times log2(e) folded into the
exponent; ALiBi's scores scaled and biased first), the ``m = -inf``
guard (the exponent subtracts 0 while a row has seen no visible key), the
row sums of the f32 probabilities, P rounded to bf16 before P·V (f32 accumulation), 1/l at
the end (0 where l = 0) and the log-sum-exp ``(m + log2 l)·ln 2``.  The
bidirectional forward's (``emulate_bidir``): the head dim 72 zero-padded to
80 in Q·Kᵀ (TMA's zeros past the map's dims), every key tile of the whole
sequence, the ones no row of the block can see skipped, the segment rule
with the keys past S at a validity no row has, and ``valid=None`` as every
key real.  The backward's (``emulate_bwd``): 64-key tiles up to the causal
bound for 128-query blocks (dQ), 64-query tiles from the diagonal for
128-key blocks (dK, dV), the log-sum-exp in base 2, D from the bf16 output,
and P and dS rounded to bf16 as the gradient products' A operands.  These
emulations live here only: no code path of the package runs them.

Tolerances: with P (and dS) kept in f32 and f32 inputs the emulation is
the plain function up to summation order and exp2 against exp (1e-5 of
max|plain|); with them rounded, against the plain version on bf16 inputs,
phase 3's bf16 limit (2e-2 of max|plain|).  The log-sum-exp to 1e-5 of
max|plain|.
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


# ------------------------------------------------ the bidirectional forward


def _key_validity(valid, b: int, s: int, tail: int = -2) -> torch.Tensor:
    """(B, whole tiles) int32: 1 real, 0 invalid, ``tail`` past S."""
    kval = torch.full((b, -(-s // BLOCK_N) * BLOCK_N), tail, dtype=torch.int32)
    kval[:, :s] = 1 if valid is None else (valid != 0).to(torch.int32)
    return kval


def _tile_kinds(kval: torch.Tensor) -> torch.Tensor:
    """(B, n_tiles): 1 if the 128-key tile holds a real key, 2 if an
    invalid one (both: 3).  A block skips the key tiles that share no kind
    with its own query tile."""
    tiles = kval.view(kval.shape[0], -1, BLOCK_N)
    return (tiles == 1).any(-1).int() | 2 * (tiles == 0).any(-1).int()


def emulate_bidir(q, k, v, valid, scale, round_p=True, tail=-2):
    """``out (B, S, H, 72) f32`` of ``csrc/flash_attn_bidir.cu``'s schedule;
    ``tail`` is the validity the keys past S take (the kernel's: -2, none)."""
    b, s, h, dh = q.shape
    n_tiles = -(-s // BLOCK_N)
    # Q·Kᵀ over 80 dims (dims 72-79 zeros); K/V rows past S zeros, as TMA reads them
    qf = torch.nn.functional.pad(q.float(), (0, 80 - dh)).transpose(1, 2)
    kf = torch.zeros((b, h, n_tiles * BLOCK_N, 80))
    kf[:, :, :s, :dh] = k.float().transpose(1, 2)
    vf = torch.zeros((b, h, n_tiles * BLOCK_N, dh))
    vf[:, :, :s] = v.float().transpose(1, 2)
    kval = _key_validity(valid, b, s, tail)
    flags = _tile_kinds(kval)
    out = torch.zeros((b, h, s, dh))
    for m0 in range(0, s, BLOCK_M):
        rows = torch.arange(m0, min(m0 + BLOCK_M, s))
        m = torch.full((b, h, len(rows)), -math.inf)
        l = torch.zeros((b, h, len(rows)))
        o = torch.zeros((b, h, len(rows), dh))
        for t in range(n_tiles):
            seen = (flags[:, t] & flags[:, m0 // BLOCK_M]) != 0  # (B,): else skipped
            keys = torch.arange(t * BLOCK_N, (t + 1) * BLOCK_N)
            x = qf[:, :, rows] @ kf[:, :, keys].transpose(-1, -2)
            visible = kval[:, keys][:, None, :] == kval[:, rows][:, :, None]
            x = x.masked_fill(~visible[:, None], -math.inf)
            m_new = torch.maximum(m, x.amax(-1) * scale * LOG2E)
            m_use = torch.where(m_new == -math.inf, 0.0, m_new)
            alpha = torch.exp2(m - m_use)
            p = torch.exp2(x * scale * LOG2E - m_use[..., None])
            pv = p.to(torch.bfloat16).float() if round_p else p
            keep = seen[:, None, None]
            l = torch.where(keep, l * alpha + p.sum(-1), l)
            o = torch.where(keep[..., None], o * alpha[..., None] + pv @ vf[:, :, keys], o)
            m = torch.where(keep, m_new, m)
        out[:, :, rows] = o * torch.where(l > 0, 1.0 / l, 0.0)[..., None]
    return out.transpose(1, 2)


def _navit(grids, gw: int, s: int) -> torch.Tensor:
    """(B, S) int32: image i fills the top-left rows x cols of its padded
    (S / gw) x gw patch grid, so its pads interleave with its patches."""
    valid = torch.zeros((len(grids), s), dtype=torch.int32)
    for i, (r, c) in enumerate(grids):
        grid = torch.zeros((s // gw, gw), dtype=torch.int32)
        grid[:r, :c] = 1
        valid[i] = grid.reshape(-1)
    return valid


# S = 300 (two 128-key tiles and a ragged tail of 44): 15x20 grids, one with
# 3 pad columns a row and 2 pad rows, one with real rows 0-9 only, whose
# third key tile then holds pads alone (the first query tile skips it)
BIDIR_KINDS = {"interleaved": ((13, 17), (10, 20)), "all_valid": None}


def _bidir_inputs(seed: int, dtype=torch.bfloat16):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((2, 300, 2, 72), dtype=np.float32)).to(dtype)
            for _ in range(3)]


@pytest.mark.parametrize("kind", list(BIDIR_KINDS))
def test_bidir_tiles_match_plain(kind):
    """Every row, the invalid ones too: exact up to summation order with P
    in f32, within the bf16 limit with P rounded as the kernel rounds it."""
    grids = BIDIR_KINDS[kind]
    valid = None if grids is None else _navit(grids, 20, 300)
    q, k, v = _bidir_inputs(6)
    scale = 72 ** -0.5
    f32 = [x.float() for x in (q, k, v)]
    got = emulate_bidir(*f32, valid, scale, round_p=False)
    _assert_close(got, L.flash_attention_bidir_reference(*f32, valid, scale), TIGHT_TOL)
    got = emulate_bidir(q, k, v, valid, scale)
    assert torch.isfinite(got).all()
    _assert_close(got, L.flash_attention_bidir_reference(q, k, v, valid, scale), REL_TOL)


def test_bidir_skips_tiles_only_where_pads_are_whole_rows():
    """A grid padded by whole rows (the second image: real rows 0-9) has a
    query tile of real rows only and a key tile of pads only, which skip
    each other; pad columns (the first image, and phase 7's 34x45 of 40x48)
    put a pad in every tile, and nothing is skipped."""
    def skipped(kinds):
        return sum(int(kinds[i] & kinds[j] == 0) for i in range(len(kinds))
                   for j in range(len(kinds)))

    kinds = _tile_kinds(_key_validity(_navit(BIDIR_KINDS["interleaved"], 20, 300), 2, 300))
    assert skipped(kinds[0]) == 0 and skipped(kinds[1]) == 2
    phase7 = _tile_kinds(_key_validity(_navit(((34, 45),), 48, 1920), 1, 1920))
    assert skipped(phase7[0]) == 0


def test_bidir_tail_needs_a_validity_of_its_own():
    """Keys past S read as TMA's zero rows.  At validity 0 (an invalid
    patch's) the invalid rows would attend them, and their outputs move
    far past the bf16 limit; the real rows stay put."""
    valid = _navit(BIDIR_KINDS["interleaved"], 20, 300)
    q, k, v = (x.float() for x in _bidir_inputs(7))
    scale = 72 ** -0.5
    want = L.flash_attention_bidir_reference(q, k, v, valid, scale)
    bad = emulate_bidir(q, k, v, valid, scale, round_p=False, tail=0)
    pad_rows, real_rows = valid == 0, valid == 1
    assert (bad[pad_rows] - want[pad_rows]).abs().max() > REL_TOL * want.abs().max()
    _assert_close(bad[real_rows], want[real_rows], TIGHT_TOL)


# ------------------------------------------------------- the backward

BWD_ROWS = 64  # a tile's rows; blocks of two tiles


def emulate_bwd(q, k, v, o, lse, do, valid, scale, round_ops=True, to_log2=LOG2E):
    """``(dq, dk, dv)`` f32 of ``csrc/flash_attn_bwd.cu``'s schedule;
    ``to_log2`` is the factor that takes the log-sum-exp to base 2."""
    b, s, h, _ = q.shape
    qf, kf, vf, of, dof = (x.float().transpose(1, 2) for x in (q, k, v, o, do))
    valid = valid.to(torch.int32)
    lse2 = lse.float() * to_log2
    d = (dof * of).sum(-1)  # D from the forward's (bf16) output
    rnd = (lambda x: x.to(torch.bfloat16).float()) if round_ops else (lambda x: x)

    def p_ds(qs, ks):
        """P and dS (f32) of the queries qs against the keys ks."""
        x = qf[:, :, qs] @ kf[:, :, ks].transpose(-1, -2)
        seen = (ks[None, :] <= qs[:, None]) & (valid[:, ks][:, None, :] == valid[:, qs][:, :, None])
        p = torch.where(seen[:, None], torch.exp2(x * scale * LOG2E - lse2[:, :, qs, None]), 0.0)
        dp = dof[:, :, qs] @ vf[:, :, ks].transpose(-1, -2)
        return p, p * (dp - d[:, :, qs, None])

    dq, dk, dv = (torch.zeros_like(qf) for _ in range(3))
    for m0 in range(0, s, 2 * BWD_ROWS):  # the dQ kernel's blocks
        qs = torch.arange(m0, min(m0 + 2 * BWD_ROWS, s))
        for n0 in range(0, min(s, m0 + 2 * BWD_ROWS), BWD_ROWS):  # up to the causal bound
            ks = torch.arange(n0, min(n0 + BWD_ROWS, s))
            _, ds = p_ds(qs, ks)
            dq[:, :, qs] += rnd(ds) @ kf[:, :, ks]
    for n0 in range(0, s, 2 * BWD_ROWS):  # the dK/dV kernel's blocks
        ks = torch.arange(n0, min(n0 + 2 * BWD_ROWS, s))
        for q0 in range(n0, s, BWD_ROWS):  # from the diagonal
            qs = torch.arange(q0, min(q0 + BWD_ROWS, s))
            p, ds = p_ds(qs, ks)
            dv[:, :, ks] += rnd(p).transpose(-1, -2) @ dof[:, :, qs]
            dk[:, :, ks] += rnd(ds).transpose(-1, -2) @ qf[:, :, qs]
    return tuple(x.transpose(1, 2) for x in (scale * dq, scale * dk, dv))


# right-padded rows at S = 300 (a ragged tail); "pad_tile": rows of 100
# and 50 real tokens, so whole 64-row tiles and a 128-row block hold pads only
BWD_KINDS = {"ragged": (300, 180), "pad_tile": (100, 50)}


def _bwd_case(kind: str, seed: int, dtype):
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((2, 300, 2, 128), dtype=np.float32))
                   .to(dtype) for _ in range(4))
    valid = (torch.arange(300)[None] < torch.tensor(BWD_KINDS[kind])[:, None]).to(torch.int32)
    o = L.flash_attention_reference(q, k, v, valid, SCALE)
    lse = L.flash_attention_lse_reference(q, k, valid, SCALE)
    return q, k, v, o, lse, do, valid


@pytest.mark.parametrize("kind", list(BWD_KINDS))
def test_backward_tiles_match_plain(kind):
    """dq, dk and dv on every row: exact up to summation order with P and
    dS in f32, within the bf16 limit with them rounded as the kernels
    round them, against the plain backward on the same inputs."""
    case = _bwd_case(kind, 8, torch.float32)
    got = emulate_bwd(*case, SCALE, round_ops=False)
    for a, w in zip(got, L.flash_attention_bwd_reference(*case, SCALE), strict=True):
        _assert_close(a, w, TIGHT_TOL)
    case = _bwd_case(kind, 8, torch.bfloat16)
    got = emulate_bwd(*case, SCALE)
    for a, w in zip(got, L.flash_attention_bwd_reference(*case, SCALE), strict=True):
        assert torch.isfinite(a).all()
        _assert_close(a, w, REL_TOL)


def test_backward_needs_the_lse_in_base_2():
    """The natural-log log-sum-exp taken as base 2 scales every P by
    exp2(lse·(log2 e − 1)): the gradients move far past the bf16 limit."""
    case = _bwd_case("ragged", 9, torch.float32)
    want = L.flash_attention_bwd_reference(*case, SCALE)
    bad = emulate_bwd(*case, SCALE, round_ops=False, to_log2=1.0)
    assert all((a - w).abs().max() > 0.1 * w.abs().max()
               for a, w in zip(bad, want, strict=True))


# ------------------------------------------------- the fused ViT attention

ONE_PASS_KEYS = 264  # the one-pass score row: m64n256k16 + m64n8k16
VIT_TILE = 128  # the two-pass key tiles
FLT_MAX = torch.finfo(torch.float32).max
# the mean error of the emulation against the plain version, over the plain
# output's mean magnitude: rounding where the plain version rounds differs
# from it only where an exp2-against-exp difference flips a bf16 rounding
MEAN_TOL = 1e-5


def emulate_vit(q, k, v, valid, scale, schedule, round_p=True, normalise_first=True,
                tail=-math.inf):
    """``out (B, S, H, Dh) f32`` of ``csrc/vit_attention.cu``'s schedules:
    ``"one"`` (S <= 264: the whole row's scores at once, keys padded to 264)
    or ``"two"`` (128-key tiles: the rows' max and sum online, then the
    scores again).  x = q·k · scale·log2(e) + the key's term (0 counts,
    -FLT_MAX masked, ``tail`` past S: the kernel's -inf; K/V rows past S are
    TMA's zeros); p = exp2(x - max); P normalised and then rounded to bf16
    before P·V (``normalise_first=False``: rounded, then the output divided
    by l)."""
    b, s, h, dh = q.shape
    nk = ONE_PASS_KEYS if schedule == "one" else -(-s // VIT_TILE) * VIT_TILE
    assert nk >= s
    qf = q.float().transpose(1, 2)
    kf = torch.zeros((b, h, nk, dh))
    kf[:, :, :s] = k.float().transpose(1, 2)
    vf = torch.zeros((b, h, nk, dh))
    vf[:, :, :s] = v.float().transpose(1, 2)
    term = torch.full((b, nk), tail)
    term[:, :s] = 0.0 if valid is None else torch.where(valid.bool(), 0.0, -FLT_MAX)
    x = (qf @ kf.transpose(-1, -2)) * (scale * LOG2E) + term[:, None, None, :]
    if schedule == "one":
        m = x.amax(-1, keepdim=True)
        l = torch.exp2(x - m).sum(-1, keepdim=True)
    else:
        m = torch.full(x.shape[:-1] + (1,), -math.inf)
        l = torch.zeros_like(m)
        for t0 in range(0, nk, VIT_TILE):
            xt = x[..., t0:t0 + VIT_TILE]
            m_new = torch.maximum(m, xt.amax(-1, keepdim=True))
            l = l * torch.exp2(m - m_new) + torch.exp2(xt - m_new).sum(-1, keepdim=True)
            m = m_new
    p = torch.exp2(x - m)
    if normalise_first:
        p = p * (1.0 / l)
    if round_p:
        p = p.to(torch.bfloat16).float()
    o = p @ vf
    if not normalise_first:
        o = o * (1.0 / l)
    return o.transpose(1, 2)


def _vit_case(seed: int, s: int, dh: int, masked: bool, dtype=torch.bfloat16):
    """(q, k, v, valid) at (2, S, 2, Dh): with ``masked`` a random key mask
    and a second row with no valid key (the uniform softmax)."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, s, 2, dh), dtype=np.float32)).to(dtype)
               for _ in range(3))
    valid = None
    if masked:
        valid = torch.from_numpy(rng.random((2, s)) > 0.3)
        valid[1] = False
    return q, k, v, valid


def _mean_ratio(got, want) -> float:
    return ((got.float() - want.float()).abs().mean() / want.float().abs().mean()).item()


VIT_SCHEDULES = (("one", 257), ("two", 257), ("two", 1024))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dh", [64, 72, 80])
@pytest.mark.parametrize("schedule,s", VIT_SCHEDULES)
def test_vit_schedules_match_plain(schedule, s, dh, masked):
    """Every row (the all-masked one's uniform softmax too): exact up to
    summation order with P in f32; with P normalised and then rounded, as
    the kernel does, equal to the plain version's bf16 output but where a
    bf16 rounding of P flips (mean error under ``MEAN_TOL``)."""
    scale = dh ** -0.5
    q, k, v, valid = _vit_case(20 + dh, s, dh, masked, torch.float32)
    got = emulate_vit(q, k, v, valid, scale, schedule, round_p=False)
    _assert_close(got, L.vit_attention_reference(q, k, v, valid, scale), TIGHT_TOL)
    q, k, v, valid = _vit_case(20 + dh, s, dh, masked)
    got = emulate_vit(q, k, v, valid, scale, schedule).to(torch.bfloat16)
    want = L.vit_attention_reference(q, k, v, valid, scale)
    assert torch.isfinite(got).all()
    _assert_close(got, want, REL_TOL)
    assert _mean_ratio(got, want) <= MEAN_TOL
    if masked:  # no valid key: the mean of V over the S keys
        _assert_close(got[1], v[1].float().mean(0, keepdim=True).expand_as(got[1]), REL_TOL)


@pytest.mark.parametrize("schedule,s", VIT_SCHEDULES)
def test_vit_rounding_point_is_after_normalising(schedule, s):
    """Rounding P to bf16 before it is normalised (the flash kernels'
    rounding point, the output divided by l after P·V) stays inside the
    2e-2 limit phase 3 holds the kernel to, but moves the mean error two
    orders past the emulation's tolerance: this is the check that sees the
    rounding point."""
    q, k, v, valid = _vit_case(31, s, 80, True)
    want = L.vit_attention_reference(q, k, v, valid, 80 ** -0.5)
    bad = emulate_vit(q, k, v, valid, 80 ** -0.5, schedule, normalise_first=False)
    bad = bad.to(torch.bfloat16)
    _assert_close(bad, want, REL_TOL)
    assert _mean_ratio(bad, want) > 10 * MEAN_TOL


@pytest.mark.parametrize("schedule", ["one", "two"])
def test_vit_tail_keys_need_a_term_of_their_own(schedule):
    """Keys past S read as TMA's zero rows, whose score is 0.  Counted as
    keys (term 0 in place of -inf) they take their share of every row's
    softmax (7 of 264 in one pass at S = 257, 127 of 384 in two), and the
    outputs move far past the bf16 limit; the all-masked row's uniform
    average would take them in too."""
    q, k, v, valid = _vit_case(32, 257, 64, True)
    want = L.vit_attention_reference(q, k, v, valid, 0.125)
    bad = emulate_vit(q, k, v, valid, 0.125, schedule, tail=0.0).to(torch.bfloat16)
    assert (bad - want).abs().max() > REL_TOL * want.abs().max()
    assert (bad[1] - want[1]).abs().max() > REL_TOL * want[1].abs().max()


def test_vit_one_pass_row_fits_the_n256_n8_split():
    """The one-pass score row covers every key of the CLIP towers (S = 257
    is the n256 tile and one key of the n8 tile; keys 258-263 are the tail)
    and P·V's 17 k16 steps cover the 264 keys (272 staged, 264-271 zero)."""
    assert 256 < 257 <= ONE_PASS_KEYS == 256 + 8
    assert 17 * 16 == 272 >= ONE_PASS_KEYS
    assert L.vit_attention_usable(1024, 80, torch.device("cuda"))
    assert not L.vit_attention_usable(1025, 80, torch.device("cuda"))

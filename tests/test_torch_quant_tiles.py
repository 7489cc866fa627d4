"""The int4 decode kernel's tile arithmetic (``csrc/int4_matmul.cu``)
emulated in plain torch and numpy on the CPU, held to the unchanged plain
version ``int4_matmul_reference``.

The byte-to-fragment mapping: a stage's 64 packed rows x 128 columns in
their 128-byte swizzle, the four words a thread reads a k16 step (rows 2t,
2t+1, 2t+8, 2t+9 at columns 32w + 4g ..), the byte permute that pairs two
rows' byte j, the nibble decode into bf16 (128 + n, less 136) for both
planes, and the n8 tiles' interleaved columns (tile j, column c is the
warp's column 4c + j) through the m16n8k16 products back to the output.
The schedule: per group of each plane an exact-product f32 partial over
16-row steps, split where a group ends, times its bf16 scale into an f32
accumulator (at G = 64 once a stage), and the split-K partials summed in
rank order.  Tolerance: the f32 outputs to 1e-4 of max|plain|, phase 3's
``F32_REL_TOL`` (the two differ by summation order only); the fragments
exactly.

The int8 decode kernel (``csrc/int8_matmul.cu``) on the same stage layout:
each byte widened through f32 (2^23 + q + 128, less 2^23 + 128, the upper
half kept as bf16) into the same interleaved fragments, the stages summed
per split, the splits in rank order, the column scale once at the end; its
launch plan, its choice between TMA and plain loads, and the plain loads'
merged words at any row pitch.
"""

import numpy as np
import pytest
import torch

from licv_vqa_tpu_torch.ops import int4_matmul as I4
from licv_vqa_tpu_torch.ops import int4_unpack_probe as P
from licv_vqa_tpu_torch.ops import int8_matmul as I8
from licv_vqa_tpu_torch.ops import quantize as Q

F32_REL_TOL = 1e-4
BN, BK = I4.TILE_N, I4.STAGE_ROWS


def swz(r, c):
    """Byte offset of (row r, byte c) in a 128-byte-swizzled tile."""
    return r * 128 + ((((c >> 4) ^ (r & 7)) << 4) | (c & 15))


def stage_tile(rows: np.ndarray) -> np.ndarray:
    """A stage's (64, 128) uint8 weight rows as TMA lays them out."""
    r, c = np.meshgrid(np.arange(BK), np.arange(BN), indexing="ij")
    tile = np.zeros(BK * BN, np.uint8)
    tile[swz(r, c)] = rows
    return tile


def word(tile: np.ndarray, off: int) -> int:
    return int.from_bytes(tile[off:off + 4].tobytes(), "little")


def byte_perm(a: int, b: int, sel: int) -> int:
    """``__byte_perm``: byte i of the result is byte (sel >> 4i) & 7 of b:a."""
    src = (b << 32 | a).to_bytes(8, "little")
    return int.from_bytes(bytes(src[(sel >> 4 * i) & 7] for i in range(4)), "little")


def bf16_pair(bits: int) -> tuple:
    """The two bf16 halves of a word as floats (low half first)."""
    return tuple(float(np.array([(bits >> 16 * h & 0xFFFF) << 16], np.uint32).view(np.float32)[0])
                 for h in range(2))


def fragments(tile: np.ndarray, wc: int, lane: int, kk: int):
    """``decode_fragments`` for one thread: (lo, hi)[j][r] as float pairs."""
    g, t = lane // 4, lane % 4
    w = [word(tile, swz(16 * kk + 2 * t + (q & 1) + 8 * (q >> 1), 32 * wc + 4 * g))
         for q in range(4)]
    lo, hi = [], []
    for j in range(4):
        lo.append([]), hi.append([])
        for r in range(2):
            v = byte_perm(w[2 * r], w[2 * r + 1], 0x4400 + 0x1111 * j)
            lo[j].append([x - 136 for x in bf16_pair((v & 0x000F000F) | 0x43004300)])
            hi[j].append([x - 136 for x in bf16_pair(((v >> 4) & 0x000F000F) ^ 0x43084308)])
    return lo, hi


def _tile_case(seed: int):
    """A stage's packed rows from random signed nibbles of both planes."""
    rng = np.random.default_rng(seed)
    q = rng.integers(-8, 8, size=(2 * BK, BN))
    packed = ((q[:BK] + 8) | ((q[BK:] & 0xF) << 4)).astype(np.uint8)
    return q, packed


def test_int4_fragments_hold_the_packed_nibbles():
    """Every thread's B fragments of every k16 step: register r of tile j
    holds rows 2t + 8r (low half) and 2t + 8r + 1 of column 32w + 4g + j,
    the low plane's q from the low nibbles and the high plane's from the
    high ones, exactly."""
    q, packed = _tile_case(0)
    tile = stage_tile(packed)
    for wc in range(4):
        for lane in range(32):
            g, t = lane // 4, lane % 4
            for kk in range(4):
                lo, hi = fragments(tile, wc, lane, kk)
                for j in range(4):
                    col = 32 * wc + 4 * g + j
                    for r in range(2):
                        row = 16 * kk + 2 * t + 8 * r
                        assert lo[j][r] == [q[row, col], q[row + 1, col]]
                        assert hi[j][r] == [q[BK + row, col], q[BK + row + 1, col]]


def test_int4_shared_memory_reads_are_free_of_bank_conflicts():
    """A warp's four B word loads each touch 32 different banks, and each
    8-lane phase of its ldmatrix of x (rows of 16 bytes) 8 different
    16-byte bank groups, in the 128-byte swizzle."""
    for wc in range(4):
        for kk in range(4):
            for q in range(4):
                banks = {swz(16 * kk + 2 * (l % 4) + (q & 1) + 8 * (q >> 1),
                             32 * wc + 4 * (l // 4)) // 4 % 32 for l in range(32)}
                assert len(banks) == 32
    for kk in range(4):
        for phase in range(4):
            lanes = range(8 * phase, 8 * phase + 8)
            groups = {swz(l % 16, 32 * kk + 16 * (l // 16)) // 16 % 8 for l in lanes}
            assert len(groups) == 8


def test_int4_interleaved_tiles_give_the_tile_product():
    """One stage through the fragments: for each warp slice and n8 tile j,
    B_j[k, c] from the threads' fragments (column c of tile j is the
    warp's column 4c + j), C_j = A·B_j over the 4 k16 steps, written back
    to the columns the C fragments name, equals x·q for both planes."""
    q, packed = _tile_case(1)
    tile = stage_tile(packed)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((16, 2 * BK)).astype(np.float32)
    got = np.zeros((2, 16, BN), np.float32)
    for wc in range(4):
        for kk in range(4):
            b = np.zeros((2, 4, 16, 8), np.float32)  # plane, tile j, k, column
            for lane in range(32):
                g, t = lane // 4, lane % 4
                lo, hi = fragments(tile, wc, lane, kk)
                for j in range(4):
                    for r in range(2):
                        for h in range(2):
                            b[0, j, 2 * t + 8 * r + h, g] = lo[j][r][h]
                            b[1, j, 2 * t + 8 * r + h, g] = hi[j][r][h]
            for plane in range(2):
                a = x[:, plane * BK + 16 * kk:plane * BK + 16 * kk + 16]
                for j in range(4):
                    got[plane][:, 32 * wc + 4 * np.arange(8) + j] += a @ b[plane, j]
    want = [x[:, :BK] @ q[:BK], x[:, BK:] @ q[BK:]]
    for plane in range(2):
        np.testing.assert_allclose(got[plane], want[plane], rtol=1e-5, atol=1e-4)


def emulate_int4(x, packed, s, group: int, splits: int, per: int, planes_swapped=False,
                 low_bias=8, hi_scale_from_low=False):
    """``(M, N) f32`` of the kernel's schedule: split-K blocks of ``per``
    packed rows; in each, 16-row steps split where a group ends; each
    piece's x·q (f32) of both planes times its group's scale into an f32
    accumulator (at G = 64 the stage's four steps make one piece); the
    blocks' accumulators summed in rank order.  The keywords break it as
    the mutation check does: x's planes swapped, the low nibble's bias,
    the high plane's partial times its low-plane group's scale."""
    m, k = x.shape
    k2, n = packed.shape
    lo = (packed & 0xF).to(torch.float32) - low_bias
    hi = (packed.view(torch.int8) >> 4).to(torch.float32)
    xf = x.float()
    xl, xh = (xf[:, k2:], xf[:, :k2]) if planes_swapped else (xf[:, :k2], xf[:, k2:])
    sf = s.float()
    hi_groups = k2 // group
    out = torch.zeros((m, n))
    for sp in range(splits):
        r0, r1 = sp * per, min(k2, (sp + 1) * per)
        acc = torch.zeros((m, n))
        step = BK if group == BK else 16
        for kr in range(r0, r1, step):
            a = 0
            while a < step and kr + a < r1:
                gi = (kr + a) // group
                b = min(step, min((gi + 1) * group, r1) - kr)
                rows = slice(kr + a, kr + b)
                pl, ph = xl[:, rows] @ lo[rows], xh[:, rows] @ hi[rows]
                acc = acc + pl * sf[gi]
                acc = acc + ph * sf[gi if hi_scale_from_low else gi + hi_groups]
                a = b
        out = out + acc
    return out


def _int4_case(m: int, k: int, n: int, group: int, seed: int):
    g = torch.Generator().manual_seed(seed)
    w = (torch.randn((k, n), generator=g) * 0.02).to(torch.bfloat16)
    x = torch.randn((m, k), generator=g).to(torch.bfloat16)
    leaf = Q.quantize_array_int4(w, group)
    return x, leaf["q4"], leaf["s"].reshape(k // group, n)


def _assert_close(got, want, tol):
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * want.float().abs().max().item(), err


# (M, K, N, G): G = 64 (a stage one group), a beam step's 3 rows and a
# prefill block's 64, with K/2 = 320 (five stages: the last split's stages
# and the last group); G = 20 and 16, groups that end inside k16 steps and
# K/2 = 100 a ragged step
INT4_CASES = ((3, 640, 256, 64), (64, 640, 256, 64), (3, 200, 24, 20), (64, 512, 40, 16))


@pytest.mark.parametrize("m,k,n,group", INT4_CASES)
def test_int4_schedule_matches_plain(m, k, n, group):
    """The schedule with the launch plan's split-K (two blocks an SM on a
    small card of 4 SMs, so that the cases split), both planes and every
    group, to ``F32_REL_TOL`` of the plain version."""
    x, packed, s = _int4_case(m, k, n, group, 5)
    splits, per = I4.launch_plan(m, k // 2, n, 4)
    got = emulate_int4(x, packed, s, group, splits, per)
    want = I4.int4_matmul_reference(x, packed, s, group, torch.float32)
    _assert_close(got, want, F32_REL_TOL)


@pytest.mark.parametrize("mutation", ["planes_swapped", "low_bias", "hi_scale_from_low"])
def test_int4_schedule_breaks_where_the_mutations_break_it(mutation):
    """The mutation check's broken kernels, emulated: x's planes swapped,
    the low nibble left biased by 8, the high plane scaled by its low-plane
    group's scale; each moves the output far past ``F32_REL_TOL``."""
    x, packed, s = _int4_case(3, 640, 256, 64, 6)
    kw = {"planes_swapped": {"planes_swapped": True}, "low_bias": {"low_bias": 0},
          "hi_scale_from_low": {"hi_scale_from_low": True}}[mutation]
    got = emulate_int4(x, packed, s, 64, 2, 192, **kw)
    want = I4.int4_matmul_reference(x, packed, s, 64, torch.float32)
    assert (got - want).abs().max() > 100 * F32_REL_TOL * want.abs().max()


@pytest.mark.parametrize("m,k,n", [(3, 4096, 4096), (3, 4096, 11008), (3, 11008, 4096),
                                   (64, 4096, 4096), (64, 4096, 11008), (64, 11008, 4096),
                                   (64, 1280, 4096), (33, 200, 24), (1, 128, 6)])
def test_int4_launch_plan_covers_every_row_once(m, k, n):
    """Whole 64-row stages a split, at most 8 splits (a portable cluster),
    none empty, every packed row in one; at a beam step's shapes about two
    blocks an SM, at 64 rows at most half the SMs' worth of blocks."""
    k2 = k // 2
    splits, per = I4.launch_plan(m, k2, n, 132)
    assert per % BK == 0 and 1 <= splits <= I4.MAX_SPLITS
    assert (splits - 1) * per < k2 <= splits * per
    blocks = -(-n // BN) * splits
    if m > 32:
        assert blocks <= 66 or splits == 1
    elif k2 >= 8 * BK:
        assert blocks >= 132 or splits == I4.MAX_SPLITS


# ---------------------------------------------------------------------------
# int8 (csrc/int8_matmul.cu): bytes widened through f32 into bf16 fragments
# ---------------------------------------------------------------------------


def f32_bits(v: np.float32) -> int:
    return int(np.array([v], np.float32).view(np.uint32)[0])


def widen_pair(w0: int, w1: int, j: int, swapped: bool = False) -> int:
    """``widen_pair<j>`` on two words whose sign bits were flipped: byte j
    of each in the low mantissa bits of 2^23, less 2^23 + 128 in f32, the
    two upper halves packed (row k low, k + 1 high; ``swapped``: the other
    way round, as the mutation check breaks it)."""
    lo, hi = (np.array([byte_perm(w, 0x4B000000, 0x7440 | j)], np.uint32).view(np.float32)[0]
              - np.float32(8388736.0) for w in (w0, w1))
    a, b = (f32_bits(hi), f32_bits(lo)) if swapped else (f32_bits(lo), f32_bits(hi))
    return byte_perm(a, b, 0x7632)


def int8_fragments(tile: np.ndarray, wc: int, lane: int, kk: int, swapped: bool = False):
    """``widen_fragments`` for one thread: b[j][r] as float pairs."""
    g, t = lane // 4, lane % 4
    w = [word(tile, swz(16 * kk + 2 * t + (q & 1) + 8 * (q >> 1), 32 * wc + 4 * g)) ^ 0x80808080
         for q in range(4)]
    return [[list(bf16_pair(widen_pair(w[2 * r], w[2 * r + 1], j, swapped))) for r in range(2)]
            for j in range(4)]


def _int8_tile(seed: int) -> np.ndarray:
    """A stage's (64, 128) int8 weight rows, every byte value among them."""
    q = np.random.default_rng(seed).integers(-128, 128, size=(BK, BN))
    q[0] = np.arange(-128, 0)
    q[1] = np.arange(0, 128)
    return q.astype(np.int8)


def test_int8_fragments_hold_the_weight_bytes():
    """Every thread's B fragments of every k16 step: register r of tile j
    holds rows 2t + 8r (low half) and 2t + 8r + 1 of column 32w + 4g + j,
    each byte's int8 value exactly (-128 and 127 included)."""
    q = _int8_tile(0)
    tile = stage_tile(q.view(np.uint8))
    for wc in range(4):
        for lane in range(32):
            g, t = lane // 4, lane % 4
            for kk in range(4):
                b = int8_fragments(tile, wc, lane, kk)
                for j in range(4):
                    col = 32 * wc + 4 * g + j
                    for r in range(2):
                        row = 16 * kk + 2 * t + 8 * r
                        assert b[j][r] == [q[row, col], q[row + 1, col]]


def test_int8_shared_memory_reads_are_free_of_bank_conflicts():
    """A warp's four B word loads each touch 32 different banks, and each
    8-lane phase of its ldmatrix of x (one m16 tile's rows of 16 bytes) 8
    different 16-byte bank groups, in the 128-byte swizzle, for every m16
    tile of 64 rows."""
    for wc in range(4):
        for kk in range(4):
            for q in range(4):
                banks = {swz(16 * kk + 2 * (l % 4) + (q & 1) + 8 * (q >> 1),
                             32 * wc + 4 * (l // 4)) // 4 % 32 for l in range(32)}
                assert len(banks) == 32
    for mt in range(4):
        for kk in range(4):
            for phase in range(4):
                groups = {(2048 * mt + swz(l % 16, 32 * kk + 16 * (l // 16))) // 16 % 8
                          for l in range(8 * phase, 8 * phase + 8)}
                assert len(groups) == 8


def test_int8_interleaved_tiles_give_the_tile_product():
    """One stage through the fragments: for each warp slice and n8 tile j,
    B_j[k, c] from the threads' fragments (column c of tile j is the
    warp's column 4c + j), C_j = A.B_j over the 4 k16 steps, written back
    to the columns the C fragments name, equals x.q."""
    q = _int8_tile(1)
    tile = stage_tile(q.view(np.uint8))
    x = np.random.default_rng(2).standard_normal((16, BK)).astype(np.float32)
    got = np.zeros((16, BN), np.float32)
    for wc in range(4):
        for kk in range(4):
            b = np.zeros((4, 16, 8), np.float32)  # tile j, k, column
            for lane in range(32):
                g, t = lane // 4, lane % 4
                frag = int8_fragments(tile, wc, lane, kk)
                for j in range(4):
                    for r in range(2):
                        for h in range(2):
                            b[j, 2 * t + 8 * r + h, g] = frag[j][r][h]
            a = x[:, 16 * kk:16 * kk + 16]
            for j in range(4):
                got[:, 32 * wc + 4 * np.arange(8) + j] += a @ b[j]
    np.testing.assert_allclose(got, x @ q.astype(np.float32), rtol=1e-5, atol=1e-4)


def emulate_int8(x, q, s, out_dtype, splits: int, per: int, groups: int = 2,
                 drop_rank0=False, no_scale=False, pairs_swapped=False):
    """``(M, N)`` of the kernel's schedule: split-K blocks of ``per`` rows;
    in each, ``groups`` consumer groups (2 on the TMA path, 1 on the plain
    loads) take a 64-row stage's 16-row steps between them, each summing
    its steps' x.q (f32; rows past K are zeros) into its own accumulator;
    the accumulators summed in rank order (a rank's groups in order), times
    the column scale, then rounded to ``out_dtype``.  The keywords break it
    as the mutation check does: rank 0's partials left out of the sum, the
    scale dropped, rows k and k + 1 swapped in every B register."""
    m, k = x.shape
    qf = q.float()
    if pairs_swapped:
        qf = qf.reshape(-1, 2, qf.shape[1]).flip(1).reshape(qf.shape) if k % 2 == 0 else qf
    xf = x.to(torch.bfloat16).float()
    out = torch.zeros((m, q.shape[1]))
    steps = BK // 16 // groups
    for rank in range(splits):
        accs = [torch.zeros_like(out) for _ in range(groups)]
        for kb in range(rank * per, min(k, rank * per + per), BK):
            for grp in range(groups):
                for kk in range(grp * steps, (grp + 1) * steps):
                    r0 = kb + 16 * kk
                    accs[grp] = accs[grp] + xf[:, r0:r0 + 16] @ qf[r0:r0 + 16]
        if not (drop_rank0 and rank == 0):
            for acc in accs:
                out = out + acc
    return (out if no_scale else out * s.reshape(1, -1)).to(out_dtype)


def _int8_case(m: int, k: int, n: int, seed: int):
    g = torch.Generator().manual_seed(seed)
    w = (torch.randn((k, n), generator=g) * 0.02).to(torch.bfloat16)
    x = torch.randn((m, k), generator=g).to(torch.bfloat16)
    leaf = Q.quantize_array(w)
    return x, leaf["q"], leaf["s"].reshape(-1)


# (M, K, N): a beam step's 3 rows over five stages and a ragged last one,
# a 64-row block, more than 64 rows (three row blocks), K and N ragged
INT8_CASES = ((3, 320, 256), (3, 300, 136), (64, 640, 128), (130, 200, 72), (7, 100, 33))


@pytest.mark.parametrize("m,k,n", INT8_CASES)
@pytest.mark.parametrize("out", [torch.float32, torch.bfloat16])
def test_int8_schedule_matches_plain(m, k, n, out):
    """The schedule with the launch plan's split-K (two blocks an SM on a
    small card of 4 SMs, so that the cases split) and the path's consumer
    groups to ``F32_REL_TOL`` of the plain version's f32 output (bf16
    outputs: each within one rounding of it)."""
    x, q, s = _int8_case(m, k, n, 7)
    splits, per = I8.launch_plan(m, k, n, 4)
    groups = 2 if I8.tma_path(k, n) else 1
    got = emulate_int8(x, q, s, torch.float32, splits, per, groups)
    want = I8.int8_matmul_reference(x, q, s, torch.float32)
    _assert_close(got, want, F32_REL_TOL)
    if out == torch.bfloat16:
        bf = emulate_int8(x, q, s, out, splits, per, groups).float()
        assert ((bf - want).abs() <= want.abs() * 2 ** -8 + 1e-30).all()


@pytest.mark.parametrize("mutation", ["drop_rank0", "no_scale", "pairs_swapped"])
def test_int8_schedule_breaks_where_the_mutations_break_it(mutation):
    """The mutation check's broken kernels, emulated: the first rank's
    partial dropped, the column scale dropped, the k-row pairs swapped;
    each moves the output far past ``F32_REL_TOL``."""
    x, q, s = _int8_case(3, 640, 256, 8)
    got = emulate_int8(x, q, s, torch.float32, 4, 192, **{mutation: True})
    want = I8.int8_matmul_reference(x, q, s, torch.float32)
    assert (got - want).abs().max() > 100 * F32_REL_TOL * want.abs().max()


def test_int8_swapped_pair_fragment_holds_the_rows_the_other_way_round():
    """The swapped pack puts row k + 1 in the low half: what the emulated
    mutation computes with its flipped row pairs."""
    q = _int8_tile(3)
    tile = stage_tile(q.view(np.uint8))
    for lane in range(32):
        g, t = lane // 4, lane % 4
        b = int8_fragments(tile, 1, lane, 2, swapped=True)
        for j in range(4):
            row, col = 32 + 2 * t, 32 + 4 * g + j
            assert b[j][0] == [q[row + 1, col], q[row, col]]


@pytest.mark.parametrize("m,k,n", [(3, 4096, 4096), (3, 4096, 11008), (3, 11008, 4096),
                                   (64, 4096, 4096), (3, 4096, 32000), (3, 4096, 32002),
                                   (1, 4096, 32002), (65, 256, 72), (7, 100, 33), (5, 96, 130),
                                   (3, 4100, 4096), (130, 4096, 4112), (1, 1, 1), (9, 63, 17)])
def test_int8_launch_plan_covers_every_row_once(m, k, n):
    """Whole 64-row stages a split, at most ``INT8_MAX_SPLITS`` (6) splits
    (the kernel's cluster takes 8), none empty, every weight row in one
    (ragged K too); the beam step's projections take about two blocks an
    SM where the cluster allows."""
    splits, per = I8.launch_plan(m, k, n, 132)
    assert per % I8.INT8_STAGE_ROWS == 0 and 1 <= splits <= I8.INT8_MAX_SPLITS
    assert (splits - 1) * per < k <= splits * per
    blocks = -(-n // I8.INT8_TILE_N) * -(-m // I8.INT8_TILE_M) * splits
    if k >= 8 * I8.INT8_STAGE_ROWS:
        assert blocks >= 132 or splits == I8.INT8_MAX_SPLITS
    assert blocks <= 2 * 132 + -(-n // I8.INT8_TILE_N) * -(-m // I8.INT8_TILE_M)
    if (m, k, n) == (3, 4096, 4096):
        assert (splits, per) == (6, 704)  # 32 column tiles x 6: 192 blocks


# phase 3's shapes and the card tests' (ops/int8_matmul.py::tma_path): TMA
# where both row pitches are multiples of 16 bytes, else the plain loads
INT8_ROUTES = (
    ((4096, 4096), True), ((4096, 11008), True), ((11008, 4096), True), ((4096, 32000), True),
    ((1280, 1536), True), ((1280, 4096), True), ((4096, 4112), True), ((64, 128), True),
    ((4096, 32002), False), ((256, 72), False), ((100, 33), False), ((96, 130), False),
    ((4096, 4104), False), ((4100, 4096), False),
)


@pytest.mark.parametrize("kn,tma", INT8_ROUTES)
def test_int8_routes_tma_or_plain_loads_by_the_pitch(kn, tma):
    """The path each shape takes with 16-byte aligned operands; an
    unaligned weight or x (a slice into a plane) takes the plain loads."""
    k, n = kn
    assert I8.tma_path(k, n, 256, 512) == tma
    assert not I8.tma_path(k, n, 256, 514) and not I8.tma_path(k, n, 258, 512)


def plain_words(plane: np.ndarray, n0: int, pitch_offset: int = 0):
    """The plain producers' stage words of a tile at column n0 of an (R, N)
    uint8 plane that starts ``pitch_offset`` bytes into an aligned buffer
    (``PlainStage``): lane l's aligned word at or before its 4 columns (a
    word with no byte of the plane is zero, not read; one with any is read
    whole), merged with the next lane's (lane 31: the word after its own)
    by ``__byte_perm`` (selector 0x3210 + 0x1111 o for the row's
    misalignment o), bytes past N zero."""
    r_n, n = plane.shape
    buf = np.full(pitch_offset + plane.size + 8, 0xEE, np.uint8)  # not the plane's
    buf[pitch_offset:pitch_offset + plane.size] = plane.reshape(-1)
    lo_b, hi_b = pitch_offset, pitch_offset + plane.size
    out = np.zeros((r_n, 128), np.uint8)

    def word_at(a):
        if a + 4 <= lo_b or a >= hi_b:
            return 0
        return int.from_bytes(buf[max(a, 0):a + 4].tobytes().rjust(4, b"\xee"), "little")

    for row in range(r_n):
        tile = pitch_offset + row * n + n0
        o = tile & 3
        words = [word_at(tile - o + 4 * lane) for lane in range(33)]
        for lane in range(32):
            v = byte_perm(words[lane], words[lane + 1], 0x3210 + 0x1111 * o)
            valid = n - n0 - 4 * lane
            v = v if valid >= 4 else 0 if valid <= 0 else v & ((1 << (8 * valid)) - 1)
            out[row, 4 * lane:4 * lane + 4] = np.frombuffer(v.to_bytes(4, "little"), np.uint8)
    return out


@pytest.mark.parametrize("n,offset", [(32002, 0), (33, 0), (130, 1), (72, 3), (4104, 2),
                                      (200, 0), (33, 13), (4096, 6)])
def test_int8_plain_loads_read_each_row_tile_at_any_pitch(n, offset):
    """The plain path's merged words hold the row's 128 columns of the tile
    exactly, whatever the row's misalignment (N odd or 2 mod 4, the plane
    at any byte offset), zeros past N; at the first and last tiles."""
    rng = np.random.default_rng(n + offset)
    plane = rng.integers(0, 256, size=(9, n)).astype(np.uint8)
    for n0 in sorted({0, (n - 1) // 128 * 128}):
        got = plain_words(plane, n0, offset)
        want = np.zeros((9, 128), np.uint8)
        want[:, :min(128, n - n0)] = plane[:, n0:n0 + 128]
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# w8a8 (csrc/w8a8_matmul.cu): s8 fragments from N-major weight rows
# ---------------------------------------------------------------------------

W8A8_BK = 128  # K bytes a stage


# (BM, BN, MT, NB, WM, WN) of the one tile, as the kernel's template
# arguments give them
W8A8_TILE = (64, 128, 4, 1, 1, 4)


def swizzled(rows: np.ndarray) -> np.ndarray:
    """A (R, 128) uint8 tile as TMA lays it out in the 128-byte swizzle."""
    r, c = np.meshgrid(np.arange(rows.shape[0]), np.arange(128), indexing="ij")
    tile = np.zeros(rows.size, np.uint8)
    tile[swz(r, c)] = rows
    return tile


def s8_fragments(w, t: int):
    """``s8_fragments`` for lane t: w[i] the words of K-rows 4t + (i ^ (t &
    2)); returns the four B registers."""
    sel_lo, sel_hi = (0x1054, 0x3276) if t & 2 else (0x5410, 0x7632)
    lo01, hi01 = byte_perm(w[0], w[1], 0x5140), byte_perm(w[0], w[1], 0x7362)
    lo23, hi23 = byte_perm(w[2], w[3], 0x5140), byte_perm(w[2], w[3], 0x7362)
    return [byte_perm(lo01, lo23, sel_lo), byte_perm(lo01, lo23, sel_hi),
            byte_perm(hi01, hi23, sel_lo), byte_perm(hi01, hi23, sel_hi)]


def s8_bytes(reg: int) -> list:
    return [int(v) for v in np.frombuffer(reg.to_bytes(4, "little"), np.int8)]


def w8a8_b_registers(tile: np.ndarray, col: int, lane: int, kk: int):
    """A thread's B registers of k32 step kk at the 128-byte box column
    ``col`` (its group's column 4g): ``b[j] = (b0, b1)`` for n8 tile j."""
    t = lane % 4
    regs = []
    for half in range(2):
        w = [word(tile, swz(32 * kk + 16 * half + 4 * t + (i ^ (t & 2)), col)) for i in range(4)]
        regs.append(s8_fragments(w, t))
    return [(regs[0][j], regs[1][j]) for j in range(4)]


def test_w8a8_fragments_hold_four_k_rows_of_one_column():
    """Register j of a thread (g, t) holds K-rows 4t .. 4t + 3 (b0) and
    16 + 4t .. (b1) of the group's column 4g + j, low byte first, for the
    lanes that load their rows rotated (t >= 2) and those that do not."""
    rng = np.random.default_rng(0)
    q = rng.integers(-128, 128, size=(W8A8_BK, 128)).astype(np.int8)
    tile = swizzled(q.view(np.uint8))
    for wn in range(4):
        for lane in range(32):
            g, t = lane // 4, lane % 4
            for kk in range(4):
                regs = w8a8_b_registers(tile, 32 * wn + 4 * g, lane, kk)
                for j in range(4):
                    for half in range(2):
                        rows = 32 * kk + 16 * half + 4 * t + np.arange(4)
                        assert s8_bytes(regs[j][half]) == list(q[rows, 32 * wn + 4 * g + j])


def test_w8a8_word_loads_and_ldmatrix_are_free_of_bank_conflicts():
    """Each of a warp's B word loads touches 32 different banks (the rows
    4t + (i ^ (t & 2)) keep the four rows of a load in four 32-byte bank
    ranges); with the rows 4t + i it would not.  Each 8-lane phase of the
    A ``ldmatrix`` reads 8 different 16-byte bank groups."""
    def banks(row_of):
        return {swz(row_of(l % 4, i), 32 * wc + 4 * (l // 4)) // 4 % 32 for l in range(32)}

    for wc in range(4):
        for i in range(4):
            assert len(banks(lambda t, i=i: 4 * t + (i ^ (t & 2)))) == 32
        assert min(len(banks(lambda t, i=i: 4 * t + i)) for i in range(4)) == 16
    for kk in range(4):
        for phase in range(4):
            groups = {swz(l % 16, 32 * kk + 16 * (l // 16)) // 16 % 8
                      for l in range(8 * phase, 8 * phase + 8)}
            assert len(groups) == 8


def _ldmatrix_a(stage: np.ndarray, m16: int, kk: int, lane: int):
    """``ldmatrix.x4`` of the A stage for thread ``lane``: matrix i's rows
    come from the addresses of lanes 8i .. 8i + 7 (row lane % 16, byte 16 *
    (lane / 16) of the step), the thread gets row g's bytes 4t .. 4t + 3."""
    g, t = lane // 4, lane % 4
    regs = []
    for i in range(4):
        src = 8 * i + g
        off = 2048 * m16 + swz(src % 16, 32 * kk + 16 * (src // 16)) + 4 * t
        regs.append(word(stage, off))
    return regs


def emulate_w8a8(xq, xs, q, s, out_dtype, splits: int):
    """The kernel's schedule on the CPU, as integers: blocks of BM x BN
    outputs, K in stages of 128 bytes (zeros past M, K and N), split over
    ``splits`` blocks; per warp and k32 step the A registers from the
    swizzled stage through ``ldmatrix``'s row addresses, the B registers
    from ``s8_fragments``, m16n8k32 products per n8 tile, the sums placed
    by the thread's C registers (tile j's c0 / c1 at columns 8t + j and
    8t + 4 + j); with splits, each block's int32 tile written in chunks to
    their owners and summed in rank order; then ``(f32(acc) * xs) * s``."""
    m, k = xq.shape
    n = q.shape[1]
    bm, bn, mt_n, nb_n, wm_n, wn_n = W8A8_TILE
    steps = -(-k // W8A8_BK)
    per = -(-steps // splits) * W8A8_BK
    used = -(-k // per)
    xqp = np.zeros((-(-m // bm) * bm, used * per), np.int8)
    xqp[:m, :k] = xq.numpy()
    qp = np.zeros((used * per, -(-n // bn) * bn), np.int8)
    qp[:k, :n] = q.numpy()
    acc_out = np.zeros((xqp.shape[0], qp.shape[1]), np.int64)
    for by in range(xqp.shape[0] // bm):
        m0 = by * bm
        rows = min(bm, m - m0)
        for bx in range(qp.shape[1] // bn):
            n0 = bx * bn
            tiles = []
            for rank in range(used):
                acc = np.zeros((bm, bn), np.int64)
                for k0 in range(rank * per, min(k, rank * per + per), W8A8_BK):
                    stage_a = swizzled(xqp[m0:m0 + bm, k0:k0 + W8A8_BK].view(np.uint8))
                    boxes = [swizzled(qp[k0:k0 + W8A8_BK, n0 + 128 * h:n0 + 128 * h + 128]
                                      .view(np.uint8)) for h in range(bn // 128)]
                    for wm in range(wm_n):
                        for wn in range(wn_n):
                            for kk in range(4):
                                for mt in range(mt_n):
                                    m16 = mt_n * wm + mt
                                    a = np.zeros((16, 32), np.int64)
                                    for lane in range(32):
                                        g, t = lane // 4, lane % 4
                                        r = _ldmatrix_a(stage_a, m16, kk, lane)
                                        a[g, 4 * t:4 * t + 4] = s8_bytes(r[0])
                                        a[g + 8, 4 * t:4 * t + 4] = s8_bytes(r[1])
                                        a[g, 16 + 4 * t:20 + 4 * t] = s8_bytes(r[2])
                                        a[g + 8, 16 + 4 * t:20 + 4 * t] = s8_bytes(r[3])
                                    for nb in range(nb_n):
                                        cb = 32 * (wn * nb_n + nb)
                                        b = np.zeros((4, 32, 8), np.int64)  # tile j, k, n
                                        for lane in range(32):
                                            g, t = lane // 4, lane % 4
                                            regs = w8a8_b_registers(boxes[cb // 128],
                                                                    cb % 128 + 4 * g, lane, kk)
                                            for j in range(4):
                                                b[j, 4 * t:4 * t + 4, g] = s8_bytes(regs[j][0])
                                                b[j, 16 + 4 * t:20 + 4 * t, g] = s8_bytes(regs[j][1])
                                        for j in range(4):
                                            c = a @ b[j]
                                            for lane in range(32):
                                                g, t = lane // 4, lane % 4
                                                for half in range(2):
                                                    r0 = 16 * m16 + g + 8 * half
                                                    acc[r0, cb + 8 * t + j] += c[g + 8 * half, 2 * t]
                                                    acc[r0, cb + 8 * t + 4 + j] += \
                                                        c[g + 8 * half, 2 * t + 1]
                tiles.append(acc)
            if used == 1:
                acc_out[m0:m0 + bm, n0:n0 + bn] = tiles[0]
                continue
            n_out = rows * bn
            chunk = -(-(n_out // 4) // used) * 4
            recv = np.zeros((used, used * chunk), np.int64)
            for rank, acc in enumerate(tiles):
                flat = acc[:rows].reshape(-1)
                for e in range(0, n_out, 4):
                    owner = e // chunk
                    slot = rank * chunk + e - owner * chunk
                    recv[owner, slot:slot + 4] = flat[e:e + 4]
            summed = np.zeros(n_out, np.int64)
            for owner in range(used):
                for c0 in range(owner * chunk, min(n_out, owner * chunk + chunk)):
                    v = 0
                    for rank in range(used):  # in rank order
                        v += recv[owner, rank * chunk + c0 - owner * chunk]
                    summed[c0] = v
            acc_out[m0:m0 + rows, n0:n0 + bn] = summed.reshape(rows, bn)
    acc32 = acc_out[:m, :n].astype(np.int32)
    y = (acc32.astype(np.float32) * xs.numpy().reshape(-1, 1)) * s.numpy().reshape(1, -1)
    return torch.from_numpy(y.astype(np.float32)).to(out_dtype)


def _w8a8_case(m: int, k: int, n: int, seed: int):
    g = torch.Generator().manual_seed(seed)
    w = (torch.randn((k, n), generator=g) * 0.02).to(torch.bfloat16)
    x = (torch.randn((m, k), generator=g) * 3).to(torch.bfloat16)
    x[0] = 0  # the floor scale
    leaf = Q.quantize_array(w)
    xq, xs = I8.quantize_act_rows(x)
    return xq, xs, leaf["q"], leaf["s"].reshape(-1)


# (M, K, N, splits): a 3-block split (ragged K: the last split shorter, the
# last stage past K) and none; ragged M, K and N over three row blocks; an
# even split
W8A8_CASES = ((70, 320, 136, 3), (17, 100, 33, 1), (130, 144, 264, 1), (64, 256, 128, 2))


@pytest.mark.parametrize("m,k,n,splits", W8A8_CASES)
def test_w8a8_schedule_equals_plain(m, k, n, splits):
    """The kernel's fragments, column mapping and cluster split-K order
    give the plain version's output bit for bit, as phase 3 holds the
    kernel (bf16 and f32 outputs)."""
    xq, xs, q, s = _w8a8_case(m, k, n, 21)
    for out in (torch.float32, torch.bfloat16):
        got = emulate_w8a8(xq, xs, q, s, out, splits)
        want = I8.w8a8_prequantized_reference(xq, xs, q, s, out)
        assert torch.equal(got, want)


@pytest.mark.parametrize("m,k,n", [(64, 4096, 4096), (64, 4096, 11008), (64, 11008, 4096),
                                   (64, 1280, 4096), (321, 1280, 1536), (512, 4096, 11008),
                                   (4096, 4096, 11008), (17, 100, 33), (1, 64, 8)])
def test_w8a8_launch_plan(m, k, n):
    """The one tile at every M; its splits (a portable cluster, at most 8)
    leave no split empty and blocks for at most three quarters of the SMs
    unless there is no split at all."""
    ti = I8._w8a8_tile(None)
    assert I8.W8A8_TILES[ti] == "64x128" == f"{W8A8_TILE[0]}x{W8A8_TILE[1]}"
    splits = I8._w8a8_splits(m, k, n, ti, 132)
    steps = -(-k // W8A8_BK)
    per = -(-steps // splits) * W8A8_BK
    assert 1 <= splits <= 8 and -(-k // per) == splits  # the kernel's own arithmetic
    blocks = -(-m // W8A8_TILE[0]) * -(-n // W8A8_TILE[1]) * splits
    assert blocks <= 3 * 132 // 4 or splits == 1


# ---------------------------------------------------------------------------
# The int4 unpack probe (csrc/int4_unpack_probe.cu): the four schedules on
# the int4 kernel's fragments
# ---------------------------------------------------------------------------

PROBE_READS = {"a": ("biased", "biased"), "d": ("unbiased", "unbiased"),
               "e": ("signed", "signed"), "f": ("unbiased", "signed")}


def bf16_round(v: float) -> float:
    return float(torch.tensor(v, dtype=torch.float32).to(torch.bfloat16).float())


def nibble_value(v: int, read: str) -> list:
    """``nibbles<read>`` on the word v (nibbles at bits 0-3 and 16-19): the
    two halves as floats, by the kernel's bf16 bit arithmetic."""
    if read == "signed":
        bits = ((v & 0x000F000F) ^ 0x43084308)
        return [x - 136 for x in bf16_pair(bits)]
    bits = (v & 0x000F000F) | 0x43004300
    return [x - (136 if read == "biased" else 128) for x in bf16_pair(bits)]


def probe_fragments(tile: np.ndarray, wc: int, lane: int, kk: int, schedule: str):
    """``load_step``'s B fragments of one thread, decoded (lo, hi)[j][r] as
    float pairs."""
    g, t = lane // 4, lane % 4
    w = [word(tile, swz(16 * kk + 2 * t + (q & 1) + 8 * (q >> 1), 32 * wc + 4 * g))
         for q in range(4)]
    read_lo, read_hi = PROBE_READS[schedule]
    lo, hi = [], []
    for j in range(4):
        lo.append([]), hi.append([])
        for r in range(2):
            v = byte_perm(w[2 * r], w[2 * r + 1], 0x4400 + 0x1111 * j)
            lo[j].append(nibble_value(v, read_lo))
            hi[j].append(nibble_value(v >> 4, read_hi))
    return lo, hi


@pytest.mark.parametrize("schedule", P.SCHEDULES)
def test_probe_fragments_decode_and_scale_as_the_plain_version(schedule):
    """Each schedule's B fragments hold the integers its plain version reads
    from the nibbles (``_decode``), exactly; for d, e and f the fragment
    times its column's bf16 scale pair, rounded once to bf16, is the plain
    version's weight bf16(q · bf16(s)) (f's high plane through 16 ·
    bf16(s/16)), exactly."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.integers(-7, 8, size=(2 * BK, BN)).astype(np.int8))
    s = torch.from_numpy(rng.random((2, BN)).astype(np.float32) * 0.01 + 0.001)
    packed, table = P.probe_operands(q, s, schedule)
    lo_int, hi_int = P._decode(packed, schedule)
    tile = stage_tile(packed.numpy())
    factor = 16.0 if schedule == "f" else 1.0
    for wc in range(4):
        for lane in range(32):
            g, t = lane // 4, lane % 4
            for kk in range(4):
                lo, hi = probe_fragments(tile, wc, lane, kk, schedule)
                for j in range(4):
                    col = 32 * wc + 4 * g + j
                    sl = bf16_round(float(table[0, col]))
                    sh = bf16_round(factor * bf16_round(float(table[1, col])))
                    for r in range(2):
                        for h in range(2):
                            row = 16 * kk + 2 * t + 8 * r + h
                            # f's high fragment holds q, its plain version 16 q
                            assert lo[j][r][h] == lo_int[row, col]
                            assert hi[j][r][h] * factor == hi_int[row, col]
                            if schedule != "a":
                                want_lo = bf16_round(float(lo_int[row, col]) * bf16_round(
                                    float(table[0, col])))
                                want_hi = bf16_round(float(hi_int[row, col]) * bf16_round(
                                    float(table[1, col])))
                                assert bf16_round(lo[j][r][h] * sl) == want_lo
                                assert bf16_round(hi[j][r][h] * sh) == want_hi


def emulate_probe(x, packed, s, group: int, schedule: str, splits: int, per: int):
    """``(M, N) f32`` of the probe kernel's schedule: split-K blocks of
    ``per`` packed rows, stages of 64 and k16 steps; a: each group piece's
    exact-integer partial (both planes) times its f32 scale into the
    accumulator; d, e, f: the products with w = bf16(q · scale) summed
    directly, and for d at each group's end -8 · bf16(f32(exact group sum
    of x)) · bf16(s) per plane; the splits summed in rank order.  Schedule
    f's correction outside the kernel is the caller's."""
    m, k = x.shape
    k2, n = packed.shape
    xb = x.to(torch.bfloat16).float()
    lo, hi = (v.float() for v in P._decode(packed, schedule))
    fh = 16.0 if schedule == "f" else 1.0
    hi = hi / fh  # f's high fragment: q, its scale 16 bf16(s/16)
    sf = s.float()
    hi_groups = k2 // group
    out = torch.zeros((m, n))
    for sp in range(splits):
        r0, r1 = sp * per, min(k2, (sp + 1) * per)
        acc = torch.zeros((m, n))
        for kr in range(r0, r1, 16):
            a = kr
            while a < min(kr + 16, r1):
                gi = a // group
                b = min(kr + 16, r1, (gi + 1) * group)
                rows = slice(a, b)
                xl, xh = xb[:, rows], xb[:, k2 + a:k2 + b]
                if schedule == "a":
                    acc = acc + (xl @ lo[rows]) * sf[gi] + (xh @ hi[rows]) * sf[gi + hi_groups]
                else:
                    wl = (lo[rows] * sf[gi].to(torch.bfloat16).float()).to(torch.bfloat16).float()
                    wh = (hi[rows] * (fh * sf[gi + hi_groups].to(torch.bfloat16).float()))
                    acc = acc + xl @ wl + xh @ wh.to(torch.bfloat16).float()
                if schedule == "d" and b == (gi + 1) * group:
                    gs = [xb[:, p * k2 + gi * group:p * k2 + b].double().sum(-1).float()
                          .to(torch.bfloat16).float() for p in range(2)]
                    for p, row in ((0, gi), (1, gi + hi_groups)):
                        acc = acc - 8.0 * gs[p][:, None] * sf[row].to(torch.bfloat16).float()
                a = b
        out = out + acc
    return out


# (M, K, N, G): the tool's G = 64 at a few splits, G = 20 and 8 (groups
# inside k16 steps), G = 128 (a group over two stages) with more than one
# row block
PROBE_CASES = ((8, 1024, 256, 64), (13, 640, 132, 20), (5, 256, 64, 8), (20, 1024, 256, 128))


@pytest.mark.parametrize("schedule", P.SCHEDULES)
@pytest.mark.parametrize("m,k,n,group", PROBE_CASES)
def test_probe_schedule_matches_plain(m, k, n, group, schedule):
    """The schedule with the launch plan's split-K on a card of 4 SMs (so
    that the cases split), f's correction then taken outside as the
    wrapper takes it, to ``F32_REL_TOL`` of the plain version."""
    rng = np.random.default_rng(m + k + group)
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32))
    q = torch.from_numpy(rng.integers(-7, 8, size=(k, n)).astype(np.int8))
    s = torch.from_numpy(rng.random((k // group, n)).astype(np.float32) * 0.01 + 0.001)
    packed, table = P.probe_operands(q, s, schedule)
    splits, per = P.launch_plan(m, k // 2, n, group, 4)
    got = emulate_probe(x, packed, table, group, schedule, splits, per)
    if schedule == "f":
        got = P._f_corrected(got, x.to(torch.bfloat16), table, group)
    _assert_close(got, P.int4_unpack_probe_reference(x, packed, table, group, schedule),
                  F32_REL_TOL)


@pytest.mark.parametrize("m,k,n,group", [(8, 4096, 11008, 64), (1, 512, 36, 64),
                                         (13, 1024, 132, 32), (8, 200, 44, 20),
                                         (9, 4096, 256, 128), (5, 256, 64, 8),
                                         (20, 1024, 256, 128), (3, 640, 128, 20)])
def test_probe_launch_plan_covers_every_row_once(m, k, n, group):
    """At most 8 splits (a portable cluster), none empty, each whole stages
    and whole groups (d's group sums never cut), every packed row in one;
    the tool's shape takes about two blocks an SM."""
    k2 = k // 2
    splits, per = P.launch_plan(m, k2, n, group, 132)
    assert 1 <= splits <= P.MAX_SPLITS and per % P.STAGE_ROWS == 0 and per % group == 0
    assert (splits - 1) * per < k2 <= splits * per
    if (m, k, n) == (8, 4096, 11008):
        assert (splits, per) == (4, 512)  # 86 column tiles x 4: 344 blocks


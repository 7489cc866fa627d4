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
"""

import numpy as np
import pytest
import torch

from licv_vqa_tpu_torch.ops import int4_matmul as I4
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

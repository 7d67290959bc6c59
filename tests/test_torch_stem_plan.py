"""The stem weight-gradient kernel's plan (csrc/stem_wgrad.cu, bf16 wgmma),
emulated in numpy on the CPU, where the kernel cannot run.

The emulation walks what the kernel walks: the split copy that unfolds the
space-to-depth folded volume xf (each thread one of a folded voxel's 8
channel blocks, written as its grid voxel's row: channels padded to 8, the
even and odd w positions of each (d, h) line apart);
launch_plan's slices of the output bricks; each brick staged as the
producer's two TMA boxes land it (the input brick, box (d 7, h 11, 2
parities, 18 positions x 8 channels) of the split volume, zeros outside
it; the g tile's 128-byte rows under the 128-byte swizzle); each brick
row's A fragment gathered through the lanes' ldmatrix.x4.trans addresses;
each (kd, kw) group's B read through its no-swizzle MN-major descriptor
(start, leading offset 128 between k neighbours, stride offset 576 between
n neighbours); the m64n40k16 products summed in the kernel's order (slice,
block, warpgroup, brick, row, group) into each slice's partial, stored in
the accumulators' layout (group, register, thread), and the slices summed
in order into dW through the reduction's map (frag_to_dw). In float64 the
result is held against stem_wgrad_plain to 1e-12 of the peak: only the
order of the sums differs. A wrong row, offset, swizzle, fragment lane or
accumulator index moves a tap's or a channel's whole sum.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from neraf_tpu_torch.models.grid import fold_volume
from neraf_tpu_torch.ops.cuda.stem_wgrad import launch_plan
from neraf_tpu_torch.ops.stem_wgrad import stem_wgrad_plain

SRC = (Path(__file__).resolve().parents[1] / "neraf_tpu_torch" / "csrc"
       / "stem_wgrad.cu").read_text()
SMS = 132  # the H100's SMs: 66 slices
CIN, COUT = 8, 64
BW, HALF = 16, 18  # output voxels a brick row; positions a parity's line
ID, IH = 7, 11  # input lines of a bf16 brick (2 x 4 output rows)
LBO, SBO = 128, 2 * HALF * 16  # bytes: k neighbours, n (kh) neighbours
G_OFF = -(-ID * IH * SBO // 1024) * 1024  # the g tile's offset, bytes
GROUPS, CTA_GROUPS, MAX_WG_GROUPS = 25, 13, 7


def test_constants_are_the_sources():
    for name, value in (("kCin", CIN), ("kCout", COUT), ("kBW", BW),
                        ("kGroups", GROUPS), ("kCtaGroups", CTA_GROUPS),
                        ("kMaxWgGroups", MAX_WG_GROUPS)):
        assert re.search(rf"constexpr int {name} = {value};", SRC), name
    for line in ("kLine = 2 * kHalfW * kCin * 2",
                 "kG = (kXBytes + 1023) / 1024 * 1024",
                 "x_box[4] = {kHalfW * kCin, 2, Bb::IH, Bb::ID}",
                 "8 * (w0 - 1), 0, 2 * h0 - 2",
                 "wgmma_desc(smem, 128, Stage::kLine)",
                 "pw[((first + j) * 20 + e) * 128] = acc[j][e]",
                 "16u * uint32_t((wq * 2 + (mat & 1)) ^ r8)",
                 "CU_TENSOR_MAP_SWIZZLE_128B",
                 # the split copy's thread map (split() below)
                 "const int b = int(i & 7);",
                 "line = (2LL * dd + (b >> 2)) * (2 * Hf) + 2 * hh + "
                 "((b >> 1) & 1);",
                 "const T* src = xf + i * cin;",
                 "xs + ((line * 2 + (b & 1)) * Wf + k) * kCin"):
        assert line in SRC, line
    assert "stem_pack_kernel" not in SRC
    assert G_OFF == 45056


def frag_to_dw(i):
    """csrc/stem_wgrad.cu::frag_to_dw: entry i = (G 20 + e) 128 + t of a
    wgmma partial -> its index in dW (64, 8, 125)."""
    t, e, G = i & 127, (i >> 7) % 20, (i >> 7) // 20
    lane, (kd, kw), kh = t & 31, divmod(G, 5), e >> 2
    co = (t >> 5) * 16 + (lane >> 2) + 8 * ((e >> 1) & 1)
    ci = 2 * (lane & 3) + (e & 1)
    return (co * CIN + ci) * 125 + kd * 25 + kh * 5 + kw


def test_partial_layout_maps_onto_dw_once():
    idx = [frag_to_dw(i) for i in range(COUT * CIN * 125)]
    assert sorted(idx) == list(range(COUT * CIN * 125))


def wg_groups(y, c):
    """The (kd, kw) groups [first, first + count) of consumer warpgroup c
    of blockIdx.y (wg_first_group, wg_group_count)."""
    cta = GROUPS - CTA_GROUPS if y else CTA_GROUPS
    first = y * CTA_GROUPS + ((cta + 1) // 2 if c else 0)
    return first, (cta // 2 if c else (cta + 1) // 2)


def test_groups_cover_every_tap_once_none_padded():
    seen, counts = [], []
    for y in (0, 1):
        for c in (0, 1):
            first, count = wg_groups(y, c)
            counts.append(count)
            seen += list(range(first, first + count))
    assert sorted(seen) == list(range(GROUPS)) and counts == [7, 6, 6, 6]
    assert max(counts) == MAX_WG_GROUPS  # 140 f32 accumulators a thread
    taps = [kd * 25 + kh * 5 + kw for G in seen
            for kd, kw in [divmod(G, 5)] for kh in range(5)]
    assert sorted(taps) == list(range(125))


@pytest.mark.parametrize("out_shape,bf16,grid,slices", [
    ((64, 64, 64), True, (32, 16, 4), 66),
    ((64, 64, 64), False, (64, 16, 4), 66),
    ((8, 8, 8), True, (4, 2, 1), 8),
    ((7, 10, 19), True, (4, 3, 2), 24),
])
def test_launch_plan(out_shape, bf16, grid, slices):
    plan = launch_plan(out_shape, bf16, SMS)
    assert plan["grid"] == grid and plan["slices"] == slices
    assert plan["nbricks"] == int(np.prod(grid))
    flat = [b for lo, hi in plan["ranges"] for b in range(lo, hi)]
    assert flat == list(range(plan["nbricks"]))  # in order, each once
    sizes = [hi - lo for lo, hi in plan["ranges"]]
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1


def xrow(id_, ih, iw):
    """The staged 16-byte row of input position (id, ih, iw) of a brick:
    line (id, ih), its parity iw & 1, position iw >> 1."""
    return ((id_ * IH + ih) * 2 + (iw & 1)) * HALF + (iw >> 1)


def group_bytes(G):
    kd, kw = divmod(G, 5)
    return 16 * xrow(kd, 0, kw)


def split(xf):
    """stem_split_kernel: xf (Df, Hf, Wf, 8 cin) folded -> (2 Df, 2 Hf, 2,
    Wf, 8), thread by thread: thread i = 8 v + b reads cin channels from
    element i cin of xf and writes the row of line (2 dd + fd, 2 hh + fh),
    parity fw, position k, b = (fd, fh, fw) and v = (dd Hf + hh) Wf + k;
    the channels past cin zero. Every row is written exactly once."""
    Df, Hf, Wf, c8 = xf.shape
    cin = c8 // 8
    flat = xf.reshape(-1)
    xs = np.full((2 * Df, 2 * Hf, 2, Wf, CIN), np.nan)
    for i in range(Df * Hf * Wf * 8):
        b, v = i & 7, i >> 3
        k, dh = v % Wf, v // Wf
        hh, dd = dh % Hf, dh // Hf
        d, h = 2 * dd + (b >> 2), 2 * hh + ((b >> 1) & 1)
        assert np.isnan(xs[d, h, b & 1, k]).all()
        xs[d, h, b & 1, k] = np.pad(flat[i * cin:(i + 1) * cin],
                                    (0, CIN - cin))
    assert not np.isnan(xs).any()
    return xs


def g_elem(v, co):
    """The element of the staged g tile holding voxel v, channel co: row v
    of 128 bytes, its 16-byte chunk co // 8 at chunk (co // 8) ^ (v % 8)."""
    return v * 64 + ((co // 8) ^ (v % 8)) * 8 + co % 8


def a_fragment(gt, r, wq):
    """The 16 x 16 A tile (output channels 16 wq.., the 16 voxels of brick
    row r) as warp wq's lanes hold it after ldmatrix.x4.trans: lane l gives
    the address of row l % 8 of matrix l // 8 (voxel 16 r + 8 (m // 2) +
    l % 8, chunk 2 wq + m % 2, swizzled); thread (g, q) gets of matrix m the
    elements [2q + h][g] (h = 0, 1), which are its m16n8k16 fragment
    register m: rows g (+8 for m odd), k 2q + h (+8 for m >= 2)."""
    addr = []
    for m in range(4):
        for i in range(8):
            v = r * BW + (m >> 1) * 8 + i
            addr.append(v * 64 + (((2 * wq + (m & 1)) ^ (v % 8)) * 8))
    a = np.full((16, 16), np.nan)
    for lane in range(32):
        g, q = lane >> 2, lane & 3
        for m in range(4):
            for h in range(2):
                a[g + 8 * (m & 1), 2 * q + h + 8 * (m >> 1)] = \
                    gt[addr[8 * m + 2 * q + h] + g]
    return a


def b_tile(xs_flat, start):
    """B (16 voxels x 40 = 5 kh x 8 channels) through the descriptor:
    element (k, n) at byte start + (k // 8) LBO + (k % 8) 16 + (n // 8) SBO
    + (n % 8) 2."""
    k = np.arange(16)[:, None]
    n = np.arange(40)[None, :]
    byte = start + (k // 8) * LBO + (k % 8) * 16 + (n // 8) * SBO + (n % 8) * 2
    assert (byte % 2 == 0).all()
    return xs_flat[byte // 2], byte // 16


def emulate(xf, g):
    """xf (Df, Hf, Wf, 8 cin) folded, g (Df, Hf, Wf, 64) float64 -> dW (64,
    8, 125) in the kernel's plan and order, with the plan's invariants
    asserted."""
    D, H, W = (2 * n for n in xf.shape[:3])
    Do, Ho, Wo, _ = g.shape
    plan = launch_plan((Do, Ho, Wo), True, SMS)
    BD, BH, _ = plan["brick"]
    nbd, nbh, nbw = plan["grid"]
    assert (2 * BD + 3, 2 * BH + 3) == (ID, IH)
    # every input position a brick reads has its own staged row
    rows_of = [xrow(i, j, k) for i in range(ID) for j in range(IH)
               for k in range(2 * BW + 3)]
    assert len(set(rows_of)) == len(rows_of) and max(rows_of) < G_OFF // 16
    xsplit = split(xf)
    wh = xsplit.shape[3]
    covered = np.zeros((Do, Ho, Wo), np.int64)
    partials = np.zeros((plan["slices"], GROUPS * 20 * 128))
    for c, (b0, b1) in enumerate(plan["ranges"]):
        for y in (0, 1):
            for cw in (0, 1):
                first, count = wg_groups(y, cw)
                for b in range(b0, b1):
                    bw_, rest = b % nbw, b // nbw
                    d0, h0, w0 = (rest // nbh) * BD, (rest % nbh) * BH, bw_ * BW
                    # the x box at map coordinates (8 (w0 - 1), 0, 2 h0 - 2,
                    # 2 d0 - 2) of the split volume (8 ceil(W / 2), 2, H, D)
                    xs = np.full((G_OFF // 16, CIN), np.nan)
                    for i in range(ID):
                        for j in range(IH):
                            for par in range(2):
                                for k in range(HALF):
                                    gd, gh = 2 * d0 - 2 + i, 2 * h0 - 2 + j
                                    w2 = w0 - 1 + k
                                    ok = (0 <= gd < D and 0 <= gh < H
                                          and 0 <= w2 < wh)
                                    xs[((i * IH + j) * 2 + par) * HALF + k] = \
                                        xsplit[gd, gh, par, w2] if ok else 0.0
                    # the g box at (0, w0, h0, d0), 128-byte swizzle
                    gt = np.full(BD * BH * BW * 64, np.nan)
                    for v in range(BD * BH * BW):
                        od, oh = d0 + v // (BH * BW), h0 + (v // BW) % BH
                        ow = w0 + v % BW
                        ok = od < Do and oh < Ho and ow < Wo
                        for co in range(COUT):
                            gt[g_elem(v, co)] = g[od, oh, ow, co] if ok else 0.0
                        if ok and y == 0 and cw == 0:
                            covered[od, oh, ow] += 1
                    xs_flat = xs.reshape(-1)
                    for r in range(BD * BH):
                        bd, bh = divmod(r, BH)
                        a = np.concatenate([a_fragment(gt, r, wq)
                                            for wq in range(4)])
                        vox = np.arange(r * BW, (r + 1) * BW)
                        assert np.array_equal(a, gt[[[g_elem(v, co)
                                                      for v in vox]
                                                     for co in range(COUT)]])
                        row0 = 16 * xrow(2 * bd, 2 * bh, 0)
                        for G in range(first, first + count):
                            kd, kw = divmod(G, 5)
                            bt, brow = b_tile(xs_flat, row0 + group_bytes(G))
                            want = np.array([[xrow(2 * bd + kd, 2 * bh + n // 8,
                                                   2 * ow + kw)
                                              for n in range(40)]
                                             for ow in range(16)])
                            assert np.array_equal(brow, want)
                            assert not np.isnan(bt).any()
                            d = a @ bt  # (64, 40)
                            # wgmma's accumulator layout: register e of lane
                            # (gq, q) of warp wq holds row 16 wq + gq + 8
                            # ((e >> 1) & 1), column 8 (e >> 2) + 2 q + (e & 1)
                            for wq in range(4):
                                for lane in range(32):
                                    gq, q = lane >> 2, lane & 3
                                    for e in range(20):
                                        co = 16 * wq + gq + 8 * ((e >> 1) & 1)
                                        n = 8 * (e >> 2) + 2 * q + (e & 1)
                                        partials[c, (G * 20 + e) * 128
                                                 + 32 * wq + lane] += d[co, n]
    assert (covered == 1).all()
    summed = np.zeros(GROUPS * 20 * 128)
    for c in range(plan["slices"]):
        summed += partials[c]
    out = np.zeros(COUT * CIN * 125)
    out[[frag_to_dw(i) for i in range(summed.size)]] = summed
    return out.reshape(COUT, CIN, 125)


@pytest.mark.parametrize("shape", [(16, 16, 16), (10, 34, 18), (10, 18, 34),
                                   (14, 20, 38)],
                         ids=["cube", "asymmetric", "asymmetric_w", "ragged"])
def test_emulated_plan_matches_plain_float64(shape):
    """The grid volume of `shape` folded as the stem folds it; ragged: the
    (7, 10, 19) output bricks are cut at every edge."""
    rng = np.random.default_rng(sum(shape))
    out_shape = tuple((n - 1) // 2 + 1 for n in shape)
    x = rng.normal(size=(*shape, 7))  # the ResNet's 7 grid channels
    g = rng.normal(size=(*out_shape, COUT))
    got = emulate(fold_volume(torch.from_numpy(x)[None])[0].numpy(), g)
    want = stem_wgrad_plain(
        torch.from_numpy(x)[None],
        torch.from_numpy(np.ascontiguousarray(g.transpose(3, 0, 1, 2)))[None])
    want = want.numpy().reshape(COUT, 7, 125)
    assert np.abs(want).max() > 1.0
    np.testing.assert_allclose(got[:, :7], want, rtol=0,
                               atol=1e-12 * np.abs(want).max())
    assert np.abs(got[:, 7]).max() == 0.0  # the padded channel

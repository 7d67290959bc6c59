"""The hash-encoding backward kernel's grouped adds, checked on the CPU.

csrc/hash_encoding.cu runs on the card only, so its backward is emulated
here in numpy, in the kernel's order: warps of 32 consecutive rows (the last
one ragged), the levels in order; on each level the warp's rows are grouped
by their point's cell (`cell_group`'s `__match_any_sync`), and for each of
the 8 corners a group sums w_c * g over its rows in lane order in float32
and adds the sum once (one vector atomic) into the table gradient
(`add_group`); dx is summed over the corners and levels and scaled by
clip's gradient. The emulated gradients
are held against hash_encoding_plain's autograd (index_add_) and against
jax.vjp of neraf_tpu.ops.hashgrid.hash_encoding, at 1e-6 of each one's
peak, and the adds it makes are what ops/hashgrid.py::bwd_atomics counts.
bwd_atomics and the forward's sector count (fwd_sectors) are pinned on
hand-built point sets.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neraf_tpu.ops import hashgrid as jhashgrid
from neraf_tpu_torch.models.grid import cell_centers
from neraf_tpu_torch.ops import hashgrid

WARP = 32
TOL = 1e-6  # of each gradient's peak
# (levels, log2 table rows, base res, max res): the tiny grid (res 4-32,
# two dense levels and two hashed), one dense level (res 8) beside one
# hashed (res 32), and three hashed levels (res 8-32) in 256 rows, where
# the rows of distinct cells collide
SPECS = {"tiny": (4, 10, 4, 32), "dense_hashed": (2, 12, 8, 32),
         "hashed": (3, 8, 8, 32)}
POINTS = ("bounds", "ragged", "bake", "ray", "face")


def _specs(name, F):
    L, lt, base, top = SPECS[name]
    kw = dict(num_levels=L, log2_hashmap_size=lt, base_res=base, max_res=top,
              features_per_level=F)
    return hashgrid.HashGridSpec(**kw), jhashgrid.HashGridSpec(**kw)


def _points(kind: str, rng) -> np.ndarray:
    """bounds: 200 points in [-0.1, 1.1]^3 (6 warps and 8 rows), some at
    exactly 0 and 1; ragged: 103 in [0, 1]^3; bake: 18 directions x 24
    cells of an 8^3 grid, direction-major, as models/grid.py repeats a
    cell's position once a direction; ray: 3 rays of 48 samples in order;
    face: 2 rays of 40 samples on the face x = 1 (half of them beyond it,
    clipped), where the cell's upper corners clamp onto its lower ones."""
    if kind == "bounds":
        x = rng.uniform(-0.1, 1.1, (200, 3))
        x[:5], x[5:9] = 0.0, 1.0
        x[9, 0], x[10, 1], x[11, 2] = 0.0, 1.0, 0.0
    elif kind == "ragged":
        x = rng.uniform(0.0, 1.0, (3 * WARP + 7, 3))
    elif kind == "bake":
        x = np.tile(cell_centers(8)[:24], (18, 1))
    elif kind == "face":
        t = np.linspace(0.0, 1.0, 40)[None, :, None]
        x = (rng.uniform(0.1, 0.3, (2, 1, 3)) + t * 0.5).reshape(-1, 3)
        x[:, 0] = np.where(np.arange(80) % 2 == 0, 1.0, 1.05)
    else:
        o = rng.uniform(0.1, 0.3, (3, 1, 3))
        d = rng.uniform(0.2, 0.6, (3, 1, 3))
        t = np.linspace(0.0, 1.0, 48)[None, :, None]
        x = (o + t * d).reshape(-1, 3)
    return x.astype(np.float32)


def emulate_bwd(table, x, g, spec):
    """The kernel's backward in numpy: table (L, T, F), x (N, 3), g (N, L*F)
    float32 -> (d_table (L, T, F), dx (N, 3), the vector adds made)."""
    L, T, F = spec.num_levels, spec.table_size, spec.features_per_level
    xc = np.clip(x, 0.0, 1.0)
    rows, w = hashgrid.hash_corners(torch.from_numpy(xc), spec)
    rows, w = rows.numpy(), w.numpy()  # (L, N, 8) flat rows, weights
    res = spec.resolutions()
    cells = np.floor(xc[None] * res[:, None, None].astype(np.float32))
    flat = table.reshape(L * T, F)
    d_table = np.zeros((L * T, F), np.float32)
    adds = 0
    for row0 in range(0, x.shape[0], WARP):
        lanes = np.arange(row0, min(row0 + WARP, x.shape[0]))
        for l in range(L):
            gl = g[lanes, l * F:(l + 1) * F]
            v = w[l, lanes][:, :, None] * gl[:, None]  # (lanes, 8, F) f32
            _, group = np.unique(cells[l, lanes], axis=0, return_inverse=True)
            groups = [np.flatnonzero(group.ravel() == k)
                      for k in range(group.max() + 1)]
            for members in groups:  # each in lane order
                for c in range(8):
                    s = np.zeros(F, np.float32)
                    for m in members:
                        s = s + v[m, c]
                    d_table[rows[l, lanes[members[0]], c]] += s
                    adds += 1
    # dx: d/dxc of each corner's weight times (feature . g) times res,
    # summed over corners and levels in registers
    dxs = np.zeros(x.shape, np.float32)
    for l in range(L):
        pos = xc * np.float32(res[l])
        frac = pos - np.floor(pos)
        gl = g[:, l * F:(l + 1) * F]
        dpos = np.zeros(x.shape, np.float32)
        for c, bits in enumerate(hashgrid.CORNERS):
            ax = [frac[:, d] if bits[d] else np.float32(1.0) - frac[:, d]
                  for d in range(3)]
            dw = [ax[1] * ax[2], ax[0] * ax[2], ax[0] * ax[1]]
            dot = (flat[rows[l, :, c]] * gl).sum(axis=1, dtype=np.float32)
            for d in range(3):
                dpos[:, d] += (dw[d] if bits[d] else -dw[d]) * dot
        dxs += dpos * np.float32(res[l])
    clip_grad = np.where((x < 0.0) | (x > 1.0), 0.0,
                         np.where((x == 0.0) | (x == 1.0), 0.5, 1.0))
    return d_table.reshape(L, T, F), dxs * clip_grad.astype(np.float32), adds


@functools.lru_cache(maxsize=None)
def _case(spec_name: str, F: int, points: str):
    """Inputs made with numpy from a seed, and the plain version's and the
    JAX package's gradients of sum(encoding * g) in the table and x."""
    spec, jspec = _specs(spec_name, F)
    rng = np.random.default_rng(len(spec_name) * 10 + F + POINTS.index(points))
    x = _points(points, rng)
    table = rng.uniform(-1.0, 1.0, (spec.num_levels, spec.table_size,
                                    F)).astype(np.float32)
    g = rng.normal(size=(x.shape[0], spec.out_dim)).astype(np.float32)
    tt = torch.from_numpy(table).requires_grad_()
    xx = torch.from_numpy(x).requires_grad_()
    out = hashgrid.hash_encoding_plain(tt, xx, spec)
    (out * torch.from_numpy(g)).sum().backward()
    _, vjp = jax.vjp(lambda t, p: jhashgrid.hash_encoding(t, p, jspec),
                     jnp.asarray(table), jnp.asarray(x))
    jd_table, jdx = (np.asarray(a) for a in vjp(jnp.asarray(g)))
    return (spec, table, x, g, {"plain": (tt.grad.numpy(), xx.grad.numpy()),
                                "jax": (jd_table, jdx)})


@pytest.mark.parametrize("points", POINTS)
@pytest.mark.parametrize("F", [2, 4])
@pytest.mark.parametrize("spec_name", list(SPECS))
def test_aggregated_backward_matches_plain_and_jax(spec_name, F, points):
    spec, table, x, g, refs = _case(spec_name, F, points)
    d_table, dx, adds = emulate_bwd(table, x, g, spec)
    for ref_name, (ref_dt, ref_dx) in refs.items():
        for got, want, what in ((d_table, ref_dt, "d_table"), (dx, ref_dx, "dx")):
            np.testing.assert_allclose(
                got, want, rtol=0, atol=TOL * np.abs(want).max(),
                err_msg=f"{what} against {ref_name}")
    counts = hashgrid.bwd_atomics(torch.from_numpy(x), spec)
    sectors = hashgrid.fwd_sectors(torch.from_numpy(x), spec)
    assert len(sectors) == spec.num_levels
    assert all(8 <= k <= 8 * x.shape[0] for k in sectors)
    assert adds == counts["aggregated"]
    assert counts["scalar"] == 8 * spec.num_levels * F * x.shape[0]
    assert counts["distinct"] <= counts["aggregated"] <= 8 * (
        spec.num_levels * x.shape[0])
    if points == "bake":  # 18 copies of 24 cells: warps repeat rows
        assert counts["aggregated"] < 8 * spec.num_levels * x.shape[0]


def _one_dense_level(F=4):
    """One dense level at res 16 (17^3 corners in 2^13 rows)."""
    spec = hashgrid.HashGridSpec(num_levels=1, log2_hashmap_size=13,
                                 base_res=16, max_res=16, features_per_level=F)
    assert spec.dense_levels().all() and spec.resolutions()[0] == 16
    return spec


def test_atomics_all_rows_equal():
    """70 copies of one point (warps of 32, 32, 6) on the tiny grid: a
    warp's rows form one group for each level and corner; the 8 corners of
    the point's cell are 8 rows on each level."""
    spec, _ = _specs("tiny", 2)
    x = torch.tensor([[0.3, 0.6, 0.7]]).repeat(70, 1)
    assert hashgrid.bwd_atomics(x, spec) == {
        "scalar": 8 * 4 * 2 * 70,
        "aggregated": 3 * 4 * 8,
        "distinct": 3 * 4 * 8,
    }
    # the forward: one sector a warp and corner on every level
    assert hashgrid.fwd_sectors(x, spec) == [3 * 8] * 4


def test_atomics_all_rows_different():
    """32 points at the centres of the cells (0, 2j, 2k) of a res-16 grid
    (j < 4, k < 8): no two share a corner, so nothing is merged."""
    spec = _one_dense_level()
    j, k = np.meshgrid(np.arange(4), np.arange(8), indexing="ij")
    cells = np.stack([np.zeros(32), 2 * j.ravel(), 2 * k.ravel()], axis=1)
    x = torch.tensor((cells + 0.5) / 16.0, dtype=torch.float32)
    assert hashgrid.bwd_atomics(x, spec) == {
        "scalar": 8 * 4 * 32, "aggregated": 8 * 32, "distinct": 8 * 32}
    # rows of one corner 34 or more apart: each in a sector of its own
    assert hashgrid.fwd_sectors(x, spec) == [8 * 32]


def test_atomics_one_ray_of_coherent_samples():
    """48 samples along z at x = y = 5.5 / 16 on a res-16 grid, sample k at
    z = (k + 0.5) / 48, in cell k // 3: warp 0 (k < 32) spans cells 0-10,
    warp 1 cells 10-15. Each cell is one group a corner; a warp's distinct
    rows are the 2 x 2 columns of corners over its cells' z range plus one."""
    spec = _one_dense_level()
    z = (np.arange(48) + 0.5) / 48.0
    x = torch.tensor(np.stack([np.full(48, 5.5 / 16), np.full(48, 5.5 / 16),
                               z], axis=1), dtype=torch.float32)
    assert hashgrid.bwd_atomics(x, spec) == {
        "scalar": 8 * 4 * 48,
        "aggregated": 8 * 11 + 8 * 6,
        "distinct": 4 * 12 + 4 * 7,
    }
    # a corner's rows 17^2 apart from cell to cell: one sector a cell
    assert hashgrid.fwd_sectors(x, spec) == [8 * 11 + 8 * 6]


@pytest.mark.cuda
@pytest.mark.parametrize("points", POINTS)
@pytest.mark.parametrize("F", [2, 4])
def test_kernel_matches_the_emulation_on_card(F, points):
    """The backward kernel (through hash_encoding_bwd_cuda) on the tiny grid
    against the emulation: the table gradient and dx to 1e-5 of each one's
    peak (the kernel's atomics add the groups in another order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel has no CPU mode)")
    from neraf_tpu_torch.ops.cuda.hash_encoding import hash_encoding_bwd_cuda

    spec, table, x, g, _ = _case("tiny", F, points)
    want_dt, want_dx, _ = emulate_bwd(table, x, g, spec)
    tt, xx, gg = (torch.from_numpy(a).cuda() for a in (table, x, g))
    d_table, dx = hash_encoding_bwd_cuda(tt, xx, gg, spec)
    torch.cuda.synchronize()
    for got, want in ((d_table, want_dt), (dx, want_dx)):
        np.testing.assert_allclose(got.cpu().numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())

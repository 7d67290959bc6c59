"""The Griffin-Lim kernel's index plan, checked on the CPU.

csrc/griffin_lim.cu runs on the card only, so its index arithmetic is
emulated here in numpy, one formula for each line of the kernel it mirrors:
the register FFT's lane layout (lane l holds points l + 32 s), its stages,
twiddle exponents and exchange permutation (`warp_fft`, `load_twiddles`,
`swz`), the real packing and the split step through the mirror lane, and the
inverse split step with the inverse FFT as the conjugate of the forward one.
In float64 the emulation must match numpy's FFTs to rounding (1e-12 of the
peak). The launch plan (`gl_launch_plan`) is pinned at the geometries the
port serves.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest

from neraf_tpu_torch.ops.cuda import griffin_lim as gl_cuda

W = 32  # kWarp
SRC = Path(gl_cuda.__file__).resolve().parents[2] / "csrc" / "griffin_lim.cu"


def stages(P):
    """(p, rho) of each stage: p = 1, then p *= rho (`stage_radix`)."""
    R, p, out = P // W, 1, []
    while p < P:
        rho = min(R, P // p)
        out.append((p, rho))
        p *= rho
    return out


def swz(j):
    """`swz`: row a = j // 16 permutes its 16 slots by (a ^ 2a ^ 4a) mod 16."""
    a = j >> 4
    return j ^ ((a ^ (a << 1) ^ (a << 2)) & 15)


def twiddle_exponents(P, lane):
    """`load_twiddles`: for each stage after the first, for b < R / rho and
    s in 1..rho-1, the exponent s k (2P / (rho p)) of exp(-2 pi i / 2P),
    k = (lane + 32 b) mod p, in the order of the register array."""
    R, out = P // W, []
    for p, rho in stages(P)[1:]:
        for b in range(R // rho):
            k = (lane + W * b) & (p - 1)
            out += [s * k * (2 * P // (rho * p)) for s in range(1, rho)]
    return out


def warp_fft(v, P):
    """`warp_fft` on all 32 lanes: v[l, s] is point l + 32 s on entry and bin
    l + 32 s on exit; stores and loads go through one buffer of P slots."""
    R, N = P // W, 2 * P
    tw_g = np.exp(-2j * np.pi * np.arange(N) / N)
    twr = [tw_g[twiddle_exponents(P, lane)] for lane in range(W)]
    v = v.copy()
    for p, rho in stages(P):
        nb, off, last = R // rho, 0, p * rho == P
        off = sum((R // r) * (r - 1) for q, r in stages(P)[1:] if q < p)
        buf = np.full(P, np.nan, complex)
        out = v.copy()
        for lane in range(W):
            for b in range(nb):
                a = np.array([v[lane, b + s * nb] for s in range(rho)])
                if p > 1:
                    a[1:] *= twr[lane][off + b * (rho - 1):off + (b + 1) * (rho - 1)]
                a = np.fft.fft(a)  # `dft<rho>`
                i = lane + W * b
                k = i & (p - 1)
                for t in range(rho):
                    if last:
                        out[lane, b + t * nb] = a[t]
                    else:
                        buf[swz((i - k) * rho + k + t * p)] = a[t]
        if not last:
            assert not np.isnan(buf).any()  # every slot written once
            out = np.array([[buf[swz(lane + W * s)] for s in range(R)]
                            for lane in range(W)])
        v = out
    return v


def to_lanes(x, P):
    return np.array([[x[lane + W * s] for s in range(P // W)] for lane in range(W)])


def from_lanes(v):
    return v.T.reshape(-1)  # bin lane + 32 s


def mirror(v, lane, j):
    """Z[P - k] for k = lane + 32 j: the shuffle from lane (32 - lane) mod
    32 of its v[R - 1 - j]; lane 0 holds its own, v[(R - j) mod R]."""
    R = v.shape[1]
    return v[0, (R - j) % R] if lane == 0 else v[(W - lane) % W, R - 1 - j]


@pytest.mark.parametrize("P", [128, 256, 512])
def test_register_fft_matches_numpy(P):
    rng = np.random.default_rng(P)
    x = rng.normal(size=P) + 1j * rng.normal(size=P)
    got = from_lanes(warp_fft(to_lanes(x, P), P))
    ref = np.fft.fft(x)
    assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()
    assert len(twiddle_exponents(P, 0)) == {128: 8, 256: 13, 512: 23}[P]


@pytest.mark.parametrize("P", [128, 256, 512])
def test_split_steps_match_rfft_and_irfft(P):
    """The analysis (packing, FFT, split step) against np.fft.rfft, and the
    synthesis of C = X / P (inverse split step, conj(FFT(conj Z'))) back to
    the frame, as the kernel runs them."""
    N, R = 2 * P, P // W
    rng = np.random.default_rng(P + 1)
    frame = rng.normal(size=N)
    tw = np.exp(-2j * np.pi * np.arange(N) / N)
    z = to_lanes(frame[0::2] + 1j * frame[1::2], P)
    Z = warp_fft(z, P)
    X = np.zeros(P + 1, complex)
    for lane in range(W):
        for j in range(R):
            k = lane + W * j
            zk, zc = Z[lane, j], np.conj(mirror(Z, lane, j))
            e, o = (zk + zc) / 2, -1j * (zk - zc) / 2
            X[k] = e + tw[k] * o
            if k == 0:
                X[P] = e - o
    ref = np.fft.rfft(frame)
    assert np.abs(X - ref).max() <= 1e-12 * np.abs(ref).max()

    C = to_lanes(ref[:P] / P, P)
    zp = np.zeros((W, R), complex)
    for lane in range(W):
        for j in range(R):
            k = lane + W * j
            cc = np.conj(ref[P] / P if k == 0 else mirror(C, lane, j))
            e, o = (C[lane, j] + cc) / 2, (C[lane, j] - cc) / 2 * np.conj(tw[k])
            zp[lane, j] = np.conj(e + 1j * o)
    r = np.conj(from_lanes(warp_fft(zp, P)))
    back = np.stack([r.real, r.imag], -1).reshape(-1)
    assert np.abs(back - frame).max() <= 1e-12 * np.abs(frame).max()


@pytest.mark.parametrize("P", [128, 256, 512])
def test_exchanges_are_free_of_bank_conflicts(P):
    """Each exchange's stores (stage outputs) and loads (points lane + 32 s)
    touch 16 distinct 8-byte slots of a 128-byte row in each half-warp, and
    `swz` permutes the buffer within its rows."""
    R = P // W
    lanes = np.arange(W)
    accesses = [lanes + W * s for s in range(R)]
    for p, rho in stages(P):
        if p * rho < P:
            for t in range(rho):
                k = lanes & (p - 1)
                accesses.append((lanes - k) * rho + k + t * p)
    assert len(accesses) > R
    for j in accesses:
        phys = swz(j)
        for half in (phys[:16], phys[16:]):
            assert len(set(half % 16)) == 16, (P, j)
    perm = swz(np.arange(P))
    assert sorted(perm) == list(range(P)) and (perm >> 4 == np.arange(P) >> 4).all()


# (n_fft, hop, T) -> (warps, shared memory bytes)
PLANS = {
    (512, 128, 78): (20, 187_712),   # SoundSpaces, served: one round a class
    (1024, 256, 60): (8, 215_168),   # RAF: rounds of 8 and 7
    (256, 64, 64): (16, 76_544),     # n_fft 256
    (512, 128, 12): (3, 32_816),     # the tiny SoundSpaces slice
    (256, 64, 200): (17, 148_752),   # 50 frames a class: 3 rounds
}


@pytest.mark.parametrize("geo", sorted(PLANS))
def test_launch_plan(geo):
    n_fft, hop, T = geo
    length = hop * (T - 1)
    plan = gl_cuda.gl_launch_plan(n_fft, hop, T, length)
    assert tuple(plan) == PLANS[geo]
    assert plan.smem_bytes == gl_cuda.gl_smem_bytes(n_fft, hop, T, length,
                                                    plan.warps)
    frames = -(-T // (n_fft // hop))
    rounds = -(-frames // plan.warps)
    # whole rounds, none idle, the frames spread evenly over them
    assert plan.warps * (rounds - 1) < frames <= plan.warps * rounds
    assert plan.warps == -(-frames // rounds)
    assert plan.warps <= gl_cuda.MAX_WARPS[n_fft]
    # one block and the driver's 1 KB beside it fit an SM's 228 KB
    assert plan.smem_bytes + 1024 <= 228 * 1024 == gl_cuda.SMEM_PER_BLOCK + 1024
    # no plan with fewer rounds fits
    fewer = -(-frames // (rounds - 1)) if rounds > 1 else None
    if fewer is not None:
        assert (fewer > gl_cuda.MAX_WARPS[n_fft]
                or gl_cuda.gl_smem_bytes(n_fft, hop, T, length, fewer)
                > gl_cuda.SMEM_PER_BLOCK)


def test_plan_constants_match_the_kernel_source():
    src = SRC.read_text()
    m = re.search(r"max_warps\(int N\) \{ return N == 1024 \? (\d+) : (\d+); \}", src)
    assert m, "max_warps not found in csrc/griffin_lim.cu"
    assert gl_cuda.MAX_WARPS == {256: int(m[2]), 512: int(m[2]), 1024: int(m[1])}
    assert "j ^ ((a ^ (a << 1) ^ (a << 2)) & 15)" in src  # swz above
    with pytest.raises(ValueError, match="does not fit"):
        gl_cuda.gl_launch_plan(1024, 256, 600, 256 * 599)

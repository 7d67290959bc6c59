"""The port's STFT and Griffin-Lim against the JAX package, on the CPU.

Inputs come from numpy with a seed and go through both packages; the JAX
Pallas kernel runs in interpret mode. Geometries: SoundSpaces (n_fft 512,
hop 128, win 512) and RAF (n_fft 1024, hop 256, win 512 zero-padded).
"""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neraf_tpu.dsp import stft as jstft
from neraf_tpu.dsp.griffin_lim import _griffin_lim_matmul
from neraf_tpu.ops.pallas.griffin_lim_kernel import griffin_lim_pallas
from neraf_tpu_torch.dsp import stft as tstft
from neraf_tpu_torch.dsp.griffin_lim import (
    griffin_lim,
    griffin_lim_plain,
    random_angles,
)
from neraf_tpu_torch.ops.cuda import griffin_lim as gl_cuda
from neraf_tpu_torch.utils.profiling import counters

GEOMETRIES = {"soundspaces": (512, 128, 512), "raf": (1024, 256, 512)}


def _signal(rng, n, length):
    t = np.arange(length) / length
    return (rng.normal(size=(n, length)) * np.exp(-6 * t)).astype(np.float32)


def test_log_to_magnitude_matches_jax(rng):
    # exp/log in float32 on both sides: a few ulp of values up to 1e4
    x = rng.uniform(-12.0, 12.0, size=(4, 257, 9)).astype(np.float32)
    out = tstft.log_to_magnitude(torch.from_numpy(x)).numpy()
    ref = np.asarray(jstft.log_to_magnitude(jnp.asarray(x)))
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-7)
    back = tstft.log_magnitude(torch.from_numpy(out)).numpy()
    np.testing.assert_allclose(
        back, np.asarray(jstft.log_magnitude(jnp.asarray(ref))),
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("geo", sorted(GEOMETRIES))
def test_stft_istft_match_jax(geo, rng):
    # pocketfft (torch) vs XLA's FFT in float32: sums of n_fft terms of
    # O(1) values, ~1e-5 absolute
    n_fft, hop, win = GEOMETRIES[geo]
    x = _signal(rng, 3, hop * 9)
    spec = tstft.stft_complex(torch.from_numpy(x), n_fft, hop, win).numpy()
    ref = np.asarray(jstft.stft_complex(jnp.asarray(x), n_fft, hop, win))
    assert spec.shape == ref.shape == (3, n_fft // 2 + 1, 10)
    np.testing.assert_allclose(spec, ref, atol=5e-5, rtol=1e-4)

    # a spectrum that is not an STFT, with imaginary DC/Nyquist parts that
    # irfft must drop
    z = (rng.normal(size=ref.shape) + 1j * rng.normal(size=ref.shape))
    z = z.astype(np.complex64)
    wav = tstft.istft(torch.from_numpy(z), n_fft, hop, win).numpy()
    wref = np.asarray(jstft.istft(jnp.asarray(z), n_fft=n_fft,
                                  hop_length=hop, win_length=win))
    assert wav.shape == wref.shape == (3, hop * 9)
    np.testing.assert_allclose(wav, wref, atol=5e-5, rtol=1e-4)


def _gl_inputs(rng, geo, M, T):
    n_fft, hop, win = GEOMETRIES[geo]
    mag = np.abs(rng.normal(size=(M, n_fft // 2 + 1, T))).astype(np.float32)
    ang = rng.uniform(0, 2 * np.pi, size=mag.shape)
    return mag, np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


@pytest.mark.parametrize("geo", sorted(GEOMETRIES))
def test_griffin_lim_plain_matches_jax_matmul_and_pallas(geo, rng):
    # the tolerance of tests/test_pallas_gl.py: 4 iterations of float32 GL
    # from the same initial angles through three DFT implementations
    n_fft, hop, win = GEOMETRIES[geo]
    T = 8
    mag, aR, aI = _gl_inputs(rng, geo, 2, T)
    length = hop * (T - 1)
    out = griffin_lim_plain(
        torch.from_numpy(mag), n_fft=n_fft, hop_length=hop, win_length=win,
        n_iter=4, init_angles=torch.from_numpy(aR + 1j * aI)).numpy()
    ref = np.asarray(_griffin_lim_matmul(
        jnp.asarray(mag), jnp.asarray(aR), jnp.asarray(aI), n_fft, hop, win,
        n_iter=4, mom=0.99 / 1.99, length=length))
    pal = np.asarray(griffin_lim_pallas(
        jnp.asarray(mag), n_fft=n_fft, hop_length=hop, win_length=win,
        n_iter=4, length=length, block=2,
        init_angles=(jnp.asarray(aR), jnp.asarray(aI)), interpret=True))
    assert out.shape == ref.shape == pal.shape == (2, length)
    np.testing.assert_allclose(out, ref, atol=5e-4, rtol=1e-3)
    np.testing.assert_allclose(out, pal, atol=5e-4, rtol=1e-3)


def test_griffin_lim_dispatch_on_cpu_is_plain(rng):
    """A CPU tensor goes through the plain loop and launches no kernel;
    the same generator seed gives the same angles."""
    n_fft, hop, win = GEOMETRIES["soundspaces"]
    mag = torch.from_numpy(_gl_inputs(rng, "soundspaces", 3, 6)[0])
    before = counters().get("kernel.griffin_lim", 0)
    out = griffin_lim(mag, n_fft=n_fft, hop_length=hop, win_length=win,
                      n_iter=3, generator=torch.Generator().manual_seed(5))
    ang = random_angles(mag.shape, torch.Generator().manual_seed(5))
    ref = griffin_lim_plain(mag, n_fft=n_fft, hop_length=hop,
                            win_length=win, n_iter=3, init_angles=ang)
    assert counters().get("kernel.griffin_lim", 0) == before
    assert out.shape == (3, hop * 5)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    assert torch.allclose(ang.abs(), torch.ones(()), atol=1e-6)


def test_griffin_lim_reconstructs_tone():
    """The served 32 iterations recover a decaying tone's magnitude to the
    bound of the JAX package's test_pallas_gl_reconstructs_tone."""
    fs, n_fft, hop, win = 22050, 512, 128, 512
    t = np.arange(2048) / fs
    x = (np.sin(2 * np.pi * 600 * t) * np.exp(-t * 10)).astype(np.float32)
    mag = tstft.stft_magnitude(torch.from_numpy(x), n_fft, hop, win)[None]
    wav = griffin_lim(mag, n_fft=n_fft, hop_length=hop, win_length=win,
                      n_iter=32, generator=torch.Generator().manual_seed(0))
    rec = tstft.stft_magnitude(wav, n_fft, hop, win)
    Tm = min(mag.shape[-1], rec.shape[-1])
    err = float(torch.linalg.norm(rec[..., :Tm] - mag[..., :Tm])
                / torch.linalg.norm(mag))
    assert err < 0.2, err


def test_cuda_wrapper_imports_without_nvcc_and_rejects_other_devices():
    """Importing the wrapper builds nothing; a tensor neither on the CPU
    nor on a card raises instead of falling back."""
    code = ("import neraf_tpu_torch.ops.cuda.griffin_lim as g, "
            "neraf_tpu_torch.ops.cuda.build as b, sys; "
            "assert not b.load.cache_info().currsize; "
            "assert 'jax' not in sys.modules; print(b.library_path().name)")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("libneraf_kernels_")
    mag = torch.zeros((1, 257, 4), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        gl_cuda.griffin_lim_cuda(mag, mag.to(torch.complex64), n_fft=512,
                                 hop_length=128)


@pytest.mark.cuda
@pytest.mark.parametrize("geo", sorted(GEOMETRIES))
def test_gl_kernel_matches_plain_on_card(geo, rng):
    """The CUDA kernel against the plain loop on the card, at the served
    frame counts; 4 iterations, the bound of the CPU comparison above."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel has no CPU mode)")
    n_fft, hop, win = GEOMETRIES[geo]
    T = 78 if geo == "soundspaces" else 60
    mag, aR, aI = _gl_inputs(rng, geo, 16, T)
    mag_d = torch.from_numpy(mag).cuda()
    ang_d = torch.from_numpy(aR + 1j * aI).cuda()
    before = counters().get("kernel.griffin_lim", 0)
    out = gl_cuda.griffin_lim_cuda(mag_d, ang_d, n_fft=n_fft,
                                   hop_length=hop, win_length=win, n_iter=4)
    ref = griffin_lim_plain(mag_d, n_fft=n_fft, hop_length=hop,
                            win_length=win, n_iter=4, init_angles=ang_d)
    torch.cuda.synchronize()
    assert counters().get("kernel.griffin_lim", 0) == before + 1
    torch.testing.assert_close(out, ref, atol=5e-4, rtol=1e-3)

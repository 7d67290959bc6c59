"""The port's native C++ ingest (neraf_tpu_torch/native) against its own
Python path on the CPU and against the JAX package's native library
(neraf_tpu.native), in every case of tests/test_native_ingest.py and at its
tolerances: wav reads (int16, float32, 24-bit, mono), malformed wavs
raising, the resampler, the STFT, the batch against preprocessing, the RAF
loader and process_scene native against Python, and the 0.32 s cut. The
decode and the resampler are the JAX library's code and are held to it
bitwise; the STFT is a float64 FFT where that library sums a direct DFT
with a float32 window, so it is held at the tolerances above.

Also: the library is built into build/neraf_tpu_torch/, under a name that
changes with the compiler; NERAF_NATIVE=0 takes the Python path without
touching the library; a missing g++ raises where the JAX package would fall
back; an n_fft that is not a power of two raises; in the RAF loader a wav
the parser refuses, or whose samples the library cannot decode, takes the
Python path and is counted by native.fallbacks(); a wav whose data chunk is
cut short is read the same by both paths.
"""

import struct
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from fixtures import make_raf_scene, make_soundspaces_scene
from neraf_tpu import native as jnative
from neraf_tpu_torch import native
from neraf_tpu_torch.data import datasets, preprocess
from neraf_tpu_torch.dsp.resample import resample_poly
from neraf_tpu_torch.dsp.stft import stft_magnitude
from neraf_tpu_torch.utils.wav import read_wav

REPO = Path(__file__).resolve().parents[1]


def _tone(n, fs=22050, f=500.0, decay=8.0):
    t = np.arange(n) / fs
    return (np.sin(2 * np.pi * f * t) * np.exp(-t * decay)).astype(np.float32)


def _write_wav_manual(path, sr, channels, bits, fmt_code, frames_bytes):
    """A RIFF writer for formats scipy does not emit (24-bit, broken)."""
    byte_rate = sr * channels * bits // 8
    block_align = channels * bits // 8
    fmt = struct.pack("<HHIIHH", fmt_code, channels, sr, byte_rate,
                      block_align, bits)
    riff = (b"WAVE" + b"fmt " + struct.pack("<I", len(fmt)) + fmt +
            b"data" + struct.pack("<I", len(frames_bytes)) + frames_bytes)
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(riff)) + riff)


def _unreachable(*args, **kwargs):
    raise AssertionError("the native library was called under NERAF_NATIVE=0")


def test_library_builds_into_the_build_dir():
    assert native.available()
    path = native.library_path()
    assert path.parent == REPO / "build" / "neraf_tpu_torch"
    assert path.name.startswith("libneraf_ingest_") and path.is_file()
    assert native.SRC == REPO / "neraf_tpu_torch" / "native" / "ingest.cpp"


def test_library_name_follows_the_compiler(monkeypatch):
    path = native.library_path()
    cxx, ver = native._compiler()
    monkeypatch.setattr(native, "_compiler", lambda: (cxx, ver + "other"))
    assert native.library_path() != path
    assert native.library_path().parent == path.parent


def test_stft_needs_a_power_of_two():
    x = _tone(2000)
    with pytest.raises(ValueError, match="power of two"):
        native.stft_magnitude(x, n_fft=400, hop_length=100)
    with pytest.raises(ValueError, match="power of two"):
        native.process_rir_batch([], target_fs=0, n_fft=400, hop=100,
                                 win=400, n_frames=4)


def test_native_off_is_the_python_path(monkeypatch):
    monkeypatch.setenv("NERAF_NATIVE", "0")
    assert not native.available()
    monkeypatch.setenv("NERAF_NATIVE", "1")
    assert native.available()


def test_missing_compiler_raises_not_falls_back(tmp_path, monkeypatch):
    """No g++ and no built library: available() and the loaders raise (the
    JAX package returns False and takes the Python path)."""
    scene = make_raf_scene(tmp_path / "scene")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("PATH", str(tmp_path / "no_bin"))
    native.load.cache_clear()
    try:
        with pytest.raises(RuntimeError, match=r"g\+\+ not found"):
            native.available()
        with pytest.raises(RuntimeError, match=r"g\+\+ not found"):
            datasets.load_raf_dataset(scene, "train")
        assert not (tmp_path / "build").exists()
    finally:
        native.load.cache_clear()


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "ingest.cpp"
    bad.write_text("int broken( {\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    native.load.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+ failed") as e:
            native.load()
        assert "ingest.cpp" in str(e.value) and "error" in str(e.value)
        assert not list((tmp_path / "build").glob("*.so"))
    finally:
        native.load.cache_clear()


def test_wav_read_parity_int16_and_float32(tmp_path):
    x = _tone(4000)
    stereo = np.stack([x, -0.5 * x], axis=1)
    p16 = tmp_path / "i16.wav"
    wavfile.write(p16, 22050, (stereo * 32767).astype(np.int16))
    pf32 = tmp_path / "f32.wav"
    wavfile.write(pf32, 44100, stereo.astype(np.float32))
    for path in (p16, pf32):
        sr_ref, ref = read_wav(path)
        sr_nat, nat = native.read_wav(path)
        sr_j, jnat = jnative.read_wav(path)
        assert sr_nat == sr_ref == sr_j
        assert nat.shape == ref.shape == jnat.shape
        np.testing.assert_allclose(nat, ref, atol=1e-6)
        np.testing.assert_array_equal(nat, jnat)


def test_wav_read_mono(tmp_path):
    x = _tone(1000)
    p = tmp_path / "mono.wav"
    wavfile.write(p, 48000, (x * 32767).astype(np.int16))
    sr, data = native.read_wav(p)
    assert sr == 48000 and data.ndim == 1 and data.shape[0] == 1000
    assert native.wav_info(p) == jnative.wav_info(p) == (48000, 1000, 1)
    np.testing.assert_allclose(data, read_wav(p)[1], atol=1e-6)
    np.testing.assert_array_equal(data, jnative.read_wav(p)[1])


def test_wav_read_24bit_matches_scipy(tmp_path):
    rng = np.random.default_rng(3)
    vals = rng.integers(-(2**23), 2**23, size=256)
    payload = b"".join(struct.pack("<i", int(v) << 8)[1:] for v in vals)
    p = tmp_path / "p24.wav"
    _write_wav_manual(p, 22050, 1, 24, 1, payload)
    sr_ref, ref = wavfile.read(p)  # int32, the 24 bits in the high bytes
    sr, nat = native.read_wav(p)
    assert sr == sr_ref == 22050
    np.testing.assert_allclose(nat, ref.astype(np.float32) / 2147483648.0,
                               atol=1e-7)
    np.testing.assert_allclose(nat, read_wav(p)[1], atol=1e-7)
    np.testing.assert_array_equal(nat, jnative.read_wav(p)[1])


def test_malformed_wav_raises_not_crashes(tmp_path):
    p = tmp_path / "bad.wav"  # bits_per_sample = 0
    _write_wav_manual(p, 22050, 1, 0, 1, b"\x00" * 64)
    q = tmp_path / "garbage.wav"
    q.write_bytes(b"RIFFxxxxWAVE" + b"\x01" * 10)
    for lib in (native, jnative):
        with pytest.raises(IOError):
            lib.wav_info(p)
        with pytest.raises(IOError):
            lib.read_wav(q)
    good = tmp_path / "good.wav"
    wavfile.write(good, 22050, (_tone(1000) * 32767).astype(np.int16))
    with pytest.raises(IOError, match="1 file"):
        native.process_rir_batch([good, p], target_fs=0, n_fft=512, hop=128,
                                 win=512, max_channels=1, n_frames=9,
                                 n_threads=2)


def test_resample_parity_vs_python_and_jax():
    from neraf_tpu.dsp.resample import resample_poly as jax_resample

    x = _tone(4410, fs=44100)
    xb = np.stack([x, x[::-1].copy()])
    for sig, up, down in ((x, 1, 2), (xb, 3, 7)):
        ref = np.asarray(jax_resample(jnp.asarray(sig), up, down))
        nat = native.resample_poly(sig, up, down)
        assert nat.shape == ref.shape
        np.testing.assert_allclose(nat, ref, atol=2e-6)
        np.testing.assert_allclose(nat, resample_poly(sig, up, down).numpy(),
                                   atol=2e-6)
        np.testing.assert_array_equal(nat, jnative.resample_poly(sig, up, down))


@pytest.mark.parametrize("n_fft,hop,win", [(512, 128, 512), (1024, 256, 512)])
def test_stft_parity_vs_python_and_jax(n_fft, hop, win):
    from neraf_tpu.dsp.stft import stft_magnitude as jax_stft

    x = _tone(5000)
    ref = np.asarray(jax_stft(jnp.asarray(x), n_fft=n_fft, hop_length=hop,
                              win_length=win))
    nat = native.stft_magnitude(x, n_fft=n_fft, hop_length=hop,
                                win_length=win)
    ours = stft_magnitude(torch.from_numpy(x), n_fft=n_fft, hop_length=hop,
                          win_length=win).numpy()
    assert nat.shape == ref.shape == ours.shape
    np.testing.assert_allclose(nat, ref, atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(nat, ours, atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(
        nat, jnative.stft_magnitude(x, n_fft=n_fft, hop_length=hop,
                                    win_length=win), atol=2e-4, rtol=1e-4)


def test_process_rir_batch_matches_python_preprocess(tmp_path):
    """clip -> resample 44.1k -> 22.05k -> front pad n_fft / 2 -> at least
    4410 samples -> per-channel STFT magnitudes on a thread pool, against
    process_rir_wav on the CPU (the port's and the JAX package's) and the
    JAX package's batch."""
    from neraf_tpu.data.preprocess import process_rir_wav as jprocess_rir_wav

    P = preprocess
    rng = np.random.default_rng(0)
    paths = []
    for i in range(6):
        n = int(rng.integers(800, 6000))
        wav = np.stack([_tone(n, fs=44100, f=300 + 100 * i),
                        _tone(n, fs=44100, f=500 + 80 * i)], axis=1)
        p = tmp_path / f"rir_{i}.wav"
        wavfile.write(p, 44100, (wav * 32767 * 0.9).astype(np.int16))
        paths.append(p)
    longest = max(-(-6000 * P.TARGET_FS // 44100) + P.N_FFT // 2, P.MIN_SAMPLES)
    kw = dict(target_fs=P.TARGET_FS, n_fft=P.N_FFT, hop=P.HOP, win=P.N_FFT,
              front_pad=P.N_FFT // 2, min_samples=P.MIN_SAMPLES,
              max_channels=2, n_frames=2 + longest // P.HOP, n_threads=4)
    mags, chans = native.process_rir_batch(paths, **kw)
    jmags, jchans = jnative.process_rir_batch(paths, **kw)
    assert mags.shape[:2] == (6, 2) and list(chans) == [2] * 6
    np.testing.assert_array_equal(chans, jchans)
    for i, p in enumerate(paths):
        for ref in (P.process_rir_wav(p, device="cpu"), jprocess_rir_wav(p),
                    jmags[i]):
            T = ref.shape[-1]
            np.testing.assert_allclose(mags[i, :, :, :T], ref, atol=3e-4,
                                       rtol=2e-4)
            assert np.all(mags[i, :, :, T:] == 0)


def test_raf_loader_native_matches_python(tmp_path, monkeypatch):
    """load_raf_dataset's arrays through the native ingest, through the
    Python path and through the JAX loader (its native path), for the train
    split and the test split with its waveforms."""
    from neraf_tpu.data import datasets as jdatasets

    scene = make_raf_scene(tmp_path)
    for split, n in (("train", 3), ("test", 1)):
        nat = datasets.load_raf_dataset(scene, split)
        ref = jdatasets.load_raf_dataset(scene, split)
        with monkeypatch.context() as mp:
            mp.setenv("NERAF_NATIVE", "0")
            mp.setattr(native, "process_rir_batch", _unreachable)
            py = datasets.load_raf_dataset(scene, split)
        assert nat.log_stft.shape == py.log_stft.shape == (n, 1, 513, 60)
        for want in (py.log_stft, ref.log_stft):
            np.testing.assert_allclose(nat.log_stft, want, atol=2e-5,
                                       rtol=1e-5)
        if split == "test":
            np.testing.assert_allclose(nat.waveforms, py.waveforms, atol=1e-6)
            np.testing.assert_array_equal(nat.waveforms, ref.waveforms)


def test_soundspaces_eval_resample_native_matches_python(tmp_path, monkeypatch):
    from neraf_tpu.data import datasets as jdatasets

    scene = make_soundspaces_scene(tmp_path, n_train=2, n_test=3)
    nat = datasets.load_soundspaces_dataset(scene, "test", max_len=24)
    ref = jdatasets.load_soundspaces_dataset(scene, "test", max_len=24)
    monkeypatch.setenv("NERAF_NATIVE", "0")
    monkeypatch.setattr(native, "resample_poly", _unreachable)
    py = datasets.load_soundspaces_dataset(scene, "test", max_len=24)
    assert nat.waveforms.shape == py.waveforms.shape == (3, 2, 24 * 128)
    np.testing.assert_allclose(nat.waveforms, py.waveforms, atol=2e-6)
    np.testing.assert_array_equal(nat.waveforms, ref.waveforms)
    np.testing.assert_array_equal(nat.log_stft, py.log_stft)


def test_process_scene_native_matches_python(tmp_path, monkeypatch):
    from neraf_tpu.data.preprocess import process_scene as jprocess_scene

    scene = make_soundspaces_scene(tmp_path)
    n1 = preprocess.process_scene(scene, out_dir="mags_native", device="cpu")
    n3 = jprocess_scene(scene, out_dir="mags_jax")
    with monkeypatch.context() as mp:
        mp.setenv("NERAF_NATIVE", "0")
        mp.setattr(native, "process_rir_batch", _unreachable)
        n2 = preprocess.process_scene(scene, out_dir="mags_python",
                                      device="cpu")
    assert n1 == n2 == n3 > 0
    files = sorted((scene / "mags_native").rglob("*.npy"))
    assert len(files) == n1
    for p in files:
        rel = p.relative_to(scene / "mags_native")
        a, b = np.load(p), np.load(scene / "mags_python" / rel)
        assert a.shape == b.shape and a.dtype == np.float32
        np.testing.assert_allclose(a, b, atol=5e-4, rtol=2e-4)
        np.testing.assert_allclose(a, np.load(scene / "mags_jax" / rel),
                                   atol=5e-4, rtol=2e-4)


def test_process_rir_batch_truncation(tmp_path):
    """max_samples cuts the signal before the STFT (RAF's 0.32 s)."""
    from neraf_tpu.dsp.stft import stft_magnitude as jax_stft

    x = _tone(48000, fs=48000)
    p = tmp_path / "r.wav"
    wavfile.write(p, 48000, (x * 32767).astype(np.int16))
    max_t = int(0.32 * 48000)
    T = max_t // 256
    kw = dict(target_fs=0, n_fft=1024, hop=256, win=512, max_samples=max_t,
              max_channels=1, n_frames=T, n_threads=1)
    mags, _ = native.process_rir_batch([p], **kw)
    xs = read_wav(p)[1][:max_t]
    # JAX accumulates the DFT in f32, the library in f64: near-zero bins
    # differ at 1e-3 (the magnitudes are ~30)
    for ref in (np.asarray(jax_stft(jnp.asarray(xs), n_fft=1024,
                                    hop_length=256, win_length=512)),
                stft_magnitude(torch.from_numpy(xs), n_fft=1024,
                               hop_length=256, win_length=512).numpy(),
                jnative.process_rir_batch([p], **kw)[0][0, 0]):
        np.testing.assert_allclose(mags[0, 0, :, :T], ref[:, :T], atol=1e-3,
                                   rtol=2e-4)


def test_refused_wav_takes_the_python_path_and_is_counted(tmp_path,
                                                          monkeypatch):
    """A float64 wav (the parser takes 32-bit floats only) in a RAF scene:
    that file takes the Python path, warned about and counted; every
    array is the all-Python load's."""
    scene = make_raf_scene(tmp_path)
    with monkeypatch.context() as mp:
        mp.setenv("NERAF_NATIVE", "0")
        py = datasets.load_raf_dataset(scene, "train")
    rec = scene / "data" / "rec_001" / "rir.wav"
    sr, x = wavfile.read(rec)
    wavfile.write(rec, sr, x.astype(np.float64))
    with pytest.raises(IOError):
        native.wav_info(rec)
    native.reset_fallbacks()
    with pytest.warns(RuntimeWarning, match="rec_001"):
        nat = datasets.load_raf_dataset(scene, "train")
    assert native.fallbacks() == 1
    np.testing.assert_array_equal(nat.log_stft[1], py.log_stft[1])
    np.testing.assert_allclose(nat.log_stft, py.log_stft, atol=2e-5, rtol=1e-5)
    native.reset_fallbacks()


def _broken_during(fn, rec: Path):
    """fn, with rec cut to its first 4 bytes while fn runs: the library
    reads a header, then cannot decode the samples; the file is whole
    again for the Python path."""
    good = rec.read_bytes()

    def wrapped(*args, **kwargs):
        rec.write_bytes(good[:4])
        try:
            return fn(*args, **kwargs)
        finally:
            rec.write_bytes(good)
    return wrapped


@pytest.mark.parametrize("where", ["process_rir_batch", "read_wav"])
def test_undecodable_wav_takes_the_python_path_and_is_counted(
        tmp_path, monkeypatch, where):
    """A wav whose header the library has read but whose samples it cannot
    decode, in the batch or in the test split's waveform read: that file
    takes the Python path, warned about and counted; the arrays are the
    all-Python load's."""
    from neraf_tpu_torch.data.synthetic import write_raf_scene

    scene = write_raf_scene(tmp_path, 3, 3, seconds=(0.1, 0.6), seed=5)
    with monkeypatch.context() as mp:
        mp.setenv("NERAF_NATIVE", "0")
        py = datasets.load_raf_dataset(scene, "test")
    name = str(py.outputs.audio_filenames[-1])
    rec = scene / "data" / name / "rir.wav"
    monkeypatch.setattr(native, where,
                        _broken_during(getattr(native, where), rec))
    native.reset_fallbacks()
    with pytest.warns(RuntimeWarning, match=name):
        nat = datasets.load_raf_dataset(scene, "test")
    assert native.fallbacks() == 1
    np.testing.assert_array_equal(nat.log_stft[-1], py.log_stft[-1])
    np.testing.assert_array_equal(nat.waveforms[-1], py.waveforms[-1])
    np.testing.assert_allclose(nat.log_stft, py.log_stft, atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(nat.waveforms, py.waveforms, atol=1e-6)
    native.reset_fallbacks()


@pytest.mark.filterwarnings("ignore:Reached EOF prematurely")
def test_short_data_chunk_reads_the_same_both_ways(tmp_path, monkeypatch):
    """Wavs whose data chunk ends before their header says: the library and
    scipy both read the samples that are there, no fallback."""
    from neraf_tpu_torch.data.synthetic import write_raf_scene

    scene = write_raf_scene(tmp_path, 3, 3, seconds=(0.4, 0.6), seed=6)
    for rec in (scene / "data").glob("*/rir.wav"):
        data = rec.read_bytes()
        rec.write_bytes(data[:len(data) - 4001])
    native.reset_fallbacks()
    for split in ("train", "test"):
        with monkeypatch.context() as mp:
            mp.setenv("NERAF_NATIVE", "0")
            py = datasets.load_raf_dataset(scene, split)
        nat = datasets.load_raf_dataset(scene, split)
        np.testing.assert_allclose(nat.log_stft, py.log_stft, atol=2e-5,
                                   rtol=1e-5)
        if split == "test":
            np.testing.assert_allclose(nat.waveforms, py.waveforms, atol=1e-6)
    assert native.fallbacks() == 0


def test_raf_cut_and_formats_native_against_python(tmp_path, monkeypatch):
    """write_raf_scene's int16 and float32 scenes, RIRs of 0.1-0.6 s on both
    sides of the 0.32 s cut, through both paths and the JAX loader."""
    from neraf_tpu.data import datasets as jdatasets
    from neraf_tpu_torch.data.synthetic import write_raf_scene

    for fmt in ("int16", "float32"):
        scene = write_raf_scene(tmp_path / fmt, 6, 3, seconds=(0.1, 0.6),
                                sample_format=fmt, seed=2)
        for split in ("train", "test"):
            nat = datasets.load_raf_dataset(scene, split)
            ref = jdatasets.load_raf_dataset(scene, split)
            with monkeypatch.context() as mp:
                mp.setenv("NERAF_NATIVE", "0")
                py = datasets.load_raf_dataset(scene, split)
            for want in (py.log_stft, ref.log_stft):
                np.testing.assert_allclose(nat.log_stft, want, atol=2e-5,
                                           rtol=1e-5)
            if split == "test":
                np.testing.assert_allclose(nat.waveforms, py.waveforms,
                                           atol=1e-6)
                np.testing.assert_array_equal(nat.waveforms, ref.waveforms)
            else:
                assert nat.waveforms is None and py.waveforms is None

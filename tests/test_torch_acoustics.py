"""The port's evaluation layer against the JAX package, on the CPU: the
biquad highpass and Hilbert envelope (dsp/filters.py), the room-acoustic
estimators, host and batched (metrics/room_acoustics.py), the SING
spectral loss, both evaluators, the image panels and the synthetic
validation scenes. Inputs come from numpy seeds and go through the JAX
function and its port.

Tolerances:
- equal (assert_array_equal) where the port runs the same numpy code as
  the reference: measure_rt60, measure_edt, measure_clarity,
  compute_t60(advanced=False), evaluate_edt/evaluate_clarity, _t60_error,
  snr, magnitude_distance, normalize_signal, the SoundSpaces full metrics;
- highpass_biquad, host (scipy, float64) and device (blocked recurrence,
  float64), against the JAX package's float32 scan at atol 1e-4 on
  unit-variance input (the bound tests/test_dsp_filters.py:27 holds the
  scan to against scipy; measured 6.1e-5 at 15,360 samples);
- measure_rt60_advance and compute_t60(advanced=True): the same invalid
  flags, values within 12 / fs (one sample's shift at each of the two
  crossings, times 60 / 10): the highpass differs by float32 rounding;
- hilbert_envelope 1e-4 of the peak (the JAX package's FFTs run in
  float32), envelope_distance rtol 1e-4;
- the batched estimators against JAX's: C50 rtol 1e-4, T60 and EDT within
  one sample's shift at each crossing, equal flags on decaying RIRs; and
  against the port's host estimators at the JAX test's rtol 1e-3. The port
  integrates the energy in float64 (the module's docstring);
- spectral_loss, every mode, rtol 1e-6 (float32 means in another order);
- the evaluators on identical numpy inputs: SoundSpaces full metrics rtol
  1e-9, its quick audio_mag (a float32 mean on both sides, summed in
  another order: measured 3.3e-7) rtol 1e-6; RAF audio_stft_error rtol 1e-5, T60 rtol 1e-3
  with equal invalid counts, EDT and C50 equal;
- the panels and grid views atol 1e-12, which also pins the port's viridis
  table to matplotlib's;
- the synthetic scenes: poses, waveforms and images equal; the log-STFTs
  through exp (the magnitudes + 1e-3) within 1e-5 of their peak:
  torch.stft against jnp's FFT in float32, whose rounding the log itself
  amplifies near its 1e-3 floor (measured 1.6e-4 at a value of -6.1).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neraf_tpu.dsp import filters as jfilters
from neraf_tpu.metrics import evaluators as jev
from neraf_tpu.metrics import losses as jlosses
from neraf_tpu.metrics import room_acoustics as jra
from neraf_tpu.viz import panels as jpanels
from neraf_tpu_torch.dsp import filters
from neraf_tpu_torch.metrics import evaluators as ev
from neraf_tpu_torch.metrics import losses
from neraf_tpu_torch.metrics import room_acoustics as ra
from neraf_tpu_torch.viz import panels


def synth_rir(fs=22050, rt60=0.4, length=None, seed=0):
    """Exponentially-decaying noise with a known T60
    (tests/test_room_acoustics.py's)."""
    rng = np.random.default_rng(seed)
    if length is None:
        length = int(fs * rt60 * 2.5)
    t = np.arange(length) / fs
    tau = rt60 / (np.log(10 ** (60 / 20)))
    return (rng.standard_normal(length) * np.exp(-t / tau)).astype(np.float32)


def geometric_rir(r: float, n: int) -> np.ndarray:
    """±r^n, an exact geometric decay (tests/test_rt60_oracle.py's)."""
    h = r ** np.arange(n, dtype=np.float64)
    return h * np.where(np.arange(n) % 2 == 0, 1.0, -1.0)


def decaying_batch(fs=22050, n=6, length=22050, seed=0):
    return np.stack([synth_rir(fs, rt, length=length, seed=seed + i)
                     for i, rt in enumerate(np.linspace(0.2, 0.7, n))])


def degenerate_batch(L=2048, fs=22050.0):
    """tests/test_room_acoustics.py:123's family: near-silent decays,
    truncated decays, noise-floor-dominated decays, zero and constant."""
    t = np.arange(L) / fs
    rng = np.random.default_rng(7)
    sigs = [amp * np.exp(-t / 0.02) * rng.standard_normal(L)
            for amp in (1e-3, 1e-5, 1e-7)]
    sigs += [np.exp(-t / tau) * rng.standard_normal(L) for tau in (0.5, 0.15, 0.05)]
    sigs += [np.exp(-t / 0.01) * rng.standard_normal(L)
             + floor * rng.standard_normal(L) for floor in (1e-2, 1e-3)]
    sigs += [np.zeros(L), np.full(L, 0.3)]
    return np.stack(sigs).astype(np.float32)


def _host_or_none(fn, *a, **k):
    try:
        return fn(*a, **k)
    except (IndexError, ValueError, FloatingPointError):
        return None


# ------------------------------------------------------------------ filters
@pytest.mark.parametrize("fs,length", [(48000, 15360), (22050, 4000), (16000, 257)])
def test_highpass_biquad_host_and_device_match_jax(fs, length):
    x = np.random.default_rng(length).standard_normal((3, 2, length)).astype(np.float32)
    ref = np.asarray(jfilters.highpass_biquad(jnp.asarray(x), fs, 200.0))
    host = filters.highpass_biquad(x, fs, 200.0)
    dev = filters.highpass_biquad(torch.from_numpy(x), fs, 200.0)
    assert host.shape == dev.shape == ref.shape and dev.dtype == torch.float32
    np.testing.assert_allclose(host, ref, rtol=0, atol=1e-4)
    np.testing.assert_allclose(dev.numpy(), ref, rtol=0, atol=1e-4)
    # the two forms compute the same float64 filter
    np.testing.assert_allclose(dev.numpy(), host, rtol=0, atol=1e-6)


def test_highpass_coeffs_equal_jax():
    for args in ((48000, 200.0), (22050, 200.0, 0.5), (16000, 80.0)):
        assert filters._highpass_coeffs(*args) == jfilters._highpass_coeffs(*args)


@pytest.mark.parametrize("n", [500, 501])
def test_hilbert_envelope_matches_jax(n):
    x = np.random.default_rng(n).standard_normal((2, n)).astype(np.float32)
    ref = np.asarray(jfilters.hilbert_envelope(jnp.asarray(x)))
    out = filters.hilbert_envelope(x)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4 * np.abs(ref).max())


# ------------------------------------------------------- host estimators
@pytest.mark.parametrize("rt60,seed", [(0.3, 0), (0.5, 1), (0.8, 2)])
def test_host_estimators_equal_jax(rt60, seed):
    fs = 22050
    h = synth_rir(fs, rt60, seed=seed)
    for decay_db in (10, 30, 60):
        np.testing.assert_array_equal(ra.measure_rt60(h, fs, decay_db),
                                      jra.measure_rt60(h, fs, decay_db))
    np.testing.assert_array_equal(ra.measure_edt(h, fs), jra.measure_edt(h, fs))
    np.testing.assert_array_equal(ra.measure_clarity(h, fs=fs),
                                  jra.measure_clarity(h, fs=fs))
    g = geometric_rir(0.999, 40000)
    np.testing.assert_array_equal(ra.measure_rt60(g, fs, 30), jra.measure_rt60(g, fs, 30))
    np.testing.assert_array_equal(ra.measure_edt(g, fs), jra.measure_edt(g, fs))


def test_host_estimators_failures_equal_jax():
    with pytest.raises((IndexError, ValueError)):
        ra.measure_rt60(np.ones(1000, np.float32), fs=1000, decay_db=30)
    with pytest.raises(ValueError):
        ra.measure_rt60(np.zeros(1000), fs=22050, decay_db=30)
    assert np.isnan(ra.measure_edt(np.zeros(100), fs=22050))
    assert np.isnan(ra.measure_edt(np.ones(2), fs=22050))  # never decays
    np.testing.assert_array_equal(ra.measure_edt(np.ones(100), fs=22050),
                                  jra.measure_edt(np.ones(100), fs=22050))


def test_compute_t60_evaluate_edt_clarity_equal_jax():
    fs = 22050
    gt = np.stack([synth_rir(fs, 0.4, seed=1), synth_rir(fs, 0.4, seed=2)])
    pred = np.stack([synth_rir(fs, 0.45, seed=3), synth_rir(fs, 0.45, seed=4)])
    bad = np.zeros_like(gt)  # no energy: the estimator raises
    for a, b in ((gt, pred), (bad, pred), (gt, bad)):
        for port, ref in ((ra.compute_t60(a, b, fs), jra.compute_t60(a, b, fs)),
                          (ra.evaluate_edt(b, a, fs), jra.evaluate_edt(b, a, fs)),
                          (ra.evaluate_clarity(b, a, fs),
                           jra.evaluate_clarity(b, a, fs))):
            for p, r in zip(port, ref):
                np.testing.assert_array_equal(p, r)
    t_gt, t_pr = ra.compute_t60(bad, pred, fs)
    assert (t_gt == -1).all() and (t_pr == -1).all()


def test_rt60_advance_matches_jax():
    """The same invalid flags and values within 12 / fs."""
    fs = 48000.0
    rng = np.random.default_rng(1)
    n = 24000
    sigs = [np.exp(-np.arange(n) / (tau * fs)) * rng.normal(size=n)
            for tau in (0.02, 0.05, 0.08, 0.12)]
    sigs += [np.ones(n), np.zeros(n)]
    for s in sigs:
        s = s.astype(np.float32)
        p = _host_or_none(ra.measure_rt60_advance, s, sr=fs)
        r = _host_or_none(jra.measure_rt60_advance, s, sr=fs)
        assert (p is None) == (r is None)
        if p is not None:
            assert abs(p - r) <= 12 / fs, (p, r)
    gt = np.stack(sigs[:2]).astype(np.float32)
    pred = np.stack([sigs[2], sigs[4]]).astype(np.float32)
    port = ra.compute_t60(gt, pred, fs, advanced=True)
    ref = jra.compute_t60(gt, pred, fs, advanced=True)
    for p, r in zip(port, ref):
        np.testing.assert_array_equal(p < -0.5, r < -0.5)
        np.testing.assert_allclose(p, r, rtol=0, atol=12 / fs)


def test_helper_metrics_equal_jax():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((2, 500)).astype(np.float32)
    b = rng.standard_normal((2, 500)).astype(np.float32)
    np.testing.assert_array_equal(ra.snr(a, b), jra.snr(a, b))
    np.testing.assert_array_equal(ra.magnitude_distance(np.abs(a), np.abs(b)),
                                  jra.magnitude_distance(np.abs(a), np.abs(b)))
    np.testing.assert_array_equal(ra.normalize_signal(a), jra.normalize_signal(a))
    np.testing.assert_allclose(ra.envelope_distance(a, b),
                               jra.envelope_distance(a, b), rtol=1e-4)
    assert ra.envelope_distance(a, a) == 0.0 and ra.snr(a, a) > 35


def test_t60_error_equal_jax():
    cases = [(np.array([0.4, 0.5]), np.array([0.42, 0.47])),
             (np.array([0.4, -1.0]), np.array([0.42, -1.0])),
             (np.array([0.3]), np.array([-1.0]))]
    for gt, pr in cases:
        assert ev._t60_error(gt, pr) == jev._t60_error(gt, pr)
    assert ev._t60_error(*cases[1]) == (100.0, 1)


# ------------------------------------------------------ batched estimators
def _one_sample(decay_db, fs, crossings):
    """A shift of one sample at each crossing, times 60 / decay_db, plus
    float32 rounding of the result."""
    return crossings * (60.0 / decay_db) / fs + 1e-6


def test_batched_estimators_match_jax_on_decaying_rirs():
    fs = 22050.0
    hs = decaying_batch()
    t60 = ra.batched_rt60(torch.from_numpy(hs), fs, decay_db=30).numpy()
    edt = ra.batched_edt(torch.from_numpy(hs), fs).numpy()
    c50 = ra.batched_clarity(torch.from_numpy(hs), fs).numpy()
    assert t60.dtype == edt.dtype == c50.dtype == np.float32
    jt60 = np.asarray(jra.batched_rt60(jnp.asarray(hs), fs, decay_db=30))
    jedt = np.asarray(jra.batched_edt(jnp.asarray(hs), fs))
    jc50 = np.asarray(jra.batched_clarity(jnp.asarray(hs), fs))
    np.testing.assert_array_equal(t60 < 0, jt60 < 0)
    assert (t60 > 0).all()
    np.testing.assert_allclose(t60, jt60, rtol=0, atol=_one_sample(30, fs, 2))
    np.testing.assert_allclose(edt, jedt, rtol=0, atol=_one_sample(10, fs, 1))
    np.testing.assert_allclose(c50, jc50, rtol=1e-4)
    # against the port's own host estimators, at the JAX test's rtol
    for i, h in enumerate(hs):
        np.testing.assert_allclose(t60[i], ra.measure_rt60(h, fs, 30), rtol=1e-3)
        np.testing.assert_allclose(edt[i], ra.measure_edt(h, fs), rtol=1e-3)
        np.testing.assert_allclose(c50[i], ra.measure_clarity(h, fs=fs), rtol=1e-3)


def test_batched_estimators_match_jax_on_goldens():
    fs = 22050.0
    hs = np.stack([geometric_rir(r, 40000) for r in (0.999, 0.9985, 0.9995)])
    x = torch.from_numpy(hs.astype(np.float32))
    for decay_db in (10.0, 30.0):
        t60 = ra.batched_rt60(x, fs, decay_db=decay_db).numpy()
        jt60 = np.asarray(jra.batched_rt60(jnp.asarray(hs, jnp.float32), fs,
                                           decay_db=decay_db))
        np.testing.assert_allclose(t60, jt60, rtol=0,
                                   atol=_one_sample(decay_db, fs, 2))
        for i in range(3):
            np.testing.assert_allclose(t60[i], ra.measure_rt60(hs[i], fs, decay_db),
                                       rtol=1e-3)
    edt = ra.batched_edt(x, fs).numpy()
    np.testing.assert_allclose(edt, np.asarray(jra.batched_edt(
        jnp.asarray(hs, jnp.float32), fs)), rtol=0, atol=_one_sample(10, fs, 1))
    flat = torch.zeros((2, 1000))
    assert (ra.batched_rt60(flat, fs).numpy() == -1).all()
    assert np.isnan(ra.batched_edt(flat, fs).numpy()).all()


def test_batched_rt60_advance_matches_jax():
    fs = 48000.0
    rng = np.random.default_rng(1)
    n = 24000
    hs = np.stack([np.exp(-np.arange(n) / (tau * fs)) * rng.normal(size=n)
                   for tau in (0.03, 0.05, 0.12)]).astype(np.float32)
    out = ra.batched_rt60_advance(torch.from_numpy(hs), fs).numpy()
    ref = np.asarray(jra.batched_rt60_advance(jnp.asarray(hs), fs))
    np.testing.assert_array_equal(out < 0, ref < 0)
    np.testing.assert_allclose(out, ref, rtol=0, atol=_one_sample(10, fs, 2))
    for i in range(3):
        np.testing.assert_allclose(out[i], ra.measure_rt60_advance(hs[i], fs),
                                   rtol=1e-3)


def test_batched_against_host_on_degenerate_rirs():
    """tests/test_room_acoustics.py:123's contract, on the port: where both
    paths call a signal valid, T60 and EDT within 2 sample periods (x 60 /
    decay_db) and C50 within 1e-3 dB; a flipped invalid flag only where
    the decay crossing sits within 2 samples of the signal's end. The
    flags also equal the JAX package's batched estimators' on the family."""
    fs, sigs = 22050.0, degenerate_batch()
    x = torch.from_numpy(sigs)
    dev_t60 = ra.batched_rt60(x, fs, decay_db=30).numpy()
    dev_edt = ra.batched_edt(x, fs).numpy()
    dev_c50 = ra.batched_clarity(x, fs).numpy()
    dt = 1.0 / fs
    for i, s in enumerate(sigs):
        host_t60 = _host_or_none(ra.measure_rt60, s, fs, decay_db=30.0)
        host_inv = host_t60 is None or host_t60 < 0
        if host_inv != (dev_t60[i] < 0):
            # borderline: the -35 dB crossing within 2 samples of the end
            db, _ = ra._schroeder_db(x[i])
            cross = int(ra._first_crossing(db, -35.0))
            assert cross >= len(s) - 3, (i, cross)
        elif not host_inv:
            assert abs(float(dev_t60[i]) - host_t60) <= 2 * dt * 2.0 + 1e-6
        host_edt = ra.measure_edt(s, fs)
        if np.isfinite(host_edt):
            assert abs(float(dev_edt[i]) - host_edt) <= 6 * 2 * dt + 1e-6
        host_c50 = _host_or_none(ra.measure_clarity, s, fs=fs)
        if host_c50 is not None and np.isfinite(host_c50):
            assert abs(float(dev_c50[i]) - host_c50) <= 1e-3
    # against the JAX package's batched estimators on the same family
    jt60 = np.asarray(jra.batched_rt60(jnp.asarray(sigs), fs, decay_db=30))
    np.testing.assert_array_equal(dev_t60 < 0, jt60 < 0)
    assert dev_t60[-2] == -1 and np.isnan(dev_edt[-2])


# -------------------------------------------------------------- losses
@pytest.mark.parametrize("base", ["l1", "mse"])
@pytest.mark.parametrize("mode", ["mag", "mag db", "log mag"])
def test_spectral_loss_matches_jax(base, mode):
    rng = np.random.default_rng(3)
    a = np.abs(rng.standard_normal((2, 257, 60))).astype(np.float32)
    b = np.abs(rng.standard_normal((2, 257, 60))).astype(np.float32)
    kw = dict(base=base, db=mode == "mag db",
              stft_input_type="log mag" if mode == "log mag" else "mag")
    out = float(losses.spectral_loss(torch.from_numpy(a), torch.from_numpy(b), **kw))
    ref = float(jlosses.spectral_loss(jnp.asarray(a), jnp.asarray(b), **kw))
    np.testing.assert_allclose(out, ref, rtol=1e-6)


# ---------------------------------------------------------- evaluators
def test_soundspaces_evaluator_matches_jax():
    fs = 22050
    gt = np.stack([synth_rir(fs, 0.4, seed=1), synth_rir(fs, 0.4, seed=2)])
    preds = [np.stack([synth_rir(fs, 0.45, seed=3), synth_rir(fs, 0.45, seed=4)]),
             np.ones_like(gt), gt[:, :-700]]
    for pred in preds:
        out = ev.SoundSpacesEvaluator(fs).get_full_metrics(
            None, None, gt, pred, pred, None, None)
        ref = jev.SoundSpacesEvaluator(fs).get_full_metrics(
            None, None, gt, pred, pred, None, None)
        assert set(out) == set(ref)
        for k in ref:
            np.testing.assert_allclose(out[k], ref[k], rtol=1e-9, err_msg=k)
    rng = np.random.default_rng(0)
    a = np.abs(rng.standard_normal((2, 257, 60))).astype(np.float32)
    b = np.abs(rng.standard_normal((2, 257, 60))).astype(np.float32)
    out = ev.SoundSpacesEvaluator().get_stft_metrics(a, b)
    ref = jev.SoundSpacesEvaluator().get_stft_metrics(a, b)
    assert set(out) == set(ref) == {"audio_mag"}
    np.testing.assert_allclose(out["audio_mag"], ref["audio_mag"], rtol=1e-6)


@pytest.mark.parametrize("fs", [48000, 16000])
def test_raf_evaluator_matches_jax(fs):
    n = int(0.32 * fs)
    gt = synth_rir(fs, 0.3, seed=5)[None, :n]
    rng = np.random.default_rng(fs)
    e = ev.RAFEvaluator(fs)
    frames = min(60, n // e.hop_len + 1)
    log_gt = np.log(np.abs(rng.standard_normal((1, e.n_fft // 2 + 1, frames)))
                    .astype(np.float32) + 1e-3)
    preds = [synth_rir(fs, 0.32, seed=6)[None, :n],
             synth_rir(fs, 0.25, seed=7)[None, : n - e.hop_len * 3],
             np.ones((1, n), np.float32)]
    for pred in preds:
        out = e.get_full_metrics(None, None, gt, pred, pred, None, log_gt)
        ref = jev.RAFEvaluator(fs).get_full_metrics(None, None, gt, pred, pred,
                                                    None, log_gt)
        assert set(out) == set(ref)
        np.testing.assert_allclose(out["audio_stft_error"],
                                   ref["audio_stft_error"], rtol=1e-5)
        assert out["audio_total_invalids_T60"] == ref["audio_total_invalids_T60"]
        np.testing.assert_allclose(out["audio_T60"], ref["audio_T60"], rtol=1e-3)
        for k in ("audio_EDT", "audio_C50"):
            np.testing.assert_array_equal(out[k], ref[k], err_msg=k)
    a = np.abs(rng.standard_normal((1, 257, 60))).astype(np.float32)
    b = np.abs(rng.standard_normal((1, 257, 60))).astype(np.float32)
    out, ref = e.get_stft_metrics(a, b), jev.RAFEvaluator(fs).get_stft_metrics(a, b)
    assert set(out) == set(ref)
    for k in ref:
        np.testing.assert_allclose(out[k], ref[k], rtol=1e-6, err_msg=k)
    with pytest.raises(ValueError):
        ev.RAFEvaluator(44100)


# ---------------------------------------------------------------- panels
def test_panels_match_jax():
    rng = np.random.default_rng(4)
    pred = rng.normal(-3.0, 1.5, (257, 60)).astype(np.float32)
    gt = rng.normal(-3.0, 1.0, (257, 60)).astype(np.float32)
    out = panels.stft_comparison_panel(pred, gt)
    ref = jpanels.stft_comparison_panel(pred, gt)
    assert out.shape == ref.shape == (257, 120, 3)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-12)
    grid = rng.uniform(0.0, 1.0, (8 ** 3, 7)).astype(np.float32)
    tv, jtv = panels.grid_top_view(grid, 8), jpanels.grid_top_view(grid, 8)
    for k in ("color", "density"):
        assert tv[k].shape == jtv[k].shape == (8, 8, 3)
        np.testing.assert_allclose(tv[k], jtv[k], rtol=0, atol=1e-12)
    # every table entry, and the ends of [0, 1]
    x = np.concatenate([(np.arange(256) + 0.5) / 256, [0.0, 1.0]])
    np.testing.assert_allclose(panels._viridis(x), jpanels._viridis(x),
                               rtol=0, atol=1e-12)


# ------------------------------------------------------ synthetic scenes
def test_synthetic_scenes_match_the_reference_builders():
    from scripts.validate_joint import make_cameras as jmake_cameras
    from scripts.validate_learning import synth_scene as jsynth_scene

    from neraf_tpu_torch.data.synthetic import make_cameras, synth_scene

    for n, max_len, seed in ((5, 60, 0), (3, 12, 1)):
        ds, ref = synth_scene(n, max_len=max_len, seed=seed), jsynth_scene(
            n, max_len=max_len, seed=seed)
        o, r = ds.outputs, ref.outputs
        assert o.audio_filenames == r.audio_filenames
        for k in ("microphone_poses", "source_poses", "rotations", "aabb"):
            np.testing.assert_array_equal(getattr(o, k), getattr(r, k), err_msg=k)
        np.testing.assert_array_equal(ds.waveforms, ref.waveforms)
        assert ds.log_stft.shape == ref.log_stft.shape == (n, 2, 257, max_len)
        mag, ref_mag = np.exp(ds.log_stft), np.exp(ref.log_stft)
        np.testing.assert_allclose(mag, ref_mag, rtol=0, atol=1e-5 * ref_mag.max())
        assert (ds.max_len, ds.fs, ds.hop_len) == (ref.max_len, ref.fs, ref.hop_len)
        arrays = ds.slice_arrays("cpu")
        assert set(arrays) == set(ref.slice_arrays())
        for k, v in (("mic_pose", o.microphone_poses), ("source_pose", o.source_poses),
                     ("rot", o.rotations), ("log_stft", ds.log_stft)):
            assert arrays[k].dtype == torch.float32, k
            np.testing.assert_array_equal(arrays[k].numpy(), v.astype(np.float32))
    cams, images = make_cameras(5, size=16)
    jcams, jimages = jmake_cameras(5, size=16)
    np.testing.assert_array_equal(images, jimages)
    for k in ("c2w", "fx", "fy", "cx", "cy"):
        np.testing.assert_array_equal(getattr(cams, k), np.asarray(jcams[k]),
                                      err_msg=k)


def test_datasets_helpers_match_jax():
    from neraf_tpu.data import datasets as jds

    from neraf_tpu_torch.data import datasets

    rng = np.random.default_rng(2)
    mag = np.abs(rng.standard_normal((2, 33, 10))).astype(np.float32)
    wav = rng.standard_normal((2, 300)).astype(np.float32)
    for max_len in (6, 10, 14):
        np.testing.assert_array_equal(datasets._pack_log_stft(mag, max_len),
                                      jds._pack_log_stft(mag, max_len))
    for n in (200, 300, 400):
        np.testing.assert_array_equal(datasets._fit_waveform(wav, n),
                                      jds._fit_waveform(wav, n))


# ------------------------------------------- the device sweep's metrics
@pytest.mark.parametrize("dataset,fs", [("SoundSpaces", 22050), ("RAF", 48000)])
def test_device_rir_metrics_match_the_host_evaluator(dataset, fs):
    """evaluate_audio_device's per-RIR body (engine/pipeline.py::
    device_rir_metrics) against the host evaluator on the same decaying
    RIR pairs, a short prediction zero-padded to the GT's length: equal
    invalid flags, T60 error, EDT and C50 at the JAX test's rtol 1e-3
    (tests/test_eval_paths.py:85-91)."""
    from neraf_tpu_torch.engine.pipeline import device_rir_metrics

    n, L = 4, int(0.32 * fs)
    gt = np.stack([np.stack([synth_rir(fs, 0.2 + 0.05 * i, length=L, seed=10 * i + c)
                             for c in range(2)]) for i in range(n)])
    pred = np.stack([np.stack([synth_rir(fs, 0.22 + 0.04 * i, length=L - 300,
                                         seed=10 * i + c + 5) for c in range(2)])
                     for i in range(n)])
    pred[-1] = 0.0  # no energy: invalid T60, 100% error
    mag = np.abs(np.random.default_rng(1).standard_normal((n, 2, 9, 5)))
    out = device_rir_metrics(torch.from_numpy(pred), torch.from_numpy(gt),
                             torch.from_numpy(mag), torch.from_numpy(mag * 0.5),
                             dataset, fs)
    e = ev.make_evaluator(dataset, fs)
    t60_key = "audio_T60" if dataset == "RAF" else "audio_T60_mean_error"
    log_gt = np.zeros((2, e.n_fft // 2 + 1, 4), np.float32) if dataset == "RAF" else None
    host = [e.get_full_metrics(None, None, gt[i], pred[i], pred[i], None, log_gt)
            for i in range(n)]
    np.testing.assert_array_equal(out["audio_total_invalids_T60"].numpy(),
                                  [h["audio_total_invalids_T60"] for h in host])
    assert out["audio_total_invalids_T60"][-1] == 1.0
    for k, hk in (("audio_T60_mean_error", t60_key), ("audio_EDT", "audio_EDT"),
                  ("audio_C50", "audio_C50")):
        np.testing.assert_allclose(out[k].numpy(), [h[hk] for h in host],
                                   rtol=1e-3, err_msg=k)
    np.testing.assert_allclose(out["audio_mag"].numpy(),
                               np.mean((mag * 0.5) ** 2, axis=(1, 2, 3)) * 2,
                               rtol=1e-12)

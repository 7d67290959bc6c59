"""Room-acoustic metrics: RT60, EDT, C50 (counterpart of
neraf_tpu/metrics/room_acoustics.py).

Two surfaces, as there:
1. Host estimators in numpy, the same code as the JAX package's (the
   metric of record): `measure_rt60` (Schroeder backward integration with a
   -5 dB headroom point, pyroomacoustics' algorithm), `measure_rt60_advance`
   (a 200 Hz biquad highpass first and a 10 dB decay, the RAF benchmark's),
   `measure_edt` (no headroom, x6), `measure_clarity` (C50), `compute_t60`
   with the reference's shared try/except that turns a failure into -1, and
   the helpers of the reference's evaluators.
2. `batched_*` estimators in torch over (..., L) tensors on any device,
   with invalid estimates flagged -1 (RT60) or NaN (EDT) instead of raised.
   They integrate the energy in float64 whatever the input, so that a decay
   crossing sits at the sample the host's float64 search finds (a float32
   cumulative sum moves the level by ~1e-5 dB over 10^4 samples, enough to
   move one crossing in a few hundred by a sample); the results come back
   in the input's dtype. A crossing index becomes seconds by one multiply
   with a Python float, which rounds alike on every device (CUDA divides by
   a scalar through its reciprocal, which the CPU does not).
"""

from __future__ import annotations

import numpy as np
import torch

from neraf_tpu_torch.dsp.filters import highpass_biquad, hilbert_envelope


# ---------------------------------------------------------------------------
# Host (numpy) estimators
# ---------------------------------------------------------------------------

def measure_rt60(h: np.ndarray, fs: float, decay_db: float = 60.0) -> float:
    """Schroeder-integration RT60 (pyroomacoustics-compatible). Raises
    IndexError/ValueError when the decay range is not reached; compute_t60
    turns that into the invalid value -1."""
    h = np.asarray(h, dtype=np.float64)
    fs = float(fs)

    power = h**2
    energy = np.cumsum(power[::-1])[::-1]  # Schroeder backward integration

    pos = np.where(energy > 0)[0]
    if pos.size == 0:  # all-zero or non-finite signal -> invalid estimate
        raise ValueError("no positive energy in impulse response")
    i_nz = np.max(pos)
    energy = energy[:i_nz]
    energy_db = 10 * np.log10(energy)
    energy_db -= energy_db[0]

    # -5 dB headroom point
    i_5db = np.min(np.where(-5 - energy_db > 0)[0])
    t_5db = i_5db / fs

    # decay point
    i_decay = np.min(np.where(-5 - decay_db - energy_db > 0)[0])
    t_decay = i_decay / fs

    return (60.0 / decay_db) * (t_decay - t_5db)


def measure_rt60_advance(signal: np.ndarray, sr: float, decay_db: float = 10.0,
                         cutoff_freq: float = 200.0) -> float:
    """RAF-benchmark RT60: 200 Hz biquad highpass then 10 dB Schroeder decay."""
    return measure_rt60(highpass_biquad(np.asarray(signal), sr, cutoff_freq),
                        sr, decay_db=decay_db)


def measure_edt(h: np.ndarray, fs: float = 44100.0, decay_db: float = 10.0) -> float:
    """Early decay time: Schroeder integration, first `decay_db` dB, x6
    scaling, no -5 dB headroom. NaN for an all-zero signal."""
    h = np.asarray(h, dtype=np.float64)
    fs = float(fs)

    power = h**2
    energy = np.cumsum(power[::-1])[::-1]

    pos = np.where(energy > 0)[0]
    if pos.size == 0:  # all-zero or non-finite (e.g. NaN) signal
        return float("nan")

    i_nz = np.max(pos)
    energy = energy[:i_nz]
    energy_db = 10 * np.log10(energy)
    energy_db -= energy_db[0]

    crossings = np.where(-decay_db - energy_db > 0)[0]
    if crossings.size == 0:  # never decays far enough
        return float("nan")
    t_decay = np.min(crossings) / fs
    return (60.0 / decay_db) * t_decay


def measure_clarity(signal: np.ndarray, time_ms: float = 50.0, fs: float = 44100.0) -> float:
    """C50 clarity in dB: 10 log10(E[:50ms] / E[50ms:])."""
    h2 = np.asarray(signal, dtype=np.float64) ** 2
    t = int((time_ms / 1000.0) * fs + 1)
    return float(10 * np.log10(np.sum(h2[:t]) / np.sum(h2[t:])))


def compute_t60(true_in: np.ndarray, gen_in: np.ndarray, fs: float,
                advanced: bool = False) -> tuple[np.ndarray, np.ndarray]:
    """Per-channel RT60 of GT and prediction; if either estimate of a
    channel fails, both are -1 (the reference's shared try/except)."""
    ch = true_in.shape[0]
    gt, pred = [], []
    for c in range(ch):
        try:
            if advanced:
                t = measure_rt60_advance(true_in[c], sr=fs)
                g = measure_rt60_advance(gen_in[c], sr=fs)
            else:
                t = measure_rt60(true_in[c], fs=fs, decay_db=30)
                g = measure_rt60(gen_in[c], fs=fs, decay_db=30)
        except (IndexError, ValueError, FloatingPointError):
            t = -1
            g = -1
        gt.append(t)
        pred.append(g)
    return np.array(gt), np.array(pred)


def evaluate_edt(pred_ir: np.ndarray, gt_ir: np.ndarray, fs: float) -> tuple[np.ndarray, np.ndarray]:
    """Per-channel EDT of (pred, gt) pairs -> (gt, pred)."""
    ch = gt_ir.shape[0]
    gt, pred = [], []
    for c in range(ch):
        pred.append(measure_edt(pred_ir[c], fs=fs))
        gt.append(measure_edt(gt_ir[c], fs=fs))
    return np.array(gt), np.array(pred)


def evaluate_clarity(pred_ir: np.ndarray, gt_ir: np.ndarray, fs: float) -> tuple[np.ndarray, np.ndarray]:
    """Per-channel C50 of (pred, gt) pairs -> (gt, pred)."""
    ch = gt_ir.shape[0]
    gt, pred = [], []
    for c in range(ch):
        pred.append(measure_clarity(pred_ir[c], fs=fs))
        gt.append(measure_clarity(gt_ir[c], fs=fs))
    return np.array(gt), np.array(pred)


def envelope_distance(predicted: np.ndarray, gt: np.ndarray) -> float:
    """Summed per-channel RMS distance between Hilbert envelopes."""
    ch = predicted.shape[0]
    total = 0.0
    for c in range(ch):
        pred_env = hilbert_envelope(predicted[c])
        gt_env = hilbert_envelope(gt[c])
        total += float(np.sqrt(np.mean((gt_env - pred_env) ** 2)))
    return float(total)


def snr(predicted: np.ndarray, gt: np.ndarray) -> float:
    """10 log10((E[gt^2] + 1e-4) / (MSE + 1e-4))."""
    mse = np.mean((predicted - gt) ** 2)
    return float(10.0 * np.log10((np.mean(gt**2) + 1e-4) / (mse + 1e-4)))


def magnitude_distance(predicted_mag: np.ndarray, gt_mag: np.ndarray) -> float:
    """Summed per-channel MSE between magnitude STFTs."""
    ch = predicted_mag.shape[0]
    return float(sum(np.mean((predicted_mag[c] - gt_mag[c]) ** 2) for c in range(ch)))


def normalize_signal(samples: np.ndarray) -> np.ndarray:
    """Peak-normalise."""
    return samples / np.maximum(1e-20, np.max(np.abs(samples)))


# ---------------------------------------------------------------------------
# Batched estimators (torch, any device)
# ---------------------------------------------------------------------------

def _schroeder_db(h: torch.Tensor):
    """Backward-integrated energy in dB (float64), 0 dB at t = 0, with the
    all-zero tail masked to +1e9 (above every threshold, so never a
    crossing), as the host search truncates it -> (db, total energy)."""
    power = h.to(torch.float64) ** 2
    energy = power.flip(-1).cumsum(-1).flip(-1)
    total = energy[..., :1]
    valid = energy > 0
    db = 10.0 * torch.log10(torch.where(valid, energy, 1.0)) - 10.0 * torch.log10(
        total.clamp_min(1e-30))
    return torch.where(valid, db, 1e9), total[..., 0]


def _first_crossing(energy_db: torch.Tensor, threshold: float) -> torch.Tensor:
    """Index of the first sample with energy_db < threshold; L if none."""
    length = energy_db.shape[-1]
    idx = torch.arange(length, device=energy_db.device)
    return torch.where(energy_db < threshold, idx, length).amin(dim=-1)


def batched_rt60(h: torch.Tensor, fs: float, decay_db: float = 30.0) -> torch.Tensor:
    """RT60 over (..., L) RIRs; invalid estimates -> -1."""
    db, total = _schroeder_db(h)
    length = h.shape[-1]
    i_5db = _first_crossing(db, -5.0)
    i_decay = _first_crossing(db, -5.0 - decay_db)
    rt60 = (i_decay - i_5db).to(h.dtype) * (60.0 / decay_db / fs)
    invalid = (i_decay >= length) | (i_5db >= length) | (total <= 0)
    return torch.where(invalid, -1.0, rt60)


def batched_rt60_advance(h: torch.Tensor, fs: float, decay_db: float = 10.0,
                         cutoff_freq: float = 200.0) -> torch.Tensor:
    """RAF's RT60 (200 Hz highpass + 10 dB decay) over (..., L) RIRs."""
    return batched_rt60(highpass_biquad(h, fs, cutoff_freq), fs,
                        decay_db=decay_db)


def batched_edt(h: torch.Tensor, fs: float, decay_db: float = 10.0) -> torch.Tensor:
    """EDT over (..., L) RIRs; all-zero signals -> NaN."""
    db, total = _schroeder_db(h)
    i_decay = _first_crossing(db, -decay_db)
    edt = i_decay.to(h.dtype) * (60.0 / decay_db / fs)
    return torch.where(total <= 0, torch.nan, edt)


def batched_clarity(h: torch.Tensor, fs: float, time_ms: float = 50.0) -> torch.Tensor:
    """C50 over (..., L) RIRs, the energies summed in float64."""
    t = int((time_ms / 1000.0) * fs + 1)
    h2 = h.to(torch.float64) ** 2
    early, late = h2[..., :t].sum(-1), h2[..., t:].sum(-1)
    return (10.0 * torch.log10(early / late)).to(h.dtype)

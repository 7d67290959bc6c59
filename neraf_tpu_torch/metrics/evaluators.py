"""Acoustic evaluators (counterpart of neraf_tpu/metrics/evaluators.py):

- full metrics: the T60 relative error with an invalid instance counted as
  100%, the EDT and C50 absolute errors, and (RAF only) the benchmark's
  STFT error, which re-STFTs the Griffin-Lim waveform before the log-L1
  comparison;
- quick STFT metrics: 2x the MSE of the magnitudes (and, for RAF, the SING
  spectral loss).

Inputs and outputs are numpy; the STFT and the spectral loss run in torch
on CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from neraf_tpu_torch.dsp.stft import stft_magnitude
from neraf_tpu_torch.metrics.losses import spectral_loss
from neraf_tpu_torch.metrics.room_acoustics import (
    compute_t60,
    evaluate_clarity,
    evaluate_edt,
)


def _t60_error(t60s_gt: np.ndarray, t60s_prd: np.ndarray) -> tuple[float, int]:
    """Mean relative T60 error in %, an instance with any invalid estimate
    (< -0.5) on either side counted as 1 (100%)."""
    n_ch = t60s_gt.shape[0]
    t60s = np.concatenate((t60s_gt, t60s_prd))
    t60s = np.expand_dims(t60s, axis=0)
    diff = np.abs(t60s[:, n_ch:] - t60s[:, :n_ch]) / np.abs(t60s[:, :n_ch])
    mask = np.any(t60s < -0.5, axis=1)
    diff = np.mean(diff, axis=1)
    diff[mask] = 1
    return float(np.mean(diff) * 100.0), int(np.sum(mask))


def _edt_c50_errors(wav_prd: np.ndarray, wav_gt_ff: np.ndarray, fs: float) -> tuple[float, float]:
    edt_gt, edt_prd = evaluate_edt(wav_prd, wav_gt_ff, fs=fs)
    mean_edt = float(np.mean(np.abs(edt_prd - edt_gt)))
    c50_gt, c50_prd = evaluate_clarity(wav_prd, wav_gt_ff, fs=fs)
    mean_c50 = float(np.mean(np.abs(c50_prd - c50_gt)))
    return mean_edt, mean_c50


def _pad_to(wav: np.ndarray, length: int) -> np.ndarray:
    if wav.shape[1] >= length:
        return wav[:, :length]
    return np.pad(wav, ((0, 0), (0, length - wav.shape[1])), "constant")


def _mag_mse(mag_prd, mag_gt) -> float:
    """2x the mean squared difference, in float32 as the reference's."""
    a = torch.as_tensor(np.asarray(mag_prd, np.float32))
    b = torch.as_tensor(np.asarray(mag_gt, np.float32))
    return float(torch.mean((a - b) ** 2) * 2)


class RAFEvaluator:
    """RAF evaluator (48 kHz or 16 kHz, mono)."""

    def __init__(self, fs: int = 48000):
        self.fs = fs
        if fs == 48000:
            self.n_fft, self.win_length, self.hop_len = 1024, 512, 256
        elif fs == 16000:
            self.n_fft, self.win_length, self.hop_len = 512, 256, 128
        else:
            raise ValueError("Sample rate not supported")

    def get_full_metrics(self, mag_prd, mag_gt, wav_gt_ff, wav_pred_istft,
                         wav_gt_istft, log_prd, log_gt) -> dict:
        wav_prd = np.asarray(wav_pred_istft)
        wav_gt_ff = np.asarray(wav_gt_ff)
        log_gt = np.asarray(log_gt)

        # zero-pad synthesized waveforms to the file GT's length
        wav_prd = _pad_to(wav_prd, wav_gt_ff.shape[1])

        # RAF-benchmark STFT error: waveform -> re-STFT -> log -> L1 vs GT log
        mag_prd_from_istft = stft_magnitude(
            torch.as_tensor(wav_prd), n_fft=self.n_fft,
            hop_length=self.hop_len, win_length=self.win_length)
        log_prd_from_istft = np.log(np.abs(mag_prd_from_istft.numpy()) + 1e-3)
        log_prd_from_istft = log_prd_from_istft[..., : log_gt.shape[2]]
        raf_spectral = float(spectral_loss(
            torch.as_tensor(log_prd_from_istft), torch.as_tensor(log_gt),
            base="l1", stft_input_type="log mag"))

        # "advanced" T60 (200 Hz highpass, 10 dB decay)
        t60s_gt, t60s_prd = compute_t60(wav_gt_ff, wav_prd, fs=self.fs, advanced=True)
        t60_err, invalids = _t60_error(t60s_gt, t60s_prd)

        mean_edt, mean_c50 = _edt_c50_errors(wav_prd, wav_gt_ff, self.fs)

        return {
            "audio_T60": t60_err,
            "audio_total_invalids_T60": float(invalids),
            "audio_stft_error": raf_spectral,
            "audio_EDT": mean_edt,
            "audio_C50": mean_c50,
        }

    def get_stft_metrics(self, mag_prd, mag_gt) -> dict:
        spec = float(spectral_loss(
            torch.as_tensor(np.asarray(mag_prd, np.float32)),
            torch.as_tensor(np.asarray(mag_gt, np.float32)),
            base="l1", stft_input_type="mag"))
        return {"audio_mag": _mag_mse(mag_prd, mag_gt),
                "audio_spectral_loss": spec}


class SoundSpacesEvaluator:
    """SoundSpaces evaluator (22.05 kHz, binaural)."""

    def __init__(self, fs: int = 22050):
        self.fs = fs

    def get_full_metrics(self, mag_prd, mag_gt, wav_gt_ff, wav_pred_istft,
                         wav_gt_istft, log_prd, log_gt) -> dict:
        wav_prd = np.asarray(wav_pred_istft)
        wav_gt_ff = np.asarray(wav_gt_ff)
        wav_prd = _pad_to(wav_prd, wav_gt_ff.shape[1])

        # plain 30 dB Schroeder T60
        t60s_gt, t60s_prd = compute_t60(wav_gt_ff, wav_prd, fs=self.fs)
        t60_err, invalids = _t60_error(t60s_gt, t60s_prd)

        mean_edt, mean_c50 = _edt_c50_errors(wav_prd, wav_gt_ff, self.fs)

        return {
            "audio_T60_mean_error": t60_err,
            "audio_total_invalids_T60": float(invalids),
            "audio_EDT": mean_edt,
            "audio_C50": mean_c50,
        }

    def get_stft_metrics(self, mag_prd, mag_gt) -> dict:
        return {"audio_mag": _mag_mse(mag_prd, mag_gt)}


def make_evaluator(dataset: str, fs: int):
    """The dataset's evaluator at sample rate fs."""
    return RAFEvaluator(fs=fs) if dataset == "RAF" else SoundSpacesEvaluator(fs=fs)

"""Metrics: PSNR, SSIM, the spectral losses, the room-acoustic estimators and the evaluators."""

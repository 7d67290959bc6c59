"""Metrics: PSNR, SSIM and the spectral losses."""

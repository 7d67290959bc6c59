"""Metrics: PSNR and SSIM."""

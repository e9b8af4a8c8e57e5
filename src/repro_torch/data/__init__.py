"""Synthetic fingerprint images and the paper's PSNR metric."""

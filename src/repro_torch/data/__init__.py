"""Synthetic fingerprint images and the paper's PSNR metric (`images`), and
the deterministic synthetic LM batches of training (`tokens`)."""

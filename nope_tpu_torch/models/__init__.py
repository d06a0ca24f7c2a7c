"""Models: the SD-VAE encoder and the pose-conditioned U-Net."""

"""Device ops of the PyTorch port: window encoding, the distance tile and
the fused serving pipeline."""

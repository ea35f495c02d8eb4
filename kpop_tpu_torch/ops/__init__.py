"""Device ops of the PyTorch port: window encoding, the CA Gram, the
distance tile, the fused serving pipeline and the relatedness engine."""

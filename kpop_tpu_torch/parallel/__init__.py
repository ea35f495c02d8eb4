"""Device training of the PyTorch port: the CA fit on one device."""

"""Training and serving over ranks: the device CA (one device or the ranks
of a layout), k-mer-sharded serving, sharded checkpoints and input."""

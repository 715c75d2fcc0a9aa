"""Training side of the port (port of diffulab_tpu/training/): the trainer,
optimizer factories, EMA, checkpoints in torch format, meters and tracking."""

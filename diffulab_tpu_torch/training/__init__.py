"""Training side of the port (port of diffulab_tpu/training/): the trainer,
the GRPO trainer, LoRA/DoRA adapters, optimizer factories, EMA, checkpoints
in torch format, meters, tracking and profiling."""

"""The port's command-line entry points (ports of the JAX package's
``examples/`` CLIs of the same names), run as modules from the repository
root, e.g. ``python -m diffulab_tpu_torch.examples.train_diffusion``."""

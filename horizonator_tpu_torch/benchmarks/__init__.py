"""Probes of the port's kernels on the card (``python -m
horizonator_tpu_torch.benchmarks.<probe>``)."""

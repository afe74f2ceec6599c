"""Command-line tools of the port (``python -m valle_tpu_torch.bin.infer``)."""

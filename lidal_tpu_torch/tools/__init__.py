"""Probe entry points of the port: each times a kernel variant against the
kernel it varies (``python -m lidal_tpu_torch.tools.<probe>``).  Nothing runs
at import."""

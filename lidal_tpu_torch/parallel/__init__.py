"""Data-parallel runs over ``torch.distributed`` (port of ``lidal_tpu/parallel``)."""

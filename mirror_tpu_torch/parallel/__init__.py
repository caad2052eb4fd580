"""Multi-process data parallelism of the port (``torch.distributed``)."""

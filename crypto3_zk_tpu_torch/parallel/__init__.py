"""The mesh layer of the port: sharded kernels on `torch.distributed`."""

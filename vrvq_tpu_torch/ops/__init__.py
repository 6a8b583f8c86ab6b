"""Tensor operations of the port: each kernel beside its plain version."""

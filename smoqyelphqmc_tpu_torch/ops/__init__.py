"""ops of the PyTorch port (module names mirror the JAX package's ops)."""

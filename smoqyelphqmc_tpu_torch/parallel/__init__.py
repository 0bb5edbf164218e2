"""parallel of the PyTorch port: walker batching (module names mirror the JAX package's parallel)."""

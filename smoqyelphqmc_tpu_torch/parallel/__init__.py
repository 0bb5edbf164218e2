"""parallel of the PyTorch port: walker batching and multi-process walker
fleets (module names mirror the JAX package's parallel)."""

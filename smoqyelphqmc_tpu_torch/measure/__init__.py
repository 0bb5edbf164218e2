"""Measurements of the PyTorch port: the stochastic Green's-function
estimator, scalar, local and correlation measurements, the measurement pass
and bin accumulation (module names mirror the JAX package's measure/)."""

"""The port's kernels and their host front-ends, one package per JAX
counterpart under ``repro.kernels``."""

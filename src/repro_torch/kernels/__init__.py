"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version.  Built at first use (see `_build`); importing this package builds
and imports nothing of CUDA."""

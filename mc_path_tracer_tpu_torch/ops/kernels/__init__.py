"""Hand-written CUDA kernels: the nvcc build (`build`) and the wrappers with
their plain PyTorch versions and launch counters (`traversal`)."""

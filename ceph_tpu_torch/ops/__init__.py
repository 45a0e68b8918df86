"""Device operations of the port: the hand-written CUDA kernels, their
wrappers, plain PyTorch versions and the nvcc build."""

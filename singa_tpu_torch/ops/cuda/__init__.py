"""Hand-written Hopper kernels: one module per TPU Pallas kernel it replaces.

Each module holds the kernel's plain PyTorch version, a dispatching wrapper
(plain version for CPU tensors, the CUDA kernel for CUDA tensors) and an
integer ``launches`` counter that the wrapper bumps on every kernel launch.
"""

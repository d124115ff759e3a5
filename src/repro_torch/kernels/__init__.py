"""Hand-written Hopper kernels of the port, each beside its plain version.

``<name>/csrc/<name>.cu`` is the CUDA source, ``<name>/ref.py`` the plain
PyTorch version and ``<name>/ops.py`` the wrapper: the plain version for
CPU tensors, the kernel (or an error) for CUDA tensors, and a ``launches``
count of kernel launches.
"""

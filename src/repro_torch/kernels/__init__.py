"""Hand-written CUDA kernels of the port, each beside its plain version.

Importing this package never builds anything; see :mod:`.build`.
"""

"""PyTorch/CUDA port of ``repro`` for NVIDIA Hopper.

The layout mirrors ``repro`` module for module.  Plain tensor code is
PyTorch; every kernel that ``repro`` wrote in Pallas becomes a CUDA kernel
under ``kernels/csrc``.  Entry points run on ``cuda`` unless the caller
asks for ``cpu``; on the CPU each kernel wrapper runs its plain version.
"""

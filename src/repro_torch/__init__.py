"""PyTorch + CUDA port of the hardware HEFT_RT scheduler reproduction.

Mirrors ``src/repro/`` module for module and never imports it (nor JAX).
Plain tensor code is PyTorch; every Pallas kernel of the reference becomes
a CUDA C++ kernel for Hopper (``csrc/``), built with nvcc at first use.
Entry points run on the CUDA card unless the caller passes ``device="cpu"``.
"""

"""repro_torch — the BSP sorting library (Gerbessiotis & Siniolakis) in
PyTorch, with hand-written CUDA kernels for NVIDIA Hopper.

A second package beside the JAX package ``repro``, laid out module for
module like it. See README.md for what is ported so far.
"""

__version__ = "0.1.0"

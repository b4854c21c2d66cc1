"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

K1 and K4 ``bitonic`` (bitonic tile sort, keys alone or with values), K2
``searchsorted`` (tagged ranks), K3 ``merge_path`` (merge-path merge).
Sources live in ``../csrc``; ``_build`` compiles them on first use.
"""

"""Kernel layer of the port: hand-written CUDA kernels for Hopper.

``csrc/*.cu`` hold the kernels, ``build.py`` compiles and loads them,
``alloc_score.py`` / ``ebf_shadow.py`` / ``selective_scan.py`` wrap them
for tensors, ``ref.py`` holds their plain PyTorch versions, and
``ops.py`` is the entry point the dispatchers and the Mamba mixer call.
Importing the package builds nothing.
"""

"""Hand-written CUDA kernels with their plain PyTorch versions.

Each module holds one kernel's wrapper (CUDA tensors -> the kernel),
its plain version (CPU tensors -> plain PyTorch), and a module-level
``launches`` count that the wrapper raises by one per kernel launch.
"""

"""Hand-written CUDA kernels for Hopper: build, bind, wrappers and
their plain PyTorch versions. Nothing here imports triton or compiles
anything at import time."""

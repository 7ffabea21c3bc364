"""Hand-written CUDA kernels for Hopper (sm_90a), one per Pallas kernel of
``tpumon/ops``. Sources live in ``csrc/``; ``_build`` compiles them with
``nvcc`` at first use and binds them with ``ctypes``. Each wrapper keeps
its plain PyTorch version beside it (used for CPU tensors and as the
on-card oracle) and a plain-int ``launches`` counter."""

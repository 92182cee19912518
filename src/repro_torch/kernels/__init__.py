"""Hand-written CUDA kernels (``csrc/``), their plain PyTorch versions
(``ref``), the build (``build``) and the checked wrappers (``ops``)."""

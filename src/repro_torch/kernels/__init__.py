"""Hand-written CUDA kernels of the port (``csrc/``), their wrappers
(:mod:`.ops`), their plain PyTorch versions (:mod:`.ref`) and the build
step (:mod:`.build`)."""

"""PyTorch/CUDA port of the TAC/TAC+ compressor and its TACZ container.

The port runs the paper's pipeline — pre-process each AMR level (OpST,
AKDTree, NaST partitions or GSP padding), predict and quantize (Lor/Reg,
Lorenzo or Interp), share one Huffman codebook per level (SHE) or merge
same-size sub-blocks into 4D arrays (TAC), write a TACZ container, decode
levels and regions back — on an NVIDIA GPU, with hand-written CUDA
kernels for the hot loops
(:mod:`repro_torch.kernels`).  Public entry points take ``device=`` and
default to ``"cuda"``; pass ``device="cpu"`` to run the kernels' plain
PyTorch versions on the host.
"""

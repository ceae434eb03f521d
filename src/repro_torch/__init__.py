"""PyTorch/CUDA port of the TAC+ compressor and its TACZ container.

The port runs the paper's pipeline — partition each AMR level, predict
and quantize every sub-block (Lor/Reg), share one Huffman codebook per
level (SHE), write a TACZ container, decode levels and regions back — on
an NVIDIA GPU, with hand-written CUDA kernels for the hot loops
(:mod:`repro_torch.kernels`).  Public entry points take ``device=`` and
default to ``"cuda"``; pass ``device="cpu"`` to run the kernels' plain
PyTorch versions on the host.
"""

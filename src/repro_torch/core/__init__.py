"""Compression core of the port: AMR data model, partitioning (OpST,
AKDTree, NaST, GSP padding), SZ prediction (Lor/Reg, Lorenzo, Interp),
Huffman/entropy coding, SHE and the level-wise hybrid compressor."""

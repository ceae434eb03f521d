"""Compression core of the port: AMR data model, partitioning, SZ
Lor/Reg prediction, Huffman/entropy coding, SHE and the level-wise hybrid compressor."""

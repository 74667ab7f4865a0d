"""The closest-hit query: tables, phase A, the leaf walk and their CUDA kernels."""

"""Hand-written CUDA kernels of the query path and their plain versions."""

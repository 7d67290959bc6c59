"""Hand-written CUDA kernels for Hopper (sm_90a), built with nvcc at first use."""

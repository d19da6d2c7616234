"""Device ops: RoPE, paged attention (plain versions + CUDA kernels),
sampling."""

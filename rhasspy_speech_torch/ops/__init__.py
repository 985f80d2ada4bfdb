"""Device ops of the port: plain PyTorch twins and the CUDA kernel wrappers."""

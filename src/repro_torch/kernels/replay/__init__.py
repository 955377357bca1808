"""The trace-replay megakernel (CUDA) and its plain PyTorch version."""

"""Request encoding and the scheduling kernels (plain PyTorch + CUDA)."""

"""PyTorch / CUDA port of the Transformer-XL generation path (see README)."""

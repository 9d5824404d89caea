"""The paper's benchmark suite on PyTorch."""

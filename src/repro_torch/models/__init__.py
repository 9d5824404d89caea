"""Model building blocks on PyTorch: the counterparts of ``repro.models``.
So far the attention module, which the flash and paged attention kernels
are held against."""

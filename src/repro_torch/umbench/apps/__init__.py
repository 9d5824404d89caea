"""``numeric()`` of the paper's apps on PyTorch: the counterparts of the
``numeric()`` helpers in ``repro.umbench.apps``.  BS, cuBLAS and FDTD3d run
through the port's CUDA kernels; CG, Graph500 and the FFT convolutions are
plain PyTorch, as they are plain ``jnp`` on the JAX side.

Each ``numeric(seed=0, <sizes>, device=None)`` draws its inputs from a
``torch.Generator`` on the target device, returns them beside its outputs,
and runs on the CUDA card unless ``device`` says otherwise.
"""

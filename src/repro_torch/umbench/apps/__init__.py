"""The paper's apps on PyTorch: the counterparts of ``repro.umbench.apps``.

Each module's ``workload(total_bytes)`` (``conv_fft.make_workload(kind)``
for the three convolutions) builds the app's declarative UM trace for the
simulator, as the reference's does; it is pure Python and touches no card.
Its ``numeric()`` computes the app for real: BS, cuBLAS and FDTD3d run
through the port's CUDA kernels; CG, Graph500 and the FFT convolutions are
plain PyTorch, as they are plain ``jnp`` on the JAX side.

Each ``numeric(seed=0, <sizes>, device=None)`` draws its inputs from a
``torch.Generator`` on the target device, returns them beside its outputs,
and runs on the CUDA card unless ``device`` says otherwise.
"""

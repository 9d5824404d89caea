"""Shared by the port's compiled-step tests: a ``TorchDispatchMode`` that
raises on what a step captured in a CUDA graph cannot do."""
import torch
from torch.utils._python_dispatch import TorchDispatchMode


class NoHostRead(TorchDispatchMode):
    """Raises on a read of a tensor's value on the host and on an operation
    whose output shape depends on the data (``nonzero``, ``masked_select``,
    indexing by a mask); with ``host_data`` set, also on a tensor built
    from host data (``torch.tensor``, which dispatches ``aten.lift_fresh``),
    which on a card is a copy from pageable memory that a capture refuses.
    The message names ``where``."""

    where = "the step"
    host_data = False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        aten = torch.ops.aten
        if (func.overloadpacket in (aten._local_scalar_dense, aten.nonzero, aten.masked_select)
                or self.host_data and func.overloadpacket is aten.lift_fresh
                or func.overloadpacket is aten.index and any(
                    i is not None and i.dtype in (torch.bool, torch.uint8) for i in args[1])):
            raise RuntimeError(f"{func} inside {self.where}")
        return func(*args, **(kwargs or {}))

"""Host-side native components (C++ for the host CPU, bound with
``ctypes``): the CIFAR binary decoder and the batch gather. Each is
built with ``g++`` on first use; every consumer has a NumPy version
that gives the same bytes where no compiler exists."""

from cs744_pytorch_distributed_tutorial_tpu_torch.native.build import (
    load_library,
    native_available,
)

__all__ = ["load_library", "native_available"]

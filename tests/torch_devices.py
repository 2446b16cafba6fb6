"""A tensor on a device type the port has neither a kernel nor a plain
version for, for the tests of the kernel wrappers' refusal."""

import torch


class OtherDevice(torch.Tensor):
    """A bf16 tensor of ``shape`` that reports ``xpu``; any op on it
    fails, so a wrapper must refuse it before computing anything."""

    @staticmethod
    def __new__(cls, *shape):
        return torch.Tensor._make_wrapper_subclass(
            cls, shape, dtype=torch.bfloat16, device="xpu")

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        raise NotImplementedError(func)

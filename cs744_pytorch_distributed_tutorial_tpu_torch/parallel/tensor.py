"""Tensor-parallel region boundaries: the Megatron f/g pair (the JAX
package's ``parallel/tensor.py``).

A sublayer splits into a column-parallel linear (output features split
over the tensor axis, no communication forward) and a row-parallel
linear (input features split, the partial outputs summed). The pair of
boundaries gets the backward right:

- ``copy_to_tp_region`` ("f"): identity forward, sum over the tensor
  axis backward, on the activation entering a column-parallel layer, so
  every parameter upstream sees the whole gradient;
- ``reduce_from_tp_region`` ("g"): sum forward, identity backward, on a
  row-parallel layer's partial output.

Both run on the group of this rank's line along the axes given
(``parallel/mesh.py::Mesh``) and are the identity on a line of one rank.
"""

from __future__ import annotations

import torch

from cs744_pytorch_distributed_tutorial_tpu_torch.parallel import collectives as C


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        with torch.no_grad():
            return C.axis_sum(g, ctx.mesh, *ctx.axes), None, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return C.axis_sum(x, mesh, *axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def copy_to_tp_region(x: torch.Tensor, mesh, *axes: str) -> torch.Tensor:
    """Identity forward; the sum over ``axes`` on the backward pass."""
    if mesh.size(*axes) == 1:
        return x
    return _Copy.apply(x, mesh, axes)


def reduce_from_tp_region(x: torch.Tensor, mesh, *axes: str) -> torch.Tensor:
    """The sum over ``axes`` forward; identity on the backward pass."""
    if mesh.size(*axes) == 1:
        return x
    return _Reduce.apply(x, mesh, axes)

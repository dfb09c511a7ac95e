"""Parameter creation with logical sharding axes: the torch twin of the JAX
package's ``repro/models/param.py`` factory.

:class:`Mk` draws each parameter from one ``torch.Generator``: a
fan-in-scaled normal drawn in f32 and cast to the parameter dtype (bf16 by
default, f32 where a parameter asks for it, as the MoE router does), or
zeros or ones.  Shapes, dtypes, scales and tree keys are the JAX
tree's; the numbers are not, since ``torch`` and ``jax.random`` give
different draws from one seed.  A test that needs both packages on the same
weights carries the JAX tree across (``repro_torch.convert.model_params``).
On the meta device it draws shapes alone and allocates nothing.

Each parameter names the reference's logical axes (``"embed"``,
``"heads"``, ...; ``repro_torch.distributed.sharding`` maps them to mesh
dims).  :class:`Mk` checks them against the shape; :class:`AxesMk` returns
them in place of the tensor, so the same init code yields the reference's
axes tree (``Model.logical_axes``) beside the parameters.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["AxesMk", "Mk"]


class Mk:
    """Parameter factory over one generator and device.

    ``layers=L`` draws a stack of ``L`` independent parameters of ``shape``
    in one call, with the per-layer fan-in: the JAX package builds the same
    stacked ``blocks`` tree by vmapping a per-layer init.
    """

    def __init__(self, generator: torch.Generator, device,
                 dtype: torch.dtype = torch.bfloat16):
        self.generator = generator
        self.device = torch.device(device)
        self.dtype = dtype

    def param(
        self,
        shape: Tuple[int, ...],
        axes: Tuple[Optional[str], ...],
        *,
        scale: Optional[float] = None,
        init: str = "normal",
        layers: Optional[int] = None,
        dtype: Optional[torch.dtype] = None,
    ) -> torch.Tensor:
        assert len(shape) == len(axes), (shape, axes)
        full = ((layers,) if layers else ()) + tuple(shape)
        dtype = dtype or self.dtype
        if init in ("zeros", "ones"):
            fill = torch.zeros if init == "zeros" else torch.ones
            return fill(full, dtype=dtype, device=self.device)
        if scale is None:
            fan_in = shape[0] if len(shape) > 1 else shape[-1]
            scale = fan_in**-0.5
        v = torch.randn(full, generator=self.generator, dtype=torch.float32,
                        device=self.device)
        return v.mul_(scale).to(dtype)


class AxesMk:
    """The same calls as :class:`Mk`, returning each parameter's logical
    axes (with ``"layers"`` ahead of a stacked one, the reference's
    ``merge_axes``) instead of a tensor."""

    def param(self, shape, axes, *, layers: Optional[int] = None,
              **_) -> tuple:
        assert len(shape) == len(axes), (shape, axes)
        return (("layers",) if layers else ()) + tuple(axes)

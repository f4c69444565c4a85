"""Montgomery multiply: the CUDA kernel ``csrc/mont_mul.cu`` and its wrapper.

Replaces ``ligero_tpu/engine/pallas_kernels.py:_mont_mul_kernel_factory``
(``mont_mul_pallas``), which the JAX package runs inside the sparse r^T A
product of the linear phase, for BN254 Fr and BLS12-377 Fq.  On this card
the kernel is bound by device memory (4 L bytes in per operand and out per
element: 64 for BN254, 96 for BLS12-377; ~200 or ~430 instructions of
arithmetic); its design is one thread per element with the limbs packed
into 32-bit words in registers, so every operand crosses memory once, and
a warp's results staged through shared memory (a swizzle free of bank
conflicts) so that they leave as whole 512-byte runs.

A tensor on the CPU takes the plain version (:func:`fieldops.mont_mul`); a
CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

from ..fields import FieldSpec

from . import cuda_build, fieldops

#: kernel launches by :func:`mont_mul`
launches = cuda_build.LaunchCounter()


def mont_mul(field: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """REDC(a * b) elementwise over ``(..., L)`` int32 limbs; shapes
    broadcast.  Fully reduced for a < R and b < p."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return fieldops.mont_mul(field, a, b)
    fid = cuda_build.kernel_field_id(field, "mont_mul")
    L = field.num_limbs
    shape = torch.broadcast_shapes(a.shape, b.shape)
    if shape[-1] != L:
        raise ValueError(f"mont_mul: last axis must hold {L} limbs, got {shape}")
    a = a.expand(shape).contiguous()
    broadcast = b.numel() == L
    b = b.contiguous() if broadcast else b.expand(shape).contiguous()
    out = torch.empty(shape, dtype=torch.int32, device=a.device)
    count = out.numel() // L
    if count == 0:
        return out
    cuda_build.require_cuda_tensors("mont_mul", a, b, out)
    lib = cuda_build.library()
    cuda_build.check(lib.lt_mont_mul(fid, a.data_ptr(), b.data_ptr(),
                                     out.data_ptr(), count, int(broadcast),
                                     cuda_build.stream_handle(a.device)),
                     "lt_mont_mul")
    launches.add()
    return out

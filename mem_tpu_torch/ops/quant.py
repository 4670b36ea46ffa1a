"""W8A8 int8 products for serving forwards, port of mem_tpu/ops/quant.py.

Post-training quantization with no calibration pass, the reference's
arithmetic operation for operation:

- weights: symmetric per-output-column int8, scale = f32 absmax / 127.0
  (a zero scale becomes 1.0), ``round`` half to even, then the cast;
- activations: symmetric per-row (last axis) dynamic int8, the same rule;
- the product accumulates in int32 and is dequantized as
  ``acc.f32 * row_scale * col_scale`` in that order; a bias is added in f32
  before the cast to the output dtype.

Weights here are (C_in, C_out), as the reference's flax kernels; the
models pass ``nn.Linear.weight.t()``. The reference computes the int8
product with ``lax.dot_general`` outside any Pallas kernel (quant.py:66-69),
so the port's product is a library call: :func:`int8_matmul` launches
``torch._int_mm`` (cuBLASLt's int8 path) for CUDA operands, counted as
``int8_mm``, and raises for a shape it refuses; CPU operands take an exact
integer product. It is forward-only: ``round`` has a zero gradient almost
everywhere, so ``models.vit.INT8_GEMM`` is honoured only in eval mode.
"""
from __future__ import annotations

import torch

from mem_tpu_torch.kernels import count_launch

# torch._int_mm's shape rules on CUDA: more than 16 rows, inner and outer
# widths positive multiples of 8
INT_MM_MIN_ROWS = 17
INT_MM_ALIGN = 8


def _scale(absmax: torch.Tensor) -> torch.Tensor:
    # divided by a tensor: PyTorch's CUDA division by a Python number
    # multiplies by its rounded reciprocal, which is not the reference's
    # correctly rounded absmax / 127.0 (one ulp off for some values)
    scale = absmax / torch.full((), 127.0, device=absmax.device)
    return torch.where(scale == 0.0, torch.ones_like(scale), scale)


def quantize_weight(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-column int8 quantization of a (C_in, C_out)
    weight: (w_int8, col_scale f32 (C_out,)) with w ~= w_int8 * col_scale.
    The int8 tensor keeps ``w``'s strides (a transposed view stays one)."""
    wf = w.float()
    safe = _scale(wf.abs().amax(dim=0))
    return torch.round(wf / safe).to(torch.int8), safe


def quantize_activation(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row (last-axis) symmetric dynamic int8 quantization: (x_int8,
    row_scale f32 shaped like x with the last axis kept as 1)."""
    xf = x.float()
    safe = _scale(xf.abs().amax(dim=-1, keepdim=True))
    return torch.round(xf / safe).to(torch.int8), safe


def int8_matmul_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The exact integer product of (M, K) and (K, N) int8 tensors as int32.
    Computed in f64: every product and partial sum is an integer below
    127^2 * K < 2^53, so each is exact in any order."""
    return torch.matmul(a.double(), b.double()).to(torch.int32)


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (K, N) int8 -> (M, N) int32. CPU tensors take the plain
    version; CUDA tensors launch ``torch._int_mm`` or raise (a shape it
    refuses is never converted to another dtype)."""
    if a.dtype != torch.int8 or b.dtype != torch.int8 or a.dim() != 2 or b.dim() != 2 \
            or a.shape[1] != b.shape[0]:
        raise ValueError(f"int8_matmul takes (M, K) and (K, N) int8 tensors, got "
                         f"{a.dtype} {tuple(a.shape)} and {b.dtype} {tuple(b.shape)}")
    if a.device.type == "cpu" and b.device.type == "cpu":
        return int8_matmul_reference(a, b)
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"int8_matmul: operands on {a.device} and {b.device}")
    (M, K), N = a.shape, b.shape[1]
    if M < INT_MM_MIN_ROWS or K % INT_MM_ALIGN or N % INT_MM_ALIGN or K == 0 or N == 0:
        raise ValueError(f"int8_matmul: torch._int_mm takes more than 16 rows and inner / "
                         f"outer widths that are multiples of 8, got ({M}, {K}) @ ({K}, {N})")
    # cuBLASLt's int8 path reads B column-major: the transpose of a
    # contiguous (N, K) weight is already that
    if b.stride(0) != 1 or b.stride(1) != K:
        b = b.t().contiguous().t()
    out = torch._int_mm(a.contiguous(), b)
    count_launch("int8_mm")
    return out


def _int8_product(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """Contract xq's last axis with wq's first: (..., K) @ (K, N) int32."""
    lead = xq.shape[:-1]
    acc = int8_matmul(xq.reshape(-1, xq.shape[-1]), wq)
    return acc.reshape(*lead, wq.shape[1])


def dense_w8a8_prequant(xq: torch.Tensor, row_scale: torch.Tensor, w: torch.Tensor,
                        bias: torch.Tensor | None, out_dtype: torch.dtype) -> torch.Tensor:
    """The int8 product against an already-quantized activation (the q / k /
    v projections share one), dequantized, the bias added in f32."""
    wq, col_scale = quantize_weight(w)
    out = _int8_product(xq, wq).float() * row_scale * col_scale
    if bias is not None:
        out = out + bias.float()
    return out.to(out_dtype)


def dense_w8a8(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None = None,
               out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``x @ w + bias`` with both operands int8-quantized on the fly: x
    (..., C_in) in any float dtype, w (C_in, C_out). The output dtype
    defaults to x's."""
    xq, row_scale = quantize_activation(x)
    return dense_w8a8_prequant(xq, row_scale, w, bias, out_dtype or x.dtype)

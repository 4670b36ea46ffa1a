"""Fused attention on flat (B, N, H*D) layouts: kernel K2 (forward) and its
plain version.

Port of mem_tpu/ops/attention.py ``fused_attention_flat``: per head,
``softmax(q k^T * scale + bias_h) v`` with q/k/v flat (B, N, H*D) and a
(H, N, N) f32 bias shared by the batch (the BEiT relative-position bias).
The head count comes from the bias. On the card the work is done by
csrc/attention_fwd.cu: a tensor-core kernel for bf16 at head dim 64 and
N <= 256 (the serving shapes), a scalar kernel for the rest (f32 included).
The backward (K2b, with the f32 bias gradient) comes with the training
slice, so the CUDA path refuses inputs that need grad.
"""
from __future__ import annotations

import torch

from mem_tpu_torch.kernels import count_launch

MAX_SMEM_BYTES = 232_448   # the most dynamic shared memory one H100 block may use


def fused_attention_flat_reference(q, k, v, bias, scale: float):
    """Plain version, in the TPU kernel's order (attention.py:115-125):
    s = (q.k) * scale in f32 from the operands, + f32 bias, f32 softmax,
    p cast to v's dtype, PV with f32 accumulation, output in q's dtype."""
    B, N, C = q.shape
    H = bias.shape[0]
    D = C // H

    def heads(t):
        return t.reshape(B, N, H, D).transpose(1, 2).float()

    s = torch.matmul(heads(q), heads(k).transpose(-1, -2)) * scale
    s = s + bias.float()
    s = s - s.amax(dim=-1, keepdim=True)
    e = torch.exp(s)
    p = e / e.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(v.dtype).float(), heads(v))
    return o.transpose(1, 2).reshape(B, N, C).to(q.dtype)


def fused_attention_flat(q, k, v, bias, scale: float):
    """(B, N, H*D) q/k/v + (H, N, N) f32 bias -> (B, N, H*D) in q's dtype.

    CPU tensors take the plain version; CUDA tensors launch K2 forward or
    raise."""
    if q.device.type == "cpu":
        return fused_attention_flat_reference(q, k, v, bias, scale)
    if q.device.type != "cuda" or any(t.device != q.device for t in (k, v, bias)):
        raise ValueError("fused_attention_flat: q, k, v and bias must share one CUDA device")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v, bias)):
        raise NotImplementedError(
            "fused_attention_flat has no CUDA backward yet (kernel K2b comes "
            "with the pretraining slice); call it under torch.no_grad() or "
            "torch.inference_mode()")
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"fused_attention_flat takes f32 or bf16 q/k/v of one "
                        f"dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if bias.dtype != torch.float32:
        raise TypeError(f"fused_attention_flat takes an f32 bias, got {bias.dtype}")
    B, N, C = q.shape
    H = bias.shape[0]
    if k.shape != q.shape or v.shape != q.shape or bias.shape != (H, N, N) \
            or C % H:
        raise ValueError(f"fused_attention_flat: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, bias {tuple(bias.shape)}")
    D = C // H
    if not all(t.is_contiguous() for t in (q, k, v, bias)):
        raise ValueError("fused_attention_flat: q, k, v and bias must be contiguous")
    from mem_tpu_torch.kernels import build

    lib = build.library()
    is_bf16 = int(q.dtype == torch.bfloat16)
    smem = lib.mem_attention_fwd_flat_smem(N, D, is_bf16)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"fused_attention_flat: N={N}, D={D} needs {smem} B of "
                         f"shared memory, above the {MAX_SMEM_BYTES} B a block may use")
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.mem_attention_fwd_flat(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                    bias.data_ptr(), out.data_ptr(),
                                    B, N, H, D, float(scale), is_bf16, stream)
    build.check("fused_attention_flat", rc)
    count_launch("fused_attention_flat")
    return out


def cuda_kernel_path(q, k, v, bias) -> str:
    """Which CUDA kernel a launch on these operands takes: "mma" (tensor
    cores) or "scalar"."""
    from mem_tpu_torch.kernels import build

    H = bias.shape[0]
    D = q.shape[-1] // H
    is_bf16 = int(q.dtype == torch.bfloat16)
    mma = build.library().mem_attention_fwd_flat_uses_mma(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q.data_ptr(), q.shape[1], D, is_bf16)
    return "mma" if mma else "scalar"

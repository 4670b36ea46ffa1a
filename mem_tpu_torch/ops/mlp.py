"""The fused ViT MLP: kernels K6f (forward) and K6b (backward) and their
plain versions.

Port of mem_tpu/ops/mlp.py ``mlp_fused`` and its VJP:
``out = gelu(T(x W1 + b1)) W2 + b2`` over the rows of ``x`` (T is x's dtype,
bf16 in training; every sum is f32). h is stored once, as the backward's
residual, or not at all on inference calls. The roundings are the reference
kernel's (mlp.py:54-64, :118-154): h is rounded to T before gelu, gelu and
gelu' are taken in f32 from that rounded value with the Abramowitz & Stegun
erf polynomial (not ``erf``), g and dh are rounded to T before the products
that consume them, and the weight and bias gradients are f32 sums over all
rows.

``mlp_fused`` is a ``torch.autograd.Function``. On the card the forward is
csrc/mlp_fwd.cu and the backward csrc/mlp_bwd.cu: bf16 at C in {128, 384,
768} with hidden % 128 == 0 takes the Hopper GEMM body of
csrc/gemm_sm90.cuh (:func:`kernel_route` says "wgmma"; two launches forward,
three and two short passes backward, with bf16 g and dh workspaces and the
weight gradients summed over a fixed row plan, :func:`wgrad_chunk_plan`),
everything else, f32 included, the scalar kernels; on the CPU both directions
take the plain versions. Weights are passed as the reference passes them,
``w1 (C, hidden)`` and ``w2 (hidden, C)``; a transposed view of a torch
``nn.Linear`` weight is the cheap way to do that, since the forward kernel
wants exactly torch's storage.
"""
from __future__ import annotations

import math

import torch

from mem_tpu_torch.kernels import count_launch
from mem_tpu_torch.ops.attention import MAX_SMEM_BYTES

_INV_SQRT2 = 1.0 / math.sqrt(2.0)
_INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)

WGMMA_WIDTHS = (128, 384, 768)   # the C the Hopper GEMM takes (csrc/mlp_rows.cuh)
WGRAD_ROWS_PER_CHUNK = 4096      # the weight gradients' row plan: about this many rows a
WGRAD_MAX_CHUNKS = 4             # chunk, at most this many chunks (4 x 144 tiles fill the
                                 # 132 SMs 4.4 times; each chunk costs 2 x hidden x C f32)
COLSUM_ROWS = 256                # db1 / db2: rows summed in order by one colsum block


def kernel_route(dtype, C: int, hidden: int) -> str:
    """The kernels K6f and K6b take on the card for operands of ``dtype`` at
    widths (C, hidden), 16-byte aligned: "wgmma" (the Hopper GEMM body) for
    bf16 at C in WGMMA_WIDTHS and hidden a positive multiple of 128, else
    "scalar". mlp_rows.cuh's ``mlp_wgmma_shape`` is the same rule."""
    ok = dtype == torch.bfloat16 and C in WGMMA_WIDTHS and hidden > 0 and hidden % 128 == 0
    return "wgmma" if ok else "scalar"


def wgrad_chunk_plan(rows: int) -> tuple[int, int]:
    """(chunk_rows, chunks) of K6b's weight gradients on the Hopper path: the
    rows cut into ``chunks`` runs of ``chunk_rows`` (a multiple of 64, the
    GEMM's depth step; the last run may be shorter), in order, each row in
    exactly one; a function of ``rows`` alone, so the sums' order is too."""
    if rows <= 0:
        raise ValueError(f"wgrad_chunk_plan: rows must be positive, got {rows}")
    want = min(WGRAD_MAX_CHUNKS, -(-rows // WGRAD_ROWS_PER_CHUNK))
    chunk_rows = 64 * -(-(-(-rows // want)) // 64)
    return chunk_rows, -(-rows // chunk_rows)


def erf_poly(x: torch.Tensor) -> torch.Tensor:
    """erf by Abramowitz & Stegun 7.1.26 (|error| < 1.5e-7), the polynomial
    the kernels evaluate (mlp.py:38-46)."""
    a = x.abs()
    t = 1.0 / (1.0 + 0.3275911 * a)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (1.421413741
               + t * (-1.453152027 + t * 1.061405429))))
    return torch.sign(x) * (1.0 - poly * torch.exp(-a * a))


def gelu_poly(h: torch.Tensor) -> torch.Tensor:
    """Exact-form gelu with :func:`erf_poly` (mlp.py:49-51)."""
    return 0.5 * h * (1.0 + erf_poly(h * _INV_SQRT2))


def gelu_grad_poly(h: torch.Tensor) -> torch.Tensor:
    """gelu'(h) = 0.5 (1 + erf(h / sqrt 2)) + h phi(h) (mlp.py:135-136)."""
    phi = torch.exp(-0.5 * h * h) * _INV_SQRT_2PI
    return 0.5 * (1.0 + erf_poly(h * _INV_SQRT2)) + h * phi


def mlp_fused_reference(x, w1, b1, w2, b2, save_h: bool = True):
    """Plain version of K6f on 2-D operands of one dtype: x (R, C), w1
    (C, hidden), b1 (hidden), w2 (hidden, C), b2 (C) -> (out (R, C), h
    (R, hidden)), h None with ``save_h=False``."""
    h = torch.matmul(x.float(), w1.float()) + b1.float()
    hb = h.to(x.dtype)
    g = gelu_poly(hb.float()).to(x.dtype)
    o = torch.matmul(g.float(), w2.float())
    return (o + b2.float()).to(x.dtype), (hb if save_h else None)


def mlp_fused_bwd_reference(do, h, x, w1, w2):
    """Plain version of K6b: (dx (R, C) in x's dtype, dW1 (C, hidden), dW2
    (hidden, C), db1 (hidden), db2 (C)), the last four f32."""
    hf = h.float()
    dof = do.float()
    g = gelu_poly(hf).to(do.dtype).float()
    dw2 = torch.matmul(g.t(), dof)
    db2 = dof.sum(dim=0)
    dh = (torch.matmul(dof, w2.float().t()) * gelu_grad_poly(hf)).to(do.dtype).float()
    dw1 = torch.matmul(x.float().t(), dh)
    db1 = dh.sum(dim=0)
    dx = torch.matmul(dh, w1.float().t()).to(x.dtype)
    return dx, dw1, dw2, db1, db2


def mlp_fused_bwd_chunked(do, h, x, w1, w2):
    """K6b's order of sums on the Hopper path, in plain torch (the tests'
    emulation of csrc/mlp_bwd.cu; the wrappers never call it): as
    :func:`mlp_fused_bwd_reference`, but dW1 and dW2 are each
    :func:`wgrad_chunk_plan`'s chunk products added in chunk order, and db1
    and db2 the column sums of COLSUM_ROWS-row blocks added in block order."""
    hf, dof, xf = h.float(), do.float(), x.float()
    g = gelu_poly(hf).to(do.dtype).float()
    dh = (torch.matmul(dof, w2.float().t()) * gelu_grad_poly(hf)).to(do.dtype).float()
    chunk_rows, chunks = wgrad_chunk_plan(x.shape[0])
    dw1 = dw2 = db1 = db2 = None
    for s in range(chunks):
        r = slice(s * chunk_rows, (s + 1) * chunk_rows)
        p1, p2 = torch.matmul(xf[r].t(), dh[r]), torch.matmul(g[r].t(), dof[r])
        dw1, dw2 = (p1, p2) if s == 0 else (dw1 + p1, dw2 + p2)
    for q in range(-(-x.shape[0] // COLSUM_ROWS)):
        r = slice(q * COLSUM_ROWS, (q + 1) * COLSUM_ROWS)
        c1, c2 = dh[r].sum(dim=0), dof[r].sum(dim=0)
        db1, db2 = (c1, c2) if q == 0 else (db1 + c1, db2 + c2)
    dx = torch.matmul(dh, w1.float().t()).to(x.dtype)
    return dx, dw1, dw2, db1, db2


def _check_cuda_operands(name, x, others, shapes):
    if x.device.type != "cuda" or any(t.device != x.device for t in others):
        raise ValueError(f"{name}: all operands must share one CUDA device")
    if x.dtype not in (torch.float32, torch.bfloat16) or any(
            t.dtype != x.dtype for t in others):
        raise TypeError(f"{name} takes f32 or bf16 operands of one dtype, got "
                        f"{[t.dtype for t in (x, *others)]}")
    if any(tuple(t.shape) != s for t, s in zip((x, *others), shapes)):
        raise ValueError(f"{name}: shapes {[tuple(t.shape) for t in (x, *others)]}, "
                         f"expected {shapes}")
    if not all(t.is_contiguous() for t in (x, *others)):
        raise ValueError(f"{name}: all operands must be contiguous")


def _scalar_smem_check(name, lib, C):
    smem = lib.mem_mlp_scalar_smem(C)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"{name}: C={C} needs {smem} B of shared memory on the scalar "
                         f"kernels, above the {MAX_SMEM_BYTES} B a block may use")


def mlp_fwd_2d(x, w1, b1, w2, b2, save_h: bool = True):
    """K6f on 2-D operands of one dtype (shapes as
    :func:`mlp_fused_reference`). CPU tensors take the plain version; CUDA
    tensors launch the kernels or raise (the Hopper path with a (R, hidden)
    g workspace in x's dtype, allocated here)."""
    if x.device.type == "cpu":
        return mlp_fused_reference(x, w1, b1, w2, b2, save_h)
    R, C = x.shape
    hidden = w1.shape[1]
    # the kernel reads both weights along their contraction: torch's storage
    w1t, w2t = w1.t().contiguous(), w2.t().contiguous()
    _check_cuda_operands("mlp_fused", x, (w1t, b1, w2t, b2),
                         [(R, C), (hidden, C), (hidden,), (C, hidden), (C,)])
    from mem_tpu_torch.kernels import build

    lib = build.library(x.device)
    is_bf16 = int(x.dtype == torch.bfloat16)
    out = torch.empty_like(x)
    h = torch.empty(R, hidden, dtype=x.dtype, device=x.device) if save_h else None
    if R == 0:
        return out, h
    ptrs = [t.data_ptr() if t is not None else None for t in (x, w1t, b1, w2t, b2, out, h)]
    g_ws = None
    if lib.mem_mlp_fwd_path(*ptrs, C, hidden, is_bf16):
        g_ws = torch.empty(R, hidden, dtype=x.dtype, device=x.device)
    else:
        _scalar_smem_check("mlp_fused", lib, C)
    rc = lib.mem_mlp_fwd(*ptrs, None if g_ws is None else g_ws.data_ptr(), R, C, hidden, is_bf16,
                         torch.cuda.current_stream(x.device).cuda_stream)
    build.check("mlp_fused", rc)
    count_launch("mlp_fused")
    return out, h


def mlp_bwd_2d(do, h, x, w1, w2):
    """K6b on 2-D operands of one dtype (shapes as
    :func:`mlp_fused_bwd_reference`). CPU tensors take the plain version;
    CUDA tensors launch the kernels or raise. The workspaces are allocated
    here: dh (R, hidden) in x's dtype and, on the Hopper path, g (R, hidden)
    in x's dtype, the f32 weight-gradient partials (2, chunks, hidden, C)
    and the f32 column-sum partials (ceil(R / COLSUM_ROWS), hidden + C)."""
    if x.device.type == "cpu":
        return mlp_fused_bwd_reference(do, h, x, w1, w2)
    R, C = x.shape
    hidden = w1.shape[1]
    w1, w2 = w1.contiguous(), w2.contiguous()
    _check_cuda_operands("mlp_fused_bwd", x, (do, h, w1, w2),
                         [(R, C), (R, C), (R, hidden), (C, hidden), (hidden, C)])
    dx = torch.empty_like(x)
    f32 = dict(dtype=torch.float32, device=x.device)
    if R == 0:
        return (dx, torch.zeros(C, hidden, **f32), torch.zeros(hidden, C, **f32),
                torch.zeros(hidden, **f32), torch.zeros(C, **f32))
    from mem_tpu_torch.kernels import build

    lib = build.library(x.device)
    is_bf16 = int(x.dtype == torch.bfloat16)
    dw1t = torch.empty(hidden, C, **f32)
    dw2 = torch.empty(hidden, C, **f32)
    db1 = torch.empty(hidden, **f32)
    db2 = torch.empty(C, **f32)
    dh_ws = torch.empty(R, hidden, dtype=x.dtype, device=x.device)
    ptrs = [t.data_ptr() for t in (do, h, x, w1, w2, dx, dh_ws)]
    chunk_rows, chunks = wgrad_chunk_plan(R)
    g_ws = part_ws = cs_ws = None
    if lib.mem_mlp_bwd_path(*ptrs, C, hidden, is_bf16):
        g_ws = torch.empty(R, hidden, dtype=x.dtype, device=x.device)
        part_ws = torch.empty(2, chunks, hidden, C, **f32)
        cs_ws = torch.empty(-(-R // COLSUM_ROWS), hidden + C, **f32)
    else:
        _scalar_smem_check("mlp_fused_bwd", lib, C)
    ws = [None if t is None else t.data_ptr() for t in (g_ws, part_ws, cs_ws)]
    rc = lib.mem_mlp_bwd(*ptrs[:5], dx.data_ptr(), dw1t.data_ptr(), dw2.data_ptr(),
                         db1.data_ptr(), db2.data_ptr(), dh_ws.data_ptr(), *ws, R, C, hidden,
                         chunk_rows, chunks, COLSUM_ROWS, is_bf16,
                         torch.cuda.current_stream(x.device).cuda_stream)
    build.check("mlp_fused_bwd", rc)
    count_launch("mlp_fused_bwd")
    return dx, dw1t.t(), dw2, db1, db2


class _MlpFused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2):
        x2 = x.reshape(-1, x.shape[-1]).contiguous()
        dt = x.dtype
        out, h = mlp_fwd_2d(x2, w1.to(dt), b1.to(dt), w2.to(dt), b2.to(dt),
                            save_h=any(ctx.needs_input_grad))
        ctx.save_for_backward(x2, h, w1, w2)
        return out.reshape(x.shape)

    @staticmethod
    def backward(ctx, dout):
        x2, h, w1, w2 = ctx.saved_tensors
        dt = x2.dtype
        do2 = dout.reshape(-1, x2.shape[-1]).to(dt).contiguous()
        dx, dw1, dw2, db1, db2 = mlp_bwd_2d(do2, h, x2, w1.to(dt), w2.to(dt))
        return (dx.reshape(dout.shape), dw1.to(w1.dtype), db1.to(w1.dtype),
                dw2.to(w2.dtype), db2.to(w2.dtype))


def mlp_fused(x, w1, b1, w2, b2):
    """(..., C) -> (..., C): fc2(gelu(fc1(x))) in x's dtype, differentiable
    in all five operands. ``w1`` (C, hidden), ``b1``, ``w2`` (hidden, C) and
    ``b2`` may be f32 parameters: they are cast to x's dtype for the compute
    and receive f32 gradients. Where nothing requires a gradient (inference)
    h is not stored. CPU tensors take the plain versions; CUDA tensors launch
    K6f forward and K6b backward, or raise."""
    return _MlpFused.apply(x, w1, b1, w2, b2)


def cuda_kernel_path(x, hidden: int) -> str:
    """Which CUDA kernels a launch at x's width and dtype takes (its operands
    as aligned as x): "wgmma" (the Hopper GEMM body) or "scalar"."""
    from mem_tpu_torch.kernels import build

    p = x.data_ptr()
    wgmma = build.library().mem_mlp_fwd_path(p, p, p, p, p, p, p, x.shape[-1], hidden,
                                             int(x.dtype == torch.bfloat16))
    return "wgmma" if wgmma else "scalar"

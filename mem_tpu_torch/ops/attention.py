"""Fused attention: kernels K2f (forward), K2b (backward), K3f (forward at
long N) and K3b (backward at long N) on flat (B, N, H*D) layouts, K5a / K5b
(forward) and K5c / K5d / K5e (backward) on head-major (B, H, N, D) layouts,
and their plain versions.

Port of mem_tpu/ops/attention.py ``fused_attention_flat`` and its VJP: per
head, ``softmax(q k^T * scale + bias_h) v`` with q/k/v flat (B, N, H*D) and
a (H, N, N) f32 bias shared by the batch (the BEiT relative-position bias),
whose gradient is summed over the batch. The head count comes from the
bias. ``fused_attention_flat`` is a ``torch.autograd.Function``. On the card,
for bf16 at head dim 64 or 32 and N <= 256 (the serving and training shapes,
the MAE decoder's 16 heads of 32), the forward launches K3f's Hopper kernel
and the backward K3b's (below; at these N their rings hold a (b, h)'s whole K
and V, or Q and dO, within the first pass); the other shapes, f32 included,
take the scalar kernels of csrc/attention_fwd.cu and attention_bwd.cu. On the
CPU both directions take the plain versions.

``fused_attention_flat_long`` is the same function for sequences too long
for K2f, whose blocks hold a head's whole K and V in shared memory: the
segmentation backbone's N = 1025. Its forward on the card is
csrc/attention_long_fwd.cu (K3f), which tiles the keys and, for bf16 at
head dim 64 or 32, goes over them once with an online softmax on ``wgmma`` (K and V
through a TMA ring; the unnormalised p rounded to bf16 where the plain version
rounds the normalised one), and otherwise twice (row max and sum, then p v)
in the plain version's order of roundings; its backward is
csrc/attention_long_bwd.cu (K3b), which goes over the scores from the query
side (dq, ds) and from the key side (dk, dv), for bf16 at head dim 64 or 32
on ``wgmma`` with tiles through TMA rings, and sums the bias gradient in batch
order. :func:`attention_route` is the rule that picks between the two.

``fused_attention`` is the reference's ``fused_attention`` on (B, H, N, D),
the layout its head-major branch produces (``FLAT_ATTN = False``, or
``FLAT_ATTN_LONG = False`` at long N), with the reference's routing rule
(:func:`fused_attention_route`): for the shapes its head-blocked kernels take
(``_hb_eligible``) K5a forward and K5c backward (K2f's and K2b's kernels
with head-major addressing: for bf16 at head dim 64 or 32 K3's Hopper bodies in
csrc/attention_long_fwd_bhnd.cu and attention_long_bwd_bhnd.cu, else the
scalar csrc/attention_fwd_bhnd.cu and attention_bwd_bhnd.cu);
for the others K5b forward and K5d (N <= ``_WHOLE_BWD_MAX_N``) or K5e
backward (csrc/attention_long_fwd_bhnd.cu, attention_long_bwd_bhnd.cu: K3f's
and K3b's key-tiled kernels with head-major addressing).

``fused_attention_flat_bwd_pair`` (X3, csrc/attention_bwd_pair.cu) is the
experiment of scripts/exp_attn_bwd.py: K2b's function with each head's two
depth-D products s = q k^T and dp = do v^T taken as one depth-2D product
against a block-diagonal operand, on K2b's own Hopper body (K3b's rows kernel
with the pair as one m64n128k16 chain), held bit for bit to
``fused_attention_flat_bwd``. No model path calls it;
``mem_tpu_torch.tools.exp_attn_bwd`` times the two side by side.
"""
from __future__ import annotations

import torch

from mem_tpu_torch.kernels import count_launch

MAX_SMEM_BYTES = 232_448   # the most dynamic shared memory one H100 block may use
# The longest N the flat route sends to K2f / K2b (and the head-blocked one,
# for bf16 at head dim 64 or 32, to K3's Hopper bodies under K5a's / K5c's names):
# K2's scalar kernels keep a head's whole K and V in one block's shared
# memory; above it the key-tiled K3f and K3b take over.
FLAT_MAX_N = 256


def _heads(t, H):
    B, N, C = t.shape
    return t.reshape(B, N, H, C // H).transpose(1, 2).float()


def fused_attention_flat_reference(q, k, v, bias, scale: float):
    """Plain version, in the TPU kernel's order (attention.py:115-125):
    s = (q.k) * scale in f32 from the operands, + f32 bias, f32 softmax,
    p cast to v's dtype, PV with f32 accumulation, output in q's dtype."""
    B, N, C = q.shape
    H = bias.shape[0]
    s = torch.matmul(_heads(q, H), _heads(k, H).transpose(-1, -2)) * scale
    s = s + bias.float()
    s = s - s.amax(dim=-1, keepdim=True)
    e = torch.exp(s)
    p = e / e.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(v.dtype).float(), _heads(v, H))
    return o.transpose(1, 2).reshape(B, N, C).to(q.dtype)


def fused_attention_flat_bwd_reference(q, k, v, bias, do, scale: float):
    """Plain backward, in the TPU kernel's order (attention.py:147-167):
    p recomputed in f32, pc = p in v's dtype, dv = pc^T do, dp = do v^T,
    delta = rowsum(dp * p), ds = p (dp - delta) in f32, dsc = ds in q's
    dtype, dq = (dsc k) * scale and dk = (dsc^T q) * scale accumulated in
    f32 and then cast, db = ds summed over the batch in f32 (H, N, N)."""
    H = bias.shape[0]
    qh, kh, vh, doh = (_heads(t, H) for t in (q, k, v, do))
    return _flat_bwd_from_products(q, k, v, bias, qh, kh, doh,
                                   torch.matmul(qh, kh.transpose(-1, -2)),
                                   torch.matmul(doh, vh.transpose(-1, -2)), scale)


def fused_attention_flat_bwd_pair_reference(q, k, v, bias, do, scale: float):
    """Plain version of X3 (scripts/exp_attn_bwd.py:_bwd_flat_pair_kernel):
    per (b, h) the product [q | do] (N, 2D) . [[k^T, 0], [0, v^T]] (2D, 2N)
    computed literally and split into s = q k^T and dp = do v^T, then K2b's
    plain steps."""
    B, N, C = q.shape
    H = bias.shape[0]
    qh, kh, vh, doh = (_heads(t, H) for t in (q, k, v, do))
    z = qh.new_zeros(B, H, C // H, N)
    rhs = torch.cat([torch.cat([kh.transpose(-1, -2), z], -1),
                     torch.cat([z, vh.transpose(-1, -2)], -1)], -2)
    both = torch.matmul(torch.cat([qh, doh], -1), rhs)
    return _flat_bwd_from_products(q, k, v, bias, qh, kh, doh, both[..., :N], both[..., N:],
                                   scale)


def _flat_bwd_from_products(q, k, v, bias, qh, kh, doh, qk, dp, scale: float):
    """K2b's plain steps after the two products of its phase 1, qk = q k^T
    and dp = do v^T (f32, per head)."""
    B, N, C = q.shape
    s = qk * scale + bias.float()
    s = s - s.amax(dim=-1, keepdim=True)
    e = torch.exp(s)
    p = e / e.sum(dim=-1, keepdim=True)
    pc = p.to(v.dtype).float()
    dv = torch.matmul(pc.transpose(-1, -2), doh)
    delta = (dp * p).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta)
    dsc = ds.to(q.dtype).float()
    dq = torch.matmul(dsc, kh) * scale
    dk = torch.matmul(dsc.transpose(-1, -2), qh) * scale

    def flat(t, dtype):
        return t.transpose(1, 2).reshape(B, N, C).to(dtype)

    return flat(dq, q.dtype), flat(dk, k.dtype), flat(dv, v.dtype), ds.sum(dim=0)


def _check_cuda_operands(name, tensors, q, bias, bhnd: bool = False):
    """The device, dtype, shape and layout rules the CUDA wrappers share;
    returns (B, N, H, D). q/k/v are flat (B, N, H*D), or with ``bhnd``
    head-major (B, H, N, D)."""
    if q.device.type != "cuda" or any(t.device != q.device for t in tensors):
        raise ValueError(f"{name}: all operands must share one CUDA device")
    if q.dtype not in (torch.float32, torch.bfloat16) or any(
            t.dtype != q.dtype for t in tensors if t is not bias):
        raise TypeError(f"{name} takes f32 or bf16 operands of one dtype, got "
                        f"{[t.dtype for t in tensors if t is not bias]}")
    if bias.dtype != torch.float32:
        raise TypeError(f"{name} takes an f32 bias, got {bias.dtype}")
    H = bias.shape[0]
    if bhnd:
        B, Hq, N, D = q.shape
        bad = Hq != H
    else:
        B, N, C = q.shape
        D, bad = C // H, bool(C % H)
    if bad or any(t.shape != q.shape for t in tensors if t is not bias) \
            or bias.shape != (H, N, N):
        raise ValueError(f"{name}: shapes {[tuple(t.shape) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: all operands must be contiguous")
    return B, N, H, D


def _smem_check(name, smem, N, D):
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"{name}: N={N}, D={D} needs {smem} B of shared memory, "
                         f"above the {MAX_SMEM_BYTES} B a block may use")


def _forward(q, k, v, bias, scale: float):
    """(B, N, H*D) q/k/v + (H, N, N) f32 bias -> (B, N, H*D) in q's dtype.
    CPU tensors take the plain version; CUDA tensors launch K2f or raise."""
    if q.device.type == "cpu":
        return fused_attention_flat_reference(q, k, v, bias, scale)
    name = "fused_attention_flat"
    B, N, H, D = _check_cuda_operands(name, (q, k, v, bias), q, bias)
    if _k2_wgmma(q, k, v, None, N, D):
        return _long_fwd(name, "mem_attention_long_fwd", q, k, v, bias, scale, B, N, H, D)
    return _scalar_fwd(name, "mem_attention_fwd_flat", q, k, v, bias, scale, B, N, H, D)


def _scalar_fwd(name, entry, q, k, v, bias, scale, B, N, H, D):
    """Launch K2f's (or K5a's) scalar kernel through the C entry point
    ``entry`` and count the launch under ``name``."""
    from mem_tpu_torch.kernels import build

    lib = build.library(q.device)
    is_bf16 = int(q.dtype == torch.bfloat16)
    _smem_check(name, lib.mem_attention_fwd_flat_smem(N, D, is_bf16), N, D)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = getattr(lib, entry)(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                             out.data_ptr(), B, N, H, D, float(scale), is_bf16, stream)
    build.check(name, rc)
    count_launch(name)
    return out


def _k2_wgmma(q, k, v, do, N, D) -> bool:
    """Whether a K2 (or K5a / K5c) launch on these operands takes K3's Hopper
    body: N <= FLAT_MAX_N and K3f's (``do`` None) or K3b's wgmma rule (bf16,
    head dim 64 or 32, 16-byte aligned). Outputs are allocated like the
    operands, so their alignment is the operands'."""
    from mem_tpu_torch.kernels import build

    if N > FLAT_MAX_N:
        return False
    lib, is_bf16 = build.library(), int(q.dtype == torch.bfloat16)
    p = [q.data_ptr(), k.data_ptr(), v.data_ptr()]
    if do is None:
        return bool(lib.mem_attention_long_fwd_uses_mma(*p, q.data_ptr(), D, is_bf16))
    return bool(lib.mem_attention_long_bwd_uses_mma(*p, do.data_ptr(), *p, D, is_bf16))


def fused_attention_flat_bwd(q, k, v, bias, do, scale: float):
    """The VJP of :func:`fused_attention_flat`: (dq, dk, dv) shaped and typed
    as q/k/v and db (H, N, N) f32 summed over the batch. CPU tensors take the
    plain version; CUDA tensors launch K2b or raise."""
    if q.device.type == "cpu":
        return fused_attention_flat_bwd_reference(q, k, v, bias, do, scale)
    name = "fused_attention_flat_bwd"
    B, N, H, D = _check_cuda_operands(name, (q, k, v, bias, do), q, bias)
    if _k2_wgmma(q, k, v, do, N, D):
        return _long_bwd(name, "mem_attention_long_bwd", q, k, v, bias, do, scale, B, N, H, D)
    from mem_tpu_torch.kernels import build

    _smem_check(name, build.library().mem_attention_bwd_flat_smem(
        N, D, int(q.dtype == torch.bfloat16)), N, D)
    return _flat_bwd(name, "mem_attention_bwd_flat", q, k, v, bias, do, scale, B, N, H, D)


def fused_attention_flat_bwd_pair(q, k, v, bias, do, scale: float):
    """X3: K2b's function, with each head's s = q k^T and dp = do v^T taken as
    one depth-2D product against a block-diagonal operand (the experiment of
    scripts/exp_attn_bwd.py). (dq, dk, dv) shaped and typed as q/k/v and db
    (H, N, N) f32 summed over the batch. CPU tensors take the plain version;
    CUDA tensors launch csrc/attention_bwd_pair.cu (K2b's Hopper body with the
    pair in its rows kernel: bf16, head dim 64, N <= FLAT_MAX_N and 16-byte
    aligned operands only, K2b's Hopper domain; other operands raise before
    any launch) or raise."""
    if q.device.type == "cpu":
        return fused_attention_flat_bwd_pair_reference(q, k, v, bias, do, scale)
    name = "fused_attention_flat_bwd_pair"
    B, N, H, D = _check_cuda_operands(name, (q, k, v, bias, do), q, bias)
    if q.dtype != torch.bfloat16 or D != 64 or N > FLAT_MAX_N:
        raise ValueError(f"{name} takes bf16 operands at head dim 64 and N <= {FLAT_MAX_N}, "
                         f"got {q.dtype}, D={D}, N={N}")
    if any(t.data_ptr() % 16 for t in (q, k, v, do)):   # the outputs are allocated like them
        raise ValueError(f"{name} takes 16-byte aligned operands")
    return _pair_bwd(q, k, v, bias, do, scale, B, N, H, D)


def _pair_bwd(q, k, v, bias, do, scale, B, N, H, D):
    """Launch X3 (csrc/attention_bwd_pair.cu) with its outputs, the padded ds
    workspace and the row statistics of K3b's Hopper body (no p workspace),
    and count the launch."""
    from mem_tpu_torch.kernels import build

    lib = build.library(q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    db = torch.empty(H, N, N, dtype=torch.float32, device=q.device)
    ds_ws = torch.empty(B, H, N, lib.mem_attention_long_bwd_ws_stride(N, 1),
                        dtype=torch.float32, device=q.device)
    stats = torch.empty(B, H, -(-N // 64), 3, 64, dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.mem_attention_bwd_pair(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                                    do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                                    db.data_ptr(), ds_ws.data_ptr(), stats.data_ptr(), B, N, H,
                                    D, float(scale), 1, stream)
    build.check("fused_attention_flat_bwd_pair", rc)
    count_launch("fused_attention_flat_bwd_pair")
    return dq, dk, dv, db


def _flat_bwd(name, entry, q, k, v, bias, do, scale, B, N, H, D):
    """Launch a backward that keeps ds and p in workspaces (K2b's or K5c's
    scalar kernel) through the C entry point ``entry`` with its outputs and
    (B, H, N, N) workspaces of ds (f32) and p (the operands' dtype), and
    count the launch under ``name``."""
    from mem_tpu_torch.kernels import build

    lib = build.library(q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    db = torch.empty(H, N, N, dtype=torch.float32, device=q.device)
    ds_ws = torch.empty(B, H, N, N, dtype=torch.float32, device=q.device)
    pc_ws = torch.empty(B, H, N, N, dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = getattr(lib, entry)(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                             do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                             db.data_ptr(), ds_ws.data_ptr(), pc_ws.data_ptr(), B, N, H, D,
                             float(scale), int(q.dtype == torch.bfloat16), stream)
    build.check(name, rc)
    count_launch(name)
    return dq, dk, dv, db


class _FusedAttentionFlat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, scale):
        ctx.save_for_backward(q, k, v, bias)
        ctx.scale = scale
        return _forward(q, k, v, bias, scale)

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias = ctx.saved_tensors
        dq, dk, dv, db = fused_attention_flat_bwd(q, k, v, bias, do.contiguous(), ctx.scale)
        return dq, dk, dv, db, None


def fused_attention_flat(q, k, v, bias, scale: float):
    """(B, N, H*D) q/k/v + (H, N, N) f32 bias -> (B, N, H*D) in q's dtype,
    differentiable in q, k, v and bias. CPU tensors take the plain versions;
    CUDA tensors launch K2f forward and K2b backward, or raise."""
    return _FusedAttentionFlat.apply(q, k, v, bias, float(scale))


def fused_attention_flat_long_reference(q, k, v, bias, scale: float):
    """Plain version of K3f: the function of
    :func:`fused_attention_flat_reference`, in the same order of roundings
    (attention.py:262-273 is attention.py:114-125 at long N)."""
    return fused_attention_flat_reference(q, k, v, bias, scale)


def _long_fwd(name, entry, q, k, v, bias, scale, B, N, H, D):
    """Launch K3f's key-tiled kernels through the C entry point ``entry``
    (the flat or the head-major one; checked operands in its layout) and
    count the launch under ``name``."""
    from mem_tpu_torch.kernels import build

    lib = build.library(q.device)
    if D > lib.mem_attention_long_fwd_max_d():
        raise ValueError(f"{name}: head dim {D} above the "
                         f"{lib.mem_attention_long_fwd_max_d()} the kernel takes")
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = getattr(lib, entry)(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                             out.data_ptr(), B, N, H, D, float(scale),
                             int(q.dtype == torch.bfloat16), stream)
    build.check(name, rc)
    count_launch(name)
    return out


def _forward_long(q, k, v, bias, scale: float):
    """(B, N, H*D) q/k/v + (H, N, N) f32 bias -> (B, N, H*D) in q's dtype.
    CPU tensors take the plain version; CUDA tensors launch K3f or raise."""
    if q.device.type == "cpu":
        return fused_attention_flat_long_reference(q, k, v, bias, scale)
    name = "fused_attention_flat_long"
    B, N, H, D = _check_cuda_operands(name, (q, k, v, bias), q, bias)
    return _long_fwd(name, "mem_attention_long_fwd", q, k, v, bias, scale, B, N, H, D)


def fused_attention_flat_long_bwd_reference(q, k, v, bias, do, scale: float):
    """Plain version of K3b: the function of
    :func:`fused_attention_flat_bwd_reference`, in the same order of
    roundings (attention.py:300-322 is attention.py:147-167 at long N): p
    recomputed in f32 from q k^T * scale + bias, p cast to do's dtype for dv,
    ds = p (dp - rowsum(dp p)) in f32, ds cast to q's dtype before the dq and
    dk products, f32 accumulation, db = sum over the batch of ds in f32.

    Any N is taken as it is. What the TPU kernel does around that arithmetic
    is not reproduced: it pads N to blocks of 256 query rows and masks the
    keys >= N, and it rounds each block's dk/dv partial to the operand dtype
    before the partials are summed (attention.py:394-395); here dk and dv
    are summed in f32 over all rows and rounded once. With bf16 operands the
    two differ by about one bf16 rounding of a partial, inside the tolerance
    the bf16 comparison is held to."""
    return fused_attention_flat_bwd_reference(q, k, v, bias, do, scale)


def fused_attention_flat_long_bwd(q, k, v, bias, do, scale: float):
    """The VJP of :func:`fused_attention_flat_long`: (dq, dk, dv) shaped and
    typed as q/k/v and db (H, N, N) f32 summed over the batch. CPU tensors
    take the plain version; CUDA tensors launch K3b or raise."""
    if q.device.type == "cpu":
        return fused_attention_flat_long_bwd_reference(q, k, v, bias, do, scale)
    name = "fused_attention_flat_long_bwd"
    B, N, H, D = _check_cuda_operands(name, (q, k, v, bias, do), q, bias)
    return _long_bwd(name, "mem_attention_long_bwd", q, k, v, bias, do, scale, B, N, H, D)


def _long_bwd(name, entry, q, k, v, bias, do, scale, B, N, H, D):
    """Launch K3b's kernels through the C entry point ``entry`` (the flat or
    a head-major one; checked operands in its layout) and count the launch
    under ``name``: (dq, dk, dv) shaped and typed as q/k/v, db (H, N, N) f32."""
    from mem_tpu_torch.kernels import build

    lib = build.library(q.device)
    if D > lib.mem_attention_long_bwd_max_d():
        raise ValueError(f"{name}: head dim {D} above the "
                         f"{lib.mem_attention_long_bwd_max_d()} the kernel takes")
    is_bf16 = int(q.dtype == torch.bfloat16)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    db = torch.empty(H, N, N, dtype=torch.float32, device=q.device)
    # the wgmma kernels keep row statistics (m, 1 / l, delta per 64-row query
    # tile) and recompute p; the scalar kernels store p rounded to the operand
    # dtype beside ds
    mma = lib.mem_attention_long_bwd_uses_mma(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), D, is_bf16)
    ds_ws = torch.empty(B, H, N, lib.mem_attention_long_bwd_ws_stride(N, mma),
                        dtype=torch.float32, device=q.device)
    stats = pc_ws = None
    if mma:
        stats = torch.empty(B, H, -(-N // 64), 3, 64, dtype=torch.float32, device=q.device)
    else:
        _smem_check(name, lib.mem_attention_long_bwd_scalar_smem(N, D), N, D)
        pc_ws = torch.empty(B, H, N, N, dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = getattr(lib, entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), do.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), db.data_ptr(), ds_ws.data_ptr(),
        None if pc_ws is None else pc_ws.data_ptr(),
        None if stats is None else stats.data_ptr(),
        B, N, H, D, float(scale), is_bf16, stream)
    build.check(name, rc)
    count_launch(name)
    return dq, dk, dv, db


class _FusedAttentionFlatLong(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, scale):
        ctx.save_for_backward(q, k, v, bias)
        ctx.scale = scale
        return _forward_long(q, k, v, bias, scale)

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias = ctx.saved_tensors
        dq, dk, dv, db = fused_attention_flat_long_bwd(q, k, v, bias, do.contiguous(),
                                                       ctx.scale)
        return dq, dk, dv, db, None


def fused_attention_flat_long(q, k, v, bias, scale: float):
    """:func:`fused_attention_flat` for long sequences, differentiable in q,
    k, v and bias: CPU tensors take the plain versions, CUDA tensors launch
    K3f forward and K3b backward, or raise."""
    return _FusedAttentionFlatLong.apply(q, k, v, bias, float(scale))


# ---------------------------------------------------------------------------
# head-major (B, H, N, D) layouts: K5a / K5b forward, K5c / K5d / K5e backward
# ---------------------------------------------------------------------------

# The reference's routing constants (attention.py:39, 47, 506, 512) with its
# values, module globals read at call time (tests set them on both packages
# at once). ENABLED is the reference's global switch for its fused kernels:
# models.vit.Attention reads it. The head-blocked kernels take a shape when
# the whole (H, N, N) f32 bias fits their on-chip budget (N <= 330 at 12
# heads); the backward of the others works on the whole (N, N) matrix up to
# _WHOLE_BWD_MAX_N and in blocks of QBLK query rows above it. The port's
# kernels for those shapes tile the keys by 64 and pad nothing, so QBLK only
# names the reference's blocks (see fused_attention_bwd_long_reference).
ENABLED = False
_HB_MAX_BIAS_BYTES = 5 * 1024 * 1024
QBLK = 256
_WHOLE_BWD_MAX_N = 448


def _hb_eligible(H: int, N: int) -> bool:
    return H * N * N * 4 <= _HB_MAX_BIAS_BYTES


def fused_attention_route(H: int, N: int) -> tuple:
    """The branch the reference's ``_fa_fwd`` / ``_fa_bwd`` take at (H, N),
    as the launch-counter names of the port's kernels (forward, backward):
    ("fused_attention", "fused_attention_bwd") -- K5a, K5c -- for the
    head-blocked-eligible shapes; otherwise "fused_attention_long" (K5b)
    forward and "fused_attention_bwd_whole" (K5d) at N <=
    ``_WHOLE_BWD_MAX_N`` or "fused_attention_bwd_long" (K5e) backward."""
    if _hb_eligible(H, N):
        return "fused_attention", "fused_attention_bwd"
    return "fused_attention_long", ("fused_attention_bwd_whole" if N <= _WHOLE_BWD_MAX_N
                                    else "fused_attention_bwd_long")


def fused_attention_reference(q, k, v, bias, scale: float):
    """Plain version of K5a, in the TPU kernel's order (attention.py:57-67):
    :func:`fused_attention_flat_reference` on (B, H, N, D)."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    s = s + bias.float()
    s = s - s.amax(dim=-1, keepdim=True)
    e = torch.exp(s)
    p = e / e.sum(dim=-1, keepdim=True)
    return torch.matmul(p.to(v.dtype).float(), v.float()).to(q.dtype)


def fused_attention_bwd_reference(q, k, v, bias, do, scale: float):
    """Plain version of K5c, in the TPU kernel's order (attention.py:78-102):
    :func:`fused_attention_flat_bwd_reference` on (B, H, N, D)."""
    qh, kh, vh, doh = q.float(), k.float(), v.float(), do.float()
    s = torch.matmul(qh, kh.transpose(-1, -2)) * scale + bias.float()
    s = s - s.amax(dim=-1, keepdim=True)
    e = torch.exp(s)
    p = e / e.sum(dim=-1, keepdim=True)
    pc = p.to(v.dtype).float()
    dv = torch.matmul(pc.transpose(-1, -2), doh)
    dp = torch.matmul(doh, vh.transpose(-1, -2))
    delta = (dp * p).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta)
    dsc = ds.to(q.dtype).float()
    dq = torch.matmul(dsc, kh) * scale
    dk = torch.matmul(dsc.transpose(-1, -2), qh) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), ds.sum(dim=0)


def fused_attention_long_reference(q, k, v, bias, scale: float):
    """Plain version of K5b: the function of :func:`fused_attention_reference`
    in the same order of roundings (attention.py:413-422 is :57-67 for one
    (b, h) at a time)."""
    return fused_attention_reference(q, k, v, bias, scale)


def fused_attention_bwd_whole_reference(q, k, v, bias, do, scale: float):
    """Plain version of K5d: the function of
    :func:`fused_attention_bwd_reference` in the same order of roundings
    (attention.py:425-456 is :78-102 for one (h, b) at a time, db summed over
    the batch in f32)."""
    return fused_attention_bwd_reference(q, k, v, bias, do, scale)


def fused_attention_bwd_long_reference(q, k, v, bias, do, scale: float):
    """Plain version of K5e: the function and roundings of
    :func:`fused_attention_bwd_reference` (attention.py:532-556: p recomputed
    in f32, p cast to do's dtype for dv, ds = p (dp - rowsum(dp p)) in f32,
    ds cast to q's dtype before the dq and dk products, db summed over the
    batch in f32).

    Any N is taken as it is. What the TPU kernel does around that arithmetic
    is not reproduced, as for K3b (:func:`fused_attention_flat_long_bwd_reference`):
    it pads N to blocks of ``QBLK`` = 256 query rows and masks the keys >= N,
    and it rounds each block's dk/dv partial to the operand dtype before the
    partials are summed in f32 (attention.py:645-646); here dk and dv are
    summed in f32 over all rows and rounded once. With bf16 operands the two
    differ by about one bf16 rounding of a partial, inside the tolerance the
    bf16 comparison is held to; in f32 the roundings are no-ops."""
    return fused_attention_bwd_reference(q, k, v, bias, do, scale)


def _bhnd_path(lib, name, q, k, v, do, N, D, is_bf16) -> str:
    """Which kernels a head-major launch of the branch ``name`` takes. The
    head-blocked branch (K5a, K5c) at N <= FLAT_MAX_N: "wgmma" (K3's Hopper
    body) or "scalar" (K2's scalar kernel). K5b, K5d and K5e, and the
    head-blocked branch above FLAT_MAX_N keys where K3 runs on tensor cores
    (as the flat route does): "tiled_wgmma" or "tiled_scalar" (K3's bodies
    on tensor cores or not). ``do`` is None for a forward; outputs are
    allocated like the operands, so their alignment is the operands'."""
    p = [q.data_ptr(), k.data_ptr(), v.data_ptr()]
    if do is None:
        tiled_mma = lib.mem_attention_long_fwd_uses_mma(*p, q.data_ptr(), D, is_bf16)
    else:
        tiled_mma = lib.mem_attention_long_bwd_uses_mma(*p, do.data_ptr(), *p, D, is_bf16)
    if name in ("fused_attention", "fused_attention_bwd") and (N <= FLAT_MAX_N
                                                               or not tiled_mma):
        return "wgmma" if tiled_mma else "scalar"
    return "tiled_wgmma" if tiled_mma else "tiled_scalar"


def _forward_bhnd(q, k, v, bias, scale: float):
    """(B, H, N, D) q/k/v + (H, N, N) f32 bias -> (B, H, N, D) in q's dtype.
    CPU tensors take the plain version of the reference's branch; CUDA
    tensors launch K5a or K5b (:func:`fused_attention_route`) or raise."""
    name = fused_attention_route(q.shape[1], q.shape[2])[0]
    if q.device.type == "cpu":
        plain = fused_attention_reference if name == "fused_attention" \
            else fused_attention_long_reference
        return plain(q, k, v, bias, scale)
    B, N, H, D = _check_cuda_operands(name, (q, k, v, bias), q, bias, bhnd=True)
    from mem_tpu_torch.kernels import build

    if _bhnd_path(build.library(), name, q, k, v, None, N, D,
                  int(q.dtype == torch.bfloat16)) == "scalar":
        return _scalar_fwd(name, "mem_attention_fwd_bhnd", q, k, v, bias, scale, B, N, H, D)
    return _long_fwd(name, "mem_attention_long_fwd_bhnd", q, k, v, bias, scale, B, N, H, D)


def fused_attention_bwd(q, k, v, bias, do, scale: float):
    """The VJP of :func:`fused_attention`: (dq, dk, dv) shaped and typed as
    q/k/v and db (H, N, N) f32 summed over the batch. CPU tensors take the
    plain version of the reference's branch; CUDA tensors launch K5c, K5d or
    K5e (:func:`fused_attention_route`) or raise."""
    name = fused_attention_route(q.shape[1], q.shape[2])[1]
    if q.device.type == "cpu":
        plain = {"fused_attention_bwd": fused_attention_bwd_reference,
                 "fused_attention_bwd_whole": fused_attention_bwd_whole_reference,
                 "fused_attention_bwd_long": fused_attention_bwd_long_reference}[name]
        return plain(q, k, v, bias, do, scale)
    B, N, H, D = _check_cuda_operands(name, (q, k, v, bias, do), q, bias, bhnd=True)
    from mem_tpu_torch.kernels import build

    lib = build.library()
    is_bf16 = int(q.dtype == torch.bfloat16)
    if _bhnd_path(lib, name, q, k, v, do, N, D, is_bf16) == "scalar":
        _smem_check(name, lib.mem_attention_bwd_flat_smem(N, D, is_bf16), N, D)
        return _flat_bwd(name, "mem_attention_bwd_bhnd", q, k, v, bias, do, scale, B, N, H, D)
    entry = ("mem_attention_bwd_blocked_bhnd" if name == "fused_attention_bwd_long"
             else "mem_attention_bwd_whole_bhnd")
    return _long_bwd(name, entry, q, k, v, bias, do, scale, B, N, H, D)


class _FusedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, scale):
        ctx.save_for_backward(q, k, v, bias)
        ctx.scale = scale
        return _forward_bhnd(q, k, v, bias, scale)

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias = ctx.saved_tensors
        dq, dk, dv, db = fused_attention_bwd(q, k, v, bias, do.contiguous(), ctx.scale)
        return dq, dk, dv, db, None


def fused_attention(q, k, v, bias, scale: float):
    """(B, H, N, D) q/k/v + (H, N, N) f32 bias -> (B, H, N, D) in q's dtype,
    differentiable in q, k, v and bias (mem_tpu/ops/attention.py
    ``fused_attention``), at any (H, N), routed as the reference routes
    (:func:`fused_attention_route`). CPU tensors take the plain versions;
    CUDA tensors launch K5a or K5b forward and K5c, K5d or K5e backward, or
    raise."""
    return _FusedAttention.apply(q, k, v, bias, float(scale))


def attention_route(N: int) -> str:
    """"flat" (K2f/K2b) or "long" (K3f/K3b) for a sequence of N tokens.

    The reference routes on whether the whole (H, N, N) f32 bias fits its
    kernel's on-chip memory (``_hb_eligible``, attention.py:50: N <= 330 at
    12 heads). The card's limit is a different one: K2's scalar kernels
    stage a head's whole K and V in one block's shared memory, and the
    route sends them at most FLAT_MAX_N keys, which covers the 197 tokens of
    classification and pretraining (for bf16 at head dim 64 or 32 K2 launches
    K3's Hopper bodies there); the 1025 tokens of the segmentation backbone go to
    K3f and K3b. The head count, which sizes the reference's bias, plays
    no part here. Under ``FLAT_ATTN = False`` the head-major wrappers run
    tensor cores at those N as well: above FLAT_MAX_N keys K5a and K5c launch
    K3's key-tiled bodies for bf16 at head dim 64 or 32 (:func:`_bhnd_path`)."""
    return "flat" if N <= FLAT_MAX_N else "long"


def cuda_long_kernel_path(q, k, v, bias) -> str:
    """Which CUDA kernel a K3f launch on these operands takes: "wgmma" (the
    one-pass tensor-core kernel) or "scalar"."""
    from mem_tpu_torch.kernels import build

    D = q.shape[-1] // bias.shape[0]
    mma = build.library().mem_attention_long_fwd_uses_mma(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q.data_ptr(), D,
        int(q.dtype == torch.bfloat16))
    return "wgmma" if mma else "scalar"


def cuda_kernel_path(q, k, v, bias) -> str:
    """Which CUDA forward kernel a K2f launch on these operands takes:
    "wgmma" (K3f's Hopper kernel) or "scalar"."""
    D = q.shape[-1] // bias.shape[0]
    return "wgmma" if _k2_wgmma(q, k, v, None, q.shape[1], D) else "scalar"


def cuda_bwd_kernel_path(q, k, v, bias) -> str:
    """Which CUDA backward kernels a K2b launch on these operands takes:
    "wgmma" (K3b's Hopper rows and columns kernels) or "scalar"."""
    D = q.shape[-1] // bias.shape[0]
    return "wgmma" if _k2_wgmma(q, k, v, q, q.shape[1], D) else "scalar"


def cuda_long_bwd_kernel_path(q, k, v, bias) -> str:
    """Which CUDA kernels a K3b launch on these operands takes: "wgmma" (the
    rows and columns kernels on tensor cores) or "scalar"."""
    from mem_tpu_torch.kernels import build

    D = q.shape[-1] // bias.shape[0]
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr()] * 2 + [q.data_ptr()]
    mma = build.library().mem_attention_long_bwd_uses_mma(
        *ptrs, D, int(q.dtype == torch.bfloat16))
    return "wgmma" if mma else "scalar"


def cuda_bhnd_kernel_path(q, k, v, bias) -> str:
    """Which CUDA kernel a :func:`fused_attention` forward launch on these
    (B, H, N, D) operands takes: "wgmma" / "scalar" (K2's bodies) or
    "tiled_wgmma" / "tiled_scalar" (K3f's)."""
    from mem_tpu_torch.kernels import build

    B, H, N, D = q.shape
    return _bhnd_path(build.library(), fused_attention_route(H, N)[0], q, k, v, None, N, D,
                      int(q.dtype == torch.bfloat16))


def cuda_bhnd_bwd_kernel_path(q, k, v, bias) -> str:
    """Which CUDA kernels a :func:`fused_attention_bwd` launch on these
    (B, H, N, D) operands takes, as :func:`cuda_bhnd_kernel_path`."""
    from mem_tpu_torch.kernels import build

    B, H, N, D = q.shape
    return _bhnd_path(build.library(), fused_attention_route(H, N)[1], q, k, v, q, N, D,
                      int(q.dtype == torch.bfloat16))

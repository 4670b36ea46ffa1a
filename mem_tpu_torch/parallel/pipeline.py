"""GPipe pipeline parallelism over a "pipe" group, port of
mem_tpu/parallel/pipeline.py.

A stack of S identical stages is cut over S processes (stage s on the
process of pipe rank s), M microbatches stream through them, and the
activations move stage to stage by point-to-point send / recv. The schedule
is plain GPipe: every microbatch forward (stage s computes microbatch m once
stage s - 1 has sent it), then every microbatch backward in reverse order.

The pipeline is one ``torch.autograd.Function``: its forward runs the
schedule without a graph and keeps each stage's inputs; its backward
recomputes each microbatch's stage forward with a graph, takes the gradients
of the stage's parameters and inputs, and sends the input gradient to the
stage before. So gradients flow across stages with nothing but send / recv,
and the activations held are one input per microbatch and stage. As with
the reference's ``psum`` (pipeline.py:104), every process gets the result:
the last stage broadcasts it; the gradient of that replicated result is the
last stage's (every process computes the same loss from it), and the
gradient of the replicated input ``x`` is stage 0's, broadcast to all.

No CLI calls it; the tests hold it against the sequential stack and the
reference's ``pipeline_apply``.
"""
from __future__ import annotations

from typing import Callable, Dict, List

import torch
import torch.distributed as dist


def stack_stage_params(stage_param_list: List[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """S per-stage parameter dicts -> one dict with leading axis S."""
    return {k: torch.stack([p[k] for p in stage_param_list]) for k in stage_param_list[0]}


def _pipe(mesh, axis: str):
    """(group, size, rank) of the pipe axis: a ``DeviceMesh`` dim, a process
    group, or None (the default group)."""
    if mesh is None or isinstance(mesh, dist.ProcessGroup):
        group = mesh
    else:
        group = mesh.get_group(axis)
    return group, dist.get_world_size(group), dist.get_rank(group)


def pipeline_param_sharding(stacked_params: Dict[str, torch.Tensor], mesh=None,
                            axis: str = "pipe") -> Dict[str, torch.Tensor]:
    """This process's stage of the stacked parameters, leading axis 1 (the
    reference places the stack along the pipe axis; each process holds its
    slice), as new leaf tensors that keep ``requires_grad``."""
    _, _, r = _pipe(mesh, axis)
    return {k: v[r: r + 1].detach().clone().requires_grad_(v.requires_grad)
            for k, v in stacked_params.items()}


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, stage_fn, group, m, x, keys, *local):
        n, s = dist.get_world_size(group), dist.get_rank(group)
        glob = lambda r: dist.get_global_rank(group, r) if group is not None else r  # noqa: E731
        params = {k: v[0] for k, v in zip(keys, local)}
        xs = x.detach().chunk(m)
        inputs, outs = [], []
        with torch.no_grad():
            for i in range(m):
                a = xs[i].contiguous() if s == 0 else torch.empty_like(xs[i])
                if s > 0:
                    dist.recv(a, src=glob(s - 1), group=group)
                inputs.append(a)
                y = stage_fn(params, a)
                if s < n - 1:
                    dist.send(y.contiguous(), dst=glob(s + 1), group=group)
                else:
                    outs.append(y)
        y = torch.cat(outs) if s == n - 1 else torch.empty_like(x)
        dist.broadcast(y, src=glob(n - 1), group=group)
        ctx.stage_fn, ctx.group, ctx.m, ctx.keys = stage_fn, group, m, keys
        ctx.inputs = inputs
        ctx.save_for_backward(*local)
        ctx.x_shape = x.shape
        return y

    @staticmethod
    def backward(ctx, gy):
        group, m = ctx.group, ctx.m
        n, s = dist.get_world_size(group), dist.get_rank(group)
        glob = lambda r: dist.get_global_rank(group, r) if group is not None else r  # noqa: E731
        local = ctx.saved_tensors
        grads = [torch.zeros_like(v) for v in local]
        gys = gy.contiguous().chunk(m)
        gx = [None] * m
        for i in reversed(range(m)):
            a = ctx.inputs[i].detach().requires_grad_(s > 0 or ctx.needs_input_grad[3])
            with torch.enable_grad():
                ps = [v.detach()[0].requires_grad_(True) for v in local]
                y = ctx.stage_fn(dict(zip(ctx.keys, ps)), a)
                if s == n - 1:
                    g = gys[i]
                else:
                    g = torch.empty_like(y)
                    dist.recv(g, src=glob(s + 1), group=group)
                wrt = ps + ([a] if a.requires_grad else [])
                got = torch.autograd.grad(y, wrt, g, allow_unused=True)
            for j in range(len(ps)):
                if got[j] is not None:
                    grads[j][0] += got[j]
            ga = got[len(ps)] if a.requires_grad else None
            if s > 0:
                dist.send(ga.contiguous(), dst=glob(s - 1), group=group)
            else:
                gx[i] = ga
        grad_x = None
        if ctx.needs_input_grad[3]:
            grad_x = (torch.cat(gx) if s == 0
                      else torch.empty(ctx.x_shape, dtype=gy.dtype, device=gy.device))
            dist.broadcast(grad_x, src=glob(0), group=group)
        return (None, None, None, grad_x, None, *grads)


def pipeline_apply(stage_fn: Callable, stacked_params: Dict[str, torch.Tensor],
                   x: torch.Tensor, mesh=None, *, axis: str = "pipe",
                   num_microbatches: int = 8) -> torch.Tensor:
    """``y = stage_{S-1}(... stage_0(x))`` pipelined over ``axis``.

    ``stage_fn(stage_params, act) -> act`` must keep the activation's shape
    (true of transformer trunks). ``stacked_params``: this process's stage
    (:func:`pipeline_param_sharding`, leading axis 1). ``x``: (B, ...), the
    same on every process of the pipe; B must divide by ``num_microbatches``.
    Data parallelism composes outside: each data rank pipelines its own
    batch and the placement averages the gradients. Returns y, x's shape, on
    every process; differentiable in ``x`` and the stage parameters."""
    group, _, _ = _pipe(mesh, axis)
    if x.shape[0] % num_microbatches:
        raise ValueError(f"batch {x.shape[0]} does not divide into {num_microbatches} "
                         f"microbatches")
    keys = tuple(stacked_params)
    return _GPipe.apply(stage_fn, group, num_microbatches, x, keys,
                        *(stacked_params[k] for k in keys))

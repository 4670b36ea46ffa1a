"""Process groups, the device mesh and the placements of a training run on
torch.distributed, port of mem_tpu/parallel/mesh.py.

The JAX package runs one program over a ``Mesh`` of every process's devices
and lets GSPMD derive the collectives from sharding annotations. Here each
process drives one device and the collectives are written out:

- ``init_distributed`` joins the process group that torchrun (``WORLD_SIZE``
  / ``RANK`` / ``LOCAL_RANK``) or SLURM (``SLURM_NTASKS`` / ``SLURM_PROCID`` /
  ``SLURM_LOCALID``) describe: NCCL on ``cuda:LOCAL_RANK``, Gloo with
  ``--device cpu``; one process when neither is set.
- ``get_mesh(tp)`` is a ``DeviceMesh`` ("data",) or ("data", "model"), or None
  for one process without a group.
- ``place_train_state(model, optimizer, mesh, tp, zero1, fsdp)`` places a
  model and its optimizer (state included, so it is also the step after a
  restore) and returns a :class:`Placement`, which the train steps call for
  the gradient reduction, the global norm and the update, and the CLIs for
  the single-process checkpoint schema:

  * DP: parameters broadcast from rank 0; after backward one all-reduce of
    the flattened gradients, averaged over "data".
  * ZeRO-1: DP, and each rank keeps optimizer state only for the parameters
    it owns (whole tensors, dealt out by size) and broadcasts them after its
    update: every optimizer updates exactly as on one process.
  * FSDP: FSDP2 ``fully_shard`` on every ``Block`` and at the root, no mixed
    precision policy (the modules cast to the compute dtype themselves).
  * TP: Megatron-style tensor parallelism over "model", written out in
    models/vit.py (:func:`shard_tensor_parallel` cuts the weights by head and
    by hidden column); "data" takes the rest of the processes.

Losses are normalised by counts over the global batch (:func:`global_quotient`)
and BatchNorm takes its statistics over the global batch, so a multi-process
step is the single-process step over the union of the ranks' batches, up to
the order of the sums. Each rank returns ``world * num / sum(den)``: the
average that data parallelism takes of gradients and metrics is then
``sum(num) / sum(den)``. The spec rules ``tp_param_specs``,
``zero1_opt_specs`` and ``fsdp_specs`` are the reference's, on the port's
parameter names and layouts; a spec is a tuple of mesh-axis names or None per
dimension, ``()`` for a replicated leaf.
"""
from __future__ import annotations

import os
import re
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch
import torch.distributed as dist

# optimizers whose update reads a statistic of the whole tensor (a norm, a
# factored moment, a channel cosine): a shard computes another update, so
# the sharded placements refuse them; Lamb's norms are taken over the whole
# tensor under FSDP (FSDP2 parameters are DTensors: the norms reduce across
# shards)
PER_TENSOR_OPTIMIZERS = ("lamb", "adafactor", "novograd", "nvnovograd", "adamp", "sgdp")


# ---------------------------------------------------------------------------
# processes
# ---------------------------------------------------------------------------

def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size(group=None) -> int:
    return dist.get_world_size(group) if initialized() else 1


def rank(group=None) -> int:
    return dist.get_rank(group) if initialized() else 0


def is_main() -> bool:
    """True on the process that writes checkpoints, sinks and panels."""
    return rank() == 0


def launch_env() -> tuple:
    """(world size, rank, local rank) from torchrun's or SLURM's variables,
    (1, 0, 0) outside a launcher."""
    env = os.environ
    if "WORLD_SIZE" in env:
        return (int(env["WORLD_SIZE"]), int(env.get("RANK", "0")),
                int(env.get("LOCAL_RANK", "0")))
    if "SLURM_NTASKS" in env:
        return (int(env["SLURM_NTASKS"]), int(env.get("SLURM_PROCID", "0")),
                int(env.get("SLURM_LOCALID", "0")))
    return 1, 0, 0


def init_distributed(device="cuda", backend: Optional[str] = None) -> torch.device:
    """Join the process group of a multi-process launch (the rule of the
    reference's ``init_distributed``, mesh.py:28-35: more than one process in
    the launcher's environment) and return this process's device:
    ``cuda:LOCAL_RANK`` for a CUDA ``device``, the CPU otherwise. The backend
    is NCCL on CUDA and Gloo on the CPU unless ``backend`` names one; there is
    no fallback from one to the other. The rendezvous is torchrun's
    ``MASTER_ADDR`` / ``MASTER_PORT`` (under SLURM the job script sets them).
    Calling it again returns the device without a new group."""
    device = torch.device(device)
    n, r, local = launch_env()
    if n <= 1:
        return device
    if device.type == "cuda":
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
    if initialized():
        return device
    for var in ("MASTER_ADDR", "MASTER_PORT"):
        if var not in os.environ:
            raise RuntimeError(f"a {n}-process launch needs {var} (torchrun sets it)")
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    kwargs = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method="env://", world_size=n, rank=r, **kwargs)
    return device


def any_process(flag: bool) -> bool:
    """True on every process when ``flag`` is true on any (a SIGTERM that
    reached some processes first: they all save, or none does)."""
    if not initialized() or world_size() == 1:
        return bool(flag)
    t = torch.tensor([int(bool(flag))])
    if dist.get_backend() == "nccl":
        t = t.cuda()
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def common_count(n: int) -> int:
    """The least of the processes' ``n`` (the val split's shards can differ
    by a batch: an eval loop runs the batches every process has, so its
    collectives pair)."""
    if not initialized() or world_size() == 1:
        return n
    t = torch.tensor([n])
    if dist.get_backend() == "nccl":
        t = t.cuda()
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return int(t.item())


def get_mesh(tp: int = 1, device_type: Optional[str] = None):
    """A ``DeviceMesh`` over every process: ("data",), or ("data", "model")
    with ``tp`` processes on "model" when tp > 1 (mesh.py:38-45). None for
    one process without a group (tp must then be 1)."""
    n = world_size()
    if tp < 1 or n % tp:
        raise ValueError(f"--tp {tp} does not divide the {n} processes")
    if not initialized():
        if tp > 1:
            raise ValueError(f"--tp {tp} needs a process group of {tp} or more processes "
                             f"(launch with torchrun --nproc_per_node {tp})")
        return None
    from torch.distributed.device_mesh import init_device_mesh

    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    if tp > 1:
        return init_device_mesh(device_type, (n // tp, tp), mesh_dim_names=("data", "model"))
    return init_device_mesh(device_type, (n,), mesh_dim_names=("data",))


def axis_group(mesh, axis: str):
    """The process group of ``mesh``'s ``axis``, or None (one process, or an
    axis the mesh lacks)."""
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return None
    return mesh.get_group(axis)


def axis_size(mesh, axis: str) -> int:
    group = axis_group(mesh, axis)
    return 1 if group is None else dist.get_world_size(group)


def axis_rank(mesh, axis: str) -> int:
    group = axis_group(mesh, axis)
    return 0 if group is None else dist.get_rank(group)


def local_batch_size(global_batch: int, mesh=None) -> int:
    """The per-process batch of a global ``--batch_size`` (mesh.py:237-240):
    the global batch over the "data" processes."""
    n = axis_size(mesh, "data") if mesh is not None else world_size()
    if global_batch % n:
        raise ValueError(f"batch size {global_batch} does not divide over {n} processes")
    return global_batch // n


def shard_batch(batch: dict, mesh=None, axis_pos: int = 0, device=None,
                global_batch: bool = False) -> dict:
    """A host batch as this process's device tensors (mesh.py:189-218). Each
    process ingests its own shard (the pipelines' ``shard_id`` /
    ``num_shards``), so the host batch is already the rank's and moves as it
    is; with ``global_batch`` the host batch is the global one and the rank
    keeps its contiguous slice on dimension ``axis_pos`` (0 for (B, ...), 1
    for micro-batches folded as (update_freq, B, ...))."""
    n, r = axis_size(mesh, "data"), axis_rank(mesh, "data")

    def put(x):
        t = torch.as_tensor(x)
        if global_batch and t.ndim > axis_pos:
            b = t.shape[axis_pos]
            if b % n:
                raise ValueError(f"batch dimension {b} does not divide over {n} processes")
            t = t.narrow(axis_pos, r * (b // n), b // n)
        return t.to(device) if device is not None else t

    return {k: put(v) for k, v in batch.items()}


def replicate(model: torch.nn.Module, src: int = 0) -> torch.nn.Module:
    """Broadcast a module's parameters and buffers from rank ``src`` to every
    process, in place (the reference's ``replicate``: every rank starts from
    rank 0's weights); returns the module."""
    if initialized():
        with torch.no_grad():
            for t in list(model.parameters()) + list(model.buffers()):
                dist.broadcast(t.data, src)
    return model


def _full(t):
    """The whole value of a tensor: a DTensor gathered, anything else as it is."""
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


def unreplicate(tree) -> dict:
    """A dict of (replicated or FSDP-sharded) tensors as host numpy arrays."""
    return {k: _full(v).detach().cpu().numpy() for k, v in tree.items()}


def psum_metrics(metrics: dict, group=None, average: bool = False) -> dict:
    """0-d tensor metrics summed (or averaged) over ``group``'s processes in
    one all-reduce (mesh.py:228-233; the reference's SmoothedValue
    all_reduce)."""
    if not metrics or not initialized() or world_size(group) == 1:
        return metrics
    keys = list(metrics)
    buf = torch.stack([metrics[k].float().reshape(()) for k in keys])
    dist.all_reduce(buf, group=group)
    if average:
        buf = buf / world_size(group)
    return {k: buf[i] for i, k in enumerate(keys)}


class _AllReduceSum(torch.autograd.Function):
    """Sum over a group forward; the gradient of a sum that every rank reads
    is the sum of their gradients, so the backward all-reduces too."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable all-reduce sum over ``group`` (SyncBN's statistics)."""
    return _AllReduceSum.apply(x, group)


def global_quotient(num: torch.Tensor, den: torch.Tensor, group=None) -> torch.Tensor:
    """``num / den`` with the denominator summed over ``group``: each rank
    returns ``(num / sum(den)) * world``, so the mean over the ranks (what
    data parallelism takes of gradients and metrics) is ``sum(num) /
    sum(den)``, the JAX package's quotient over the global array. One
    process (``group`` None): ``num / den``."""
    if group is None:
        return num / den
    den = den.detach().to(torch.float32).clone()
    dist.all_reduce(den, group=group)
    return (num / den.clamp(min=1.0)) * dist.get_world_size(group)


def global_scale(group=None) -> int:
    """The factor a rank's share of a loss summed over the global batch
    takes (``num * world``: the average over the ranks is the sum)."""
    return 1 if group is None else dist.get_world_size(group)


# ---------------------------------------------------------------------------
# the spec rules (mesh.py:48-156) on the port's names and layouts
# ---------------------------------------------------------------------------

def _dims(shape, axis_dim: Optional[int], axis: str) -> tuple:
    if axis_dim is None:
        return ()
    return tuple(axis if i == axis_dim else None for i in range(len(shape)))


def tp_dim(name: str) -> Optional[int]:
    """The torch dimension that tensor parallelism cuts for the parameter
    ``name`` (tp_param_specs, mesh.py:48-74; torch Linear weights are the
    transposes of the flax kernels): the fan-out weights (q/k/v rows of
    ``attn.qkv.weight``, ``mlp.fc1``) on their output dim, ``q_bias`` /
    ``v_bias``, the fan-in weights (``attn.proj.weight``, ``mlp.fc2.weight``)
    on their input dim, and each block's own rel-pos table on its head column.
    None: replicated (embeddings, norms, heads, the fan-in biases, a shared
    rel-pos table)."""
    if re.search(r"(^|\.)attn\.qkv\.weight$", name):
        return 0
    if re.search(r"(^|\.)attn\.(q_bias|v_bias)$", name):
        return 0
    if re.search(r"(^|\.)attn\.proj\.weight$", name):
        return 1
    if re.search(r"(^|\.)attn\.relative_position_bias_table$", name):
        return 1
    if re.search(r"(^|\.)mlp\.fc1\.(weight|bias)$", name):
        return 0
    if re.search(r"(^|\.)mlp\.fc2\.weight$", name):
        return 1
    return None


def tp_param_specs(named: Dict[str, torch.Tensor], axis: str = "model") -> Dict[str, tuple]:
    """{name: spec} of Megatron-style tensor parallelism over ``axis``."""
    return {k: _dims(v.shape, tp_dim(k), axis) for k, v in named.items()}


def _size(mesh_or_size, axis: str) -> int:
    return mesh_or_size if isinstance(mesh_or_size, int) else axis_size(mesh_or_size, axis)


def _map_leaves(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_leaves(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(v, fn) for v in tree)
    return fn(tree)


def zero1_opt_specs(tree, mesh_or_size, axis: str = "data"):
    """ZeRO-1 spec tree of optimizer state (mesh.py:86-110): a leaf whose
    leading dim divides the axis size shards there; scalars and odd shapes
    stay replicated."""
    n = _size(mesh_or_size, axis)

    def spec(leaf):
        shape = tuple(getattr(leaf, "shape", ()))
        ok = len(shape) >= 1 and shape[0] > 0 and shape[0] % n == 0
        return _dims(shape, 0 if ok else None, axis)

    return _map_leaves(tree, spec)


def fsdp_specs(tree, mesh_or_size, axis: str = "data"):
    """FSDP spec tree (mesh.py:121-156): every leaf shards its largest
    dimension that divides the axis size (ties: the first); scalars and odd
    shapes stay replicated."""
    n = _size(mesh_or_size, axis)

    def spec(leaf):
        shape = tuple(getattr(leaf, "shape", ()))
        best = -1
        for i, d in enumerate(shape):
            if d > 0 and d % n == 0 and (best < 0 or d > shape[best]):
                best = i
        return _dims(shape, best if best >= 0 else None, axis)

    return _map_leaves(tree, spec)


# ---------------------------------------------------------------------------
# placements
# ---------------------------------------------------------------------------

def optimizer_name(optimizer) -> str:
    """The optimizer's family, as ``--opt`` names it (for the refusals)."""
    inner = getattr(optimizer, "inner", None)
    if inner is not None:
        return "lookahead_" + optimizer_name(inner)
    name = type(optimizer).__name__.lower()
    if name == "adamp" and any(g.get("sgd_momentum") is not None for g in optimizer.param_groups):
        return "sgdp"
    return {"adamwlowprecision": "adamw"}.get(name, name)


@dataclass
class Placement:
    """How a model and its optimizer live across the processes; the train
    steps call :meth:`reduce_gradients`, :meth:`sharded` (for the global
    norm) and :meth:`step`, the CLIs :meth:`model_state_dict` and
    :meth:`optimizer_state_dict` (single-process schema, every rank calls)."""
    mode: str = "single"          # single | dp | zero1 | fsdp | tp
    mesh: object = None
    data_group: object = None     # None: one data rank
    model_group: object = None    # tp only
    owner: Dict = field(default_factory=dict)      # zero1: param -> owning data rank
    tp_layout: Dict = field(default_factory=dict)  # tp: param -> (dim, parts)
    tp_partial: list = field(default_factory=list)  # tp: replicated params with partial grads

    @property
    def data_size(self) -> int:
        return 1 if self.data_group is None else dist.get_world_size(self.data_group)

    @property
    def data_rank(self) -> int:
        return 0 if self.data_group is None else dist.get_rank(self.data_group)

    def reduce_gradients(self, params) -> None:
        """After backward: the average of the data ranks' gradients (FSDP2
        reduce-scatters them itself), and under TP the sum over "model" of
        the gradients a replicated parameter gets only for its rank's heads."""
        if self.mode == "tp" and self.tp_partial:
            _all_reduce_flat([p.grad for p in self.tp_partial if p.grad is not None],
                             self.model_group, average=False)
        if self.mode in ("dp", "zero1", "tp") and self.data_group is not None:
            _all_reduce_flat([p.grad for p in params if p.grad is not None],
                             self.data_group, average=True)

    def sharded(self) -> Optional[dict]:
        """{param: group} of the parameters whose gradients are shards (the
        global norm sums their squares over the group); FSDP's DTensors say
        it themselves."""
        if self.mode == "tp":
            return {p: self.model_group for p in self.tp_layout}
        return None

    def step(self, optimizer) -> None:
        """The optimizer update; under ZeRO-1 each rank updates the
        parameters it owns and broadcasts them (before Lookahead's sync)."""
        if self.mode != "zero1":
            optimizer.step()
        elif hasattr(optimizer, "inner"):
            optimizer.step(inner_step=lambda: self._zero1_step(optimizer.inner))
        else:
            self._zero1_step(optimizer)

    def _zero1_step(self, optimizer) -> None:
        me = self.data_rank
        saved = {}
        for p, r in self.owner.items():
            if r != me and p.grad is not None:
                saved[p], p.grad = p.grad, None
        optimizer.step()
        for p, g in saved.items():
            p.grad = g
        with torch.no_grad():
            for p, r in self.owner.items():
                dist.broadcast(p.data, dist.get_global_rank(self.data_group, r),
                               group=self.data_group)

    # -- checkpoints: the single-process schema ---------------------------
    def model_state_dict(self, model) -> dict:
        """The model's state_dict in the single-process schema (every rank
        calls: FSDP and TP gather)."""
        if self.mode == "fsdp":
            return {k: _full(v).detach().cpu() for k, v in model.state_dict().items()}
        if self.mode == "tp":
            out = {}
            for k, v in model.state_dict(keep_vars=True).items():
                lay = self.tp_layout.get(v) if isinstance(v, torch.nn.Parameter) else None
                out[k] = (_tp_gather(v.detach(), lay, self.model_group) if lay
                          else v.detach()).cpu()
            return out
        return {k: v.detach().cpu() for k, v in model.state_dict().items()}

    def gather_like(self, p: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """A tensor laid out as parameter ``p`` (a moment, an EMA copy) in the
        full single-process shape."""
        if self.mode == "fsdp":
            return _full(t)
        if self.mode == "tp" and p in self.tp_layout and t.shape == p.shape:
            return _tp_gather(t, self.tp_layout[p], self.model_group)
        return t

    def place_like(self, p: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """A full single-process tensor laid out as the placed parameter
        ``p`` (an EMA copy, a restored moment): FSDP's shard, TP's cut."""
        if self.mode == "fsdp":
            from torch.distributed.tensor import DTensor, distribute_tensor

            if isinstance(p, DTensor) and not isinstance(t, DTensor):
                return distribute_tensor(t.to(p.device), p.device_mesh, p.placements)
        if self.mode == "tp" and p in self.tp_layout and t.shape != p.shape:
            return tp_slice(t, self.tp_layout[p], dist.get_rank(self.model_group),
                             dist.get_world_size(self.model_group))
        return t

    def optimizer_state_dict(self, optimizer) -> dict:
        """The optimizer's state_dict in the single-process schema: ZeRO-1's
        owned states merged, FSDP's and TP's gathered (every rank calls)."""
        sd = optimizer.state_dict()
        inner = sd["inner"] if "inner" in sd else sd
        params = [p for g in _inner(optimizer).param_groups for p in g["params"]]
        if self.mode == "zero1":
            merged = [None] * world_size(self.data_group)
            local = {i: {k: (v.cpu() if torch.is_tensor(v) else v) for k, v in st.items()}
                     for i, st in inner["state"].items()}
            dist.all_gather_object(merged, local, group=self.data_group)
            state = {}
            for part in merged:
                state.update(part)
            inner["state"] = {i: state[i] for i in sorted(state)}
        elif self.mode in ("fsdp", "tp"):
            inner["state"] = {
                i: {k: (self.gather_like(params[i], v).detach().cpu()
                        if torch.is_tensor(v) and v.ndim > 0 else v)
                    for k, v in st.items()}
                for i, st in sorted(inner["state"].items())}
        return sd


def _inner(optimizer):
    return getattr(optimizer, "inner", optimizer)


def _all_reduce_flat(grads, group, average: bool) -> None:
    """One all-reduce of the gradients flattened into a buffer per dtype and
    device, copied back in place (divided by the group size with
    ``average``: exact for a power of two)."""
    buckets: Dict = {}
    for g in grads:
        buckets.setdefault((g.dtype, g.device), []).append(g)
    n = dist.get_world_size(group)
    for gs in buckets.values():
        flat = torch.cat([g.reshape(-1) for g in gs])
        dist.all_reduce(flat, group=group)
        if average and n > 1:
            flat.div_(n)
        off = 0
        for g in gs:
            g.copy_(flat[off: off + g.numel()].view_as(g))
            off += g.numel()


# -- tensor parallelism: slicing and gathering -------------------------------

def tp_slice(t: torch.Tensor, layout, rank_: int, size: int) -> torch.Tensor:
    """Rank ``rank_``'s cut of a full tensor laid out as ``layout`` = (dim,
    parts): ``parts`` equal blocks along ``dim`` (q | k | v), each split in
    ``size``, this rank's piece of every block concatenated."""
    dim, parts = layout
    chunks = t.chunk(parts, dim=dim)
    return torch.cat([c.chunk(size, dim=dim)[rank_] for c in chunks], dim=dim).contiguous()


def _tp_gather(t: torch.Tensor, layout, group) -> torch.Tensor:
    dim, parts = layout
    n = dist.get_world_size(group)
    pieces = []
    for c in t.contiguous().chunk(parts, dim=dim):
        bufs = [torch.empty_like(c) for _ in range(n)]
        dist.all_gather(bufs, c.contiguous(), group=group)
        pieces.append(torch.cat(bufs, dim=dim))
    return torch.cat(pieces, dim=dim)


def shard_tensor_parallel(model: torch.nn.Module, group) -> Dict:
    """Cut every parameter :func:`tp_dim` names to this rank's share over
    ``group`` (q | k | v as three blocks: by head, not a contiguous cut of the
    packed columns) and set every ``Attention`` and ``Mlp`` to run on it
    (models/vit.py ``tp_setup``); returns {new parameter: (dim, parts)}, the
    layout that :func:`_tp_gather` undoes."""
    from mem_tpu_torch.models.vit import Attention, Mlp

    r, n = dist.get_rank(group), dist.get_world_size(group)
    for m in model.modules():
        if isinstance(m, (Attention, Mlp)):
            m.tp_setup(group)
    layout = {}
    for name, p in list(model.named_parameters()):
        dim = tp_dim(name)
        if dim is None:
            continue
        lay = (dim, 3 if name.endswith("qkv.weight") else 1)
        owner, attr = name.rsplit(".", 1)
        new = torch.nn.Parameter(tp_slice(p.detach(), lay, r, n), requires_grad=p.requires_grad)
        setattr(model.get_submodule(owner), attr, new)
        layout[new] = lay
    return layout


def _rebind_optimizer(optimizer, new_of: Dict, convert) -> None:
    """Point the optimizer's groups and state at the new parameters,
    converting each state tensor shaped as its parameter with ``convert(old
    param, new param, tensor)``."""
    opt = _inner(optimizer)
    state = {}
    for g in opt.param_groups:
        g["params"] = [new_of.get(p, p) for p in g["params"]]
    for p, st in list(opt.state.items()):
        q = new_of.get(p, p)
        state[q] = {k: (convert(p, q, v) if torch.is_tensor(v) and v.shape == p.shape
                        and v.ndim > 0 else v) for k, v in st.items()}
    opt.state.clear()
    opt.state.update(state)
    if hasattr(opt, "axes"):
        opt.axes = {new_of.get(p, p): a for p, a in opt.axes.items()}


def check_optimizer(optimizer, tp: int, fsdp: bool) -> None:
    """Refuse the optimizers whose update would differ on a shard (see
    PER_TENSOR_OPTIMIZERS) and Lookahead's slow weights under FSDP and TP."""
    name = optimizer_name(optimizer)
    mode = "--fsdp 1" if fsdp else f"--tp {tp}"
    if "lookahead" in name:
        raise ValueError(f"--opt {name} with {mode}: Lookahead's slow weights are kept "
                         f"whole and do not follow a sharded placement; use --zero1 1 or DP")
    base = name.split("_")[-1]
    if base in PER_TENSOR_OPTIMIZERS and not (fsdp and base == "lamb"):
        raise ValueError(
            f"--opt {base} with {mode}: its update reads a statistic of the whole "
            f"tensor, which a shard does not hold; use --zero1 1 (whole tensors per rank) "
            f"or DP")


def _owners(params, n: int) -> Dict:
    """ZeRO-1's partition: whole parameters dealt out by size, largest first,
    each to the data rank holding the fewest elements so far."""
    load = [0] * n
    owner = {}
    for p in sorted(params, key=lambda q: -q.numel()):
        r = min(range(n), key=lambda i: load[i])
        owner[p] = r
        load[r] += p.numel()
    return {p: owner[p] for p in params}


def check_modes(tp: int = 1, zero1: bool = False, fsdp: bool = False) -> None:
    """The placement modes are exclusive (mesh.py:175-179): TP shards over
    'model', FSDP over 'data' and subsumes ZeRO-1."""
    if sum([tp > 1, bool(fsdp), bool(zero1)]) > 1:
        raise ValueError(
            f"tp={tp}, fsdp={fsdp}, zero1={zero1}: pick one placement mode "
            "(TP shards over 'model'; FSDP shards params+moments over "
            "'data' and already subsumes ZeRO-1)")


def place_train_state(model: torch.nn.Module, optimizer, mesh, tp: int = 1,
                      zero1: bool = False, fsdp: bool = False) -> Placement:
    """Place ``model`` and ``optimizer`` (with whatever state it holds: the
    step after a restore) on ``mesh`` under the parallelism config
    (mesh.py:159-186) and return the :class:`Placement`. The modes are
    exclusive, as in the reference; the optimizer keeps its object, its
    groups and state pointing at the placed parameters. Every BatchNorm of
    the model takes its statistics over the "data" processes."""
    check_modes(tp, zero1, fsdp)
    if tp > 1 or fsdp:
        check_optimizer(optimizer, tp, fsdp)
    if mesh is None:
        if tp > 1:
            raise ValueError(f"--tp {tp} needs a process group (get_mesh(tp={tp}))")
        _set_bn_group(model, None)
        return Placement()
    data_group = axis_group(mesh, "data")
    _set_bn_group(model, data_group if dist.get_world_size(data_group) > 1 else None)
    if fsdp:
        return _place_fsdp(model, optimizer, mesh, data_group)
    if tp > 1:
        return place_tensor_parallel(model, optimizer, mesh)
    replicate(model)
    if zero1:
        params = [p for g in _inner(optimizer).param_groups for p in g["params"]]
        owner = _owners(params, dist.get_world_size(data_group))
        me = dist.get_rank(data_group)
        opt = _inner(optimizer)
        for p, r in owner.items():
            if r != me:
                opt.state.pop(p, None)
        return Placement("zero1", mesh, data_group, owner=owner)
    return Placement("dp", mesh, data_group)


def place_tensor_parallel(model: torch.nn.Module, optimizer, mesh) -> Placement:
    """The TP placement over ``mesh``'s "model" axis (``place_train_state``
    with tp > 1; the card check also runs it on a one-rank "model" axis): the
    weights broadcast, each Attention and Mlp cut, the optimizer's groups and
    state moved onto the cuts."""
    replicate(model)
    data_group, model_group = axis_group(mesh, "data"), axis_group(mesh, "model")
    _set_bn_group(model, data_group if dist.get_world_size(data_group) > 1 else None)
    old = dict(model.named_parameters())
    layout = shard_tensor_parallel(model, model_group)
    new = dict(model.named_parameters())
    new_of = {old[k]: new[k] for k in new if new[k] is not old[k]}
    r, size = dist.get_rank(model_group), dist.get_world_size(model_group)
    _rebind_optimizer(optimizer, new_of,
                      lambda p, q, v: tp_slice(v, layout[q], r, size) if q in layout else v)
    partial = [p for n, p in model.named_parameters()
               if n.endswith("rel_pos_bias.relative_position_bias_table")]
    return Placement("tp", mesh, data_group, model_group, tp_layout=layout, tp_partial=partial)


def _set_bn_group(model, group) -> None:
    from mem_tpu_torch.models.segmentation import BatchNorm

    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.group = group


def _fully_shard():
    try:
        from torch.distributed.fsdp import fully_shard
    except ImportError:   # torch < 2.6
        from torch.distributed._composable.fsdp import fully_shard
    return fully_shard


def _place_fsdp(model, optimizer, mesh, data_group) -> Placement:
    """FSDP2 on every Block (and the MAE's TimmBlock) and at the root; the
    optimizer's groups and state
    move onto the DTensor parameters (state tensors cut as their parameter)."""
    from torch.distributed.tensor import distribute_tensor

    from mem_tpu_torch.models.mae import TimmBlock
    from mem_tpu_torch.models.vit import Block

    fully_shard = _fully_shard()
    replicate(model)
    dmesh = mesh["data"] if len(mesh.mesh_dim_names) > 1 else mesh
    old = dict(model.named_parameters())
    for m in model.modules():
        if isinstance(m, (Block, TimmBlock)):
            fully_shard(m, mesh=dmesh)
    fully_shard(model, mesh=dmesh)
    new = dict(model.named_parameters())
    new_of = {old[k]: new[k] for k in new if new[k] is not old[k]}
    _rebind_optimizer(optimizer, new_of,
                      lambda p, q, v: distribute_tensor(v.to(q.device), q.device_mesh,
                                                        q.placements))
    return Placement("fsdp", mesh, data_group)

"""Multi-process worker of the port, the counterpart of scripts/mp_worker.py:
the placements of parallel/mesh.py and the GPipe of parallel/pipeline.py
driven across OS processes over torch.distributed, with every result written
for the launcher to compare against one process (or the JAX package).

Launch one process per rank with torchrun's variables (``WORLD_SIZE``,
``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``):

    python -m mem_tpu_torch.tools.mp_worker <mode> <workdir> [key=value ...]

Modes (Gloo on the CPU unless said otherwise):

- ``train``: tiny pt_vit pretraining steps (width 32, depth 2, 2 heads, 32^2
  images) under DP, ZeRO-1 and FSDP with ``adamw`` and ``lamb``, a planted
  per-rank loss mean, and tensor parallelism (tp = world size) on the
  weights and batch of ``tp_inputs.npz`` with ``FUSED_MLP`` off and on and a
  planted fc2 bias added per rank; then, at width 128 (``OPT_MODEL``), the
  optimizers whose update reads a whole-tensor statistic under FSDP
  (``FSDP_OPTS``) and TP (``TP_OPTS``), each statistic also taken over the
  local shard alone (the planted ``local_stat`` fault), checkpoints after
  step ``SAVE_AT`` and resumes from the single-process ones
  (``ckpt_single_<opt>.pt``); the tiny MAE (``MAE_MODEL``) at tp = world
  size, its steps and its loss and gradients on ``mae_inputs.npz``; writes
  ``<case>_r<rank>.npz``; then the metric, RSS-watchdog and stop-flag
  agreements (``sync_r<rank>.json``).
- ``seg``: tiny segmentor train steps under DP (the PSP BatchNorms damped to
  eps 0.1) and with a planted unsynced BatchNorm.
- ``pipeline``: :func:`pipeline_apply` over the world on the dense stages and
  the ViT blocks of ``pipe_inputs.npz``.
- ``cli``: the CLIs under the process group, flags from ``cli_flags.json``
  ({name: [module, [flags]]}).
- ``chip`` (two processes, on one card): rank 0 first runs a world-size-1
  NCCL group alone (full-width pt_vit steps, ``configs/ncaltech.conf``,
  under DP, ZeRO-1, FSDP and TP against the same steps without a group),
  then both meet over Gloo on ``cuda:0`` (NCCL refuses two ranks on one
  device): the DP step (f32, 2 x 32 against 64) with the per-rank mean
  fault, the TP step at tp = 2 (bf16, ``FUSED_MLP``) with the fc2-bias
  fault, and the seg step under DP with the unsynced-BatchNorm fault
  (tools/mp_chip.py; ``chip1_r0.json``, ``chip2_r<rank>.json``).

The functions that build the models, batches and steps are importable, so a
launcher computes the single-process reference with the same code.
"""
from __future__ import annotations

import contextlib
import copy
import faulthandler
import json
import os
import sys
import time

import numpy as np
import torch

from mem_tpu_torch.parallel import mesh as M

# -- the tiny pretraining case ------------------------------------------------
PT_MODEL = dict(img_size=(32, 32), patch_size=(8, 8), in_chans=3, vocab_size=32,
                embed_dim=32, depth=2, num_heads=2, init_values=0.1,
                use_shared_rel_pos_bias=True, num_masked_tokens=10)
PT_VAE = dict(num_tokens=32, codebook_dim=8, num_layers=2, num_resnet_blocks=1, hidden_dim=16)
PT_PREPROC = dict(input_h=32, input_w=32, canvas_h=48, canvas_w=48, rand_aug=False,
                  color_jitter=0.0)
GLOBAL_B, STEPS = 8, 3
# the optimizers under the sharded placements: at width 128 (MLP 512)
# Adafactor factors every 2-D weight (two dims >= 128) and AdamP's
# projection fires on cut ones within the three steps
OPT_MODEL = dict(PT_MODEL, embed_dim=128)
FSDP_OPTS = ("adafactor", "novograd", "adamp", "sgdp", "lookahead_adamw", "lookahead_lamb")
TP_OPTS = ("lamb", "adafactor", "novograd", "adamp", "lookahead_lamb")
LOCAL_STAT_FAULTS = {"fsdp": ("adafactor", "novograd", "adamp"),
                     "tp": ("lamb", "adafactor", "novograd", "adamp")}
RESUME_OPTS = ("adafactor", "lookahead_lamb")
SAVE_AT = 1         # the checkpoint after steps 0 and 1; a resume runs step 2
LOOKAHEAD_K = 3     # Lookahead's sync at step 2: after a resume, from restored slow weights
MAE_MODEL = dict(img_size=32, patch_size=8, in_chans=3, embed_dim=32, depth=2, num_heads=2,
                 decoder_embed_dim=16, decoder_depth=1, decoder_num_heads=2)


def opt_lr(opt: str) -> float:
    """The peak lr of an optimizer case: Lamb's step is lr times each
    tensor's norm, so at 1e-3 the norms' weights (near 1.0) move by ~1e-3 a
    step and one f32 rounding of such a weight (6e-8) is ~1e-5 of three
    steps' displacement (half of it after Lookahead's sync): Lamb takes
    1e-2; the elementwise-normalised ones keep the recipe's 1e-3 (at 1e-2
    AdamP's LayerScale moves by a tenth a step and three steps amplify
    rounding to ~4e-5)."""
    return 1e-2 if opt.split("_")[-1] == "lamb" else 1e-3


def pretrain_batches(global_b: int = GLOBAL_B, steps: int = STEPS, n: int = 1200):
    """Host batches of the global batch. The first half of every batch (rank
    0 of two) masks 3 or 4 of the 16 patches, the second half 8 to 10, so the
    ranks' masked counts differ (a per-rank mean is not the global one)."""
    rng = np.random.default_rng(5)
    out = []
    for _ in range(steps):
        B = global_b
        ev = np.zeros((B, n, 4), np.float32)
        ev[..., 0] = rng.integers(0, 48, (B, n))
        ev[..., 1] = rng.integers(0, 40, (B, n))
        ev[..., 2] = np.sort(rng.integers(0, 10**6, (B, n)), axis=1)
        ev[..., 3] = rng.choice([-1.0, 1.0], (B, n))
        mask = np.zeros((B, 16), bool)
        for b in range(B):
            k = int(rng.integers(3, 5)) if b < B // 2 else int(rng.integers(8, 11))
            mask[b, rng.choice(16, k, replace=False)] = True
        out.append({"events": ev, "n_valid": rng.integers(600, n + 1, B).astype(np.int32),
                    "sample_h": rng.integers(28, 41, B).astype(np.int32),
                    "sample_w": rng.integers(31, 49, B).astype(np.int32),
                    "time_flip": rng.random(B) < 0.5, "x_flip": rng.random(B) < 0.5,
                    "shift_xy": rng.integers(-2, 3, (B, 2)).astype(np.int32), "mask": mask})
    return out


def run_pretrain(opt: str, mesh=None, zero1=False, fsdp=False, tp=1, device="cpu",
                 fault=None, model_kw=PT_MODEL, save=None, resume=None, lr=1e-3) -> dict:
    """STEPS pretraining steps from seeded weights; returns the per-step
    metrics, the step-0 gradients, the final weights in the single-process
    schema (numpy) and ``probe``: each parameter's cut and Adafactor
    factoring, and after each step AdamP's decision on every tensor of 2+
    dims. ``save``: a path where rank 0 writes the model and optimizer
    state (the single-process schema, gathered) after step SAVE_AT;
    ``resume``: such a file, restored before the placement (as the CLIs
    do), then the steps after SAVE_AT, and ``probe["regathered_equal"]``
    says whether the placed state gathers back to the file bit for bit."""
    from mem_tpu_torch.data.device_pipeline import PreprocConfig
    from mem_tpu_torch.models.discrete_vae import DiscreteVAE
    from mem_tpu_torch.models.registry import create_model
    from mem_tpu_torch.train.optim import create_optimizer
    from mem_tpu_torch.train.schedules import cosine_scheduler
    from mem_tpu_torch.train.steps import make_pretrain_train_step

    torch.manual_seed(0)
    model = create_model("pt_vit", **model_kw, device=device)
    model.init_weights(torch.Generator(device=device).manual_seed(0))
    vae = DiscreteVAE((32, 32), **PT_VAE, device=device)
    vae.init_weights(torch.Generator(device=device).manual_seed(1))
    vae.eval().requires_grad_(False)
    lr_sched = cosine_scheduler(lr, lr / 10, 1, STEPS)
    wd = cosine_scheduler(0.05, 0.2, 1, STEPS)
    optimizer = create_optimizer(model, lr, 0.05, opt=opt)
    if hasattr(optimizer, "k"):     # Lookahead syncs within the three steps
        optimizer.k = LOOKAHEAD_K
    first, probe = 0, {}
    if resume is not None:
        payload = torch.load(resume, weights_only=True)
        model.load_state_dict(payload["model"], strict=True)
        optimizer.load_state_dict(payload["optimizer"])
        first = SAVE_AT + 1
    placement = (M.place_train_state(model, optimizer, mesh, tp=tp, zero1=zero1, fsdp=fsdp)
                 if mesh is not None else None)
    if resume is not None:
        probe["regathered_equal"] = float(state_equal(gathered_state(model, optimizer,
                                                                     placement), payload))
    step = make_pretrain_train_step(model, vae, optimizer, PreprocConfig(**PT_PREPROC), lr_sched,
                                    wd, clip_grad=1.0, seed=0, placement=placement)
    metrics, grads0 = [], None
    with _faulty(fault):
        for t, b in enumerate(pretrain_batches()):
            if t < first:
                continue
            batch = M.shard_batch(b, mesh, device=device, global_batch=True)
            metrics.append({k: float(v) for k, v in step(batch, t).items()})
            probe.update(_probe(model, optimizer, t, first))
            if t == 0:
                grads0 = _full_grads(model, placement)
            if save is not None and t == SAVE_AT:
                state = gathered_state(model, optimizer, placement)
                if M.rank() == 0:
                    torch.save(state, save)
    weights = (placement.model_state_dict(model) if placement is not None
               else model.state_dict())
    return {"metrics": metrics, "grads0": grads0, "state_local": _state_numel(optimizer),
            "weights": {k: v.float().cpu().numpy() for k, v in weights.items()},
            "probe": probe}


def gathered_state(model, optimizer, placement) -> dict:
    """The model's and the optimizer's state in the single-process schema,
    copied off the live tensors (every rank calls)."""
    if placement is None:
        return copy.deepcopy({"model": model.state_dict(), "optimizer": optimizer.state_dict()})
    return copy.deepcopy({"model": placement.model_state_dict(model),
                          "optimizer": placement.optimizer_state_dict(optimizer)})


def state_equal(a, b) -> bool:
    """Two state trees hold the same keys and bit-identical tensors."""
    if isinstance(a, dict):
        return (isinstance(b, dict) and set(a) == set(b)
                and all(state_equal(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(state_equal(x, y) for x, y in zip(a, b)))
    if torch.is_tensor(a):
        return (torch.is_tensor(b) and a.dtype == b.dtype and a.shape == b.shape
                and torch.equal(a.detach().cpu(), b.detach().cpu()))
    return a == b


def _probe(model, optimizer, t: int, first: int) -> dict:
    """AdamP's decision on every tensor of 2+ dims after step ``t``; after
    the first step also each parameter's cut (1: its statistics cross
    processes) and whether Adafactor factored its second moment."""
    from mem_tpu_torch.train.optim import split

    inner = M._inner(optimizer)
    out = {}
    for name, p in model.named_parameters():
        st = inner.state.get(p, {})
        if "fired" in st and p.ndim >= 2:
            out[f"fired.{t}.{name}"] = float(st["fired"])
        if t == first:
            out[f"cut.{name}"] = float(split(p, getattr(inner, "cuts", None))[1].group
                                       is not None)
            out[f"factored.{name}"] = float("v_row" in st)
    return out


def _state_numel(optimizer) -> int:
    """Elements of optimizer state this process holds (its shards)."""
    from torch.distributed.tensor import DTensor

    n = 0
    for st in M._inner(optimizer).state.values():
        for v in st.values():
            if torch.is_tensor(v) and v.ndim > 0:
                n += (v.to_local() if isinstance(v, DTensor) else v).numel()
    return n


def _full_grads(model, placement) -> dict:
    out = {}
    for name, p in model.named_parameters():
        if p.grad is None:
            continue
        g = placement.gather_like(p, p.grad) if placement is not None else p.grad
        out[name] = g.detach().float().cpu().numpy().copy()
    return out


@contextlib.contextmanager
def _faulty(fault):
    """The planted faults: ``rank_mean`` (each rank's loss normalised by its
    own count, then averaged), ``unsynced_bn`` (set elsewhere),
    ``fc2_bias_per_rank`` (the tensor-parallel MLP, and the MAE's timm
    block's, adds fc2's bias before the sum, once per rank), ``local_stat``
    (the optimizers' whole-tensor statistics taken over this process's shard
    alone: no reduction across the cut)."""
    from mem_tpu_torch.models import vit
    from mem_tpu_torch.models.mae import TimmBlock
    from mem_tpu_torch.train import optim

    saved = []
    if fault == "local_stat":
        saved.append((optim.Cut, "_all_reduce", optim.Cut._all_reduce))
        optim.Cut._all_reduce = lambda self, x, op=None: x
    if fault == "rank_mean":
        saved.append((M, "global_quotient", M.global_quotient))
        M.global_quotient = lambda num, den, group=None: num / den.clamp(min=1.0)
    if fault == "fc2_bias_per_rank":
        def forward_tp(self, x, generator):
            x = vit.tp_enter(x.to(self.dtype), self.tp_group)
            if vit.FUSED_MLP and self.dropout == 0.0:
                y = vit.mlp_fused(x, self.fc1.weight.t(), self.fc1.bias, self.fc2.weight.t(),
                                  self.fc2.bias)
            else:
                h = torch.nn.functional.gelu(vit.linear(x, self.fc1, self.dtype),
                                             approximate="none")
                y = vit.linear(h, self.fc2, self.dtype)
            return vit.tp_reduce(y, self.tp_group)

        def timm_mlp(self, h):
            if self.tp_group is None:
                return mlp(self, h)
            h = vit.tp_enter(h, self.tp_group)
            h = torch.nn.functional.gelu(vit.linear(h, self.fc1, self.dtype), approximate="none")
            return vit.tp_reduce(vit.linear(h, self.fc2, self.dtype), self.tp_group)

        saved.append((vit.Mlp, "_forward_tp", vit.Mlp._forward_tp))
        vit.Mlp._forward_tp = forward_tp
        mlp = TimmBlock.mlp
        saved.append((TimmBlock, "mlp", mlp))
        TimmBlock.mlp = timm_mlp
    try:
        yield
    finally:
        for obj, name, value in saved:
            setattr(obj, name, value)


# -- tensor parallelism against the JAX package's weights ---------------------
TP_MODEL = dict(img_size=(32, 32), patch_size=(8, 8), in_chans=3, vocab_size=32,
                embed_dim=32, depth=2, num_heads=2)


def run_tp(inputs: dict, mesh, fused_mlp: bool, fault=None) -> dict:
    """Loss and gradients of the masked CE on ``inputs`` (weights ``w.*`` in
    the port's names; ``x``, ``mask``, ``labels``) with the model cut over
    the mesh's "model" axis; the gradients gathered to the full schema."""
    from mem_tpu_torch.models import vit
    from mem_tpu_torch.models.pretrain import masked_cross_entropy
    from mem_tpu_torch.models.registry import create_model

    model = create_model("pt_vit", **TP_MODEL)
    model.load_state_dict({k[2:]: torch.from_numpy(v) for k, v in inputs.items()
                           if k.startswith("w.")}, strict=True)
    optimizer = torch.optim.SGD(model.parameters(), lr=0.0)
    placement = M.place_train_state(model, optimizer, mesh, tp=M.axis_size(mesh, "model"))
    x, mask = torch.from_numpy(inputs["x"]), torch.from_numpy(inputs["mask"])
    labels = torch.from_numpy(inputs["labels"])
    old = vit.FUSED_MLP
    vit.FUSED_MLP = fused_mlp
    try:
        with _faulty(fault):
            model.train()
            loss, _ = masked_cross_entropy(model(x, mask), labels, mask)
            loss.backward()
    finally:
        vit.FUSED_MLP = old
    placement.reduce_gradients(list(model.parameters()))
    return {"loss": float(loss), "grads": _full_grads(model, placement),
            "local_heads": model.blocks[0].attn.num_heads}


def run_tp_update(inputs: dict, mesh, opt: str = "adamp", lr: float = 1e-2,
                  wd: float = 0.05) -> dict:
    """One ``opt`` update (constant lr and decay, no clip) of the weights
    ``w.*`` by the gradients ``g.*`` (both full, in the port's names) with
    the model cut over the mesh's "model" axis: the weights after, gathered,
    and AdamP's decision on each tensor."""
    from mem_tpu_torch.models.registry import create_model
    from mem_tpu_torch.train.optim import create_optimizer, set_schedule

    model = create_model("pt_vit", **TP_MODEL)
    model.load_state_dict({k[2:]: torch.from_numpy(v) for k, v in inputs.items()
                           if k.startswith("w.")}, strict=True)
    optimizer = create_optimizer(model, lr, wd, opt=opt)
    placement = M.place_train_state(model, optimizer, mesh, tp=M.axis_size(mesh, "model"))
    for name, p in model.named_parameters():
        p.grad = placement.place_like(p, torch.from_numpy(inputs[f"g.{name}"]))
    set_schedule(optimizer, lr, wd)
    placement.step(optimizer)
    return {"weights": {k: v.float().numpy() for k, v in placement.model_state_dict(model).items()},
            "probe": _probe(model, optimizer, 0, 0)}


# -- the MAE under tensor parallelism -------------------------------------------

def build_mae(device="cpu"):
    from mem_tpu_torch.models.mae import MaskedAutoencoderViT

    model = MaskedAutoencoderViT(**MAE_MODEL, device=device)
    model.init_weights(torch.Generator(device=device).manual_seed(0))
    return model


def run_mae(mesh=None, tp=1, device="cpu") -> dict:
    """STEPS MAE pretraining steps (AdamW, the recipe's step) from seeded
    weights on the pretraining batches, the model cut over the mesh's
    "model" axis with ``tp`` > 1: the metrics, the step-0 gradients and the
    final weights in the single-process schema."""
    from mem_tpu_torch.data.device_pipeline import PreprocConfig
    from mem_tpu_torch.train.optim import create_optimizer
    from mem_tpu_torch.train.schedules import cosine_scheduler
    from mem_tpu_torch.train.steps import make_mae_train_step

    model = build_mae(device)
    optimizer = create_optimizer(model, 1e-3, 0.05)
    placement = M.place_train_state(model, optimizer, mesh, tp=tp) if mesh is not None else None
    lr, wd = cosine_scheduler(1e-3, 1e-4, 1, STEPS), cosine_scheduler(0.05, 0.2, 1, STEPS)
    step = make_mae_train_step(model, optimizer, PreprocConfig(**PT_PREPROC), lr, wd,
                               clip_grad=1.0, seed=0, placement=placement)
    metrics, grads0 = [], None
    for t, b in enumerate(pretrain_batches()):
        b = {k: v for k, v in b.items() if k != "mask"}
        metrics.append({k: float(v) for k, v in step(M.shard_batch(b, mesh, device=device,
                                                                   global_batch=True), t).items()})
        if t == 0:
            grads0 = _full_grads(model, placement)
    weights = (placement.model_state_dict(model) if placement is not None
               else model.state_dict())
    return {"metrics": metrics, "grads0": grads0,
            "weights": {k: v.float().cpu().numpy() for k, v in weights.items()}}


def run_mae_tp(inputs: dict, mesh, fault=None) -> dict:
    """The MAE's loss and gradients on ``inputs`` (weights ``w.*`` in the
    port's names, images ``x``, shuffle ``noise``) with the model cut over
    the mesh's "model" axis; the gradients gathered to the full schema."""
    from mem_tpu_torch.models.mae import MaskedAutoencoderViT

    model = MaskedAutoencoderViT(**MAE_MODEL)
    model.load_state_dict({k[2:]: torch.from_numpy(v) for k, v in inputs.items()
                           if k.startswith("w.")}, strict=True)
    optimizer = torch.optim.SGD(model.parameters(), lr=0.0)
    placement = M.place_train_state(model, optimizer, mesh, tp=M.axis_size(mesh, "model"))
    model.train()
    with _faulty(fault):
        loss, _, _ = model(torch.from_numpy(inputs["x"]),
                           noise=torch.from_numpy(inputs["noise"]))
        loss.backward()
    placement.reduce_gradients(list(model.parameters()))
    return {"loss": float(loss), "grads": _full_grads(model, placement),
            "local_hidden": model.blocks[0].fc1.weight.shape[0]}


# -- the tiny segmentation case ------------------------------------------------
SEG_CLASSES = 3
SEG_BACKBONE = dict(img_size=64, embed_dim=32, depth=2, num_heads=2, out_indices=(0, 0, 0, 1),
                    drop_path_rate=0.0)
SEG_HEADS = dict(head_channels=16, aux_channels=8, dropout_ratio=0.0)
SEG_DAMPED_EPS = 0.1


def seg_batches(global_b: int = 4, steps: int = STEPS, n: int = 30000):
    """Seg host batches; the first half of each batch ignores 10 of the 11
    label rows' first 40 rows, the second half 200, so the ranks' valid
    pixel counts differ."""
    rng = np.random.default_rng(9)
    out = []
    for _ in range(steps):
        B = global_b
        xyp = np.zeros((B, n, 3), np.int16)
        xyp[..., 0] = rng.integers(0, 640, (B, n))
        xyp[..., 1] = np.sort(rng.integers(0, 440, (B, n)), axis=1)
        xyp[:, : n // 2, 0] = np.clip(rng.normal(250, 70, (B, n // 2)), 0, 639).astype(np.int16)
        xyp[..., 2] = rng.choice([-1, 1], (B, n))
        labels = np.repeat(np.repeat(rng.integers(0, SEG_CLASSES, (B, 11, 16)), 40, axis=1),
                           40, axis=2).astype(np.int32)
        labels[: B // 2, :10] = 255
        labels[B // 2:, :200] = 255
        out.append({"events_xyp": xyp, "n_valid": np.full(B, n, np.int32), "label": labels,
                    "flip": np.arange(B) % 2 == 0,
                    "resize_jitter": np.stack([np.array(
                        [1.0 + 0.004 * b, 1.0 + 0.006 * b, b % 4, b % 6], np.float32)
                        for b in range(1, B + 1)])})
    return out


def damp_psp(model, eps: float = SEG_DAMPED_EPS) -> None:
    """The pooling branches' BatchNorms' epsilon raised (BatchNorm over a few
    values per channel amplifies f32 noise; ROADMAP S2)."""
    si = 0
    while hasattr(model.decode_head, f"psp_{si}"):
        getattr(model.decode_head, f"psp_{si}").bn.eps = eps
        si += 1


def build_seg(device="cpu", dtype=torch.float32, backbone=None, heads=None,
              num_classes=SEG_CLASSES):
    from mem_tpu_torch.models.segmentation import EncoderDecoder

    model = EncoderDecoder(num_classes=num_classes, backbone_cfg=dict(backbone or SEG_BACKBONE),
                           dtype=dtype, device=device, **(heads or SEG_HEADS))
    model.init_weights(torch.Generator(device=device).manual_seed(3))
    with torch.no_grad():    # every bias and BatchNorm affine away from 0 / 1
        g = torch.Generator(device=device).manual_seed(4)
        for name, p in model.named_parameters():
            if p.ndim == 1:
                p.add_(0.2 * torch.randn(p.shape, generator=g, device=device))
    damp_psp(model)
    return model


def run_seg(mesh=None, device="cpu", fault=None, batches=None, model=None) -> dict:
    """Seg train steps (AdamW, layer decay) from seeded weights: the metrics,
    the step-0 gradients, the weights and BatchNorm buffers after."""
    from mem_tpu_torch.train.optim import create_optimizer
    from mem_tpu_torch.train.schedules import poly_lr_schedule
    from mem_tpu_torch.train.steps import make_seg_steps

    model = model if model is not None else build_seg(device)
    depth = len(model.backbone.blocks)
    optimizer = create_optimizer(model, 1e-3, 0.05, layer_decay=0.65, num_layers=depth,
                                 betas=(0.9, 0.999))
    placement = M.place_train_state(model, optimizer, mesh) if mesh is not None else None
    if fault == "unsynced_bn":
        M._set_bn_group(model, None)
    step, _ = make_seg_steps(model, optimizer, poly_lr_schedule(1e-3, 3, warmup_iters=1), 0.05,
                             model.num_classes, False, y_sorted=True, placement=placement)
    metrics, grads0 = [], None
    for t, b in enumerate(batches or seg_batches()):
        batch = M.shard_batch(b, mesh, device=device, global_batch=True)
        metrics.append({k: float(v) for k, v in step(batch, t).items()})
        if t == 0:
            grads0 = _full_grads(model, placement)
    return {"metrics": metrics, "grads0": grads0,
            "weights": {k: v.float().cpu().numpy() for k, v in model.state_dict().items()}}


# -- the pipeline --------------------------------------------------------------

def dense_stage(p, a):
    return torch.tanh(a @ p["w"] + p["b"])


def block_stage_fn(dim: int, heads: int):
    """stage_fn of one ViT Block (eval mode, f32) over its parameters."""
    from torch.func import functional_call

    from mem_tpu_torch.models.vit import Block

    block = Block(dim, heads, init_values=0.1).eval()

    def stage(p, a):
        return functional_call(block, p, (a,))

    return stage


def run_pipeline(inputs: dict, mesh=None) -> dict:
    """The dense stages and the ViT blocks of ``inputs`` through
    pipeline_apply: outputs and the gradients of sum(y * t) for this rank's
    stage parameters and for x."""
    from mem_tpu_torch.parallel.pipeline import pipeline_apply, pipeline_param_sharding

    out = {}
    for tag, fn, micro in (("dense", dense_stage, 4),
                           ("vit", block_stage_fn(32, 2), 2)):
        keys = sorted({k.split(".", 2)[2] for k in inputs if k.startswith(f"{tag}.p.")})
        stacked = {k: torch.from_numpy(inputs[f"{tag}.p.{k}"]).requires_grad_(True)
                   for k in keys}
        local = pipeline_param_sharding(stacked, mesh)
        x = torch.from_numpy(inputs[f"{tag}.x"]).requires_grad_(True)
        y = pipeline_apply(fn, local, x, mesh, num_microbatches=micro)
        (y * torch.from_numpy(inputs[f"{tag}.t"])).sum().backward()
        out[f"{tag}.y"] = y.detach().numpy()
        out[f"{tag}.gx"] = x.grad.numpy()
        for k, v in local.items():
            out[f"{tag}.g.{k}"] = v.grad.numpy()
    return out


# -- the CLIs --------------------------------------------------------------------

def run_clis(workdir: str) -> dict:
    """Each entry of cli_flags.json, in its order: ``module.main(flags)``;
    returns {name: {"seconds", and the scalar metrics main returned}}."""
    import importlib

    with open(os.path.join(workdir, "cli_flags.json")) as f:
        plan = json.load(f)
    done = {}
    for name, (module, flags) in plan.items():
        t0 = time.perf_counter()
        ret = importlib.import_module(f"mem_tpu_torch.cli.{module}").main(flags)
        done[name] = {"seconds": round(time.perf_counter() - t0, 3)}
        if isinstance(ret, dict):   # test_seg's metrics
            done[name].update({k: float(v) for k, v in ret.items()
                               if isinstance(v, (float, int, np.floating))})
    return done


# -- launching -------------------------------------------------------------------

def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def launch(mode: str, workdir: str, nproc: int = 2, args=(), env=None,
           timeout: float = 600.0, cwd=None) -> list:
    """Start ``nproc`` workers of ``mode`` with torchrun's variables (one
    rendezvous on a free localhost port), wait for all of them (killing the
    rest when one fails or the time runs out) and return [(exit code,
    output)] by rank; each output is also in ``workdir/log_<mode>_r<rank>.txt``."""
    import subprocess

    os.makedirs(workdir, exist_ok=True)
    base = dict(os.environ if env is None else env, MASTER_ADDR="127.0.0.1",
                MASTER_PORT=str(free_port()), WORLD_SIZE=str(nproc))
    logs = [os.path.join(workdir, f"log_{mode}_r{r}.txt") for r in range(nproc)]
    procs = []
    for r in range(nproc):
        with open(logs[r], "w") as out:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "mem_tpu_torch.tools.mp_worker", mode, workdir, *args],
                env=dict(base, RANK=str(r), LOCAL_RANK=str(r)), cwd=cwd, stdout=out,
                stderr=subprocess.STDOUT))
    deadline = time.time() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if time.time() > deadline or any(p.poll() not in (None, 0) for p in procs):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    codes = [p.wait() for p in procs]
    return [(c, open(log).read()) for c, log in zip(codes, logs)]


# -- the chip phases --------------------------------------------------------------

def _save_npz(workdir, tag, rank, result):
    flat = {}
    for key in ("grads0", "weights", "grads"):
        for k, v in (result.get(key) or {}).items():
            flat[f"{key}.{k}"] = v
    for i, m in enumerate(result.get("metrics", [])):
        for k, v in m.items():
            flat[f"metrics.{i}.{k}"] = np.float64(v)
    for k, v in (result.get("probe") or {}).items():
        flat[f"probe.{k}"] = np.float64(v)
    for k in ("loss", "local_heads", "local_hidden", "state_local"):
        if k in result:
            flat[k] = np.float64(result[k])
    np.savez(os.path.join(workdir, f"{tag}_r{rank}.npz"), **flat)


def _train_mode(workdir: str) -> None:
    rank = M.rank()
    for tag, kw in (("dp_adamw", dict(opt="adamw")),
                    ("zero1_adamw", dict(opt="adamw", zero1=True)),
                    ("zero1_lamb", dict(opt="lamb", zero1=True)),
                    ("fsdp_adamw", dict(opt="adamw", fsdp=True)),
                    ("fsdp_lamb", dict(opt="lamb", fsdp=True)),
                    ("fault_rank_mean", dict(opt="adamw", fault="rank_mean"))):
        _save_npz(workdir, tag, rank, run_pretrain(mesh=M.get_mesh(), **kw))
    tp_path = os.path.join(workdir, "tp_inputs.npz")
    if os.path.exists(tp_path):
        inputs = dict(np.load(tp_path))
        tp_mesh = M.get_mesh(tp=M.world_size())
        for tag, kw in (("tp", dict(fused_mlp=False)), ("tp_fused", dict(fused_mlp=True)),
                        ("fault_fc2_bias", dict(fused_mlp=False, fault="fc2_bias_per_rank"))):
            _save_npz(workdir, tag, rank, run_tp(inputs, tp_mesh, **kw))
    adamp_path = os.path.join(workdir, "adamp_inputs.npz")
    if os.path.exists(adamp_path):
        _save_npz(workdir, "tp_adamp_update", rank,
                  run_tp_update(dict(np.load(adamp_path)), M.get_mesh(tp=M.world_size())))
    _optimizer_cases(workdir)
    mae_path = os.path.join(workdir, "mae_inputs.npz")
    tp_mesh = M.get_mesh(tp=M.world_size())
    _save_npz(workdir, "mae_tp_steps", rank, run_mae(tp_mesh, tp=M.world_size()))
    if os.path.exists(mae_path):
        for tag, fault in (("mae_tp", None), ("fault_mae_fc2_bias", "fc2_bias_per_rank")):
            _save_npz(workdir, tag, rank, run_mae_tp(dict(np.load(mae_path)), tp_mesh, fault))
    _sync_checks(workdir)


def _optimizer_cases(workdir: str) -> None:
    """Under FSDP and under TP (tp = world size), one mesh each: every
    optimizer of FSDP_OPTS / TP_OPTS at OPT_MODEL (RESUME_OPTS also write
    ``ckpt_<placement>_<opt>.pt`` after step SAVE_AT), each of
    LOCAL_STAT_FAULTS with the ``local_stat`` fault, and each of RESUME_OPTS
    resumed from ``ckpt_single_<opt>.pt`` where the launcher wrote it."""
    rank = M.rank()
    for placement, opts in (("fsdp", FSDP_OPTS), ("tp", TP_OPTS)):
        kw = dict(fsdp=True) if placement == "fsdp" else dict(tp=M.world_size())
        mesh = M.get_mesh(tp=kw.get("tp", 1))
        for opt in opts:
            save = (os.path.join(workdir, f"ckpt_{placement}_{opt}.pt")
                    if opt in RESUME_OPTS else None)
            _save_npz(workdir, f"{placement}_{opt}", rank,
                      run_pretrain(opt, mesh, model_kw=OPT_MODEL, lr=opt_lr(opt), save=save,
                                   **kw))
        for opt in LOCAL_STAT_FAULTS[placement]:
            _save_npz(workdir, f"fault_local_{placement}_{opt}", rank,
                      run_pretrain(opt, mesh, model_kw=OPT_MODEL, lr=opt_lr(opt),
                                   fault="local_stat", **kw))
        for opt in RESUME_OPTS:
            single = os.path.join(workdir, f"ckpt_single_{opt}.pt")
            if os.path.exists(single):
                _save_npz(workdir, f"resume_{placement}_{opt}", rank,
                          run_pretrain(opt, mesh, model_kw=OPT_MODEL, lr=opt_lr(opt),
                                       resume=single, **kw))


def _sync_checks(workdir: str) -> None:
    """The cross-process agreements: SmoothedValue's synchronised count and
    total, the RSS watchdog's max over the processes (a fake RSS of 1 + 2 *
    rank GB against a 2 GB limit), any_process and common_count."""
    from mem_tpu_torch.utils import metrics, preemption

    rank = M.rank()
    sv = metrics.SmoothedValue()
    sv.update(1.0 + rank, n=2 + rank)
    sv.synchronize_between_processes()
    saved, preemption.rss_gb = preemption.rss_gb, lambda: 1.0 + 2.0 * rank
    try:
        due = preemption.rss_recycle_due(2.0)
    finally:
        preemption.rss_gb = saved
    with open(os.path.join(workdir, f"sync_r{rank}.json"), "w") as f:
        json.dump({"count": sv.count, "total": sv.total, "rss_due": due,
                   "any": M.any_process(rank == 1), "common": M.common_count(5 + rank)}, f)


def _seg_mode(workdir: str) -> None:
    rank = M.rank()
    for tag, fault in (("seg_dp", None), ("fault_unsynced_bn", "unsynced_bn")):
        _save_npz(workdir, tag, rank, run_seg(M.get_mesh(), fault=fault))


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    mode, workdir = argv[0], argv[1]
    opts = dict(a.split("=", 1) for a in argv[2:])
    os.makedirs(workdir, exist_ok=True)
    faulthandler.enable()       # a crash in a collective prints every thread's stack
    if mode.startswith("chip"):
        from mem_tpu_torch.tools import mp_chip

        return mp_chip.main(mode, workdir, opts)
    torch.set_num_threads(int(opts.get("threads", "2")))
    M.init_distributed("cpu")
    t0 = time.perf_counter()
    result = {}
    if mode == "train":
        _train_mode(workdir)
    elif mode == "seg":
        _seg_mode(workdir)
    elif mode == "pipeline":
        out = run_pipeline(dict(np.load(os.path.join(workdir, "pipe_inputs.npz"))))
        np.savez(os.path.join(workdir, f"pipeline_r{M.rank()}.npz"), **out)
    elif mode == "cli":
        result["clis"] = run_clis(workdir)
    else:
        raise SystemExit(f"unknown mode {mode!r}")
    result.update(mode=mode, world=M.world_size(), rank=M.rank(),
                  seconds=round(time.perf_counter() - t0, 3))
    with open(os.path.join(workdir, f"ok_{mode}_r{M.rank()}.json"), "w") as f:
        json.dump(result, f)
    if M.initialized():
        torch.distributed.barrier()
        torch.distributed.destroy_process_group()
    print(f"mp_worker {mode} r{result['rank']}/{result['world']}: {result['seconds']} s OK",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

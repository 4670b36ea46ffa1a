"""Classification finetuning on PyTorch (stage 3), port of
mem_tpu/cli/run_class_finetuning.py: the same flags and aliases (so
configs/*.conf bind), plus ``--device``.

Each optimizer step (train/steps.py) runs on the device: for each of
``--update_freq`` micro-batches the training preprocessing (kernel K1 and the
augmentations) -> mixup / cutmix -> ``ft_vit`` (attention through kernels
K2f/K2b; with the toggles of models/vit.py, K5a/K5c and the MLPs through
K6f/K6b) -> cross-entropy (soft targets / label smoothing); then the
``--opt`` optimizer (train/optim.py: AdamW by default, or any name the JAX
package accepts; AdamW under ``--freeze_backbone``) with BEiT layer decay
and cosine lr / wd schedules, and the EMA of the weights.
The host loads, slices and pads events, draws the augmentations and the
mixup parameters, and copies each batch to the device one step ahead
(under ``--steps_per_dispatch K``, 8 by default: one (K, update_freq, B, ...)
block a chunk, K optimizer steps per host dispatch, train/chain.py). After
every epoch the val split is evaluated with the raw and the EMA weights
(top-1 / top-5), and the best top-1 is tagged ``checkpoint-best.pth``.

``--finetune x.pth`` starts from a MEM pretraining checkpoint through the
surgery importer (a shared rel-pos table becomes one table per block).
``--MAE 1`` finetunes the reference's MAE leg instead: ``vit_base_patch16``
(timm blocks, global pool; the ``--transformer_*`` geometry) from an MAE
pretraining checkpoint (``run_mem_pretraining --MAE 1``, or a timm-named
reference one) through ``surgery_for_mae_finetune``, loaded only when
training, as the reference does; the step, EMA, mixup and layer decay are
the same.
Checkpoints are ``output_dir/checkpoint-{epoch}.pth`` = ``{"model":
<state_dict in the export_vit_params schema>, "optimizer": ..., "ema":
<state_dict of the EMA weights, when EMA is on>, "epoch": n, "best_acc":
x}``; ``--auto_resume`` continues from the highest numbered one, and
``--eval`` evaluates it. A checkpoint written with the other ``--model_ema``
setting resumes too: a missing EMA is re-seeded from the restored weights, a
surplus one is dropped.

``--int8 1`` runs the eval forwards (``--eval`` included) with fc1, qkv and
proj as W8A8 products (``models.vit.INT8_GEMM`` for the run; training
forwards ignore it). ``--log_dir`` writes TensorBoard scalars (val acc1 /
acc5 and the epoch's train loss) under ``log_dir + wandb_group``, ``--wandb
1`` logs the train loss every 100 steps and val acc1 / acc5 each epoch;
each falls back to nothing when its package is missing.

Multi-process training (``torchrun --nproc_per_node N -m
mem_tpu_torch.cli.run_class_finetuning ...``; NCCL, or Gloo with ``--device
cpu``): ``--batch_size`` is the global batch, each process reads its share
of the samples, and the placement is data parallel, ``--zero1 1`` or
``--fsdp 1`` (parallel/mesh.py); the losses, the evaluations and the EMA
are the global batch's and rank 0 writes checkpoints (the single-process
schema), sinks and panels. ``--eval_dump`` needs one process, as in the
reference.

``--data_set IMNET`` finetunes on a JPEG class tree (data_path/{train,val})
instead, the reference's real-image baseline (build_transform_e2v): the host
decodes, crops, flips and resizes to ``--input_size`` (ColorJitter only when
``--aa`` is off) and draws the augmentations; the device runs the ``--aa``
RandAugment in timm's level mode and ``--reprob`` RandomErasing
(data/device_pipeline.preprocess_image_cls), then the same step.

Usage:
  python -m mem_tpu_torch.cli.run_class_finetuning --config configs/ncaltech.conf \\
      --data_path datasets/ncaltech101 --finetune pt_out/checkpoint-final.pth \\
      --output_dir ft_out [--device cuda]
"""
from __future__ import annotations

from mem_tpu_torch import _signals

_signals.latch()  # before torch loads: a setup-time SIGTERM must latch

import itertools
import json
import math
import os
import sys
import time

import numpy as np
import torch

from mem_tpu_torch.cli.common import (add_compat_args, add_imnet_args, add_preprocessing_args,
                                      build_classifier, build_pipeline, build_preproc,
                                      data_shard, imnet_aug, imnet_pipelines, resolve_device,
                                      validate_preproc_args, warn_compat_args)
from mem_tpu_torch.data.device_pipeline import (draw_train_aug, preprocess_batch,
                                                with_image_draws)
from mem_tpu_torch.data.prefetch import chunk_batches, device_prefetch, prefetch, to_device
from mem_tpu_torch.models import vit
from mem_tpu_torch.parallel.mesh import (any_process, check_modes, common_count, get_mesh, is_main,
                                         local_batch_size, place_train_state, world_size)
from mem_tpu_torch.train.chain import prefetch_args
from mem_tpu_torch.train.mixup import draw_mixup, make_mixup
from mem_tpu_torch.train.optim import SKIP_NAMES, create_optimizer
from mem_tpu_torch.train.schedules import cosine_scheduler
from mem_tpu_torch.train.steps import make_finetune_eval_step, make_finetune_train_step
from mem_tpu_torch.utils.checkpoint import (latest_numbered_checkpoint, load_checkpoint,
                                            save_checkpoint)
from mem_tpu_torch.utils.config import ConfigArgumentParser
from mem_tpu_torch.utils.metrics import MetricLogger, TensorboardLogger, maybe_wandb
from mem_tpu_torch.utils.preemption import (RESTART_EXIT_CODE, GracefulShutdown, rss_gb,
                                            rss_recycle_due, validate_rss_flag)

LOG_EVERY = 10   # optimizer steps between metric reads (run_class_finetuning.py:632)
SINK_EVERY = 100  # optimizer steps between wandb points (run_class_finetuning.py:638)


def get_args(argv=None):
    p = ConfigArgumentParser("MEM classification finetuning (PyTorch)")
    p.add_argument("--expweek", type=str, default="")
    p.add_argument("--expname", type=str, default="")
    p.add_argument("--data_path", type=str, default="")
    p.add_argument("--eval_data_path", type=str, default=None,
                   help="separate root for the val split")
    p.add_argument("--data_set", type=str, default="npy")
    p.add_argument("--nb_classes", type=int, default=0)
    add_preprocessing_args(p)
    p.set_defaults(normalize_events=1)   # the finetune parser's default

    p.add_argument("--model", type=str, default="ft_vit")
    p.add_argument("--pretrained", type=int, default=0)
    p.add_argument("--finetune", "--class_checkpoint", type=str, default="")
    p.add_argument("--model_key", type=str, default="model|module")
    p.add_argument("--model_prefix", type=str, default="",
                   help="prefix of the checkpoint's keys during the --finetune load")
    p.add_argument("--rel_pos_bias", type=int, default=1)
    p.add_argument("--disable_rel_pos_bias", action="store_false", dest="rel_pos_bias")
    p.add_argument("--abs_pos_emb", type=int, default=0)
    p.add_argument("--layer_scale_init_value", type=float, default=0.1)
    p.add_argument("--init_scale", type=float, default=0.001)
    p.add_argument("--use_mean_pooling", type=int, default=1)
    p.add_argument("--use_cls", action="store_false", dest="use_mean_pooling")
    p.add_argument("--disable_weight_decay_on_rel_pos_bias", action="store_true",
                   default=False)
    p.add_argument("--freeze_backbone", type=int, default=0)
    p.add_argument("--linear_probe_batch_norm", type=int, default=0)
    p.add_argument("--drop", "--class_dropout", type=float, default=0.0)
    p.add_argument("--attn_drop_rate", type=float, default=0.0)
    p.add_argument("--drop_path", "--class_drop_path", type=float, default=0.1)
    p.add_argument("--voxel", type=int, default=0)
    p.add_argument("--num_layers", type=int, default=4)
    p.add_argument("--transformer_emb", type=int, default=768)
    p.add_argument("--transformer_depth", type=int, default=12)
    p.add_argument("--transformer_heads", type=int, default=12)
    p.add_argument("--transformer_mlp_ratio", type=float, default=4.0)
    p.add_argument("--MAE", "--mae", type=int, default=0)
    p.add_argument("--mae_pretrain_input_size", type=int, default=0)

    p.add_argument("--epochs", "--class_epochs", type=int, default=300)
    p.add_argument("--batch_size", "--class_batch_size", type=int, default=1024)
    p.add_argument("--update_freq", "--class_update_freq", type=int, default=1)
    p.add_argument("--steps_per_dispatch", type=int, default=8,
                   help="optimizer steps per host dispatch (train/chain.py: one CUDA "
                        "graph on the card where the configuration allows); 1 = step "
                        "by step")
    p.add_argument("--lr", "--class_lr", type=float, default=4e-3)
    p.add_argument("--layer_decay", "--class_layer_decay", type=float, default=0.9)
    p.add_argument("--warmup_lr", type=float, default=1e-6)
    p.add_argument("--min_lr", type=float, default=1e-6)
    p.add_argument("--warmup_epochs", "--class_warmup_epochs", type=int, default=20)
    p.add_argument("--warmup_steps", type=int, default=-1)
    p.add_argument("--weight_decay", "--class_weight_decay", type=float, default=5e-2)
    p.add_argument("--weight_decay_end", type=float, default=None)
    p.add_argument("--clip_grad", type=float, default=None)
    p.add_argument("--opt", type=str, default="adamw")
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--opt_eps", type=float, default=1e-8)
    p.add_argument("--opt_betas", type=float, nargs="+", default=None,
                   help="accepted and overridden to (0.9, 0.95), as the reference "
                        "does (optim_factory.py:121)")
    p.add_argument("--smoothing", type=float, default=0.1)
    p.add_argument("--mixup", type=float, default=0.8)
    p.add_argument("--cutmix", type=float, default=1.0)
    p.add_argument("--mixup_prob", type=float, default=0.0)
    p.add_argument("--mixup_switch_prob", type=float, default=0.5)
    p.add_argument("--mixup_mode", type=str, default="batch",
                   help="batch | pair | elem (timm Mixup modes)")
    p.add_argument("--cutmix_minmax", type=float, nargs="+", default=None,
                   help="cutmix min/max box-side ratios; overrides the beta-sampled "
                        "box and enables cutmix")
    p.add_argument("--model_ema", type=int, default=1)
    p.add_argument("--model_ema_decay", type=float, default=0.9999)
    p.add_argument("--color_jitter", "--class_color_jitter", type=float, default=0.0)
    p.add_argument("--rand_aug_batch_ops", type=int, default=1,
                   help="batch-level RandAugment op choice (default on); 0 = per sample")
    p.add_argument("--zero1", type=int, default=0,
                   help="partition the optimizer state over the data processes")
    p.add_argument("--fsdp", type=int, default=0,
                   help="FSDP2: parameters, gradients and optimizer state sharded over the "
                        "data processes")
    p.add_argument("--save_ckpt_freq", "--class_save_ckpt_freq", type=int, default=25)
    p.add_argument("--save_ckpt", action="store_true", default=True)
    p.add_argument("--no_save_ckpt", action="store_false", dest="save_ckpt")
    p.add_argument("--output_dir", type=str, default="./ft_out")
    p.add_argument("--log_dir", type=str, default=None,
                   help="TensorBoard event files under log_dir + wandb_group (needs "
                        "the tensorboard package)")
    p.add_argument("--wandb_group", type=str, default="pt")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--auto_resume", type=int, default=1)
    p.add_argument("--no_auto_resume", action="store_false", dest="auto_resume")
    p.add_argument("--resume", type=str, default="",
                   help="a .pth checkpoint of this CLI (or a directory: its highest "
                        "numbered one) to resume from; wins over --auto_resume")
    p.add_argument("--start_epoch", type=int, default=0)
    p.add_argument("--disable_eval_during_finetuning", action="store_true", default=False)
    p.add_argument("--rss_restart_gb", type=float, default=0,
                   help="when host RSS exceeds this many GB at an epoch boundary, save "
                        "a resumable checkpoint and exit with code 3 (0 = off)")
    p.add_argument("--eval", action="store_true")
    p.add_argument("--eval_dump", type=str, default=None,
                   help="with --eval: write per-sample top-5 predictions as JSON lines")
    p.add_argument("--dump_samples_dir", type=str, default=None,
                   help="dump the first --dump_samples_n epoch-0 preprocessed samples "
                        "as PNG panels")
    p.add_argument("--dump_samples_n", type=int, default=64)
    p.add_argument("--int8", type=int, default=0,
                   help="W8A8 int8 products (fc1, qkv, proj) in the eval forwards "
                        "(ops/quant.py); training forwards ignore it")
    p.add_argument("--wandb", type=int, default=0,
                   help="log train loss and val acc1 / acc5 to wandb (needs the package)")
    p.add_argument("--dtype", type=str, default="bfloat16")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device: cuda (the kernels) or cpu (their plain versions)")
    add_imnet_args(p, "finetune")
    compat = add_compat_args(p, ["--world_size", "--local_rank", "--gpu", "--dist_on_itp",
                                 "--dist_url", "--dist_eval", "--pin_mem", "--no_pin_mem",
                                 "--enable_deepspeed", "--model_ema_force_cpu"])
    args = p.parse_args(argv)
    warn_compat_args(args, compat)
    return args


def check_ported(args) -> None:
    """Raise for the data sets the port does not train on and for two
    placement modes at once."""
    check_modes(1, args.zero1, args.fsdp)
    if args.data_set not in ("npy", "image_folder", "dsec_semseg", "IMNET"):
        raise NotImplementedError(f"data_set {args.data_set!r}")


def load_finetune_checkpoint(model, path: str, model_key: str, model_prefix: str,
                             window) -> None:
    """Initialise the model from a pretraining ``.pth`` through the surgery
    (run_class_finetuning.py:372-392): probe the payload for ``model_key``,
    strip ``model_prefix``, adapt the tables to ``window``."""
    from mem_tpu_torch.utils.surgery import surgery_for_finetune

    sd = _checkpoint_state_dict(path, model_key)
    if model_prefix:
        sd = {k[len(model_prefix):]: v for k, v in sd.items() if k.startswith(model_prefix)}
    template = {k: v.cpu().numpy() for k, v in model.state_dict().items()}
    merged = surgery_for_finetune({k: v.cpu().numpy() for k, v in sd.items()}, template,
                                  window)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in merged.items()}, strict=True)
    print(f"loaded + adapted pretrain checkpoint {path}")


def _checkpoint_state_dict(path: str, model_key: str) -> dict:
    """The state_dict of a ``--finetune`` ``.pth``: under the first key of
    ``model_key`` ("a|b") the payload has, else the payload itself."""
    if not path.endswith((".pth", ".pt")):
        raise ValueError(
            f"--finetune {path}: only .pth / .pt checkpoints are read; an orbax "
            f"checkpoint directory needs jax -- convert it with `python -m "
            f"mem_tpu.cli.export_torch --checkpoint {path} --output model.pth`")
    ck = load_checkpoint(path)
    keys = [k for k in model_key.split("|") if k in ck]
    return ck[keys[0]] if keys else ck


def load_mae_finetune_checkpoint(model, path: str, model_key: str, window,
                                 src_grid=None) -> None:
    """Initialise the MAE classifier from an MAE pretraining ``.pth``
    (run_class_finetuning.py:402-432): probe the payload for ``model_key``,
    map timm names to the port's (``normalize_mae_state_dict``), and load
    through ``surgery_for_mae_finetune`` at ``window`` (the pretraining's
    square grid ``src_grid`` synthesises its sin-cos table when the source
    holds none)."""
    from mem_tpu_torch.utils.surgery import surgery_for_mae_finetune
    from mem_tpu_torch.utils.weights import normalize_mae_state_dict

    sd = normalize_mae_state_dict(_checkpoint_state_dict(path, model_key))
    print(f"Load MAE PT checkpoint from: {path}")
    template = {k: v.cpu().numpy() for k, v in model.state_dict().items()}
    merged = surgery_for_mae_finetune({k: v.cpu().numpy() for k, v in sd.items()}, template,
                                      grid=window, src_grid=src_grid)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in merged.items()}, strict=True)


def _with_draws(it, preproc, mixup, seed: int, image_draw=None):
    """Add the host augmentation draws (an IMNET batch's through
    ``with_image_draws`` with ``image_draw``, ``draw_image_aug``'s
    settings), and with ``mixup`` its draws, to each training micro-batch."""
    if image_draw is not None:
        it = with_image_draws(it, **image_draw)
    for batch in it:
        if image_draw is not None:
            hw = batch["image"].shape[1:3]
        else:
            batch.update(draw_train_aug(batch["aug_seed"], preproc,
                                        preproc.canvas_h, preproc.canvas_w))
            hw = (preproc.input_h, preproc.input_w)
        if mixup is not None:
            seeds = np.asarray(batch["aug_seed"]).reshape(-1)
            batch.update(draw_mixup(mixup, (int(seed), int(seeds[0])), len(seeds), *hw))
        yield batch


def _grouped(it, n: int):
    """Lists of n consecutive items; an incomplete tail is dropped."""
    buf = []
    for item in it:
        buf.append(item)
        if len(buf) == n:
            yield buf
            buf = []


def _stacked(it, n: int):
    """Host dicts of n consecutive micro-batches stacked as (n, B, ...); an
    incomplete tail is dropped."""
    for micros in _grouped(it, n):
        yield {k: np.stack([m[k] for m in micros]) for k in micros[0]}


def main(argv=None):
    """Train (or, with ``--eval``, evaluate); returns ``{"history": [(step,
    loss, grad_norm), ...] of the steps this process logged (every
    LOG_EVERY-th of an epoch and its last, of those read back), "evals":
    [(epoch, stats, ema_stats or None), ...], "best_acc": x}``."""
    args = get_args(argv)
    validate_preproc_args(args, train=not args.eval)
    check_ported(args)
    with vit.int8_gemm(bool(args.int8)):
        return _run(args)


def _run(args):
    """``main`` after the argument checks."""
    stopper = GracefulShutdown()
    validate_rss_flag(args.rss_restart_gb)
    device = resolve_device(args.device)
    mesh = get_mesh()
    if args.eval and args.eval_dump and world_size() > 1:
        # run_class_finetuning.py:534-538
        raise SystemExit("--eval_dump needs a single-process run: per-sample predictions "
                         "are written by one process over the whole val split")
    os.makedirs(args.output_dir, exist_ok=True)
    micro_bs = local_batch_size(args.batch_size, mesh) // args.update_freq
    shard = data_shard(mesh)

    image_draw = image_preproc = None
    if args.data_set == "IMNET":
        # the host decodes, crops and resizes; the device runs --aa and
        # --reprob (run_class_finetuning.py:251-294)
        ds_train, train_it, ds_val, val_it = imnet_pipelines(args, micro_bs, **shard)
        image_preproc, image_draw = imnet_aug(args, args.rand_aug_batch_ops)
    else:
        ds_train, train_it = build_pipeline(args, "train", True, micro_bs, seed=args.seed,
                                            num_workers=args.num_workers, **shard)
        ds_val, val_it = build_pipeline(args, "val", False, micro_bs, seed=args.seed,
                                        num_workers=args.num_workers, **shard)
    preproc_train = build_preproc(args, True, color_jitter=args.color_jitter)
    preproc_val = build_preproc(args, False)
    nb_classes = args.nb_classes or ds_train.nb_classes

    patch = 2 ** args.num_layers
    window = (args.input_H // patch, args.input_W // patch)
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    if args.MAE:
        print("MAE finetuning")
    model = build_classifier(args, nb_classes, dtype, device)
    model.init_weights(torch.Generator().manual_seed(args.seed))
    if args.MAE:
        # the reference loads the MAE checkpoint on training runs only (:406)
        if args.finetune and not args.eval:
            src_grid = (args.mae_pretrain_input_size // patch
                        if args.mae_pretrain_input_size else None)
            load_mae_finetune_checkpoint(model, args.finetune, args.model_key, window,
                                         src_grid)
    elif args.finetune:
        load_finetune_checkpoint(model, args.finetune, args.model_key, args.model_prefix,
                                 window)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model = {args.model}. pretrained = {bool(args.pretrained)}")
    print(f"model params: {n_params / 1e6:.1f}M  classes: {nb_classes}  device {device}")

    steps_per_epoch = train_it.steps_per_epoch() // args.update_freq
    lr_sched = cosine_scheduler(args.lr, args.min_lr, args.epochs, steps_per_epoch,
                                warmup_epochs=args.warmup_epochs,
                                warmup_steps=args.warmup_steps,
                                start_warmup_value=args.warmup_lr)
    wd_end = args.weight_decay if args.weight_decay_end is None else args.weight_decay_end
    wd_sched = cosine_scheduler(args.weight_decay, wd_end, args.epochs, steps_per_epoch)

    skip_names = SKIP_NAMES
    if args.disable_weight_decay_on_rel_pos_bias:
        skip_names = skip_names + ("relative_position_bias_table",)
    optimizer = create_optimizer(model, args.lr, args.weight_decay, opt=args.opt,
                                 opt_eps=args.opt_eps, momentum=args.momentum,
                                 skip_names=skip_names,
                                 layer_decay=args.layer_decay,
                                 num_layers=args.transformer_depth,
                                 freeze_backbone=bool(args.freeze_backbone))
    use_ema = bool(args.model_ema)
    # with EMA off no copy of the weights is made at all
    ema = [p.detach().clone() for p in model.parameters()] if use_ema else None

    start_epoch = args.start_epoch
    best_acc = 0.0
    ckpt = None
    if args.resume:
        ckpt = (latest_numbered_checkpoint(args.resume) if os.path.isdir(args.resume)
                else args.resume)
        if ckpt is None:
            raise SystemExit(f"--resume {args.resume}: no checkpoint-N.pth in it")
    elif args.auto_resume:
        # --eval resumes too: evaluating the run in --output_dir needs the
        # trained weights; a --finetune checkpoint still wins when there is none
        ckpt = latest_numbered_checkpoint(args.output_dir)
    if ckpt:
        payload = load_checkpoint(ckpt)
        if "optimizer" not in payload:
            raise SystemExit(f"--resume {ckpt}: not a resumable checkpoint of this CLI "
                             f"(no optimizer state); to start from weights use --finetune")
        model.load_state_dict(payload["model"], strict=True)
        optimizer.load_state_dict(payload["optimizer"])
        if use_ema:
            if "ema" in payload:
                for e, (name, _) in zip(ema, model.named_parameters()):
                    e.copy_(payload["ema"][name])
            else:
                print("note: checkpoint has no EMA state; re-seeding EMA from the "
                      "restored params")
                for e, p in zip(ema, model.parameters()):
                    e.copy_(p.detach())
        elif "ema" in payload:
            print("note: dropping the checkpoint's EMA state (--model_ema 0 on this run)")
        start_epoch = int(payload["epoch"]) + 1
        best_acc = float(payload.get("best_acc", 0.0))
        # the reference's two lines (run_class_finetuning.py:491, checkpoint.py:186)
        print(f"{'Resumed' if args.resume else 'Auto-resumed'} from {ckpt} "
              f"(epoch {start_epoch})")

    # every process restored the single-process payload; now place it
    placement = place_train_state(model, optimizer, mesh, zero1=bool(args.zero1),
                                  fsdp=bool(args.fsdp))
    if ema is not None:
        named = list(model.named_parameters())
        ema = [placement.place_like(p, e) for (_, p), e in zip(named, ema)]
    mixup = make_mixup(nb_classes, args.mixup, args.cutmix, args.mixup_prob,
                       args.mixup_switch_prob, args.smoothing, mode=args.mixup_mode,
                       cutmix_minmax=args.cutmix_minmax)
    K = max(1, args.steps_per_dispatch)
    train_step = make_finetune_train_step(
        model, optimizer, preproc_train, nb_classes, lr_sched, wd_sched, mixup=mixup,
        smoothing=args.smoothing, update_freq=args.update_freq, ema=ema,
        ema_decay=args.model_ema_decay if use_ema else None, clip_grad=args.clip_grad,
        seed=args.seed + 2, image_preproc=image_preproc, placement=placement, chain=K > 1)
    eval_step = make_finetune_eval_step(model, preproc_val, placement=placement)
    main_proc = is_main()

    def evaluate(weights=None, dump=None):
        """Top-1 / top-5 / loss over the val split with the model's weights
        or, given ``weights`` (the EMA), with those swapped in for the pass."""
        step = eval_step if dump is None else make_finetune_eval_step(
            model, preproc_val, with_predictions=True)
        saved = None
        if weights is not None:
            saved = [p.detach().clone() for p in model.parameters()]
            with torch.no_grad():
                for p, w in zip(model.parameters(), weights):
                    p.copy_(w)
        vlog = MetricLogger()
        idx = 0
        try:
            for batch in itertools.islice(val_it.epoch(0),
                                          common_count(val_it.steps_per_epoch())):
                out = step(to_device(batch, device))
                vlog.update(n=batch["label"].shape[0], loss=float(out["loss"]),
                            acc1=float(out["acc1"]), acc5=float(out["acc5"]))
                if dump is not None:
                    ids = out["topk_ids"].cpu().numpy()
                    probs = out["topk_probs"].cpu().numpy()
                    # the last batch is wrap-padded: stop at the true count
                    for i in range(min(ids.shape[0], len(ds_val) - idx)):
                        dump.write(json.dumps({
                            "index": idx, "label": int(batch["label"][i]),
                            "topk_ids": ids[i].tolist(),
                            "topk_probs": [round(float(p), 6) for p in probs[i]]}) + "\n")
                        idx += 1
        finally:
            if saved is not None:
                with torch.no_grad():
                    for p, w in zip(model.parameters(), saved):
                        p.copy_(w)
        return {k: m.global_avg for k, m in vlog.meters.items()}

    result = {"history": [], "evals": [], "best_acc": best_acc}
    if args.eval:
        if args.eval_dump:
            os.makedirs(os.path.dirname(args.eval_dump) or ".", exist_ok=True)
            with open(args.eval_dump, "w") as f:
                stats = evaluate(dump=f)
            print(f"wrote per-sample predictions to {args.eval_dump}")
        else:
            stats = evaluate()
        print(f"* eval acc1 {stats['acc1']:.2f} acc5 {stats['acc5']:.2f}")
        result["evals"].append((start_epoch - 1, stats, None))
        return result

    if args.dump_samples_dir and start_epoch == 0 and main_proc:
        from mem_tpu_torch.utils.visualize import dump_sample_panels

        idx = 0
        for batch in _with_draws(train_it.epoch(0), preproc_train, None, args.seed,
                                 image_draw):
            batch = to_device(batch, device)
            with torch.no_grad():
                imgs = (image_preproc(batch) if image_preproc is not None
                        else preprocess_batch(batch, preproc_train, True))
            take = min(args.dump_samples_n - idx, int(imgs.shape[0]))
            idx = dump_sample_panels(args.dump_samples_dir, imgs.float().cpu().numpy()[:take],
                                     start=idx)
            if idx >= args.dump_samples_n:
                break
        print(f"dumped {idx} sample panels to {args.dump_samples_dir}")

    if K > 1:
        print(train_step.describe(K), flush=True)
    run = maybe_wandb(bool(args.wandb) and main_proc, project="mem_finetuning_classification",
                      group=f"{args.expweek}_{args.expname}")
    # the reference appends wandb_group to the TensorBoard directory (rank 0)
    tb = (TensorboardLogger(args.log_dir + args.wandb_group)
          if args.log_dir and main_proc else None)

    def resumable(epoch: int) -> dict:
        """The single-process payload (every process calls: the placement
        gathers)."""
        pay = {"model": placement.model_state_dict(model),
               "optimizer": placement.optimizer_state_dict(optimizer),
               "epoch": epoch, "best_acc": best_acc}
        if use_ema:
            pay["ema"] = {name: placement.gather_like(p, e).detach().cpu()
                          for (name, p), e in zip(model.named_parameters(), ema)}
        return pay

    n_chunks = -(-steps_per_epoch // K)
    fetch_every = max(1, LOG_EVERY // K)   # chunks between metric reads
    for epoch in range(start_epoch, args.epochs):
        logger = MetricLogger()
        stop = False
        t0 = time.time()
        micro = _with_draws(train_it.epoch(epoch), preproc_train, mixup, args.seed, image_draw)
        if K > 1:
            # --steps_per_dispatch K: (k, update_freq, B, ...) blocks, one call
            # of the chain each (train/chain.py)
            blocks = chunk_batches(_stacked(micro, args.update_freq), K)
            steps = device_prefetch(prefetch(blocks), device, **prefetch_args(train_step))
        else:
            steps = _grouped(device_prefetch(prefetch(micro), device), args.update_freq)
        for i, batch in enumerate(steps):
            it0 = epoch * steps_per_epoch + i * K
            m = train_step(batch, it0)
            # read metrics back only periodically: a read waits for the device
            if i % fetch_every == 0 or i == n_chunks - 1:
                losses = m["loss"].reshape(-1).float().cpu().numpy()
                gnorms = m["grad_norm"].reshape(-1).float().cpu().numpy()
                bad = [it0 + j for j in range(len(losses)) if not math.isfinite(losses[j])]
                if bad:
                    raise RuntimeError(f"non-finite loss at epoch {epoch} step {bad[0]}")
                for j, (loss, gnorm) in enumerate(zip(losses, gnorms)):
                    step = i * K + j   # the step-at-a-time run's records and points
                    if step % LOG_EVERY == 0 or step == steps_per_epoch - 1:
                        logger.update(loss=float(loss))
                        result["history"].append((it0 + j, float(loss), float(gnorm)))
                    if run and step % SINK_EVERY == 0:
                        run.log({"train/loss": float(loss), "epoch": epoch, "step": it0 + j})
            stop = any_process(stopper.requested)
            if stop:
                break
        if stop:
            # SIGTERM: a resumable checkpoint that restarts this epoch, exit 0
            if args.save_ckpt:
                save_checkpoint(args.output_dir, epoch, resumable(epoch - 1))
            print(f"preempted at epoch {epoch}: "
                  f"{'checkpoint saved' if args.save_ckpt else 'ckpt saving disabled'}"
                  f"; exiting")
            return result
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        sps = steps_per_epoch * args.batch_size / (time.time() - t0)
        print(f"epoch {epoch}: loss {logger.meters['loss'].global_avg:.4f} "
              f"{sps:.1f} samples/sec ({sps / world_size():.1f}/gpu)", flush=True)

        if not args.disable_eval_during_finetuning:
            stats = evaluate()
            print(f"* acc1 {stats['acc1']:.2f} acc5 {stats['acc5']:.2f}")
            ema_stats = None
            if use_ema:
                ema_stats = evaluate(ema)
                print(f"* EMA acc1 {ema_stats['acc1']:.2f}")
            result["evals"].append((epoch, stats, ema_stats))
            if run:
                run.log({"val/acc1": stats["acc1"], "val/acc5": stats["acc5"], "epoch": epoch})
            if tb:
                tb.update(step=epoch, acc1=stats["acc1"], acc5=stats["acc5"],
                          loss=logger.meters["loss"].global_avg)
                tb.flush()
            if stats["acc1"] > best_acc:
                best_acc = stats["acc1"]
                if args.save_ckpt:
                    save_checkpoint(args.output_dir, "best", {
                        "model": placement.model_state_dict(model), "epoch": epoch,
                        "acc1": stats["acc1"]})
        if args.save_ckpt and ((epoch + 1) % args.save_ckpt_freq == 0
                               or epoch + 1 == args.epochs):
            save_checkpoint(args.output_dir, epoch, resumable(epoch))

        if args.save_ckpt and epoch + 1 < args.epochs \
                and rss_recycle_due(args.rss_restart_gb):
            save_checkpoint(args.output_dir, epoch, resumable(epoch))
            print(f"rss {rss_gb():.1f} GB > {args.rss_restart_gb} GB: recycling process "
                  f"(exit {RESTART_EXIT_CODE}); auto_resume continues at epoch {epoch + 1}",
                  flush=True)
            sys.exit(RESTART_EXIT_CODE)

    print(f"best acc1: {best_acc:.2f}")
    result["best_acc"] = best_acc
    return result


def cli() -> None:
    """The ``mem-tpu-torch-finetune`` console script: ``main`` without its
    return value (a console script exits with what its function returns)."""
    main()


if __name__ == "__main__":
    cli()

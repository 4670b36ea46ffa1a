"""MEM masked-event pretraining on PyTorch, port of
mem_tpu/cli/run_mem_pretraining.py: the same flags and aliases (so
configs/*.conf bind), plus ``--device``.

Each step (train/steps.py) runs on the device: the training preprocessing
(kernel K1 and the augmentations) -> the frozen VAE's codebook labels ->
the masked ViT (``pt_vit``; attention through kernels K2f/K2b) -> the
cross-entropy at the masked positions -> the ``--opt`` optimizer
(train/optim.py; AdamW by default, its moments in bf16 under
``--bf16_moments 1``; betas (0.9, 0.95) whatever ``--opt_betas`` says) with
the cosine lr / wd schedules. ``--pretrained 1 --init_ckpt <timm .pth /
.npz>`` warm-starts the encoder first (utils/timm_init.py). The host loads, slices and pads events, draws the masks and the
augmentations, and copies each batch to the device one step ahead.

The frozen tokenizer comes from ``--discrete_vae_weight_path``, a ``.pth``
holding ``{"model": <reference VAE state_dict>, "hparams": {input_H,
input_W, num_tokens, emb_dim, num_layers, num_resnet_blocks, hidden_dim,
channels, loss}}`` (the keys the reference's stage-1 checkpoint carries;
``python -m mem_tpu_torch.cli.train_vae`` writes one). With
``--dump_recon_dir`` the first eval batch of each saving epoch, and a
training batch whenever the grad norm passes ``--recon_grad_norm_thresh``
(at most once per 100 steps), go through the tokenizer and its decoder into
``recon_*.png`` / ``mask_*.png`` panels. Checkpoints are
``output_dir/checkpoint-{epoch}.pth`` and ``checkpoint-final.pth``,
``{"model": <state_dict in the export_vit_params schema>, "optimizer": ...,
"epoch": n}``; ``--auto_resume`` continues from the newest one.

``--MAE 1`` trains the reference's second recipe instead: pixel regression
with ``MaskedAutoencoderViT`` (the ``--transformer_*`` encoder, a
``--mae_decoder_*`` decoder; attention through K2f/K2b at the encoder's
visible tokens and the decoder's full sequence), no tokenizer, no masks from
the host (the shuffle noise comes from each step's generator), no eval pass
and no ``mlm_acc``; ``--dump_recon_dir`` is ignored, as in the reference. Its
checkpoints hold the state_dict in the ``export_mae_params`` schema, which
``run_class_finetuning --MAE 1 --finetune`` loads.

Sinks, as the reference wires them: ``--log_dir`` writes TensorBoard scalars
(``train/loss``) under ``log_dir + wandb_group``, ``--wandb 1`` logs
``train/loss`` and ``train/grad_norm`` to wandb (both every 100 steps, read
where the metrics are read back anyway; each falls back to nothing when its
package is missing), ``--profile_dir`` writes a torch.profiler trace of the
run's third step there, and the log line carries the steps' samples/s
(``utils.profiling.StepTimer``, two warm-up steps left out).

Multi-process training (``torchrun --nproc_per_node N -m
mem_tpu_torch.cli.run_mem_pretraining ...``; NCCL, or Gloo with ``--device
cpu``): ``--batch_size`` is the global batch, each process reads its share
of the samples, and the placement is data parallel, ``--zero1 1``
(optimizer state partitioned), ``--fsdp 1`` (FSDP2) or ``--tp N`` (tensor
parallel over N processes; parallel/mesh.py). Losses and metrics are the
global batch's; rank 0 writes the checkpoints (the single-process schema,
which resumes at any process count), the sinks and the panels; the epoch line
gives the samples/s of the run and of each GPU.

``--data_set IMNET`` pretrains on a JPEG class tree (data_path/{train,val})
instead: the host makes two views of one random-resized-crop window
(DataAugmentationForPTE2V: ColorJitter 0.4 and a flip first), the
``--train_interpolation`` one for the model and the
``--second_interpolation`` one for the tokenizer, both at ``--input_H``, and
the block mask; the step takes them as they are (no event preprocessing, no
K1). The ``--dump_recon_dir`` panels show the tokenizer's view. ``--MAE 1``
with IMNET is refused, as the reference asserts.

Usage:
  python -m mem_tpu_torch.cli.run_mem_pretraining --config configs/ncaltech.conf \\
      --data_path datasets/ncaltech101 --discrete_vae_weight_path vae.pth \\
      --output_dir pt_out [--device cuda]
"""
from __future__ import annotations

from mem_tpu_torch import _signals

_signals.latch()  # before torch loads: a setup-time SIGTERM must latch

import itertools
import math
import os
import sys
import time

import numpy as np
import torch

from mem_tpu_torch.cli.common import (add_compat_args, add_imnet_args, add_preprocessing_args,
                                      build_pipeline, build_preproc, data_shard,
                                      imnet_pipelines, resolve_device, validate_preproc_args,
                                      warn_compat_args)
from mem_tpu_torch.data.device_pipeline import preprocess_batch, with_train_draws
from mem_tpu_torch.data.prefetch import device_prefetch, prefetch, to_device
from mem_tpu_torch.models.discrete_vae import DiscreteVAE
from mem_tpu_torch.models.registry import create_model
from mem_tpu_torch.parallel.mesh import (any_process, check_modes, common_count, get_mesh, is_main, local_batch_size,
                                         place_train_state, world_size)
from mem_tpu_torch.train.optim import create_optimizer
from mem_tpu_torch.train.schedules import at, cosine_scheduler
from mem_tpu_torch.train.steps import (make_mae_train_step, make_pretrain_eval_step,
                                       make_pretrain_train_step)
from mem_tpu_torch.utils.checkpoint import latest_checkpoint, load_checkpoint, save_checkpoint
from mem_tpu_torch.utils.config import ConfigArgumentParser
from mem_tpu_torch.utils.metrics import TensorboardLogger, maybe_wandb
from mem_tpu_torch.utils.preemption import (RESTART_EXIT_CODE, GracefulShutdown, rss_gb,
                                            rss_recycle_due, validate_rss_flag)
from mem_tpu_torch.utils.profiling import StepTimer, trace
from mem_tpu_torch.utils.visualize import grid, mask_overlay, reconstruction_panel, save_png

LOG_EVERY = 10   # steps between metric reads (the reference logs every 10)
SINK_EVERY = 100  # steps between wandb / TensorBoard points (run_mem_pretraining.py:540-545)
PROFILE_STEP = 2  # the step --profile_dir traces, once a run (run_mem_pretraining.py:513)


def get_args(argv=None):
    p = ConfigArgumentParser("MEM pretraining (PyTorch)")
    p.add_argument("--expweek", type=str, default="")
    p.add_argument("--expname", type=str, default="")
    p.add_argument("--data_path", type=str, default="")
    p.add_argument("--data_set", type=str, default="npy")
    add_preprocessing_args(p)

    p.add_argument("--model", type=str, default="pt_vit")
    p.add_argument("--discrete_vae_weight_path", "--vae_checkpoint", type=str, default="")
    p.add_argument("--discrete_vae_type", type=str, default="event")
    p.add_argument("--rel_pos_bias", type=int, default=1)
    p.add_argument("--disable_rel_pos_bias", action="store_false", dest="rel_pos_bias")
    p.add_argument("--abs_pos_emb", type=int, default=0)
    p.add_argument("--layer_scale_init_value", type=float, default=0.1)
    p.add_argument("--masking", type=str, default="block")
    p.add_argument("--num_mask_patches", type=int, default=75)
    p.add_argument("--max_mask_patches_per_block", type=int, default=None)
    p.add_argument("--min_mask_patches_per_block", type=int, default=16)
    p.add_argument("--mask_pool_size", type=int, default=4096,
                   help=">0: pre-generate a mask pool instead of per-sample BEiT "
                        "rejection loops; 0 = a fresh mask per sample")
    p.add_argument("--drop_path", "--pt_dropout", type=float, default=0.1)
    p.add_argument("--color_jitter", "--pt_color_jitter", type=float, default=0.2)

    p.add_argument("--voxel", type=int, default=0)
    p.add_argument("--num_layers", type=int, default=4)
    p.add_argument("--transformer_emb", type=int, default=768)
    p.add_argument("--transformer_depth", type=int, default=12)
    p.add_argument("--transformer_heads", type=int, default=12)
    p.add_argument("--transformer_mlp_ratio", type=float, default=4.0)
    p.add_argument("--num_tokens", type=int, default=8192)
    p.add_argument("--MAE", "--mae", type=int, default=0)
    p.add_argument("--mae_decoder_emb", type=int, default=512)
    p.add_argument("--mae_decoder_depth", type=int, default=8)
    p.add_argument("--mae_decoder_heads", type=int, default=16)
    p.add_argument("--mae_norm_pix_loss", type=int, default=0)
    p.add_argument("--mae_loss_only_masked", type=int, default=0)
    p.add_argument("--pretrained", type=int, default=0)
    p.add_argument("--init_ckpt", type=str, default=None)

    p.add_argument("--epochs", "--pt_epochs", type=int, default=3000)
    p.add_argument("--batch_size", "--pt_batch_size", type=int, default=512)
    p.add_argument("--lr", "--pt_lr", type=float, default=5e-4)
    p.add_argument("--warmup_lr", type=float, default=1e-6)
    p.add_argument("--min_lr", type=float, default=1e-5)
    p.add_argument("--warmup_epochs", type=int, default=40)
    p.add_argument("--warmup_steps", "--pt_warmup_steps", type=int, default=-1)
    p.add_argument("--weight_decay", type=float, default=0.05)
    p.add_argument("--weight_decay_end", type=float, default=None)
    p.add_argument("--clip_grad", "--pt_grad_clip", type=float, default=None)
    p.add_argument("--opt", type=str, default="adamw")
    p.add_argument("--opt_eps", type=float, default=1e-8)
    p.add_argument("--opt_betas", type=float, nargs="+", default=[0.9, 0.999],
                   help="accepted and overridden to (0.9, 0.95), as the reference "
                        "does (optim_factory.py:121)")
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--bf16_moments", type=int, default=0,
                   help="store AdamW's moments in bf16 (every blend in f32)")
    p.add_argument("--save_ckpt_freq", "--pt_save_ckpt_freq", type=int, default=25)
    p.add_argument("--output_dir", type=str, default="./pt_out")
    p.add_argument("--log_dir", type=str, default=None,
                   help="TensorBoard event files under log_dir + wandb_group (needs "
                        "the tensorboard package)")
    p.add_argument("--wandb_group", type=str, default="pt")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--auto_resume", type=int, default=1)
    p.add_argument("--no_auto_resume", action="store_false", dest="auto_resume")
    p.add_argument("--resume", type=str, default="",
                   help="a .pth checkpoint (or a directory: its newest .pth) to resume "
                        "from; wins over --auto_resume")
    p.add_argument("--start_epoch", type=int, default=0)
    p.add_argument("--disable_eval_during_pretraining", action="store_true", default=False)
    p.add_argument("--wandb", type=int, default=0,
                   help="log train/loss and train/grad_norm to wandb (needs the package)")
    p.add_argument("--dtype", type=str, default="bfloat16")
    p.add_argument("--profile_dir", type=str, default=None,
                   help="write a torch.profiler trace of the run's third step here")
    p.add_argument("--steps_per_dispatch", type=int, default=8,
                   help="accepted; the port dispatches step by step (numerics "
                        "unchanged)")
    p.add_argument("--dump_recon_dir", type=str, default=None)
    p.add_argument("--recon_grad_norm_thresh", type=float, default=6.0)
    p.add_argument("--rand_aug_batch_ops", type=int, default=1,
                   help="batch-level RandAugment op choice (default on); 0 = per sample")
    p.add_argument("--rss_restart_gb", type=float, default=0,
                   help="when host RSS exceeds this many GB at an epoch boundary, save "
                        "a resumable checkpoint and exit with code 3 (0 = off)")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor parallelism over this many processes (heads and hidden "
                        "columns cut Megatron-style)")
    p.add_argument("--zero1", type=int, default=0,
                   help="partition the optimizer state over the data processes")
    p.add_argument("--fsdp", type=int, default=0,
                   help="FSDP2: parameters, gradients and optimizer state sharded over the "
                        "data processes")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device: cuda (the kernels) or cpu (their plain versions)")
    add_imnet_args(p)
    compat = add_compat_args(p, ["--world_size", "--local_rank", "--dist_on_itp",
                                 "--dist_url", "--dist_eval", "--pin_mem", "--no_pin_mem"])
    args = p.parse_args(argv)
    warn_compat_args(args, compat)
    return args


def check_ported(args) -> None:
    """Raise for the option combinations the port (and the reference) refuse."""
    if args.MAE and args.data_set == "IMNET":
        raise ValueError("--MAE with --data_set IMNET is not a reference path")
    if args.MAE and args.pretrained and args.init_ckpt:
        raise ValueError("--pretrained 1 --init_ckpt warm-starts the BEiT encoder of pt_vit "
                         "(run_mem_pretraining.py:194-222); the MAE has no such path")
    check_modes(args.tp, args.zero1, args.fsdp)


def build_model(args, dtype, device):
    patch = 2 ** args.num_layers
    if args.MAE:
        from mem_tpu_torch.models.mae import MaskedAutoencoderViT

        return MaskedAutoencoderViT(
            img_size=args.input_H, patch_size=patch,
            in_chans=3 if args.voxel == 0 else args.voxel, embed_dim=args.transformer_emb,
            depth=args.transformer_depth, num_heads=args.transformer_heads,
            decoder_embed_dim=args.mae_decoder_emb, decoder_depth=args.mae_decoder_depth,
            decoder_num_heads=args.mae_decoder_heads, mlp_ratio=args.transformer_mlp_ratio,
            norm_pix_loss=bool(args.mae_norm_pix_loss),
            loss_only_masked=bool(args.mae_loss_only_masked), dtype=dtype, device=device)
    return create_model(
        args.model,
        drop_path_rate=args.drop_path,
        use_shared_rel_pos_bias=bool(args.rel_pos_bias),
        use_abs_pos_emb=bool(args.abs_pos_emb),
        init_values=args.layer_scale_init_value,
        in_chans=3 if args.voxel == 0 else args.voxel,
        img_size=(args.input_H, args.input_W),
        patch_size=(patch, patch),
        embed_dim=args.transformer_emb,
        depth=args.transformer_depth,
        num_heads=args.transformer_heads,
        mlp_ratio=args.transformer_mlp_ratio,
        vocab_size=args.num_tokens,
        dtype=dtype,
        num_masked_tokens=args.num_mask_patches,
        device=device,
    )


def load_vae(args, device) -> DiscreteVAE:
    """The frozen tokenizer (run_mem_pretraining.py:237-272), in f32."""
    if args.discrete_vae_type != "event":
        raise NotImplementedError(f"--discrete_vae_type {args.discrete_vae_type}: only the "
                                  f"event VAE exists (the reference raises too)")
    payload = load_checkpoint(args.discrete_vae_weight_path)
    h = payload["hparams"]
    vae_chans = int(h.get("channels", 3))
    in_chans = 3 if args.voxel == 0 else args.voxel
    if vae_chans != in_chans:
        raise SystemExit(f"config error: VAE checkpoint was trained on {vae_chans} channels "
                         f"but --voxel {args.voxel} rasterizes {in_chans}")
    vae = DiscreteVAE(input_hw=(int(h["input_H"]), int(h["input_W"])),
                      num_tokens=int(h["num_tokens"]), codebook_dim=int(h["emb_dim"]),
                      num_layers=int(h["num_layers"]),
                      num_resnet_blocks=int(h["num_resnet_blocks"]),
                      hidden_dim=int(h["hidden_dim"]), channels=vae_chans,
                      loss_type=str(h.get("loss", "mse")), device=device)
    vae.load_state_dict(payload["model"], strict=True)
    return vae.eval().requires_grad_(False)


def should_dump_on_grad_norm(grad_norm: float, it: int, last_dump_it: int, thresh: float,
                             min_gap: int = 100) -> bool:
    """The grad-norm trigger of the reconstruction dump
    (engine_for_pretraining.py:167-201 dumps when grad_norm > 6), at most
    one dump per ``min_gap`` steps (run_mem_pretraining.py:275)."""
    return math.isfinite(grad_norm) and grad_norm > thresh and it - last_dump_it >= min_gap


def _dump_recon_panel(args, vae, preproc, batch: dict, tag: str) -> None:
    """The original / reconstruction panel of up to 8 samples of a device
    batch through the frozen VAE, and their mask overlays
    (run_mem_pretraining.py:288-313)."""
    os.makedirs(args.dump_recon_dir, exist_ok=True)
    with torch.no_grad():
        if "vae_view" in batch:     # IMNET: the tokenizer's view
            imgs = batch["vae_view"][:8]
        else:
            imgs = preprocess_batch(batch, preproc, is_train=False)[:8]
        recon = vae.decode_indices(vae.get_codebook_indices(imgs))
    imgs, recon = imgs.float().cpu().numpy(), recon.float().cpu().numpy()
    save_png(os.path.join(args.dump_recon_dir, f"recon_{tag}.png"),
             reconstruction_panel(imgs, recon, cols=4))
    if "mask" in batch:
        mask = batch["mask"].cpu().numpy()
        overlays = [mask_overlay(imgs[i], mask[i], 2 ** args.num_layers)
                    for i in range(imgs.shape[0])]
        save_png(os.path.join(args.dump_recon_dir, f"mask_{tag}.png"), grid(overlays, cols=4))


def _checkpoint(model, optimizer, epoch: int, placement) -> dict:
    """The single-process payload (every process calls: the placement
    gathers)."""
    return {"model": placement.model_state_dict(model),
            "optimizer": placement.optimizer_state_dict(optimizer), "epoch": epoch}


def main(argv=None):
    """Train; returns the per-step history [(step, loss, mlm_acc,
    grad_norm), ...] of this process (mlm_acc None under ``--MAE 1``)."""
    args = get_args(argv)
    validate_preproc_args(args)
    check_ported(args)
    stopper = GracefulShutdown()
    validate_rss_flag(args.rss_restart_gb)
    device = resolve_device(args.device)
    mesh = get_mesh(tp=args.tp)
    local_bs = local_batch_size(args.batch_size, mesh)
    os.makedirs(args.output_dir, exist_ok=True)
    patch = 2 ** args.num_layers
    window = (args.input_H // patch, args.input_W // patch)
    masking = None if args.MAE else args.masking
    imnet = args.data_set == "IMNET"
    if imnet:
        _, train_it, _, val_it = imnet_pipelines(args, local_bs, window, **data_shard(mesh))
    else:
        _, train_it = build_pipeline(args, "train", True, local_bs, masking=masking,
                                     window_size=window, seed=args.seed,
                                     num_workers=args.num_workers, **data_shard(mesh))
        _, val_it = build_pipeline(args, "val", False, local_bs, masking=masking,
                                   window_size=window, seed=args.seed,
                                   num_workers=args.num_workers, **data_shard(mesh))
    preproc_train = build_preproc(args, True, color_jitter=args.color_jitter)
    preproc_val = build_preproc(args, False)

    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    model = build_model(args, dtype, device)
    model.init_weights(torch.Generator().manual_seed(args.seed))
    if args.pretrained and args.init_ckpt:
        # the timm ViT warm start (run_mem_pretraining.py:194-222), from a
        # local file
        from mem_tpu_torch.utils.timm_init import load_timm_state_dict, warm_start_from_timm

        warm_start_from_timm(model, load_timm_state_dict(args.init_ckpt))
        print(f"warm-started encoder from {args.init_ckpt}")
    steps_per_epoch = train_it.steps_per_epoch()
    lr_sched = cosine_scheduler(args.lr, args.min_lr, args.epochs, steps_per_epoch,
                                warmup_epochs=args.warmup_epochs,
                                warmup_steps=args.warmup_steps,
                                start_warmup_value=args.warmup_lr)
    wd_end = args.weight_decay if args.weight_decay_end is None else args.weight_decay_end
    wd_sched = cosine_scheduler(args.weight_decay, wd_end, args.epochs, steps_per_epoch)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model params: {n_params / 1e6:.1f}M; steps/epoch {steps_per_epoch}; "
          f"device {device}")

    # --opt_betas is accepted and ignored: betas stay (0.9, 0.95), the
    # reference's override (optim_factory.py:121)
    optimizer = create_optimizer(model, args.lr, args.weight_decay, opt=args.opt,
                                 opt_eps=args.opt_eps, momentum=args.momentum,
                                 moment_dtype=torch.bfloat16 if args.bf16_moments else None)

    start_epoch = args.start_epoch
    ckpt = None
    if args.resume:
        ckpt = latest_checkpoint(args.resume) if os.path.isdir(args.resume) else args.resume
    elif args.auto_resume:
        ckpt = latest_checkpoint(args.output_dir)
    if ckpt:
        # every process restores the single-process payload, then places it
        # (run_mem_pretraining.py:470-472)
        payload = load_checkpoint(ckpt)
        model.load_state_dict(payload["model"], strict=True)
        if "optimizer" in payload:
            optimizer.load_state_dict(payload["optimizer"])
        start_epoch = int(payload["epoch"]) + 1
        print(f"Resumed from {ckpt} (epoch {start_epoch})")
    placement = place_train_state(model, optimizer, mesh, tp=args.tp, zero1=bool(args.zero1),
                                  fsdp=bool(args.fsdp))
    if mesh is not None:
        print(f"placement {placement.mode}: {world_size()} processes, "
              f"data {placement.data_size}, per-process batch {local_bs}")

    if args.MAE:
        vae = eval_step = None
        train_step = make_mae_train_step(model, optimizer, preproc_train, lr_sched, wd_sched,
                                         args.clip_grad, args.seed, placement=placement)
    else:
        vae = load_vae(args, device)
        train_step = make_pretrain_train_step(model, vae, optimizer, preproc_train, lr_sched,
                                              wd_sched, args.clip_grad, args.seed,
                                              placement=placement)
        eval_step = make_pretrain_eval_step(model, vae, preproc_val, placement=placement)
    dump = args.dump_recon_dir if not args.MAE and is_main() else None
    keys = ("loss", "grad_norm") if args.MAE else ("loss", "mlm_acc", "grad_norm")

    main_proc = is_main()
    run = maybe_wandb(bool(args.wandb) and main_proc, project="mem_pretraining",
                      group=f"{args.expweek}_{args.expname}")
    # the reference appends wandb_group to the TensorBoard directory
    tb = (TensorboardLogger(args.log_dir + args.wandb_group)
          if args.log_dir and main_proc else None)
    profiled = False
    history = []
    last_dump = -10**9   # the step of the last grad-norm-triggered recon dump
    for epoch in range(start_epoch, args.epochs):
        t0 = time.time()
        timer = StepTimer(args.batch_size)
        rate = None
        pending = []   # device metrics not yet read back
        stop = False

        def flush():
            ms = {k: torch.stack([m[k] for _, m in pending]).float().cpu().numpy()
                  for k in keys}
            for j, (it, _) in enumerate(pending):
                acc = float(ms["mlm_acc"][j]) if "mlm_acc" in ms else None
                history.append((it, float(ms["loss"][j]), acc, float(ms["grad_norm"][j])))
            bad = [it for it, loss, _, _ in history[-len(pending):] if not math.isfinite(loss)]
            for it, loss, _, gnorm in history[-len(pending):]:
                if (it - epoch * steps_per_epoch) % SINK_EVERY:
                    continue
                if run:
                    run.log({"train/loss": loss, "train/grad_norm": gnorm, "step": it})
                if tb:
                    tb.update(head="train", step=it, loss=loss)
            it, loss, acc, gnorm = history[-1]
            pending.clear()
            if bad:
                raise RuntimeError(f"non-finite loss at step {bad[0]}")
            acc_s = "" if acc is None else f" mlm_acc: {acc:.4f}"
            rate_s = "" if rate is None else f" samples/s: {rate:.1f}"
            print(f"Epoch: [{epoch}] [{it - epoch * steps_per_epoch}/{steps_per_epoch}] "
                  f"loss: {loss:.4f}{acc_s} grad_norm: {gnorm:.4f} "
                  f"lr: {at(lr_sched, it):.6e}{rate_s}", flush=True)
            return float(ms["grad_norm"].max())

        host = train_it.epoch(epoch)   # IMNET: the views need no draws
        batches = device_prefetch(
            prefetch(host if imnet else with_train_draws(host, preproc_train)), device)
        for i, batch in enumerate(batches):
            it = epoch * steps_per_epoch + i
            do_trace = bool(args.profile_dir) and not profiled and i == PROFILE_STEP
            if do_trace and device.type == "cuda":
                torch.cuda.synchronize(device)   # the trace holds this step alone
            with trace(args.profile_dir if do_trace else None):
                pending.append((it, train_step(batch, it)))
                if do_trace:
                    if device.type == "cuda":
                        torch.cuda.synchronize(device)
                    profiled = True
            rate = timer.step() or rate
            if len(pending) == LOG_EVERY or i == steps_per_epoch - 1:
                gnorm_max = flush()
                if dump and should_dump_on_grad_norm(
                        gnorm_max, it, last_dump, args.recon_grad_norm_thresh):
                    last_dump = it
                    _dump_recon_panel(args, vae, preproc_train, batch, f"trigger_it{it}")
            stop = any_process(stopper.requested)
            if stop:
                break
        if pending:
            flush()
        if stop:
            # SIGTERM: a resumable checkpoint that restarts this epoch, exit 0
            save_checkpoint(args.output_dir, epoch,
                            _checkpoint(model, optimizer, epoch - 1, placement))
            print(f"preempted at epoch {epoch}: checkpoint saved; exiting")
            return history
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        sps = steps_per_epoch * args.batch_size / (time.time() - t0)
        print(f"epoch {epoch}: {sps:.1f} samples/sec ({sps / world_size():.1f}/gpu)")

        if (epoch + 1) % args.save_ckpt_freq == 0 or epoch + 1 == args.epochs:
            save_checkpoint(args.output_dir, epoch,
                            _checkpoint(model, optimizer, epoch, placement))
            if eval_step is not None and not args.disable_eval_during_pretraining:
                losses, accs = [], []
                n_val = common_count(val_it.steps_per_epoch())
                for j, batch in enumerate(itertools.islice(val_it.epoch(0), n_val)):
                    batch = to_device(batch, device)
                    out = eval_step(batch)
                    if j == 0 and dump:
                        _dump_recon_panel(args, vae, preproc_val, batch, f"ep{epoch}")
                    losses.append(out["loss"])
                    accs.append(out["mlm_acc"])
                if losses:
                    print(f"* eval: loss {torch.stack(losses).mean().item():.4f} "
                          f"mlm_acc {torch.stack(accs).mean().item():.4f}")

        if epoch + 1 < args.epochs and rss_recycle_due(args.rss_restart_gb):
            save_checkpoint(args.output_dir, epoch,
                            _checkpoint(model, optimizer, epoch, placement))
            print(f"rss {rss_gb():.1f} GB > {args.rss_restart_gb} GB: recycling process "
                  f"(exit {RESTART_EXIT_CODE}); auto_resume continues at epoch {epoch + 1}",
                  flush=True)
            sys.exit(RESTART_EXIT_CODE)

    save_checkpoint(args.output_dir, "final",
                    _checkpoint(model, optimizer, args.epochs - 1, placement))
    if tb:
        tb.flush()
    return history


def cli() -> None:
    """The ``mem-tpu-torch-pretrain`` console script: ``main`` without its
    return value (a console script exits with what its function returns)."""
    main()


if __name__ == "__main__":
    cli()

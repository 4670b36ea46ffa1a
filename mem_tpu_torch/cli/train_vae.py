"""Discrete-VAE training (stage 1, the event tokenizer) on PyTorch, port of
mem_tpu/cli/train_vae.py: the same flags and aliases (so the ``vae_*`` keys
of configs/*.conf bind), plus ``--device``.

Each step (train/steps.py ``make_vae_train_step``) runs on the device: the
training preprocessing (kernel K1 and the augmentations) -> the VAE's
Gumbel-softmax forward (noise from a generator seeded by (seed, step)) ->
reconstruction loss + KL -> backward -> the clip -> plain Adam with the
lr of the anneal. The lr and the temperature change once per 10,000 steps
of an epoch, after the step (``VaeAnnealState``). The host loads, slices and
pads events, draws the augmentations, and copies each batch to the device
one step ahead. ``--steps_per_dispatch`` is accepted and the port steps one
at a time, as the other CLIs do.

Every ``--eval_freq`` epochs the val split is tokenized and decoded: the
reconstruction MSE and the codebook usage are printed, and with
``--dump_recon_dir`` the first ``--num_images_save`` pairs go to
``recon_ep{epoch}.png``. ``--wandb 1`` logs the loss and lr every 1,000
steps, and at each evaluation the test loss, the codebook usage and the
reconstruction panel as a ``wandb.Image`` (nothing when wandb is missing).
Checkpoints are ``output_dir/checkpoint-{epoch}.pth``
(``{"model": <reference VAE state_dict>, "optimizer", "epoch", "lr",
"temp", "global_step", "hparams"}``, the newest of them auto-resumed) and
``checkpoint-final.pth`` (``{"model", "epoch", "hparams"}``), which
``run_mem_pretraining --discrete_vae_weight_path`` loads as it is.

``--data_set IMNET`` trains the VAE on a JPEG class tree (data_path/{train,
val}) through the finetune stage's transform (build_transform_e2v): the host
crops, flips and resizes to ``--input_size`` and draws the augmentations,
the device runs the ``--aa`` RandAugment and ``--reprob`` RandomErasing
(data/device_pipeline.preprocess_image_cls). ``--input_H`` / ``--input_W``
become ``--input_size``, so the checkpoint's hparams match the images.

Usage:
  python -m mem_tpu_torch.cli.train_vae --config configs/ncaltech.conf \\
      --data_path datasets/ncaltech101 --output_dir vae_out [--device cuda]
"""
from __future__ import annotations

from mem_tpu_torch import _signals

_signals.latch()  # before torch loads: a setup-time SIGTERM must latch

import math
import os
import sys
import time

import torch

from mem_tpu_torch.cli.common import (add_compat_args, add_imnet_args, add_preprocessing_args,
                                      build_pipeline, build_preproc, imnet_aug, imnet_pipelines,
                                      resolve_device, validate_preproc_args, warn_compat_args)
from mem_tpu_torch.data.device_pipeline import with_image_draws, with_train_draws
from mem_tpu_torch.data.prefetch import device_prefetch, prefetch, to_device
from mem_tpu_torch.models.discrete_vae import DiscreteVAE
from mem_tpu_torch.train.schedules import VaeAnnealState
from mem_tpu_torch.train.steps import make_vae_eval_step, make_vae_train_step
from mem_tpu_torch.utils.checkpoint import (latest_numbered_checkpoint, load_checkpoint,
                                            save_checkpoint)
from mem_tpu_torch.utils.config import ConfigArgumentParser
from mem_tpu_torch.utils.metrics import maybe_wandb
from mem_tpu_torch.utils.preemption import (RESTART_EXIT_CODE, GracefulShutdown, rss_gb,
                                            validate_rss_flag)
from mem_tpu_torch.utils.visualize import reconstruction_panel, save_png

LOG_EVERY = 10   # steps between metric reads (the reference logs every 10)
SINK_EVERY = 1000  # steps between wandb points (train_vae.py:322)


def get_args(argv=None):
    p = ConfigArgumentParser("event VAE training (PyTorch)")
    p.add_argument("--expweek", type=str, default="")
    p.add_argument("--expname", type=str, default="")
    p.add_argument("--data_path", type=str, required=False, default="")
    p.add_argument("--eval_data_path", type=str, default=None,
                   help="separate root for the val split")
    p.add_argument("--data_set", type=str, default="npy")
    add_preprocessing_args(p)
    p.set_defaults(normalize_events=1)   # the reference VAE parser's default

    p.add_argument("--epochs", "--vae_epochs", type=int, default=300)
    p.add_argument("--start_epoch", type=int, default=0)
    p.add_argument("--batch_size", "--vae_batch_size", type=int, default=192)
    p.add_argument("--lr", "--vae_lr", "--learning_rate", dest="learning_rate",
                   type=float, default=2e-4)
    p.add_argument("--lr_decay_rate", "--vae_lr_decay", type=float, default=0.99)
    p.add_argument("--clip", "--vae_grad_clip", type=float, default=1e-3)
    p.add_argument("--starting_temp", type=float, default=1.0)
    p.add_argument("--temp_min", type=float, default=0.5)
    p.add_argument("--anneal_rate", type=float, default=1e-6)
    p.add_argument("--kl_loss_weight", "--vae_kl_loss_weight", type=float, default=1e-10)
    p.add_argument("--num_tokens", type=int, default=8192)
    p.add_argument("--voxel", type=int, default=0,
                   help="0 = the 3-channel event histogram; V = a V-channel time-binned "
                        "voxel grid (the pretraining stage must pass the same --voxel)")
    p.add_argument("--emb_dim", type=int, default=32)
    p.add_argument("--num_layers", type=int, default=4)
    p.add_argument("--hidden_dim", "--vae_hidden_dim", type=int, default=384)
    p.add_argument("--num_resnet_blocks", "--vae_num_resnet_blocks", type=int, default=3)
    p.add_argument("--loss", "--vae_loss", type=str, default="mse")
    p.add_argument("--straight_through", "--vae_straight_through", type=int, default=0)
    p.add_argument("--weights", type=str, default=None,
                   help="declared and never read by the reference; accepted")
    p.add_argument("--save_ckpt_freq", "--vae_save_ckpt_freq", type=int, default=25)
    p.add_argument("--steps_per_dispatch", type=int, default=8,
                   help="accepted; the port dispatches step by step (numerics unchanged)")
    p.add_argument("--output_dir", type=str, default="./vae_out")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--auto_resume", type=int, default=1)
    p.add_argument("--rss_restart_gb", type=float, default=0,
                   help="when host RSS exceeds this many GB at an epoch boundary, save "
                        "a resumable checkpoint and exit with code 3 (0 = off)")
    p.add_argument("--eval_freq", type=int, default=25)
    p.add_argument("--disable_eval", action="store_true", default=False)
    p.add_argument("--wandb", type=int, default=0,
                   help="log loss, test loss, codebook usage and reconstruction panels "
                        "to wandb (needs the package)")
    p.add_argument("--disable_wandb", action="store_true", default=False,
                   help="the reference's off-switch; forces --wandb 0")
    p.add_argument("--num_images_save", type=int, default=4,
                   help="reconstruction pairs saved at eval")
    p.add_argument("--dump_recon_dir", type=str, default=None,
                   help="save the eval reconstruction panels as PNGs here")
    p.add_argument("--color_jitter", type=float, default=0.0,
                   help="declared by the reference VAE parser; never applied")
    p.add_argument("--smoothing", type=float, default=0.1,
                   help="declared by the reference VAE parser; unused")
    p.add_argument("--dtype", type=str, default="bfloat16")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device: cuda (the kernels) or cpu (their plain versions)")
    add_imnet_args(p, "vae")
    compat = add_compat_args(p, ["--dist_eval", "--pin_mem"])
    args = p.parse_args(argv)
    warn_compat_args(args, compat)
    if args.disable_wandb:
        args.wandb = 0
    return args


def check_ported(args) -> None:
    """Raise for the data sets the port does not train on."""
    if args.data_set not in ("npy", "image_folder", "dsec_semseg", "IMNET"):
        raise NotImplementedError(f"data_set {args.data_set!r}")


def vae_hparams(args) -> dict:
    """The hparams the pretraining CLI's ``load_vae`` rebuilds the frozen
    tokenizer from (train_vae.py:122-134)."""
    return {"input_H": args.input_H, "input_W": args.input_W,
            "num_tokens": args.num_tokens, "emb_dim": args.emb_dim,
            "num_layers": args.num_layers, "num_resnet_blocks": args.num_resnet_blocks,
            "hidden_dim": args.hidden_dim, "loss": args.loss,
            "channels": 3 if args.voxel == 0 else args.voxel}


def build_vae(args, dtype, device) -> DiscreteVAE:
    return DiscreteVAE(input_hw=(args.input_H, args.input_W), num_tokens=args.num_tokens,
                       codebook_dim=args.emb_dim, num_layers=args.num_layers,
                       num_resnet_blocks=args.num_resnet_blocks, hidden_dim=args.hidden_dim,
                       channels=3 if args.voxel == 0 else args.voxel, loss_type=args.loss,
                       straight_through=bool(args.straight_through),
                       kl_div_loss_weight=args.kl_loss_weight, dtype=dtype, device=device)


def evaluate(args, eval_step, val_it, device, epoch: int, run=None) -> None:
    """The reconstruction MSE and codebook usage over the val split, and
    with ``--dump_recon_dir`` the first batch's panel; with ``run`` (wandb)
    both logged, the panel as an image (train_vae.py:340-350)."""
    used = torch.zeros(args.num_tokens, dtype=torch.bool, device=device)
    losses, first = [], None
    for batch in val_it.epoch(0):
        out = eval_step(to_device(batch, device))
        used[out["ids"].reshape(-1)] = True
        losses.append(out["loss"])
        if first is None:
            first = out
    if first is None:
        return
    loss, n_used = torch.stack(losses).mean().item(), int(used.sum())
    print(f"* eval loss {loss:.4f} codebook usage {n_used}/{args.num_tokens}", flush=True)
    if (run or args.dump_recon_dir) and args.num_images_save > 0:
        k = args.num_images_save
        panel = reconstruction_panel(first["images"][:k].float().cpu().numpy(),
                                     first["recon"][:k].float().cpu().numpy())
        if args.dump_recon_dir:
            os.makedirs(args.dump_recon_dir, exist_ok=True)
            save_png(os.path.join(args.dump_recon_dir, f"recon_ep{epoch}.png"), panel)
        if run and hasattr(run, "Image"):
            run.log({"reconstructions": run.Image(panel), "epoch": epoch})
    if run:
        run.log({"test_loss": loss, "codebook_usage": n_used / args.num_tokens,
                 "epoch": epoch})


def main(argv=None):
    """Train; returns the per-step history [(step, loss, grad_norm), ...]
    of this process."""
    args = get_args(argv)
    validate_preproc_args(args)
    check_ported(args)
    stopper = GracefulShutdown()
    validate_rss_flag(args.rss_restart_gb)
    device = resolve_device(args.device)
    os.makedirs(args.output_dir, exist_ok=True)
    image_draw = image_preproc = None
    if args.data_set == "IMNET":
        # the finetune stage's transform (train_vae.py:151-195); no
        # --rand_aug_batch_ops here, as in the reference
        _, train_it, _, val_it = imnet_pipelines(args, args.batch_size)
        image_preproc, image_draw = imnet_aug(args)
        # the VAE sees input_size^2 images: keep the checkpoint's hparams
        # coherent, and validate the extents again on the new values
        args.input_H = args.input_W = args.input_size
        validate_preproc_args(args, train=True)
    else:
        _, train_it = build_pipeline(args, "train", True, args.batch_size, seed=args.seed,
                                     num_workers=args.num_workers)
        _, val_it = build_pipeline(args, "val", False, args.batch_size, seed=args.seed,
                                   num_workers=args.num_workers)
    preproc_train, preproc_val = build_preproc(args, True), build_preproc(args, False)

    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    vae = build_vae(args, dtype, device)
    vae.init_weights(torch.Generator().manual_seed(args.seed))
    steps_per_epoch = train_it.steps_per_epoch()
    n_params = sum(p.numel() for p in vae.parameters())
    print(f"VAE params: {n_params / 1e6:.1f}M; steps/epoch {steps_per_epoch}; device {device}")

    optimizer = torch.optim.Adam(vae.parameters(), lr=args.learning_rate, betas=(0.9, 0.999),
                                 eps=1e-8)
    train_step = make_vae_train_step(vae, optimizer, preproc_train, args.clip, args.seed,
                                     image_preproc=image_preproc)
    eval_step = make_vae_eval_step(vae, preproc_val)
    sched = VaeAnnealState(args.learning_rate, args.lr_decay_rate, args.starting_temp,
                           args.anneal_rate, args.temp_min)

    def resumable(epoch: int) -> dict:
        return {"model": vae.state_dict(), "optimizer": optimizer.state_dict(),
                "epoch": epoch, "lr": sched.lr, "temp": sched.temp,
                "global_step": sched.global_step, "hparams": vae_hparams(args)}

    start_epoch = args.start_epoch
    ckpt = latest_numbered_checkpoint(args.output_dir) if args.auto_resume else None
    if ckpt:
        payload = load_checkpoint(ckpt)
        vae.load_state_dict(payload["model"], strict=True)
        optimizer.load_state_dict(payload["optimizer"])
        sched.lr, sched.temp = float(payload["lr"]), float(payload["temp"])
        sched.global_step = int(payload["global_step"])
        start_epoch = int(payload["epoch"]) + 1
        print(f"Auto-resumed from {ckpt} (epoch {start_epoch})")

    run = maybe_wandb(bool(args.wandb), project="dalle_train_vae",
                      group=f"{args.expweek}_{args.expname}")
    history = []
    for epoch in range(start_epoch, args.epochs):
        t0 = time.time()
        step0 = sched.global_step
        pending = []   # device metrics not yet read back

        def flush():
            ms = {k: torch.stack([m[k] for _, _, m in pending]).float().cpu().numpy()
                  for k in ("loss", "grad_norm")}
            for j, (it, lr, _) in enumerate(pending):
                history.append((it, float(ms["loss"][j]), float(ms["grad_norm"][j])))
                if run and (it - step0) % SINK_EVERY == 0:
                    run.log({"epoch": epoch, "iter": it - step0,
                             "loss": float(ms["loss"][j]), "lr": lr})
            it, lr, _ = pending[-1]
            pending.clear()
            _, loss, gnorm = history[-1]
            if not math.isfinite(loss):
                raise RuntimeError(f"non-finite loss at step {it}")
            print(f"Epoch: [{epoch}] [{i}/{steps_per_epoch}] loss: {loss:.4f} "
                  f"grad_norm: {gnorm:.4f} lr: {lr:.6e}", flush=True)

        host = train_it.epoch(epoch)
        batches = device_prefetch(
            prefetch(with_image_draws(host, **image_draw) if image_draw is not None
                     else with_train_draws(host, preproc_train)), device)
        for i, batch in enumerate(batches):
            it = sched.global_step
            pending.append((it, sched.lr, train_step(batch, it, sched.lr, sched.temp)))
            sched.after_step(i)
            if len(pending) == LOG_EVERY or i == steps_per_epoch - 1:
                flush()
            if stopper.requested:
                break
        if pending:
            flush()
        if stopper.requested:
            # SIGTERM: a resumable checkpoint that restarts this epoch, exit 0
            save_checkpoint(args.output_dir, epoch, resumable(epoch - 1))
            print(f"preempted at epoch {epoch}: checkpoint saved; exiting")
            return history
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        sps = steps_per_epoch * args.batch_size / (time.time() - t0)
        print(f"epoch {epoch}: {sps:.1f} samples/sec")

        if (epoch + 1) % args.eval_freq == 0 and not args.disable_eval:
            evaluate(args, eval_step, val_it, device, epoch, run)
        if (epoch + 1) % args.save_ckpt_freq == 0 or epoch + 1 == args.epochs:
            save_checkpoint(args.output_dir, epoch, resumable(epoch))
        if args.rss_restart_gb > 0 and epoch + 1 < args.epochs \
                and rss_gb() > args.rss_restart_gb:
            save_checkpoint(args.output_dir, epoch, resumable(epoch))
            print(f"rss {rss_gb():.1f} GB > {args.rss_restart_gb} GB: recycling process "
                  f"(exit {RESTART_EXIT_CODE}); auto_resume continues at epoch {epoch + 1}",
                  flush=True)
            sys.exit(RESTART_EXIT_CODE)

    save_checkpoint(args.output_dir, "final", {"model": vae.state_dict(),
                                               "epoch": args.epochs - 1,
                                               "hparams": vae_hparams(args)})
    return history


def cli() -> None:
    """The ``mem-tpu-torch-train-vae`` console script: ``main`` without its
    return value."""
    main()


if __name__ == "__main__":
    cli()

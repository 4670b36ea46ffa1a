"""DSEC semantic-segmentation training on PyTorch (downstream stage), port of
mem_tpu/cli/train_seg.py: the same flags and defaults, plus ``--device``.

Iteration-based training (default 160k iterations) of EvBEiT ViT-B/16 at
512^2 + UPerNet + the FCN auxiliary head: AdamW with layer decay 0.65 over
the backbone, the poly lr schedule (power 1.0) with a 1500-iteration linear
warm-up, BatchNorm over the whole batch, periodic mIoU evaluation and
checkpoints. Under ``torchrun --nproc_per_node N`` (NCCL, or Gloo with
``--device cpu``) the run is data parallel: ``--batch_size`` is the global
batch, each process reads its share, the BatchNorm statistics and the loss's
valid-pixel count are the global batch's (SyncBN), the confusion matrices
are summed over the processes and rank 0 writes the checkpoints. The backbone starts from a MEM pretraining
checkpoint through the surgery importer (``--pretrained x.pth``: a shared
14x14 rel-pos table becomes one 32x32 table per block).

Each step (train/steps.py) runs on the device: the train preprocessing on
the 440x640 canvas (kernel K4, the resize jitter, photometric RandAugment,
the flips) -> the segmentor (attention through kernels K3f / K3b at 1025
tokens) -> ``seg_loss`` -> AdamW. The host loads, crops, slices and presorts
the events, draws the augmentations, and copies each batch to the device one
step ahead. ``--steps_per_dispatch K`` (8 by default) runs up to K
iterations per host dispatch (train/chain.py); a chunk never crosses an eval
interval, a save interval or ``--max_iters`` (:func:`chunk_stream`), so the
hooks fire at the reference's iterations. On ``--device cpu`` the kernels'
plain versions run.

Checkpoints are ``output_dir/checkpoint-{it}.pth`` = ``{"model": <state_dict
in the export_seg_params keys>, "optimizer": ..., "epoch": it + 1}`` and
``checkpoint-final.pth`` (no optimizer); ``--auto_resume`` continues from the
highest numbered one at its iteration (the per-sample draws go on from
there; the shuffle starts over, as in the reference); ``test_seg
--checkpoint`` reads any of them.

Usage:
  python -m mem_tpu_torch.cli.train_seg --data_root datasets/dsec \\
      --pretrained pt_out/checkpoint-final.pth --output_dir seg_out [--device cuda]
"""
from __future__ import annotations

from mem_tpu_torch import _signals

_signals.latch()  # before torch loads: a setup-time SIGTERM must latch

import math
import os
import sys
import time

import numpy as np
import torch

from mem_tpu_torch.cli.common import data_shard
from mem_tpu_torch.data.prefetch import device_prefetch, prefetch, to_device
from mem_tpu_torch.data.seg_pipeline import (SegBatchIterator, SegPipelineConfig,
                                             draw_seg_train_aug, scan_seg_pairs,
                                             seg_preprocess_batch)
from mem_tpu_torch.models.segmentation import build_segmentor, seg_metrics
from mem_tpu_torch.parallel.mesh import (any_process, get_mesh, init_distributed, is_main,
                                         local_batch_size, place_train_state, world_size)
from mem_tpu_torch.train.chain import block_length, prefetch_args
from mem_tpu_torch.train.optim import create_optimizer
from mem_tpu_torch.train.schedules import poly_lr_schedule
from mem_tpu_torch.train.steps import make_seg_steps, sum_confusion
from mem_tpu_torch.utils.checkpoint import (latest_numbered_checkpoint, load_checkpoint,
                                            save_checkpoint)
from mem_tpu_torch.utils.config import ConfigArgumentParser
from mem_tpu_torch.utils.metrics import MetricLogger
from mem_tpu_torch.utils.preemption import (RESTART_EXIT_CODE, GracefulShutdown, rss_gb,
                                            rss_recycle_due, validate_rss_flag)

LOG_EVERY = 10      # iterations between metric reads (train_seg.py:405)
PRINT_EVERY = 50    # iterations between progress lines (train_seg.py:408)
SEG_BETAS = (0.9, 0.999)   # train_seg.py:297; pretraining keeps (0.9, 0.95)


def get_args(argv=None):
    p = ConfigArgumentParser("DSEC segmentation training (PyTorch)")
    p.add_argument("--data_root", type=str, default="")
    p.add_argument("--img_dir", type=str, default="imgs/train")
    p.add_argument("--ann_dir", type=str, default="anns/train")
    p.add_argument("--val_img_dir", type=str, default="imgs/val")
    p.add_argument("--val_ann_dir", type=str, default="anns/val")
    p.add_argument("--num_classes", type=int, default=11)
    p.add_argument("--pretrained", type=str, default="",
                   help="backbone init: a MEM pretraining / finetune .pth (or an "
                        "already backbone.-prefixed seg checkpoint)")
    p.add_argument("--model_key", type=str, default="state_dict|model|module",
                   help=".pth payload probe order "
                        "(mmcv_custom/checkpoint.py:335-343)")
    p.add_argument("--seg_input_size", type=int, default=512)
    p.add_argument("--embed_dim", type=int, default=768)
    p.add_argument("--depth", type=int, default=12)
    p.add_argument("--num_heads", type=int, default=12)
    p.add_argument("--drop_path", type=float, default=0.1)
    p.add_argument("--max_iters", type=int, default=160000)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--lr", type=float, default=5e-4)
    p.add_argument("--weight_decay", type=float, default=0.05)
    p.add_argument("--layer_decay", type=float, default=0.65)
    p.add_argument("--warmup_iters", type=int, default=1500)
    p.add_argument("--eval_interval", type=int, default=4000)
    p.add_argument("--steps_per_dispatch", type=int, default=8,
                   help="iterations per host dispatch (train/chain.py: one CUDA graph on "
                        "the card where the configuration allows); 1 = one at a time")
    p.add_argument("--save_interval", type=int, default=4000)
    p.add_argument("--rand_aug", type=int, default=1)
    p.add_argument("--rand_aug_batch_ops", type=int, default=1,
                   help="share the RandAugment op choice across the batch "
                        "per round (speed mode; marginal op distribution "
                        "unchanged). 0 = per-sample ops, reference semantics")
    p.add_argument("--slice_max_evs", type=int, default=180000)
    p.add_argument("--ratio_jitter", type=int, default=1,
                   help="mmseg Resize ratio_range (1.0, 1.01) + RandomCrop "
                        "back to 440x640 (dsec.py:13); 0 disables")
    p.add_argument("--presort_y", type=int, default=1,
                   help="host-presort events by y (feeds the row-band "
                        "wide-canvas histogram without its device sort)")
    p.add_argument("--compact_wire", type=int, default=1,
                   help="ship events as int16 [x, y, p] (t is unused by the "
                        "seg raster). 0 = full f32 (N, 4) wire format")
    p.add_argument("--dump_samples_dir", type=str, default=None,
                   help="dump the first --dump_samples_n preprocessed "
                        "(image | colorized annotation) panels before "
                        "training (the reference pipeline's SaveToDisk "
                        "debug op, EventDataset.py:682-708)")
    p.add_argument("--dump_samples_n", type=int, default=16)
    p.add_argument("--output_dir", type=str, default="./seg_out")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--auto_resume", type=int, default=1)
    p.add_argument("--rss_restart_gb", type=float, default=0,
                   help="memory-recycle watchdog: when host RSS exceeds this "
                        "many GB at a save_interval boundary, save a "
                        "resumable checkpoint and exit with code 3 so a "
                        "wrapper relaunches (0 = off)")
    p.add_argument("--dtype", type=str, default="bfloat16")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the model and preprocessing: cuda "
                        "(the kernels) or cpu (their plain versions)")
    return p.parse_args(argv)


def load_pretrained_backbone(model, path: str, model_key: str, seg_input_size: int) -> None:
    """Initialise ``model.backbone`` from a ``.pth`` or a timm jax-ViT
    ``.npz`` (train_seg.py:242-286): probe a ``.pth`` payload for
    ``model_key`` and strip ``module.`` / ``backbone.`` prefixes, read an
    ``.npz`` with ``load_timm_npz``, and run the surgery onto the backbone's
    own state_dict (names it lacks are dropped)."""
    from mem_tpu_torch.utils.surgery import surgery_for_finetune
    from mem_tpu_torch.utils.weights import load_timm_npz, normalize_backbone_state_dict

    if path.endswith(".npz"):
        # a timm jax-ViT checkpoint: only the names the backbone has transfer
        print(f"loading timm npz checkpoint from {path}")
        sd = load_timm_npz(path)
    elif path.endswith((".pth", ".pt")):
        ck = load_checkpoint(path)
        keys = [k for k in model_key.split("|") if k in ck]
        sd = normalize_backbone_state_dict(ck[keys[0]] if keys else ck)
    else:
        raise ValueError(
            f"--pretrained {path}: only .pth / .pt checkpoints and timm .npz files are "
            f"read; an orbax checkpoint directory needs jax -- convert it with `python -m "
            f"mem_tpu.cli.export_torch --checkpoint {path} --output model.pth`")
    grid = seg_input_size // 16
    template = {k: v.cpu().numpy() for k, v in model.backbone.state_dict().items()}
    merged = surgery_for_finetune(sd, template, (grid, grid))
    model.backbone.load_state_dict({k: torch.from_numpy(v) for k, v in merged.items()},
                                   strict=True)
    print(f"backbone initialized from {path}")


def _with_draws(it, rand_aug: bool, rand_aug_batch_ops: bool):
    """Add the host RandAugment draws to each training batch."""
    for batch in it:
        if rand_aug:
            batch.update(draw_seg_train_aug(batch["aug_seed"], rand_aug_batch_ops))
        yield batch


def chunk_stream(batches, start_iter: int, max_iters: int, K: int, eval_interval: int,
                 save_interval: int):
    """The host batches as (k, ...) blocks of up to K iterations (single
    batches at K = 1) that never cross an eval interval, a save interval or
    ``max_iters``, so every hook fires at the reference's iterations
    (train_seg.py:355-375)."""
    it = start_iter
    while it < max_iters:
        nb = min((it // eval_interval + 1) * eval_interval,
                 (it // save_interval + 1) * save_interval, max_iters)
        k = min(K, nb - it)
        bl = [next(batches) for _ in range(k)]
        yield bl[0] if K == 1 else {key: np.stack([b[key] for b in bl]) for key in bl[0]}
        it += k


def _checkpoint(model, optimizer, next_iter: int, placement) -> dict:
    """The single-process payload (every process calls)."""
    payload = {"model": placement.model_state_dict(model), "epoch": next_iter}
    if optimizer is not None:
        payload["optimizer"] = placement.optimizer_state_dict(optimizer)
    return payload


def main(argv=None):
    """Train; returns the history [(iteration, loss, grad_norm), ...] of the
    iterations this process read back (every LOG_EVERY-th)."""
    args = get_args(argv)
    if args.pretrained == "PT21k":
        # fail fast, before any data/device work
        raise SystemExit(
            "--pretrained PT21k downloads from the timm hub "
            "(train_api.py:377-402); no network egress here -- pass a "
            "local .npz of the 21k weights instead")
    stopper = GracefulShutdown()
    validate_rss_flag(args.rss_restart_gb)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available "
                           "(pass --device cpu to train on the CPU)")
    device = init_distributed(device)
    mesh = get_mesh()
    local_bs = local_batch_size(args.batch_size, mesh)
    os.makedirs(args.output_dir, exist_ok=True)
    rand_aug, batch_ops = bool(args.rand_aug), bool(args.rand_aug_batch_ops)
    y_sorted = bool(args.presort_y)

    def pipeline(img_dir, ann_dir, is_train):
        return SegBatchIterator(
            scan_seg_pairs(args.data_root, img_dir, ann_dir),
            SegPipelineConfig(
                batch_size=local_bs, is_train=is_train, max_evs=args.slice_max_evs,
                seed=args.seed, num_workers=args.num_workers,
                **data_shard(mesh),
                compact_wire=bool(args.compact_wire), presort_y=y_sorted,
                ratio_range=(1.0, 1.01) if (is_train and args.ratio_jitter) else None))

    train_it = pipeline(args.img_dir, args.ann_dir, True)
    val_it = pipeline(args.val_img_dir, args.val_ann_dir, False)

    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    model = build_segmentor(args.num_classes, args.seg_input_size, args.embed_dim, args.depth,
                            args.num_heads, dtype, device, drop_path_rate=args.drop_path)
    model.init_weights(torch.Generator().manual_seed(args.seed))
    if args.pretrained:
        load_pretrained_backbone(model, args.pretrained, args.model_key, args.seg_input_size)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"segmentor params: {n_params / 1e6:.1f}M")

    lr_fn = poly_lr_schedule(args.lr, args.max_iters, warmup_iters=args.warmup_iters)
    optimizer = create_optimizer(model, args.lr, args.weight_decay,
                                 layer_decay=args.layer_decay, num_layers=args.depth,
                                 betas=SEG_BETAS, opt_eps=1e-8)

    start_iter = 0
    if args.auto_resume:
        ckpt = latest_numbered_checkpoint(args.output_dir)
        if ckpt:
            payload = load_checkpoint(ckpt)
            model.load_state_dict(payload["model"], strict=True)
            optimizer.load_state_dict(payload["optimizer"])
            start_iter = int(payload["epoch"])
            print(f"Auto-resumed from {ckpt} (iter {start_iter})")
    # every process restored the single-process payload; now place it (DP,
    # with the BatchNorms over the global batch)
    placement = place_train_state(model, optimizer, mesh)
    K = max(1, args.steps_per_dispatch)
    train_step, eval_step = make_seg_steps(
        model, optimizer, lr_fn, args.weight_decay, args.num_classes, rand_aug, batch_ops,
        y_sorted=y_sorted, seed=args.seed + 7, placement=placement, chain=K > 1)
    if K > 1:
        print(train_step.describe(K), flush=True)

    def evaluate():
        cm = np.zeros((args.num_classes, args.num_classes))
        for b in val_it.eval_batches():
            n_real = int(b.pop("n_real"))
            out = eval_step(to_device(b, device))
            # drop padded duplicates' contribution approximately by scaling
            cm += out.cpu().numpy() * (n_real / b["label"].shape[0])
        return seg_metrics(sum_confusion(cm))

    if args.dump_samples_dir and start_iter == 0 and is_main():
        from mem_tpu_torch.utils.visualize import dump_sample_panels

        idx = 0
        for b in _with_draws(train_it.batches(), rand_aug, batch_ops):
            with torch.no_grad():
                di, dl = seg_preprocess_batch(to_device(b, device), True, rand_aug, batch_ops,
                                              y_sorted=y_sorted)
            take = min(args.dump_samples_n - idx, int(di.shape[0]))
            idx = dump_sample_panels(args.dump_samples_dir, di.cpu().numpy()[:take],
                                     labels=dl.cpu().numpy()[:take], start=idx)
            if idx >= args.dump_samples_n:
                break
        print(f"dumped {idx} sample panels to {args.dump_samples_dir}")

    logger = MetricLogger()
    history = []
    t0 = time.time()
    last_print = start_iter
    # --steps_per_dispatch K: (k, ...) blocks of iterations, one call of the
    # chain each (train/chain.py)
    host = prefetch(chunk_stream(
        prefetch(_with_draws(train_it.batches(start_iter), rand_aug, batch_ops)), start_iter,
        args.max_iters, K, args.eval_interval, args.save_interval))
    it0 = start_iter
    for i, batch in enumerate(device_prefetch(host, device, **prefetch_args(train_step))):
        if any_process(stopper.requested):
            # SIGTERM: a resumable checkpoint that continues at this iteration
            save_checkpoint(args.output_dir, it0, _checkpoint(model, optimizer, it0, placement))
            print(f"preempted at iter {it0}: checkpoint saved; exiting")
            return history
        k = block_length(batch) if K > 1 else 1
        m = train_step(batch, it0)
        it = it0 + k - 1   # the chunk's last iteration
        it0 += k
        # read metrics back only periodically (every max(1, LOG_EVERY // K)
        # chunks): a read waits for the device
        if i % max(1, LOG_EVERY // K) == 0:
            losses = m["loss"].reshape(-1).float().cpu().numpy()
            gnorms = m["grad_norm"].reshape(-1).float().cpu().numpy()
            bad = [it - k + 1 + j for j in range(k) if not math.isfinite(losses[j])]
            if bad:
                raise RuntimeError(f"non-finite loss at iter {bad[0]}")
            for j in range(k):   # the one-at-a-time run's records
                if (it - k + 1 + j - start_iter) % LOG_EVERY == 0:
                    logger.update(loss=float(losses[j]))
                    history.append((it - k + 1 + j, float(losses[j]), float(gnorms[j])))
        if it + 1 - last_print >= PRINT_EVERY:
            ips = args.batch_size * (it + 1 - last_print) / max(time.time() - t0, 1e-9)
            print(f"iter {it}/{args.max_iters} loss {logger.meters['loss'].avg:.4f} "
                  f"{ips:.1f} img/s ({ips / world_size():.1f}/gpu)", flush=True)
            t0 = time.time()
            last_print = it + 1
        if (it + 1) % args.eval_interval == 0:
            stats = evaluate()
            print(f"* iter {it}: mIoU {stats['mIoU']:.4f} aAcc {stats['aAcc']:.4f} "
                  f"mDice {stats['mDice']:.4f}")
        if (it + 1) % args.save_interval == 0:
            save_checkpoint(args.output_dir, it, _checkpoint(model, optimizer, it + 1, placement))
            if it + 1 < args.max_iters and rss_recycle_due(args.rss_restart_gb):
                print(f"rss {rss_gb():.1f} GB > {args.rss_restart_gb} GB: "
                      f"recycling process (exit {RESTART_EXIT_CODE}); "
                      f"auto_resume continues at iter {it + 1}", flush=True)
                sys.exit(RESTART_EXIT_CODE)

    stats = evaluate()
    print(f"final mIoU {stats['mIoU']:.4f}")
    save_checkpoint(args.output_dir, "final", _checkpoint(model, None, args.max_iters, placement))
    return history


def cli() -> None:
    """The ``mem-tpu-torch-train-seg`` console script: ``main`` without its
    return value (a console script exits with what its function returns)."""
    main()


if __name__ == "__main__":
    cli()

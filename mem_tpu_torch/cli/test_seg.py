"""Segmentation evaluation CLI (reference: semantic_segmentation/tools/test.py).

Port of mem_tpu/cli/test_seg.py: the same flags plus ``--device``. Loads a
segmentor ``.pth`` checkpoint (``{"model": state_dict}`` in the keys of
``utils.weights.seg_from_jax_params``), runs whole-image inference over the
validation split, and reports mIoU / mDice / mFscore / aAcc with a
per-class table. Optional multi-scale / flip test-time augmentation
(``--aug_test``), prediction dumps as PNGs (``--save_dir``) and, with
``--int8 1``, the backbone's fc1 / qkv / proj as W8A8 products
(``models.vit.INT8_GEMM`` for the run, as the reference sets it).

The events are rasterised on the device (kernel K4 on the 440x640 canvas)
and the backbone's 1025-token attention runs through kernel K3f; on
``--device cpu`` both take their plain versions. Under ``torchrun
--nproc_per_node N`` each process evaluates its share of the split and the
confusion matrices are summed over the processes; rank 0 prints the table
(``--save_dir`` takes each process's predictions, numbered by process).

Usage:
  python -m mem_tpu_torch.cli.test_seg --data_root datasets/dsec \
      --checkpoint seg.pth [--aug_test 1] [--save_dir preds] [--device cuda]
"""
from __future__ import annotations

import os

import numpy as np
import torch

from mem_tpu_torch.data.seg_pipeline import (
    IGNORE_INDEX,
    SegBatchIterator,
    SegPipelineConfig,
    scan_seg_pairs,
    seg_preprocess_batch,
)
from mem_tpu_torch.models import vit
from mem_tpu_torch.models.segmentation import (build_segmentor, confusion_matrix,
                                               seg_metrics, tta_probs)
from mem_tpu_torch.parallel.mesh import init_distributed, is_main, rank, world_size
from mem_tpu_torch.train.steps import sum_confusion
from mem_tpu_torch.utils.checkpoint import latest_checkpoint, load_checkpoint
from mem_tpu_torch.utils.config import ConfigArgumentParser

# batch entries the eval forward reads; the rest stay on the host
_DEVICE_KEYS = ("events_xyp", "n_valid", "label")


def get_args(argv=None):
    p = ConfigArgumentParser("DSEC segmentation evaluation (PyTorch)")
    p.add_argument("--data_root", type=str, required=True)
    p.add_argument("--img_dir", type=str, default="imgs/val")
    p.add_argument("--ann_dir", type=str, default="anns/val")
    p.add_argument("--checkpoint", type=str, required=True,
                   help=".pth checkpoint ({'model': state_dict}) or a directory "
                        "(evaluates its newest .pth)")
    p.add_argument("--num_classes", type=int, default=11)
    p.add_argument("--classes", type=str, default=None,
                   help="label names file, one per line")
    p.add_argument("--seg_input_size", type=int, default=512)
    p.add_argument("--embed_dim", type=int, default=768)
    p.add_argument("--depth", type=int, default=12)
    p.add_argument("--num_heads", type=int, default=12)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--slice_max_evs", type=int, default=180000)
    p.add_argument("--save_dir", type=str, default=None)
    p.add_argument("--dtype", type=str, default="bfloat16")
    p.add_argument("--aug_test", type=int, default=0,
                   help="multi-scale/flip test-time augmentation "
                        "(MyMultiScaleFlipAug, EventDataset.py:1050-1141); "
                        "averages softmax probabilities over all "
                        "scale x flip combinations")
    p.add_argument("--aug_scales", type=str, default="0.75,1.0,1.25",
                   help="comma-separated scale ratios for --aug_test")
    p.add_argument("--aug_flip", type=int, default=1,
                   help="include horizontally flipped passes in --aug_test")
    p.add_argument("--int8", type=int, default=0,
                   help="W8A8 int8 products (fc1, qkv, proj) in the backbone forward "
                        "(ops/quant.py)")
    p.add_argument("--presort_y", type=int, default=1,
                   help="host-presort events by y for the row-band "
                        "wide-canvas histogram")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the model and preprocessing: cuda "
                        "(the kernels) or cpu (their plain versions)")
    return p.parse_args(argv)


def to_device(batch: dict, device) -> dict:
    """The batch entries the eval forward reads, as tensors on ``device``."""
    return {n: torch.from_numpy(batch[n]).to(device, non_blocking=True)
            for n in _DEVICE_KEYS}


def segment(model, batch: dict, num_classes: int, scales, flips, y_sorted: bool):
    """The evaluated forward on a device batch: eval preprocessing, the
    (test-time augmented) model, argmax -> (pred (B, 440, 640) int64, the
    labels as the batch carries them)."""
    images, labels = seg_preprocess_batch(batch, False, y_sorted=y_sorted)
    prob_sum = tta_probs(lambda x: model(x)[0], images, num_classes, scales, flips)
    return prob_sum.argmax(dim=-1), labels


def main(argv=None):
    """Evaluate; prints the per-class table and the summary line and
    returns the ``seg_metrics`` dictionary."""
    args = get_args(argv)
    with vit.int8_gemm(bool(args.int8)):
        return _evaluate(args)


def _evaluate(args):
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available "
                           "(pass --device cpu to evaluate on the CPU)")
    device = init_distributed(device)

    pairs = scan_seg_pairs(args.data_root, args.img_dir, args.ann_dir)
    it = SegBatchIterator(pairs, SegPipelineConfig(
        batch_size=args.batch_size, is_train=False, max_evs=args.slice_max_evs,
        presort_y=bool(args.presort_y), shard_id=rank(), num_shards=world_size(),
    ))

    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    model = build_segmentor(args.num_classes, args.seg_input_size, args.embed_dim,
                            args.depth, args.num_heads, dtype, device)
    path = latest_checkpoint(args.checkpoint) or args.checkpoint
    model.load_state_dict(load_checkpoint(path)["model"], strict=True)
    model.eval()

    scales = [float(s) for s in args.aug_scales.split(",")] if args.aug_test else [1.0]
    flips = [False, True] if (args.aug_test and args.aug_flip) else [False]

    cm = np.zeros((args.num_classes, args.num_classes))
    sample_i = 0
    for b in it.eval_batches():
        n_real = int(b.pop("n_real"))
        with torch.inference_mode():
            pred, labels = segment(model, to_device(b, device), args.num_classes, scales,
                                   flips, bool(args.presort_y))
            c = confusion_matrix(pred, labels, args.num_classes, IGNORE_INDEX)
        cm += c.cpu().numpy() * (n_real / b["label"].shape[0])
        if args.save_dir:
            from PIL import Image

            os.makedirs(args.save_dir, exist_ok=True)
            tag = f"r{rank()}_" if world_size() > 1 else ""
            for p in pred.cpu().numpy()[:n_real]:
                Image.fromarray(p.astype(np.uint8)).save(
                    os.path.join(args.save_dir, f"{tag}{sample_i:06d}.png"))
                sample_i += 1

    stats = seg_metrics(sum_confusion(cm))
    if not is_main():
        return stats
    names = None
    if args.classes and os.path.exists(args.classes):
        with open(args.classes) as f:
            names = [ln.strip() for ln in f if ln.strip()]
    print(f"{'class':<20s} {'IoU':>8s} {'Acc':>8s}")
    for i in range(args.num_classes):
        nm = names[i] if names and i < len(names) else str(i)
        print(f"{nm:<20s} {stats['IoU'][i]*100:8.2f} {stats['Acc'][i]*100:8.2f}")
    print(f"mIoU {stats['mIoU']*100:.2f}  mDice {stats['mDice']*100:.2f}  "
          f"mFscore {stats['mFscore']*100:.2f}  aAcc {stats['aAcc']*100:.2f}")
    return stats


def cli() -> None:
    """The ``mem-tpu-torch-test-seg`` console script: ``main`` without its
    return value (a console script exits with what its function returns)."""
    main()


if __name__ == "__main__":
    cli()

"""Shared CLI plumbing: dataset detection, preprocessing config assembly,
host pipeline construction, config validation and the shared flag blocks.

Port of mem_tpu/cli/common.py with the same flag names and defaults, so
.conf files and launch commands carry over unchanged.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import torch

from mem_tpu_torch.data.device_pipeline import PreprocConfig
from mem_tpu_torch.data.folder import NpyFolder, loader_for_path, resolve_split_root
from mem_tpu_torch.data.pipeline import EventBatchIterator, PipelineConfig


def resolve_device(name: str) -> torch.device:
    """The training CLIs' ``--device``: cuda needs a card, and no CLI goes on
    on the CPU without being told to."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available "
                           "(pass --device cpu to train on the CPU)")
    return device


def detect_dataset(data_path: str) -> str:
    """Substring dispatch, mirroring mem/datasets.py:159-168, 640."""
    p = data_path.lower()
    if "caltech" in p:
        return "ncaltech101"
    if "ncars" in p or "n-cars" in p:
        return "ncars"
    if "imagenet" in p:
        return "nimagenet"
    if "dsec" in p or "ss_final" in p:
        return "dsec"
    return "ncaltech101"


def _exact_scale_plan(num: int, den: int,
                      extent: int) -> Optional[Tuple[int, int, int]]:
    """(num, den, extent) of the compact wire's exact rescale, or None when
    the raw coordinate range is too large to table (common.py:30-53)."""
    num, den, extent = int(num), int(den), int(extent)
    if extent > 1024:
        return None
    return num, den, extent


def build_preproc(args, is_train: bool, color_jitter: float = 0.0) -> PreprocConfig:
    # the val split's quirks follow --eval_data_path when that override is set
    src = args.data_path
    if not is_train and getattr(args, "eval_data_path", None):
        src = args.eval_data_path
    ds = detect_dataset(src)
    scale_rat = None
    if ds == "dsec":
        canvas = (440, 640)
        resize, crop = True, False
    elif ds == "nimagenet":
        if is_train:
            # ReshapeScaleXandY train: short-side-256 scale of 480x640
            canvas = (256, 342)
            scale_rat = (_exact_scale_plan(256, 480, 640),
                         _exact_scale_plan(256, 480, 480))
        else:
            canvas = (args.input_H, args.input_W)
            scale_rat = (_exact_scale_plan(args.input_W, 640, 640),
                         _exact_scale_plan(args.input_H, 480, 480))
        if None in scale_rat:
            scale_rat = None
        resize, crop = False, is_train
    elif ds == "ncars":
        # N-Cars recordings are ~100x120 crops: a 128^2 canvas
        canvas = (128, 128)
        resize, crop = True, False
    else:  # ncaltech101: variable extents, ATIS coords < 256
        canvas = (256, 256)
        resize, crop = True, False
    return PreprocConfig(
        input_h=args.input_H,
        input_w=args.input_W,
        canvas_h=canvas[0],
        canvas_w=canvas[1],
        resize_to_input=resize,
        random_crop=crop,
        timesurface=bool(args.timesurface),
        hotpixfilter=bool(args.hotpixfilter),
        hotpix_num_stds=float(args.hotpix_num_stds),
        logtrafo=bool(args.logtrafo),
        gammatrafo=bool(args.gammatrafo),
        gamma=float(args.gamma),
        normalize_events=bool(args.normalize_events),
        rand_aug=bool(args.rand_aug) and is_train,
        rand_aug_batch_ops=bool(getattr(args, "rand_aug_batch_ops", 0)),
        color_jitter=color_jitter if is_train else 0.0,
        scale_xy_rational=scale_rat,
        voxel=int(getattr(args, "voxel", 0)),
    )


def build_pipeline(args, split: str, is_train: bool, batch_size: int,
                   masking: Optional[str] = None, window_size: Tuple[int, int] = (14, 14),
                   seed: int = 0,
                   num_workers: int = 4) -> Tuple[NpyFolder, EventBatchIterator]:
    """The split's folder and host batch iterator with the dataset's quirks
    (common.py:110-205): canvas, fixed extents and coordinate scale, and the
    compact int16 wire whenever the timestamp column is dead."""
    src = args.data_path
    if split != "train" and getattr(args, "eval_data_path", None):
        src = args.eval_data_path
    ds = detect_dataset(src)
    if getattr(args, "data_set", "npy") == "image_folder":
        root = src
    else:
        root = resolve_split_root(src, split)
        if src != args.data_path and not os.path.isdir(root):
            root = src
    folder = NpyFolder(root, loader=loader_for_path(src))

    scale_xy = None
    fixed_hw = None
    sample_hw_from_data = True
    can_defer_scale = True   # raw int16 wire + on-device scale
    canvas = (128, 128) if ds == "ncars" else (256, 256)
    if ds == "nimagenet":
        sample_hw_from_data = False
        if is_train:
            s = 256.0 / 480.0
            scale_xy = (s, s)
            fixed_hw = (256, 342)
            canvas = (256, 342)
            can_defer_scale = (_exact_scale_plan(256, 480, 640) is not None
                               and _exact_scale_plan(256, 480, 480) is not None)
        else:
            scale_xy = (args.input_W / 640.0, args.input_H / 480.0)
            fixed_hw = (args.input_H, args.input_W)
            canvas = (args.input_H, args.input_W)
            can_defer_scale = (_exact_scale_plan(args.input_W, 640, 640) is not None
                               and _exact_scale_plan(args.input_H, 480, 480) is not None)
    elif ds == "dsec":
        sample_hw_from_data = False
        fixed_hw = (440, 640)
        canvas = (440, 640)

    cfg = PipelineConfig(
        batch_size=batch_size,
        slice_max_evs=args.slice_max_evs,
        is_train=is_train,
        max_random_shift_evs=args.max_random_shift_evs if is_train else 0,
        sample_hw_from_data=sample_hw_from_data,
        canvas_h=canvas[0],
        canvas_w=canvas[1],
        fixed_hw=fixed_hw,
        scale_xy=scale_xy,
        masking=masking,
        window_size=window_size,
        num_mask_patches=getattr(args, "num_mask_patches", 98),
        mask_pool_size=getattr(args, "mask_pool_size", 0),
        min_mask_patches_per_block=getattr(args, "min_mask_patches_per_block", 16),
        max_mask_patches_per_block=getattr(args, "max_mask_patches_per_block", None),
        seed=seed,
        shuffle=is_train,
        drop_last=is_train,
        num_workers=num_workers,
        compact_wire=(
            bool(getattr(args, "compact_wire", 1))
            and not bool(getattr(args, "timesurface", 0))
            and not int(getattr(args, "voxel", 0))  # time bins need t
            and (scale_xy is None or can_defer_scale)
        ),
        profile=bool(getattr(args, "loader_profile", 0)),
    )
    return folder, EventBatchIterator(folder, cfg)


def validate_preproc_args(args, train: bool = True) -> None:
    """The reference's config validation (common.py:208-252): input extents,
    {0,1} flags, the log/gamma exclusion, voxel rules, hot-pixel/gamma
    bounds and the shift-vs-resolution cap (train only)."""
    def chk(cond, msg):
        if not cond:
            raise SystemExit(f"config error: {msg}")

    chk(10 < args.input_H < 1000, f"input_H {args.input_H} not in (10, 1000)")
    chk(10 < args.input_W < 1000, f"input_W {args.input_W} not in (10, 1000)")
    for f in ("timesurface", "logtrafo", "gammatrafo", "hotpixfilter"):
        v = getattr(args, f)
        chk(v in (0, 1), f"{f} must be 0 or 1, got {v}")
    chk(not (args.logtrafo and args.gammatrafo),
        "logtrafo and gammatrafo are mutually exclusive")
    voxel = int(getattr(args, "voxel", 0))
    chk(voxel == 0 or (voxel >= 2 and voxel % 2 == 0 and voxel <= 32),
        f"voxel must be 0 (3-channel histogram) or an even channel count in [2, 32], "
        f"got {voxel}")
    if voxel:
        chk(not args.timesurface, "voxel > 0 has no time-surface channel (drop --timesurface)")
        chk(not getattr(args, "rand_aug", 0) or not train,
            "voxel > 0 is incompatible with --rand_aug (RGB-defined); pass --rand_aug 0")
        chk(float(getattr(args, "color_jitter", 0.0)) == 0.0,
            "voxel > 0 is incompatible with --color_jitter (RGB-defined); pass --color_jitter 0")
    chk(0 < args.hotpix_num_stds < 30, f"hotpix_num_stds {args.hotpix_num_stds} not in (0, 30)")
    chk(0 < args.gamma < 5, f"gamma {args.gamma} not in (0, 5)")
    s = args.max_random_shift_evs
    chk(0 <= s < 200, f"max_random_shift_evs {s} not in [0, 200)")
    if train:
        chk(s / args.input_H < 0.15 and s / args.input_W < 0.15,
            f"max_random_shift_evs {s} exceeds 15% of the input extent "
            f"({args.input_H}x{args.input_W})")


# reference flags the port accepts and ignores (common.py:293-317): name ->
# (add_argument kwargs, why it has no effect)
_COMPAT_CATALOG = {
    "--world_size": (dict(type=int, default=1), "the port runs on one device"),
    "--local_rank": (dict(type=int, default=-1), "the port runs on one device"),
    "--dist_on_itp": (dict(action="store_true"), "the port runs on one device"),
    "--dist_url": (dict(type=str, default="env://"), "the port runs on one device"),
    "--dist_eval": (dict(action="store_true"), "the port runs on one device"),
    "--pin_mem": (dict(action="store_true", default=True),
                  "batches always go through pinned memory (data/prefetch.py)"),
    "--no_pin_mem": (dict(action="store_false", dest="pin_mem"),
                     "batches always go through pinned memory (data/prefetch.py)"),
    "--gpu": (dict(type=int, default=0), "the port runs on one device"),
    "--enable_deepspeed": (dict(action="store_true"), "DeepSpeed is not used"),
    "--model_ema_force_cpu": (dict(action="store_true"),
                              "the EMA weights live on the model's device"),
}


def add_compat_args(parser, names) -> list:
    """Declare reference flags the port accepts without effect, so
    reference launch commands and .conf files run; returns the list for
    :func:`warn_compat_args`."""
    out = []
    for name in names:
        kwargs, reason = _COMPAT_CATALOG[name]
        action = parser.add_argument(name, **kwargs,
                                     help="accepted for reference compatibility; no effect")
        out.append((action.dest, action.default, name, reason))
    return out


def warn_compat_args(args, compat_list) -> None:
    seen = set()
    for dest, default, name, reason in compat_list:
        if dest not in seen and getattr(args, dest, default) != default:
            print(f"note: {name} has no effect in the port ({reason})")
        seen.add(dest)


def add_imnet_args(parser, stage: str = "pretrain") -> None:
    """The ``--data_set IMNET`` knobs of the pretraining, the finetune or
    the VAE CLI (``stage`` "pretrain", "finetune" or "vae"; common.py:348-392),
    declared so .conf files bind; the IMNET path itself raises."""
    a = parser.add_argument
    a("--input_size", type=int, default=224)
    a("--imagenet_default_mean_and_std", action="store_true", default=False)
    a("--resize", action="store_true", default=False)
    if stage == "pretrain":
        a("--train_interpolation", type=str, default="bicubic")
        a("--second_interpolation", type=str, default="lanczos")
        a("--input_H2", type=int, default=128)
        a("--input_W2", type=int, default=128)
    else:
        a("--train_interpolation", "--train-interpolation", type=str, default="bicubic")
        a("--aa", type=str, default="rand-m9-mstd0.5-inc1")
        a("--reprob", type=float, default=0.25)
        a("--remode", type=str, default="pixel")
        a("--recount", type=int, default=1)
        a("--resplit", action="store_true", default=False)
    if stage == "finetune":
        a("--crop_pct", type=float, default=None)


def add_preprocessing_args(parser) -> None:
    """The shared preprocessing flag block (run_mem_pretraining.py:48-57)."""
    parser.add_argument("--timesurface", type=int, default=0)
    parser.add_argument("--hotpixfilter", type=int, default=1)
    parser.add_argument("--hotpix_num_stds", type=float, default=10)
    parser.add_argument("--logtrafo", type=int, default=0)
    parser.add_argument("--gammatrafo", type=int, default=0)
    parser.add_argument("--gamma", type=float, default=0.5)
    parser.add_argument("--normalize_events", type=int, default=0)
    parser.add_argument("--slice_max_evs", type=int, default=30000)
    parser.add_argument("--max_random_shift_evs", type=int, default=15)
    parser.add_argument("--rand_aug", type=int, default=1)
    parser.add_argument("--input_W", type=int, default=224)
    parser.add_argument("--input_H", type=int, default=224)
    parser.add_argument("--compact_wire", type=int, default=1,
                        help="ship events as int16 [x, y, p] when the "
                             "timestamp column is dead (timesurface off). "
                             "0 = always send (B, N, 4) float32. The port's "
                             "server always ships the f32 wire")
    parser.add_argument("--loader_profile", type=int, default=0,
                        help="print per-item load/transform k-items/sec")

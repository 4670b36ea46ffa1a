"""Shared CLI plumbing: dataset detection, preprocessing config assembly,
host pipeline construction, config validation and the shared flag blocks.

Port of mem_tpu/cli/common.py with the same flag names and defaults, so
.conf files and launch commands carry over unchanged.
"""
from __future__ import annotations

import functools
import os
from typing import Optional, Tuple

import torch

from mem_tpu_torch.data.device_pipeline import PreprocConfig, preprocess_image_cls
from mem_tpu_torch.data.folder import NpyFolder, loader_for_path, resolve_split_root
from mem_tpu_torch.data.pipeline import EventBatchIterator, PipelineConfig
from mem_tpu_torch.models.registry import create_model


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


def build_classifier(args, nb_classes: int, dtype, device):
    """The classifier of a finetune run and of the server that serves its
    checkpoint (run_class_finetuning.py:202-228 and, with ``--MAE 1``,
    :315-331): ``create_model`` on the ft_vit or the vit_base_patch16
    surface."""
    patch = 2 ** args.num_layers
    if args.MAE:
        return create_model(
            "vit_base_patch16", num_classes=nb_classes, drop_path_rate=args.drop_path,
            drop_rate=args.drop, global_pool=True, img_size=(args.input_H, args.input_W),
            in_chans=3 if args.voxel == 0 else args.voxel, patch_size=patch,
            embed_dim=args.transformer_emb, depth=args.transformer_depth,
            num_heads=args.transformer_heads, mlp_ratio=args.transformer_mlp_ratio,
            dtype=dtype, device=device)
    name = "ft_vit" if args.model in (None, "null") else args.model
    return create_model(
        name, num_classes=nb_classes, drop_rate=args.drop, drop_path_rate=args.drop_path,
        attn_drop_rate=args.attn_drop_rate, use_mean_pooling=bool(args.use_mean_pooling),
        init_scale=args.init_scale, use_rel_pos_bias=bool(args.rel_pos_bias),
        use_abs_pos_emb=bool(args.abs_pos_emb), init_values=args.layer_scale_init_value,
        in_chans=3 if args.voxel == 0 else args.voxel,
        img_size=(args.input_H, args.input_W), patch_size=(patch, patch),
        embed_dim=args.transformer_emb, depth=args.transformer_depth,
        num_heads=args.transformer_heads, mlp_ratio=args.transformer_mlp_ratio,
        use_batch_norm=bool(args.linear_probe_batch_norm), dtype=dtype, device=device)


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


def parse_rand_aa(spec: Optional[str]):
    """timm auto-augment spec -> (magnitude, num_ops, mstd) for
    ops/rand_augment's ``timm_levels`` mode (common.py:255-281).

    Only ``rand-*`` (RandAugment) specs are supported: the reference ships
    only ``rand-m9-mstd0.5-inc1`` (run_class_finetuning.py:203) and its event
    pipelines never read --aa. The semantics downstream are timm's: a fixed
    level m of 10 with gaussian ``mstd`` jitter, per-op apply prob 0.5 (not
    the event path's U[0, m] draw). ``inc`` is accepted and dropped: the
    torchvision magnitude table's severity directions already match the
    increasing variants. Returns None when the spec is empty or none
    (ColorJitter applies instead, timm create_transform semantics)."""
    if not spec or str(spec).lower() in ("none", "0", "false"):
        return None
    if not spec.startswith("rand"):
        raise SystemExit(f"--aa: only rand-* (RandAugment) specs are supported, got {spec!r}")
    mag, num_ops, mstd = 9, 2, 0.0  # timm _RAND_ defaults (mstd off)
    for part in spec.split("-")[1:]:
        if part.startswith("inc"):
            continue
        if part.startswith("mstd"):
            mstd = float(part[4:])
        elif part.startswith("m") and part[1:].isdigit():
            mag = int(part[1:])
        elif part.startswith("n") and part[1:].isdigit():
            num_ops = int(part[1:])
    return mag, num_ops, mstd


def imnet_aug(args, batch_ops: bool = False):
    """``(image_preproc, draw_settings)`` of a run's IMNET train batches, from
    --aa, --reprob, --remode and --recount (run_class_finetuning.py:288-293):
    the step's ``preprocess_image_cls`` with its flags bound, and the
    keywords of ``draw_image_aug`` (``with_image_draws``) for the host."""
    aa = parse_rand_aa(args.aa)
    image_preproc = functools.partial(preprocess_image_cls, is_train=True,
                                      rand_aug=aa is not None, reprob=args.reprob,
                                      remode=args.remode)
    draw_settings = dict(magnitude=aa[0] if aa else 0, num_ops=aa[1] if aa else 2,
                         mstd=aa[2] if aa else 0.0, reprob=args.reprob, recount=args.recount,
                         batch_ops=bool(batch_ops))
    return image_preproc, draw_settings


def imnet_pipelines(args, batch_size: int, window: Optional[Tuple[int, int]] = None):
    """(train folder, train iterator, val folder, val iterator) of
    ``--data_set IMNET`` over data_path/{train,val} (with the extracted_*
    fallback; --eval_data_path is ignored, datasets.py:415-420). With
    ``window`` the two-view pretraining iterator (run_mem_pretraining.py:
    334-361): both views at --input_H (the reference hard-codes the
    tokenizer view's 224, and --input_H2 never reaches the event VAE), the
    block mask on ``window``. Without, the classification iterator of the
    finetune and the VAE (run_class_finetuning.py:251-294, train_vae.py:
    151-195): --input_size, ColorJitter only when --aa is off."""
    from mem_tpu_torch.data.image_pipeline import (ImageBatchIterator, ImageFolder,
                                                   ImagePipelineConfig)

    if window is None and getattr(args, "eval_data_path", None):
        print("note: --eval_data_path is ignored on --data_set IMNET "
              "(reference datasets.py:415-420 uses data_path/{train,val})")
    out = []
    for split, is_train in (("train", True), ("val", False)):
        folder = ImageFolder(resolve_split_root(args.data_path, split))
        common = dict(batch_size=batch_size, is_train=is_train,
                      interpolation=args.train_interpolation, seed=args.seed,
                      shuffle=is_train, drop_last=is_train)
        if window is not None:
            cfg = ImagePipelineConfig(
                input_size=args.input_H, second_size=args.input_H,
                second_interpolation=args.second_interpolation, masking=args.masking,
                window_size=window, num_mask_patches=args.num_mask_patches,
                min_mask_patches_per_block=args.min_mask_patches_per_block,
                max_mask_patches_per_block=args.max_mask_patches_per_block, **common)
        else:
            cfg = ImagePipelineConfig(
                input_size=args.input_size, classification=True, masking=None,
                color_jitter_cls=args.color_jitter,
                use_color_jitter_cls=parse_rand_aa(args.aa) is None,  # timm: aa replaces CJ
                **common)
        out += [folder, ImageBatchIterator(folder, cfg)]
    return tuple(out)


def add_imnet_args(parser, stage: str = "pretrain") -> None:
    """The timm-path knobs for ``--data_set IMNET`` (real-image baseline runs;
    reference run_class_finetuning.py:201-223, run_mem_pretraining.py:79-123,
    train_vae.py:74-100) of the pretraining, the finetune or the VAE CLI
    (``stage`` "pretrain", "finetune" or "vae"; common.py:348-392). On the
    event (.npy) datasets the reference ignores every one of them
    (build_transformNPY never reads them), and so does the port; they bind
    only on the IMNET image path."""
    a = parser.add_argument
    a("--input_size", type=int, default=224,
      help="IMNET image side (event paths use --input_H/--input_W)")
    a("--imagenet_default_mean_and_std", action="store_true", default=False,
      help="reference e2v path hardcodes mean=0/std=1 regardless "
           "(datasets.py:356-357); accepted for compatibility")
    a("--resize", action="store_true", default=False,
      help="reference: prepends FixedResizeTransform(2) in the dead "
           "build_transform_e2v2 path (datasets.py:334-340); accepted and inert, "
           "see mem_tpu_torch.data.extra_transforms.fixed_resize")
    if stage == "pretrain":
        a("--train_interpolation", type=str, default="bicubic",
          help="first-view resample filter (bilinear|bicubic|lanczos|random)")
        a("--second_interpolation", type=str, default="lanczos",
          help="tokenizer-view resample filter")
        a("--input_H2", type=int, default=128,
          help="inert, reference-faithfully: run_mem_pretraining.py:269 "
               "feeds it to create_d_vae, which DROPS image_size for the "
               "event VAE (utils.py:571-578), and the IMNET two-view "
               "transform hardcodes second_size=224 (datasets.py:92-95); "
               "the IMNET tokenizer view likewise uses --input_H")
        a("--input_W2", type=int, default=128)
    else:
        a("--train_interpolation", "--train-interpolation", type=str, default="bicubic")
        a("--aa", type=str, default="rand-m9-mstd0.5-inc1",
          help="timm AutoAugment spec for the IMNET train path; rand-* specs "
               "map onto ops/rand_augment's timm level mode")
        a("--reprob", type=float, default=0.25,
          help="random-erasing probability (IMNET train path)")
        a("--remode", type=str, default="pixel")
        a("--recount", type=int, default=1)
        a("--resplit", action="store_true", default=False)
    if stage == "finetune":
        a("--crop_pct", type=float, default=None,
          help="reference quirk preserved: build_transform_e2v overwrites "
               "crop_pct to None then derives 224/256 (datasets.py:379-382), "
               "so the flag value never matters")


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

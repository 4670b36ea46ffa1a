"""Shared CLI plumbing: dataset detection, preprocessing config assembly and
the preprocessing flag block.

Port of mem_tpu/cli/common.py:16-107 and :395-418 with the same flag names
and defaults, so .conf files and launch commands carry over unchanged.
"""
from __future__ import annotations

from typing import Optional, Tuple

from mem_tpu_torch.data.device_pipeline import PreprocConfig


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

"""Serving / inference throughput on the card: classification (ft_vit-B)
and DSEC segmentation, the forward only.

Port of scripts/trace_infer.py. On the card, from the repo root::

    python -m mem_tpu_torch.tools.trace_infer [mode=cls|seg] [B=256|8] [steps=4]
        [int8=0|1] [dir=<trace dir>] [device=cuda|cpu]

The deployment-shaped path: the eval preprocessing, the bf16 forward and the
predictions, no loss and no optimizer, the modules ``run_class_finetuning
--eval`` / ``test_seg`` drive. ``mode=cls``: ``ft_vit`` (101 classes,
init_values 0.1, the shared rel-pos bias, mean pooling) in eval mode, B=256
samples of 30,000 events, argmax. ``mode=seg``: the segmentor (EvBEiT-512 +
UPerNet, 11 classes) on y-sorted 180,000-event windows, single scale through
``models.segmentation.tta_probs``, B=8. Each step consumes a batch of its own
(``steps`` + 2 batches from ``np.random.default_rng(0)``: two warm up).
``int8=1`` sets ``models.vit.INT8_GEMM`` (W8A8 fc1 / qkv / proj).
``step_timers.analyze`` prints the breakdown (cls: K1 once, K2f 12
times a batch; seg: K4 once, K3f 12 times). Runs on the card unless
``device=cpu``; exits 2 without one.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from mem_tpu_torch.tools.step_timers import (gpu_name, parse_args, refuse, resolved, toggles,
                                             trace_and_analyze)


def cls_batch(rng, B, N=30000, num_classes=101):
    """trace_infer.py:33-47: eval events, no flips or shift."""
    batch = {
        "events": rng.random((B, N, 4)).astype(np.float32) * [240, 180, 1e6, 1],
        "n_valid": np.full((B,), N, np.int32),
        "label": rng.integers(0, num_classes, (B,)).astype(np.int64),
        "sample_h": np.full((B,), 180, np.int32),
        "sample_w": np.full((B,), 240, np.int32),
        "time_flip": np.zeros(B, bool),
        "x_flip": np.zeros(B, bool),
        "shift_xy": np.zeros((B, 2), np.int32),
        "aug_seed": np.arange(B, dtype=np.uint32),
    }
    batch["events"][..., 3] = rng.choice([-1.0, 1.0], (B, N))
    return batch


def seg_batch(rng, B, N=180000):
    """trace_infer.py:94-106: y-sorted DSEC windows, zero labels."""
    from mem_tpu_torch.data.seg_pipeline import SEG_H, SEG_W

    ev = rng.random((B, N, 4)).astype(np.float32) * [SEG_W, SEG_H, 1, 1]
    ev[..., 3] = rng.choice([-1.0, 1.0], ev.shape[:2])
    order = np.argsort(ev[..., 1], axis=1)
    ev = np.take_along_axis(ev, order[..., None], axis=1)
    return {"events": ev, "n_valid": np.full((B,), N, np.int32),
            "label": np.zeros((B, SEG_H, SEG_W), np.int32), "flip": np.zeros(B, bool),
            "aug_seed": np.arange(B, dtype=np.uint32)}


def config(mode="cls", B=None, nsteps=4, N=None) -> dict:
    """What :func:`build` builds, as plain values: the model, the
    preprocessing (cls) and the ``nsteps`` + 2 host batches."""
    from mem_tpu_torch.data.device_pipeline import PreprocConfig

    rng = np.random.default_rng(0)
    if mode == "cls":
        B = B or 256
        return dict(mode=mode, model=("ft_vit", dict(
            num_classes=101, dtype="bfloat16", init_values=0.1, use_shared_rel_pos_bias=True,
            use_mean_pooling=True)),
            preproc=PreprocConfig(canvas_h=256, canvas_w=256, rand_aug=False,
                                  color_jitter=0.0),
            batches=[cls_batch(rng, B, N or 30000) for _ in range(nsteps + 2)])
    B = B or 8
    return dict(mode=mode, model=dict(num_classes=11, backbone_cfg=dict(
        img_size=512, embed_dim=768, depth=12, num_heads=12), dtype="bfloat16"),
        batches=[seg_batch(rng, B, N or 180000) for _ in range(nsteps + 2)])


def build(cfg, device, model_kw=None):
    """(infer(batch) -> predictions, model) of ``cfg`` on ``device``, weights
    drawn from seed 0; ``model_kw`` overrides the model's (the backbone's in
    seg mode) arguments."""
    from mem_tpu_torch.data.device_pipeline import preprocess_batch
    from mem_tpu_torch.data.seg_pipeline import seg_preprocess_batch
    from mem_tpu_torch.models.registry import create_model
    from mem_tpu_torch.models.segmentation import EncoderDecoder, tta_probs

    if cfg["mode"] == "cls":
        name, kw = cfg["model"]
        model = create_model(name, **resolved({**kw, **(model_kw or {})}), device=device)
        pp = cfg["preproc"]

        def infer(batch):
            images = preprocess_batch(batch, pp, is_train=False)
            return model(images).float().argmax(-1)
    else:
        m = dict(cfg["model"])
        m["backbone_cfg"] = {**m["backbone_cfg"], **(model_kw or {})}
        model = EncoderDecoder(**resolved(m), device=device)
        n = m["num_classes"]

        def infer(batch):
            imgs, _ = seg_preprocess_batch(batch, False, y_sorted=True)
            probs = tta_probs(lambda x: model(x)[0], imgs, n, scales=(1.0,), flips=(False,))
            return probs.argmax(-1)
    model.init_weights(torch.Generator().manual_seed(0))
    model.eval()
    return infer, model


def run(cfg, device, tdir=None, model_kw=None, tool="trace_infer"):
    from mem_tpu_torch.data.prefetch import to_device

    infer, _ = build(cfg, device, model_kw)
    batches = [to_device({k: v for k, v in b.items() if k != "aug_seed"}, device)
               for b in cfg["batches"]]
    nsteps, B = len(batches) - 2, len(cfg["batches"][0]["n_valid"])
    with torch.inference_mode():
        for b in batches[:2]:                  # warm
            infer(b)
        res = trace_and_analyze([lambda b=b: infer(b) for b in batches[2:]], device, nsteps,
                                f"{tool} mode={cfg['mode']}", B,
                                unit="samples" if cfg["mode"] == "cls" else "img", tdir=tdir)
    res["predictions_shape"] = list(res["out"].shape)
    return res


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    kv = parse_args(argv)
    bad = refuse("trace_infer", kv)
    if bad:
        print(bad[1], file=sys.stderr)
        return bad[0]
    device = torch.device(kv.get("device", "cuda"))
    mode = kv.get("mode", "cls")
    print(gpu_name(device), flush=True)
    if int(kv.get("int8", 0)):
        print("int8: W8A8 GEMMs enabled (vit.INT8_GEMM)")
    B = int(kv["B"]) if "B" in kv else None
    with toggles(kv):
        run(config(mode, B, int(kv.get("steps", 4))), device, kv.get("dir"))
    return 0


if __name__ == "__main__":
    sys.exit(main())

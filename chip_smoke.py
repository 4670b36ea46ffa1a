#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (mem_tpu_torch) on one H100.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from csrc/, checks each against its plain
PyTorch version on the card, drives the served classification path (the
HTTP server of mem_tpu_torch.cli.serve, ViT-B/16 ft_vit at full width with
weights drawn from a seed), checks that the path launched both kernels,
holds the card's logits against the CPU's, and times kernels, forward and
requests. One line per phase; the line before the last is the kernel table
as JSON; the last line is

    {"ok": true, "device": {"platform": "gpu", "kind": "<name>", "count": N}}

It exits non-zero, before printing any result, when no CUDA device is
available or mem_tpu_torch cannot be imported, and on any failed check.
"""
from __future__ import annotations

import io
import json
import os
import statistics
import sys
import tempfile
import threading
import time
import traceback
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np

N_REQUESTS = 24          # served through HTTP, 8 clients at a time
K2_BF16_TOL = 2e-2       # bf16 output: p and o each rounded to bf16 -> a few ulps at |o| <= 2
K2_F32_TOL = 1e-5        # f32: the same math, sums in another order
LOGITS_BF16_REL = 5e-2   # card bf16 vs CPU f32, relative L2: 12 blocks of bf16 rounding
LOGITS_F32_REL = 1e-3    # card f32 vs CPU f32, relative L2: summation order only
IMAGES_TOL = 1e-4        # preprocessed images card vs CPU (f32 resize sums reordered)


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def say(tag, **fields):
    print(f"{tag} {json.dumps(fields)}", flush=True)


def synthetic_events(rng, n):
    """N-Caltech101-like stream: x < 240, y < 180, sorted t, p = +-1; most
    events on a blob (the object), the rest spread over the sensor."""
    w, h = int(rng.integers(160, 241)), int(rng.integers(120, 181))
    n_obj = int(0.7 * n)
    cx, cy = rng.uniform(0.3, 0.7) * w, rng.uniform(0.3, 0.7) * h
    xo = np.clip(rng.normal(cx, w / 8, n_obj), 0, w - 1)
    yo = np.clip(rng.normal(cy, h / 8, n_obj), 0, h - 1)
    ev = np.zeros((n, 4), np.float64)
    ev[:, 0] = np.floor(np.concatenate([xo, rng.uniform(0, w, n - n_obj)]))
    ev[:, 1] = np.floor(np.concatenate([yo, rng.uniform(0, h, n - n_obj)]))
    perm = rng.permutation(n)
    ev[:, :2] = ev[perm, :2]
    ev[:, 2] = np.sort(rng.integers(0, 300_000, n))
    ev[:, 3] = rng.choice([-1.0, 1.0], n)
    return ev


def time_ms(torch, fn, runs=30, warmup=5):
    """Median of per-run CUDA-event times (ms) after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def run(torch):
    from mem_tpu_torch.cli import serve
    from mem_tpu_torch.cli.common import build_preproc
    from mem_tpu_torch.data.device_pipeline import preprocess_batch
    from mem_tpu_torch.kernels import build, launch_counts, reset_launch_counts
    from mem_tpu_torch.ops import voxelize_hist as vh
    from mem_tpu_torch.ops.attention import (cuda_kernel_path, fused_attention_flat,
                                             fused_attention_flat_reference)
    from mem_tpu_torch.utils import env

    # full-precision f32 products on both sides of every comparison
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # -- phase 0: probe + build ----------------------------------------------
    info = env.probe()
    gpu = info["nvidia_smi"] or f"{info['device_name']}, power limit not read"
    print(gpu, flush=True)
    say("probe", **info)
    t0 = time.perf_counter()
    build.library()
    ptxas = [ln.strip() for ln in build.build_log().splitlines()
             if "registers" in ln or "spill" in ln]
    say("build", seconds=round(time.perf_counter() - t0, 3), ptxas=ptxas)

    # -- phase 1: K1 against its plain version -------------------------------
    g = torch.Generator().manual_seed(0)
    k1_err = 0
    for B, N, H, W in ((8, 30_000, 256, 256), (3, 12_345, 180, 240)):
        col = torch.randint(-2, 2 * W + 3, (B, N), generator=g, dtype=torch.int32)
        ys = torch.randint(-2, H + 3, (B, N), generator=g, dtype=torch.int32)
        col[:, :500] = 2 * W
        col, ys = col.to(dev), ys.to(dev)
        got = vh.hist_planes_cols(col, ys, H, W)
        want = vh.hist_planes_cols_reference(col, ys, H, W)
        torch.cuda.synchronize()
        err = int((got - want).abs().max().item())
        say("k1_check", shape=[B, N, H, W], equal=bool(torch.equal(got, want)),
            max_abs_err=err, events=int(want.sum().item()))
        check(torch.equal(got, want), f"K1 differs from its plain version at {B, N, H, W}")
        k1_err = max(k1_err, err)

    # -- phase 2: K2 forward against its plain version -----------------------
    # the serving shape first (bf16: tensor-core kernel), then the other
    # instantiations and the scalar kernel (f32, other head dims)
    k2_err = None
    for (B, N, H, D), dt in (((8, 197, 12, 64), torch.bfloat16),
                             ((2, 37, 3, 64), torch.bfloat16),
                             ((2, 129, 2, 64), torch.bfloat16),
                             ((1, 256, 2, 64), torch.bfloat16),
                             ((2, 50, 4, 32), torch.bfloat16),
                             ((8, 197, 12, 64), torch.float32)):
        tol = K2_BF16_TOL if dt == torch.bfloat16 else K2_F32_TOL
        q, k, v = (torch.randn(B, N, H * D, generator=g).to(dt).to(dev) for _ in range(3))
        bias = (0.5 * torch.randn(H, N, N, generator=g)).to(dev)
        got = fused_attention_flat(q, k, v, bias, D ** -0.5)
        want = fused_attention_flat_reference(q, k, v, bias, D ** -0.5)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        say("k2_check", dtype=str(dt), shape=[B, N, H, D], max_abs_err=err, tol=tol,
            kernel=cuda_kernel_path(q, k, v, bias))
        check(err <= tol, f"K2 {dt} {B, N, H, D} max abs err {err} > {tol}")
        if k2_err is None:
            k2_err = err

    # -- phase 3: the served slice at full width ------------------------------
    rng = np.random.default_rng(0)
    payloads = [synthetic_events(rng, int(rng.integers(20_000, 60_001)))
                for _ in range(N_REQUESTS)]
    tmp = tempfile.TemporaryDirectory()
    ckpt = os.path.join(tmp.name, "ft_vit_b16_seed0.pth")
    flags = ["--checkpoint", ckpt, "--nb_classes", "101", "--dataset", "ncaltech101",
             "--model", "ft_vit", "--dtype", "bfloat16", "--batch_size", "8",
             "--max_wait_ms", "5", "--topk", "5", "--port", "0", "--device", "cuda"]
    args = serve.get_args(flags)
    ref = serve._build_ft_vit(args, 101, 16, torch.float32, torch.device("cpu"))
    ref.init_weights(torch.Generator().manual_seed(0))
    torch.save({"model": ref.state_dict(), "epoch": 0}, ckpt)
    say("model", name="ft_vit", embed_dim=args.transformer_emb,
        depth=args.transformer_depth, heads=args.transformer_heads,
        img=[args.input_H, args.input_W], patch=16, classes=101, params=sum(p.numel() for p in ref.parameters()), checkpoint_mb=round(
            os.path.getsize(ckpt) / 2**20, 1))

    t0 = time.perf_counter()
    httpd, state, threads = serve.build_server(args)
    build_s = time.perf_counter() - t0
    http_thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    http_thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"

    def post(ev):
        buf = io.BytesIO()
        np.save(buf, ev)
        t = time.perf_counter()
        req = urllib.request.Request(url + "/predict", data=buf.getvalue(), method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            body = json.loads(r.read())
            code = r.status
        return code, body, (time.perf_counter() - t) * 1e3

    try:
        reset_launch_counts()                 # just before the main path
        with ThreadPoolExecutor(8) as pool:
            burst = list(pool.map(post, payloads))
        seq = [post(payloads[i]) for i in range(8)]
        repeat = post(payloads[0])
        counts = launch_counts()              # just after it
        stats = json.loads(urllib.request.urlopen(url + "/stats", timeout=10).read())
    finally:
        with state.cv:
            state.stop = True
            state.cv.notify_all()
        httpd.shutdown()
        httpd.server_close()
        for t in threads:
            t.join(timeout=10)
        http_thread.join(timeout=10)

    for code, body, _ in burst + seq + [repeat]:
        check(code == 200, f"HTTP {code}")
        tk = body["topk"]
        probs = [p for _, p in tk]
        check(len(tk) == 5 and all(0 <= c < 101 for c, _ in tk), f"bad topk {tk}")
        check(probs == sorted(probs, reverse=True) and 0 < sum(probs) <= 1 + 1e-5,
              f"bad probabilities {probs}")
        check(all(np.isfinite(probs)), "non-finite probabilities")
    check(repeat[1]["topk"] == seq[0][1]["topk"], "same payload, different top-k")
    served = len(burst) + len(seq) + 1
    say("serve", requests=served, over_cap=sum(len(p) > 30_000 for p in payloads),
        build_server_s=round(build_s, 3), launches=counts, stats=stats,
        deterministic=True)
    check(stats["served"] >= served, f"/stats served {stats['served']} < {served}")
    for name in ("hist_planes_cols", "fused_attention_flat"):
        check(counts.get(name, 0) > 0, f"the served path launched no {name} kernel")

    # card logits (bf16 and f32) against the plain versions on the CPU in f32
    pp = build_preproc(args, is_train=False)
    batch = serve.make_assemble(args, pp)([(p, False) for p in payloads[:8]], 8)
    sd = torch.load(ckpt, map_location="cpu", weights_only=True)["model"]
    cpu_model = serve._build_ft_vit(args, 101, 16, torch.float32, torch.device("cpu"))
    cpu_model.load_state_dict(sd, strict=True)
    with torch.inference_mode():
        cpu_images = preprocess_batch(serve.to_device(batch, "cpu"), pp, is_train=False)
        cpu_logits = cpu_model.eval()(cpu_images)
    rel, models, img_err = {}, {}, 0.0
    for name, dt in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        model = serve._build_ft_vit(args, 101, 16, dt, dev)
        model.load_state_dict(sd, strict=True)
        models[name] = model.eval()
        with torch.inference_mode():
            images = preprocess_batch(serve.to_device(batch, dev), pp, is_train=False)
            logits = model(images).cpu()
        check(bool(torch.isfinite(logits).all()) and logits.shape == (8, 101),
              f"card logits {tuple(logits.shape)} not finite")
        rel[name] = (torch.linalg.norm(logits - cpu_logits)
                     / torch.linalg.norm(cpu_logits)).item()
        img_err = max(img_err, (images.cpu() - cpu_images).abs().max().item())
    say("logits_check", rel_l2_bf16=rel["bfloat16"], bound_bf16=LOGITS_BF16_REL,
        rel_l2_f32=rel["float32"], bound_f32=LOGITS_F32_REL, images_max_abs=img_err,
        logits_abs_mean=cpu_logits.abs().mean().item())
    check(img_err <= IMAGES_TOL, f"card images differ from CPU by {img_err}")
    check(rel["bfloat16"] <= LOGITS_BF16_REL, f"bf16 logits rel L2 {rel['bfloat16']}")
    check(rel["float32"] <= LOGITS_F32_REL, f"f32 logits rel L2 {rel['float32']}")

    # -- phase 4: timings (CUDA-event medians of 30 runs after 5 warm-up) ----
    timing = {}
    for B in (8, 64):
        evs = [synthetic_events(rng, 30_000) for _ in range(B)]
        xs = torch.tensor(np.stack([e[:, 0] for e in evs]), dtype=torch.int32, device=dev)
        ys = torch.tensor(np.stack([e[:, 1] for e in evs]), dtype=torch.int32, device=dev)
        pos = torch.tensor(np.stack([e[:, 3] > 0 for e in evs]), device=dev).float()
        col, ysf = vh.pack_cols(xs, ys, pos, 1.0 - pos, 256, 256)
        t_k1 = time_ms(torch, lambda: vh.hist_planes_cols(col, ysf, 256, 256))
        t_k1p = time_ms(torch, lambda: vh.hist_planes_cols_reference(col, ysf, 256, 256))
        say("time_k1", gpu=gpu, batch=B, events=30_000, canvas=[256, 256], kernel_ms=t_k1,
            plain_ms=t_k1p, kernel_gev_s=B * 30_000 / t_k1 / 1e6)

        q, k, v = (torch.randn(B, 197, 768, device=dev, dtype=torch.bfloat16)
                   for _ in range(3))
        bias = torch.randn(12, 197, 197, device=dev)
        t_k2 = time_ms(torch, lambda: fused_attention_flat(q, k, v, bias, 0.125))
        t_k2p = time_ms(torch, lambda: fused_attention_flat_reference(q, k, v, bias, 0.125))
        flop = 4 * B * 12 * 197 * 197 * 64
        say("time_k2", gpu=gpu, batch=B, shape=[197, 12, 64], dtype="bfloat16",
            kernel_ms=t_k2, plain_ms=t_k2p, kernel_tflop_s=flop / t_k2 / 1e9)
        timing[B] = (t_k1, t_k1p, t_k2, t_k2p)

        fb = serve.make_assemble(args, pp)([(p, False) for p in payloads[:B]], B)
        dev_batch = serve.to_device(fb, dev)
        with torch.inference_mode():
            t_fwd = time_ms(torch, lambda: serve.classify(models['bfloat16'], pp, dev_batch, 5),
                            runs=20)
        say("time_forward", gpu=gpu, batch=B, dtype="bfloat16", ms=t_fwd,
            samples_per_s=B / t_fwd * 1e3)

    lat = sorted(ms for _, _, ms in burst)
    say("time_http", gpu=gpu, batch_size=8, clients=8, requests=len(burst),
        p50_ms=statistics.median(lat), p90_ms=lat[int(0.9 * (len(lat) - 1))],
        sequential_p50_ms=statistics.median(ms for _, _, ms in seq))
    tmp.cleanup()

    print(json.dumps({"kernels": [
        {"name": "hist_planes_cols", "route": "cuda",
         "source": "mem_tpu_torch/csrc/voxelize_hist.cu",
         "replaces": "mem_tpu/ops/voxelize_pallas.py:64",
         "launches": counts["hist_planes_cols"], "max_abs_err": float(k1_err),
         "ms": timing[8][0], "plain_ms": timing[8][1]},
        {"name": "fused_attention_flat", "route": "cuda",
         "source": "mem_tpu_torch/csrc/attention_fwd.cu",
         "replaces": "mem_tpu/ops/attention.py:105",
         "launches": counts["fused_attention_flat"], "max_abs_err": k2_err,
         "ms": timing[8][2], "plain_ms": timing[8][3]},
    ]}), flush=True)


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    try:
        import mem_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run it from the root of a mem_tpu checkout ({e})",
              file=sys.stderr)
        return 2
    try:
        run(torch)
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

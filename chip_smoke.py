#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (mem_tpu_torch) on one H100.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from csrc/ and checks each against its
plain PyTorch version on the card. It drives the two ported paths, each
with the launch counts set to 0 just before it and read just after:

- the served classification path: the HTTP server of mem_tpu_torch.cli.serve,
  ViT-B/16 ft_vit at full width with weights drawn from a seed; it checks
  that the path launched K1 and K2f and holds the card's logits against
  the CPU's;
- the pretraining path: mem_tpu_torch.cli.run_mem_pretraining.main with the
  configs/ncaltech.conf recipe (ViT-B/16 pt_vit at full width, a seeded
  VAE tokenizer at the conf's size) on a synthetic N-Caltech-like dataset,
  two epochs, checkpoints and an auto-resumed third epoch; it checks that
  the path launched K1, K2f and K2b.

Between them it holds one train step on the card (f32 and bf16) against the
same step on the CPU, and it times kernels, forwards, requests and train
steps. One line per phase; the line before the last is the kernel table as
JSON; the last line is

    {"ok": true, "device": {"platform": "gpu", "kind": "<name>", "count": N}}

It exits non-zero, before printing any result, when no CUDA device is
available or mem_tpu_torch cannot be imported, and on any failed check.
"""
from __future__ import annotations

import io
import json
import os
import signal
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
# K2b: dq/dk/dv max abs error relative to the plain version's max abs. bf16:
# both round the outputs to bf16 (2^-8 relative) and ds to bf16 before the
# dq/dk products, from f32 sums taken in another order -> a few bf16 ulps.
K2B_BF16_TOL = 2e-2
K2B_F32_TOL = 1e-5       # f32: the same math, sums in another order
K2B_DB_REL = 1e-5        # db relative L2: f32 ds summed over the batch in batch order
# one train step, card vs CPU on the same host batch, draws and weights:
TRAIN_IMG_TOL = 2.5 / 255     # RandAugment truncates to uint8: a sum taken in another
TRAIN_IMG_FRAC = 1e-3         # order can flip one level (x <= 1.2 jitter) at a few pixels
VAE_TOKENS_AGREE = 0.99  # f32 tokenizer, TF32 off: only near-ties of the 8192 logits may flip
VAE_MIN_DISTINCT = 16    # a tokenizer that gives every patch one token makes the agreement vacuous
STEP_F32_LOSS_REL = 1e-4   # f32 card vs f32 CPU: summation order only
STEP_F32_GRAD_REL = 1e-3   # per-parameter relative L2 of the gradients, the same
STEP_BF16_LOSS_REL = 2e-2  # bf16 card vs f32 CPU: two blocks of bf16 rounding
LOSS_FALL = 0.3          # nats the loss must fall over 15 steps on one repeated batch
N_TRAIN_FILES, N_VAL_FILES = 128, 64


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

    # -- phases 5-8: the pretraining slice ------------------------------------
    k2b_err = check_k2b(torch, dev, g)
    train_tmp = tempfile.TemporaryDirectory()
    try:
        data_root, vae_path = write_training_inputs(torch, train_tmp.name, rng)
        base = ["--config", "configs/ncaltech.conf", "--data_path", data_root,
                "--discrete_vae_weight_path", vae_path, "--num_workers", "4"]
        check_train_step(torch, dev, base + ["--output_dir", os.path.join(train_tmp.name, "x")])
        train_counts = run_training_cli(torch, base + [
            "--output_dir", os.path.join(train_tmp.name, "pt_out")])
        t_k2b, t_k2bp = time_training(torch, dev, gpu, base + [
            "--output_dir", os.path.join(train_tmp.name, "x")])
    finally:
        signal.signal(signal.SIGTERM, signal.SIG_DFL)   # the CLI latched SIGTERM
        train_tmp.cleanup()

    print(json.dumps({"kernels": [
        {"name": "hist_planes_cols", "route": "cuda",
         "source": "mem_tpu_torch/csrc/voxelize_hist.cu",
         "replaces": "mem_tpu/ops/voxelize_pallas.py:64",
         "launches": train_counts["hist_planes_cols"], "max_abs_err": float(k1_err),
         "ms": timing[8][0], "plain_ms": timing[8][1]},
        {"name": "fused_attention_flat", "route": "cuda",
         "source": "mem_tpu_torch/csrc/attention_fwd.cu",
         "replaces": "mem_tpu/ops/attention.py:105",
         "launches": train_counts["fused_attention_flat"], "max_abs_err": k2_err,
         "ms": timing[8][2], "plain_ms": timing[8][3]},
        {"name": "fused_attention_flat_bwd", "route": "cuda",
         "source": "mem_tpu_torch/csrc/attention_bwd.cu",
         "replaces": "mem_tpu/ops/attention.py:128",
         "launches": train_counts["fused_attention_flat_bwd"], "max_abs_err": k2b_err,
         "ms": t_k2b, "plain_ms": t_k2bp},
    ]}), flush=True)


def rel_max_abs(a, b):
    return ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()


def rel_l2(torch, a, b):
    a, b = a.float(), b.float()
    return (torch.linalg.norm(a - b) / torch.linalg.norm(b)).item()


def check_k2b(torch, dev, g):
    """Phase 5: K2b against its plain version at the training shape, two
    ragged ones and an f32 one; autograd through fused_attention_flat on the
    card reaches K2b. Returns K2b's max abs error at the training shape."""
    from mem_tpu_torch.kernels import launch_counts
    from mem_tpu_torch.ops.attention import (cuda_bwd_kernel_path, fused_attention_flat,
                                             fused_attention_flat_bwd,
                                             fused_attention_flat_bwd_reference)

    first = None
    for (B, N, H, D), dt in (((8, 197, 12, 64), torch.bfloat16),
                             ((2, 37, 3, 64), torch.bfloat16),
                             ((2, 129, 2, 64), torch.bfloat16),
                             ((2, 197, 4, 64), torch.float32)):
        tol = K2B_BF16_TOL if dt == torch.bfloat16 else K2B_F32_TOL
        q, k, v, do = (torch.randn(B, N, H * D, generator=g).to(dt).to(dev) for _ in range(4))
        bias = (0.5 * torch.randn(H, N, N, generator=g)).to(dev)
        got = fused_attention_flat_bwd(q, k, v, bias, do, D ** -0.5)
        want = fused_attention_flat_bwd_reference(q, k, v, bias, do, D ** -0.5)
        torch.cuda.synchronize()
        errs = {n: rel_max_abs(a, b) for n, a, b in zip(("dq", "dk", "dv"), got, want)}
        db = rel_l2(torch, got[3], want[3])
        say("k2b_check", dtype=str(dt), shape=[B, N, H, D], rel_max_abs=errs, tol=tol,
            db_rel_l2=db, db_tol=K2B_DB_REL, kernel=cuda_bwd_kernel_path(q, k, v, bias))
        check(max(errs.values()) <= tol and db <= K2B_DB_REL,
              f"K2b {dt} {B, N, H, D}: {errs}, db {db}")
        if first is None:
            first = max((a.float() - b.float()).abs().max().item() for a, b in zip(got, want))

    q, k, v = (torch.randn(2, 197, 768, generator=g).to(torch.bfloat16).to(dev)
               .requires_grad_() for _ in range(3))
    bias = torch.randn(12, 197, 197, generator=g).to(dev).requires_grad_()
    do = torch.randn(2, 197, 768, generator=g).to(torch.bfloat16).to(dev)
    before = launch_counts().get("fused_attention_flat_bwd", 0)
    fused_attention_flat(q, k, v, bias, 0.125).backward(do)
    torch.cuda.synchronize()
    launched = launch_counts().get("fused_attention_flat_bwd", 0) - before
    want = fused_attention_flat_bwd_reference(q.detach(), k.detach(), v.detach(),
                                              bias.detach(), do, 0.125)
    errs = [rel_max_abs(t.grad, w) for t, w in zip((q, k, v), want)]
    say("k2b_autograd", launches=launched, rel_max_abs=errs,
        db_rel_l2=rel_l2(torch, bias.grad, want[3]))
    check(launched == 1, f"autograd through fused_attention_flat launched K2b {launched} times")
    check(max(errs) <= K2B_BF16_TOL, f"autograd grads differ from the plain backward: {errs}")
    return first


def write_training_inputs(torch, root, rng):
    """A synthetic N-Caltech-like dataset (ncaltech101/{train,val}/<cls>/*.npy,
    20k-60k events each) and a seeded VAE tokenizer .pth at the conf's size."""
    from mem_tpu_torch.models.discrete_vae import DiscreteVAE

    data_root = os.path.join(root, "ncaltech101")
    for split, n in (("train", N_TRAIN_FILES), ("val", N_VAL_FILES)):
        for i in range(n):
            d = os.path.join(data_root, split, f"class_{i % 8}")
            os.makedirs(d, exist_ok=True)
            np.save(os.path.join(d, f"image_{i:04d}.npy"),
                    synthetic_events(rng, int(rng.integers(20_000, 60_001))))
    hp = dict(input_H=224, input_W=224, num_tokens=8192, emb_dim=32, num_layers=4,
              num_resnet_blocks=3, hidden_dim=384, channels=3, loss="mse")
    vae = DiscreteVAE((224, 224), num_tokens=8192, codebook_dim=32, num_layers=4,
                      num_resnet_blocks=3, hidden_dim=384)
    vae.init_weights(torch.Generator().manual_seed(0))
    vae_path = os.path.join(root, "vae_seed0.pth")
    torch.save({"model": vae.state_dict(), "hparams": hp}, vae_path)
    say("training_inputs", train_files=N_TRAIN_FILES, val_files=N_VAL_FILES,
        vae=hp, vae_mb=round(os.path.getsize(vae_path) / 2**20, 1))
    return data_root, vae_path


def host_train_batch(args, B):
    """The first training batch of the synthetic set at batch size B, with
    its augmentation draws, as numpy."""
    from mem_tpu_torch.cli.common import build_pipeline, build_preproc
    from mem_tpu_torch.data.device_pipeline import draw_train_aug

    pp = build_preproc(args, True, color_jitter=args.color_jitter)
    patch = 2 ** args.num_layers
    _, it = build_pipeline(args, "train", True, B, masking=args.masking,
                           window_size=(args.input_H // patch, args.input_W // patch),
                           seed=args.seed, num_workers=args.num_workers)
    batch = next(iter(it.epoch(0)))
    batch.update(draw_train_aug(batch["aug_seed"], pp, pp.canvas_h, pp.canvas_w))
    return pp, batch


def make_step(torch, R, args, device, dtype, vae, pp, lr_sched):
    from mem_tpu_torch.train.optim import create_optimizer
    from mem_tpu_torch.train.steps import make_pretrain_train_step

    model = R.build_model(args, dtype, device)
    model.init_weights(torch.Generator().manual_seed(args.seed))
    opt = create_optimizer(model, args.lr, args.weight_decay)
    wd = np.full(len(lr_sched), args.weight_decay)
    return model, make_pretrain_train_step(model, vae, opt, pp, lr_sched, wd,
                                           args.clip_grad, args.seed)


def check_train_step(torch, dev, flags):
    """Phase 6: one make_pretrain_train_step of pt_vit at full width and depth
    2, B=8, drop_path 0, on one host batch and its draws: the preprocessed
    images (RandAugment and ColorJitter on) and the VAE tokens card vs CPU,
    then the step on the card in f32 (TF32 off) and bf16 against the CPU in
    f32 from the same seeded weights."""
    from mem_tpu_torch.cli import run_mem_pretraining as R
    from mem_tpu_torch.data.device_pipeline import preprocess_batch
    from mem_tpu_torch.data.prefetch import to_device

    cpu = torch.device("cpu")
    args = R.get_args(flags + ["--transformer_depth", "2", "--drop_path", "0",
                               "--batch_size", "8", "--dtype", "float32"])
    pp, host = host_train_batch(args, 8)
    images = {}
    for d in (cpu, dev):
        images[d.type] = preprocess_batch(to_device(host, d), pp, is_train=True).cpu()
    diff = (images["cuda"] - images["cpu"]).abs()
    vae_cpu, vae_card = R.load_vae(args, cpu), R.load_vae(args, dev)
    with torch.no_grad():
        tok_cpu = vae_cpu.get_codebook_indices(images["cpu"])
        tok_card = vae_card.get_codebook_indices(images["cpu"].to(dev)).cpu()
    agree = (tok_cpu == tok_card).float().mean().item()
    say("train_images_check", shape=list(images["cpu"].shape), max_abs=diff.max().item(),
        frac_differing=(diff > 1e-6).float().mean().item(), tol=TRAIN_IMG_TOL,
        frac_tol=TRAIN_IMG_FRAC, rand_aug_batch_ops=pp.rand_aug_batch_ops,
        color_jitter=pp.color_jitter)
    say("vae_tokens_check", tokens=tok_cpu.numel(), agree=agree, bound=VAE_TOKENS_AGREE,
        distinct=int(tok_cpu.unique().numel()), min_distinct=VAE_MIN_DISTINCT)
    check(diff.max().item() <= TRAIN_IMG_TOL and
          (diff > 1e-6).float().mean().item() <= TRAIN_IMG_FRAC,
          "card train images differ from the CPU's")
    check(agree >= VAE_TOKENS_AGREE, f"VAE tokens agree on {agree} < {VAE_TOKENS_AGREE}")
    check(tok_cpu.unique().numel() >= VAE_MIN_DISTINCT,
          f"the seeded VAE gave {tok_cpu.unique().numel()} distinct tokens")

    lr = np.array([args.lr])
    out = {}
    for name, d, dt, vae in (("cpu_f32", cpu, torch.float32, vae_cpu),
                             ("card_f32", dev, torch.float32, vae_card),
                             ("card_bf16", dev, torch.bfloat16, vae_card)):
        model, step = make_step(torch, R, args, d, dt, vae, pp, lr)
        m = step(to_device(host, d), 0)
        out[name] = ({k: v.item() for k, v in m.items()},
                     {n: p.grad.detach().float().cpu() for n, p in model.named_parameters()})
        del model, step
    ref_m, ref_g = out["cpu_f32"]
    loss_rel = {n: abs(out[n][0]["loss"] - ref_m["loss"]) / abs(ref_m["loss"])
                for n in ("card_f32", "card_bf16")}
    grad_rel = {n: rel_l2(torch, g, ref_g[n]) for n, g in out["card_f32"][1].items()}
    worst = max(grad_rel, key=grad_rel.get)
    say("train_step_check", model="pt_vit", embed_dim=args.transformer_emb, depth=2,
        heads=args.transformer_heads, batch=8, metrics={n: v[0] for n, v in out.items()},
        loss_rel=loss_rel, grad_rel_l2_max=grad_rel[worst], grad_rel_l2_worst_param=worst,
        bounds=dict(f32_loss=STEP_F32_LOSS_REL, f32_grad=STEP_F32_GRAD_REL,
                    bf16_loss=STEP_BF16_LOSS_REL))
    check(all(np.isfinite(v) for v in ref_m.values()), "CPU step metrics not finite")
    check(loss_rel["card_f32"] <= STEP_F32_LOSS_REL, f"f32 step loss rel {loss_rel}")
    check(grad_rel[worst] <= STEP_F32_GRAD_REL, f"f32 grad {worst} rel L2 {grad_rel[worst]}")
    check(loss_rel["card_bf16"] <= STEP_BF16_LOSS_REL, f"bf16 step loss rel {loss_rel}")
    torch.cuda.empty_cache()


def run_training_cli(torch, flags):
    """Phase 7: the pretraining CLI at full width on the card, 2 epochs with a
    checkpoint each, then an auto-resumed third epoch. Returns the launch
    counts of the first run."""
    from mem_tpu_torch.cli import run_mem_pretraining as R
    from mem_tpu_torch.kernels import launch_counts, reset_launch_counts

    out_dir = flags[flags.index("--output_dir") + 1]
    common = flags + ["--batch_size", "64", "--save_ckpt_freq", "1", "--warmup_steps", "2",
                      "--device", "cuda"]
    t0 = time.perf_counter()
    reset_launch_counts()                 # just before the main path
    hist = R.main(common + ["--epochs", "2"])
    counts = launch_counts()              # just after it
    t1 = time.perf_counter()
    written = sorted(os.listdir(out_dir))
    resumed = R.main(common + ["--epochs", "3"])
    t2 = time.perf_counter()
    say("train_cli", model="pt_vit", embed_dim=768, depth=12, heads=12, batch=64,
        steps=len(hist), losses=[h[1] for h in hist], mlm_acc=[h[2] for h in hist],
        grad_norm=[h[3] for h in hist], checkpoints=written, launches=counts,
        resumed_steps=[h[0] for h in resumed], resumed_losses=[h[1] for h in resumed],
        seconds=[round(t1 - t0, 2), round(t2 - t1, 2)])
    check(len(hist) == 4 and all(np.isfinite(h[1]) for h in hist + resumed),
          f"training losses {hist} {resumed}")
    check({"checkpoint-0.pth", "checkpoint-1.pth", "checkpoint-final.pth"} <= set(written),
          f"checkpoints {written}")
    check([h[0] for h in resumed] == [4, 5], f"auto-resume ran steps {resumed}")
    check(os.path.exists(os.path.join(out_dir, "checkpoint-2.pth")), "no checkpoint-2.pth")
    for name in ("hist_planes_cols", "fused_attention_flat", "fused_attention_flat_bwd"):
        check(counts.get(name, 0) > 0, f"the training path launched no {name} kernel")
    return counts


def time_training(torch, dev, gpu, flags):
    """Phase 8: K2b against its plain version at the training shape (B=64,
    in turns: plain, kernel, kernel, plain), and the full-width pt_vit train
    step (depth 12, bf16, the conf's recipe) at B=64 and B=128: 15 steps on
    one repeated batch with no lr warm-up (the loss must fall by LOSS_FALL
    at B=64), the median of the last 12 timed by CUDA events, and the peak
    device memory. Returns K2b's and its plain version's mean ms."""
    from mem_tpu_torch.cli import run_mem_pretraining as R
    from mem_tpu_torch.data.prefetch import to_device
    from mem_tpu_torch.ops.attention import (fused_attention_flat_bwd,
                                             fused_attention_flat_bwd_reference)
    from mem_tpu_torch.train.schedules import cosine_scheduler

    q, k, v, do = (torch.randn(64, 197, 768, device=dev, dtype=torch.bfloat16)
                   for _ in range(4))
    bias = torch.randn(12, 197, 197, device=dev)
    plain = lambda: fused_attention_flat_bwd_reference(q, k, v, bias, do, 0.125)  # noqa: E731
    kernel = lambda: fused_attention_flat_bwd(q, k, v, bias, do, 0.125)  # noqa: E731
    tp = [time_ms(torch, plain, runs=20)]
    tk = [time_ms(torch, kernel, runs=20), time_ms(torch, kernel, runs=20)]
    tp.append(time_ms(torch, plain, runs=20))
    flop = 5 * 2 * 64 * 12 * 197 * 197 * 64
    say("time_k2b", gpu=gpu, batch=64, shape=[197, 12, 64], dtype="bfloat16", kernel_ms=tk,
        plain_ms=tp, kernel_tflop_s=flop / statistics.mean(tk) / 1e9)
    del q, k, v, do, bias

    args = R.get_args(flags + ["--device", "cuda"])
    vae = R.load_vae(args, dev)
    steps, warm = 15, 3
    lr = cosine_scheduler(args.lr, args.min_lr, 1, steps, warmup_steps=0)
    for B in (64, 128):
        pp, host = host_train_batch(args, B)
        model, step = make_step(torch, R, args, dev, torch.bfloat16, vae, pp, lr)
        batch = to_device(host, dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        events, metrics = [], []
        for i in range(steps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            metrics.append(step(batch, i))
            end.record()
            events.append((start, end))
        torch.cuda.synchronize()
        ms = statistics.median(a.elapsed_time(b) for a, b in events[warm:])
        losses = [m["loss"].item() for m in metrics]
        say("time_train_step", gpu=gpu, batch=B, model="pt_vit", embed_dim=768, depth=12,
            heads=12, dtype="bfloat16", ms=ms, samples_per_s=B / ms * 1e3,
            peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
            losses=losses, mlm_acc_last=metrics[-1]["mlm_acc"].item(),
            grad_norm_last=metrics[-1]["grad_norm"].item())
        check(all(np.isfinite(losses)), f"B={B}: non-finite losses {losses}")
        if B == 64:
            check(losses[-1] <= losses[0] - LOSS_FALL,
                  f"the loss fell from {losses[0]} to {losses[-1]}, less than {LOSS_FALL}")
        del model, step, batch, metrics
        torch.cuda.empty_cache()
    return statistics.mean(tk), statistics.mean(tp)


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

"""The multi-GPU phases of the card check (``mp_worker chip``, two processes):
the placements of parallel/mesh.py at the full width of the pretraining
recipe (configs/ncaltech.conf: pt_vit ViT-B/16, vocab 8192, the seeded f32
VAE tokenizer at the conf's size), and the seg step of the segmentation
recipe, on the card.

- ``chip1`` (rank 0 alone, before the two processes meet): a world-size-1
  NCCL group of its own, destroyed after. Three pretraining
  steps at B = 64 (bf16) without a group, then the same three steps under DP,
  ZeRO-1, FSDP and TP (a one-rank "model" group: the TP code path with every
  head on the rank) from the same seeded weights and batches. DP and ZeRO-1
  must be bit-equal to the steps without a group; FSDP and TP's f32 weights
  within a relative L2 of 1e-6 (their norm is the square root of an
  all-reduced sum of squares, a rounding off the plain norm, which moves the
  clip factor). Each mode's per-step ms and peak memory are reported. Then
  the optimizers whose update reads a whole-tensor statistic under FSDP and
  TP (``OPT_PAIRS``, the first ``OPT_DEPTH`` blocks, the tokenizer's codes
  fixed) and the MAE
  (mae_vit_base_patch16_dec512d8b, B = 128) at TP, each against the same
  steps without a group: bit-equal (a group of one reduces nothing, and
  the statistics of a tensor cut into one piece are the plain ones).
- ``chip2``: the two processes on ``cuda:0`` over Gloo (NCCL refuses two ranks
  on one device; the Gloo backend carries the CUDA tensors through host
  memory, so its times are no multi-GPU throughput). Rank 0 first runs the
  single-process references. The DP step: f32 (TF32 off) at B = 2 x 32
  against 64 on one process, the tokenizer's codes fixed from the global
  batch, step-0 gradients within a relative L2 of ``DP_GRAD_REL``; a
  planted per-rank loss mean must miss it. The TP step: tp = 2 (K2f / K2b
  at 6 heads, FUSED_MLP's K6f / K6b at hidden 1,536), bf16 at B = 16
  against one process, gradients within ``TP_GRAD_REL``; fc2's bias added on
  both ranks must miss it. The seg step under DP: the full-width segmentor
  (EvBEiT ViT-B/16 at 512^2, its first six blocks, UPerNet) in f32 at
  B = 2 x 2 against 4, the PSP BatchNorms damped (eps 0.1), gradients within
  ``SEG_GRAD_REL`` (the seg train step's card-vs-CPU gradient gate); an
  unsynced BatchNorm must miss it. The whole-tensor optimizers: Adafactor
  and AdamP at tp = 2 and Adafactor under FSDP (2 x 8), f32 (TF32 off) at
  B = 16, two steps against one process: every tensor's displacement
  within ``OPT_REL`` relative L2, and each with its statistic taken over
  the rank's shard alone (the ``local_stat`` fault), which must miss it.
  The MAE at tp = 2 (bf16, B = 16, its blocks' fc1 / fc2 cut): step-0
  gradients within ``TP_GRAD_REL``; fc2's bias added on both ranks must
  miss it. Every process reports its launch counts, step ms and peak
  memory.

Each rank writes ``chip1_r0.json`` / ``chip2_r<rank>.json`` into the workdir.
"""
from __future__ import annotations

import json
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from mem_tpu_torch.parallel import mesh as M
from mem_tpu_torch.tools.mp_worker import FSDP_OPTS, LOOKAHEAD_K, TP_OPTS

CHIP1_B, CHIP2_DP_B, CHIP2_TP_B, CHIP2_SEG_B = 64, 64, 16, 4
SEG_DEPTH = 6           # blocks of the seg step (full width; the last four tapped)
STEPS = 3
FSDP_TP_REL = 1e-6      # chip1: FSDP's and TP's f32 weights against no group
DP_GRAD_REL = 1e-4      # chip2: f32 step-0 gradients, 2 x 32 against 64
TP_GRAD_REL = 2e-2      # chip2: bf16 step-0 gradients, tp = 2 against one process
SEG_GRAD_REL = 5e-3     # chip2: f32 seg step-0 gradients, 2 x 2 against 4: chip_smoke's
                        # seg gradient gate (SEG_STEP_F32_GRAD_REL): every BatchNorm's fast
                        # variance cancels in f32, and summed in two halves it rounds
                        # otherwise (1.15e-4 in a first run; an unsynced BatchNorm 0.116)
BIAS_STD = 0.1          # the seeded biases (a bias added twice must show)
CHIP1_MAE_B, CHIP2_OPT_B = 128, 16
OPT_DEPTH = 4           # blocks of chip1's (placement, optimizer) runs (full width; bit-equal
                        # at any depth: every statistic is per tensor), cut from 12 to keep the
                        # card check within a minute of its earlier length
OPT_REL = 1e-4          # chip2: f32 displacement of every tensor after two steps, relative L2
# chip1: (mode, --opt) pairs against no group, the CPU launch's sets
OPT_PAIRS = (tuple(("fsdp", o) for o in FSDP_OPTS) + tuple(("tp1", o) for o in TP_OPTS))
CHIP2_OPT_RUNS = {      # tag -> (mode, --opt, fault)
    "tp_adafactor": ("tp", "adafactor", None),
    "tp_adafactor_fault": ("tp", "adafactor", "local_stat"),
    "tp_adamp": ("tp", "adamp", None),
    "tp_adamp_fault": ("tp", "adamp", "local_stat"),
    "fsdp_adafactor": ("fsdp", "adafactor", None),
    "fsdp_adafactor_fault": ("fsdp", "adafactor", "local_stat"),
}


def _args(extra=()):
    from mem_tpu_torch.cli import run_mem_pretraining as R

    return R.get_args(["--config", "configs/ncaltech.conf", "--data_path", "ncaltech101",
                       "--drop_path", "0", "--num_workers", "0", *extra])


def _vae(device):
    from mem_tpu_torch.models.discrete_vae import DiscreteVAE

    vae = DiscreteVAE((224, 224), num_tokens=8192, codebook_dim=32, num_layers=4,
                      num_resnet_blocks=3, hidden_dim=384)
    vae.init_weights(torch.Generator().manual_seed(0))   # its convolutions' init draws on the CPU
    return vae.to(device).eval().requires_grad_(False)


def host_batches(args, B: int, steps: int, seed: int = 0):
    """Full-size host batches (30,000 N-Caltech-like events a sample on the
    256^2 canvas, block masks on the 14 x 14 grid, the training draws). The
    first half of each batch masks 60 patches, the second half the conf's 98:
    the model's head keeps 98 masked positions a sample, so only a batch
    whose halves mask fewer and more than that gives two ranks different
    masked counts (and a per-rank mean another loss)."""
    from mem_tpu_torch.cli.common import build_preproc
    from mem_tpu_torch.data.device_pipeline import draw_train_aug
    from mem_tpu_torch.ops.masking import make_mask_generator

    pp = build_preproc(args, True, color_jitter=args.color_jitter)
    rng = np.random.default_rng(seed)
    masks = [make_mask_generator("block", (14, 14), n,
                                 min_num_patches=args.min_mask_patches_per_block)
             for n in (60, args.num_mask_patches)]
    out = []
    for s in range(steps):
        n = 30_000
        ev = np.zeros((B, n, 4), np.float32)
        for b in range(B):
            w, h = int(rng.integers(160, 241)), int(rng.integers(120, 181))
            ev[b, :, 0] = rng.integers(0, w, n)
            ev[b, :, 1] = rng.integers(0, h, n)
            ev[b, :, 2] = np.sort(rng.integers(0, 300_000, n))
            ev[b, :, 3] = rng.choice([-1.0, 1.0], n)
        batch = {"events": ev, "n_valid": np.full(B, n, np.int32),
                 "sample_h": np.full(B, 180, np.int32), "sample_w": np.full(B, 240, np.int32),
                 "time_flip": rng.random(B) < 0.5, "x_flip": rng.random(B) < 0.5,
                 "shift_xy": rng.integers(-8, 9, (B, 2)).astype(np.int32),
                 "aug_seed": (np.arange(B) + 1000 * s).astype(np.uint32),
                 "mask": np.stack([masks[b >= B // 2](rng).reshape(-1).astype(bool)
                                   for b in range(B)])}
        batch.update(draw_train_aug(batch["aug_seed"], pp, pp.canvas_h, pp.canvas_w))
        batch.pop("aug_seed")
        out.append(batch)
    return pp, out


def codes(vae, pp, batches, device) -> list:
    """The tokenizer's codes of each global batch's training images."""
    from mem_tpu_torch.data.device_pipeline import preprocess_batch

    with torch.no_grad():
        return [vae.get_codebook_indices(preprocess_batch(
            M.shard_batch(b, None, device=device), pp, is_train=True)) for b in batches]


class FixedTokens:
    """A tokenizer stand-in that hands step t this rank's rows of the codes
    computed once on global batch t (the tokenizer's own argmax may flip
    between batch sizes)."""

    def __init__(self, ids, rows=slice(None)):
        self.ids, self.rows, self.t = ids, rows, 0

    def get_codebook_indices(self, images):
        out = self.ids[self.t % len(self.ids)][self.rows]
        self.t += 1
        return out


def _seed_biases(model, device):
    with torch.no_grad():
        g = torch.Generator(device=device).manual_seed(4)
        for p in model.parameters():
            if p.ndim == 1:
                p.add_(BIAS_STD * torch.randn(p.shape, generator=g, device=device))


def seeded_model(args, dtype, device):
    """The CLI's model (pt_vit, or the MAE with ``--MAE 1``) from the seeded
    init, its 1-D parameters moved off 0 / 1."""
    from mem_tpu_torch.cli import run_mem_pretraining as R

    model = R.build_model(args, dtype, device)
    model.init_weights(torch.Generator(device=device).manual_seed(args.seed))
    _seed_biases(model, device)
    return model


def pretrain_run(args, dtype, pp, batches, vae, mesh=None, mode="single", device="cuda",
                 fault=None, grads_only=False, opt_name="adamw"):
    """A pretraining step (the MAE's with ``--MAE 1``; ``vae`` unused) with
    ``opt_name`` on each of ``batches`` from the seeded weights; returns the
    metrics, the step-0 gradients (``grads_only``: and no weights) or the
    f32 weights after, the launch counts of the steps, the ms of every step
    after the first and the peak memory."""
    from mem_tpu_torch.kernels import launch_counts, reset_launch_counts
    from mem_tpu_torch.tools.mp_worker import _faulty, _full_grads
    from mem_tpu_torch.train.optim import create_optimizer
    from mem_tpu_torch.train.steps import make_mae_train_step, make_pretrain_train_step

    torch.cuda.reset_peak_memory_stats(device)
    model = seeded_model(args, dtype, device)
    opt = create_optimizer(model, args.lr, args.weight_decay, opt=opt_name)
    if hasattr(opt, "k"):       # Lookahead syncs within the three steps
        opt.k = LOOKAHEAD_K
    placement = None
    if mode == "tp1":           # the TP code path on a one-rank "model" group
        placement = M.place_tensor_parallel(model, opt, mesh)
    elif mode != "single":
        placement = M.place_train_state(model, opt, mesh, tp=2 if mode == "tp" else 1,
                                        zero1=mode == "zero1", fsdp=mode == "fsdp")
    steps = len(batches)
    lr = np.full(steps, args.lr)
    wd = np.full(steps, args.weight_decay)
    if args.MAE:
        step = make_mae_train_step(model, opt, pp, lr, wd, args.clip_grad, args.seed,
                                   placement=placement)
    else:
        step = make_pretrain_train_step(model, vae, opt, pp, lr, wd, args.clip_grad, args.seed,
                                        placement=placement)
    metrics, grads, ms = [], None, []
    reset_launch_counts()
    with _faulty(fault):
        for t, b in enumerate(batches):
            if args.MAE:
                b = {k: v for k, v in b.items() if k != "mask"}
            batch = M.shard_batch(b, mesh if mode in ("dp", "fsdp") else None,
                                  device=device, global_batch=True)
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            m = step(batch, t)
            torch.cuda.synchronize(device)
            ms.append((time.perf_counter() - t0) * 1e3)
            metrics.append({k: float(v) for k, v in m.items()})
            if t == 0 and grads_only:
                grads = {k: torch.from_numpy(v) for k, v in _full_grads(model, placement).items()}
    counts = launch_counts()
    weights = None
    if not grads_only:
        sd = placement.model_state_dict(model) if placement is not None else model.state_dict()
        weights = {k: v.detach().float().cpu() for k, v in sd.items()}
    return {"metrics": metrics, "grads": grads, "weights": weights, "launches": counts,
            "step_ms": ms[1:],
            "peak_gb": torch.cuda.max_memory_allocated(device) / 2**30,
            "mode": placement.mode if placement is not None else "single"}


def worst_displacement(got: dict, want: dict, start: dict) -> tuple:
    """(name, relative L2) of the tensor whose displacement from ``start``
    in ``got`` misses ``want``'s most."""
    worst = ("", 0.0)
    for k, w in want.items():
        d_want = w.double() - start[k].double()
        num = float((got[k].double() - start[k].double() - d_want).norm())
        den = float(d_want.norm())
        rel = num / den if den > 0 else num
        if rel > worst[1]:
            worst = (k, rel)
    return worst


def rel_l2(a: dict, b: dict) -> float:
    num = sum(float(((a[k].double() - b[k].double()) ** 2).sum()) for k in b)
    den = sum(float((b[k].double() ** 2).sum()) for k in b)
    return (num / max(den, 1e-300)) ** 0.5


def bit_equal(a: dict, b: dict) -> bool:
    return set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in b)


def _gpu_line():
    import subprocess

    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip().splitlines()[0]
    except Exception:
        return f"{torch.cuda.get_device_name(0)}, power limit not read"


def chip1(workdir: str) -> dict:
    """World-size-1 NCCL group: DP, ZeRO-1, FSDP, TP against no group."""
    t_start = time.perf_counter()
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    args = _args()
    pp, batches = host_batches(args, CHIP1_B, STEPS)
    vae = _vae(device)
    ref = pretrain_run(args, torch.bfloat16, pp, batches, vae, device=device)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{M_port()}", world_size=1,
                            rank=0, device_id=device)
    out = {"gpu": _gpu_line(), "batch": CHIP1_B, "steps": STEPS, "backend": "nccl",
           "single": {k: ref[k] for k in ("metrics", "step_ms", "peak_gb", "launches")},
           "modes": {}}
    seconds = {"single": round(time.perf_counter() - t_start, 2)}
    for mode in ("dp", "zero1", "fsdp", "tp1"):
        t0 = time.perf_counter()
        r = pretrain_run(args, torch.bfloat16, pp, batches, vae, mesh=_world1_mesh(mode),
                         mode=mode, device=device)
        out["modes"][mode] = _against(r, ref)
        del r
        torch.cuda.empty_cache()
        seconds[mode] = round(time.perf_counter() - t0, 2)
        _progress(f"world1 {mode}", t_start)
    del ref
    t0 = time.perf_counter()
    tokens = codes(vae, pp, batches, device)
    opt_args = _args(["--transformer_depth", str(OPT_DEPTH)])
    out["opt_pairs"] = {}
    for opt_name in dict.fromkeys(o for _, o in OPT_PAIRS):
        base = pretrain_run(opt_args, torch.bfloat16, pp, batches, FixedTokens(tokens),
                            device=device, opt_name=opt_name)
        for mode in (m for m, o in OPT_PAIRS if o == opt_name):
            r = pretrain_run(opt_args, torch.bfloat16, pp, batches, FixedTokens(tokens),
                             mesh=_world1_mesh(mode), mode=mode, device=device, opt_name=opt_name)
            out["opt_pairs"][f"{mode}_{opt_name}"] = _against(r, base)
            _progress(f"world1 {mode}_{opt_name}", t_start)
        del base
    seconds["opt_pairs"], t0 = round(time.perf_counter() - t0, 2), time.perf_counter()
    mae_args = _args(["--MAE", "1"])
    mae_pp, mae_batches = host_batches(mae_args, CHIP1_MAE_B, STEPS, seed=3)
    base = pretrain_run(mae_args, torch.bfloat16, mae_pp, mae_batches, None, device=device)
    r = pretrain_run(mae_args, torch.bfloat16, mae_pp, mae_batches, None,
                     mesh=_world1_mesh("tp1"), mode="tp1", device=device)
    out["mae_tp1"] = dict(_against(r, base), batch=CHIP1_MAE_B,
                          single_step_ms=base["step_ms"], single_peak_gb=base["peak_gb"])
    seconds["mae_tp1"] = round(time.perf_counter() - t0, 2)
    _progress("world1 mae_tp1", t_start)
    out["seconds"] = seconds
    dist.destroy_process_group()
    return out


def _world1_mesh(mode):
    """The world-size-1 group's mesh of ``mode``: ("data",), or a one-rank
    "model" axis for the TP code path."""
    if mode == "tp1":
        from torch.distributed.device_mesh import init_device_mesh

        return init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
    return M.get_mesh(device_type="cuda")


def _against(r: dict, base: dict) -> dict:
    """A placed run's reading against the same steps without a group."""
    return {"placement": r["mode"], "metrics": r["metrics"], "step_ms": r["step_ms"],
            "peak_gb": r["peak_gb"], "launches": r["launches"],
            "bit_equal": bit_equal(r["weights"], base["weights"]),
            "weights_rel_l2": rel_l2(r["weights"], base["weights"]),
            "loss_equal": [a["loss"] == b["loss"] for a, b in zip(r["metrics"],
                                                                 base["metrics"])]}


def _progress(what: str, t0: float) -> None:
    print(f"mp_chip r{M.launch_env()[1]}: {what} {time.perf_counter() - t0:.1f} s", flush=True)


def M_port() -> int:
    from mem_tpu_torch.tools.mp_worker import free_port

    return free_port()


def _seg_run(device, batches, mesh=None, fault=None, B=CHIP2_SEG_B):
    """Full-width seg train steps on ``batches`` (f32, damped PSP
    BatchNorms): the step-0 loss and gradients, the launch counts, the last
    step's ms, the peak memory."""
    from mem_tpu_torch.kernels import launch_counts, reset_launch_counts
    from mem_tpu_torch.models.segmentation import build_segmentor
    from mem_tpu_torch.tools.mp_worker import damp_psp, _full_grads
    from mem_tpu_torch.train.optim import create_optimizer
    from mem_tpu_torch.train.steps import make_seg_steps

    torch.cuda.reset_peak_memory_stats(device)
    model = build_segmentor(11, 512, 768, SEG_DEPTH, 12, torch.float32, device,
                            drop_path_rate=0.0, dropout_ratio=0.0)
    model.init_weights(torch.Generator(device=device).manual_seed(3))
    _seed_biases(model, device)
    damp_psp(model)
    opt = create_optimizer(model, 1e-4, 0.05, layer_decay=0.65, num_layers=SEG_DEPTH,
                           betas=(0.9, 0.999))
    placement = M.place_train_state(model, opt, mesh) if mesh is not None else None
    if fault == "unsynced_bn":
        M._set_bn_group(model, None)
    step, _ = make_seg_steps(model, opt, lambda it: 1e-4, 0.05, 11, False, y_sorted=True,
                             placement=placement)
    reset_launch_counts()
    ms, losses, grads = [], [], None
    for t, b in enumerate(batches):
        batch = M.shard_batch(b, mesh, device=device, global_batch=True)
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        m = step(batch, t)
        torch.cuda.synchronize(device)
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
        if t == 0:
            grads = {k: torch.from_numpy(v) for k, v in _full_grads(model, placement).items()}
    return {"loss": losses[0], "ms": ms[-1], "launches": launch_counts(),
            "peak_gb": torch.cuda.max_memory_allocated(device) / 2**30, "grads": grads}


def chip2(workdir: str) -> dict:
    """Two processes on cuda:0 over Gloo: DP (f32), TP (bf16, tp = 2) and
    the seg step under DP, each with its planted fault."""
    from mem_tpu_torch.models import vit
    from mem_tpu_torch.ops.mlp import kernel_route
    from mem_tpu_torch.tools.mp_worker import seg_batches

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    seconds, t0 = {}, time.perf_counter()
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    _, rank, _ = M.launch_env()
    os.environ["LOCAL_RANK"] = "0"      # both processes on the one card
    if rank != 0:   # wait for rank 0's world-size-1 phase and references
        M.init_distributed("cuda", backend="gloo")
    # per-sample RandAugment ops: the batch-level op choice is drawn per
    # process batch, so 2 x 32 and 64 would differ by design
    args = _args(["--dtype", "float32", "--rand_aug_batch_ops", "0"])
    pp, dp_batches = host_batches(args, CHIP2_DP_B, 2)
    vae = _vae(device)
    tp_args = _args()
    tp_pp, tp_batches = host_batches(tp_args, CHIP2_TP_B, 2, seed=1)
    opt_pp, opt_batches = host_batches(args, CHIP2_OPT_B, 2, seed=2)
    ids, tp_ids, opt_ids = (codes(vae, p_, bs, device) for p_, bs in (
        (pp, dp_batches), (tp_pp, tp_batches), (opt_pp, opt_batches)))
    del vae
    mae_args = _args(["--MAE", "1"])
    mae_pp, mae_batches = host_batches(mae_args, CHIP2_TP_B, 2, seed=4)
    seg_b = seg_batches(CHIP2_SEG_B, 2, 180_000)
    seconds["inputs"] = round(time.perf_counter() - t0, 2)
    out = {"gpu": _gpu_line(), "rank": rank, "backend": "gloo", "device": str(device)}
    refs = {}
    if rank == 0:   # the single-process references, before the group forms
        refs["dp"] = pretrain_run(args, torch.float32, pp, dp_batches, FixedTokens(ids),
                                  device=device, grads_only=True)
        vit.FUSED_MLP = True
        refs["tp"] = pretrain_run(tp_args, torch.bfloat16, tp_pp, tp_batches,
                                  FixedTokens(tp_ids), device=device, grads_only=True)
        vit.FUSED_MLP = False
        refs["seg"] = _seg_run(device, seg_b)
        for opt_name in ("adafactor", "adamp"):
            refs[f"opt_{opt_name}"] = pretrain_run(args, torch.float32, opt_pp, opt_batches,
                                                   FixedTokens(opt_ids), device=device,
                                                   opt_name=opt_name)
        refs["mae_tp"] = pretrain_run(mae_args, torch.bfloat16, mae_pp, mae_batches, None,
                                      device=device, grads_only=True)
        start = {k: v.detach().float().cpu() for k, v in
                 seeded_model(args, torch.float32, device).state_dict().items()}
        torch.cuda.empty_cache()
        seconds["references"] = round(time.perf_counter() - t0 - seconds["inputs"], 2)
        M.init_distributed("cuda", backend="gloo")
    dist.barrier()
    mesh = M.get_mesh(device_type="cuda")
    n, r = dist.get_world_size(), dist.get_rank()

    def half_of(B):
        return slice(r * B // n, (r + 1) * B // n)

    half = half_of(CHIP2_DP_B)
    res = {}
    t_group = t0 = time.perf_counter()
    for tag, fault in (("dp", None), ("dp_fault", "rank_mean")):
        res[tag] = pretrain_run(args, torch.float32, pp, dp_batches, FixedTokens(ids, half),
                                mesh=mesh, mode="dp", device=device, fault=fault,
                                grads_only=True)
    seconds["dp"], t0 = round(time.perf_counter() - t0, 2), time.perf_counter()
    tp_mesh = M.get_mesh(tp=2, device_type="cuda")
    vit.FUSED_MLP = True
    try:
        for tag, fault in (("tp", None), ("tp_fault", "fc2_bias_per_rank")):
            res[tag] = pretrain_run(tp_args, torch.bfloat16, tp_pp, tp_batches,
                                    FixedTokens(tp_ids), mesh=tp_mesh, mode="tp",
                                    device=device, fault=fault, grads_only=True)
    finally:
        vit.FUSED_MLP = False
    seconds["tp"], t0 = round(time.perf_counter() - t0, 2), time.perf_counter()
    for tag, fault in (("seg", None), ("seg_fault", "unsynced_bn")):
        res[tag] = _seg_run(device, seg_b, mesh=mesh, fault=fault)
    seconds["seg"], t0 = round(time.perf_counter() - t0, 2), time.perf_counter()
    _progress("two-process dp, tp, seg", t_group)
    for tag, fault in (("mae_tp", None), ("mae_tp_fault", "fc2_bias_per_rank")):
        res[tag] = pretrain_run(mae_args, torch.bfloat16, mae_pp, mae_batches, None,
                                mesh=tp_mesh, mode="tp", device=device, fault=fault,
                                grads_only=True)
    seconds["mae_tp"], t0 = round(time.perf_counter() - t0, 2), time.perf_counter()
    _progress("two-process mae_tp", t_group)
    for tag, (mode, opt_name, fault) in CHIP2_OPT_RUNS.items():
        res[tag] = pretrain_run(args, torch.float32, opt_pp, opt_batches,
                                FixedTokens(opt_ids, half_of(CHIP2_OPT_B) if mode == "fsdp"
                                            else slice(None)),
                                mesh=tp_mesh if mode == "tp" else mesh, mode=mode,
                                device=device, fault=fault, opt_name=opt_name)
        _progress(f"two-process {tag}", t_group)
    seconds["optimizers"] = round(time.perf_counter() - t0, 2)
    out["seconds"] = seconds
    out["routes"] = {"tp_heads": tp_args.transformer_heads // 2,
                     "tp_k6_route": kernel_route(torch.bfloat16, 768, 3072 // 2),
                     "hb_eligible_6_heads": bool(__import__(
                         "mem_tpu_torch.ops.attention", fromlist=["_hb_eligible"])
                         ._hb_eligible(6, 197))}
    for tag, r_ in res.items():
        out[tag] = {k: r_[k] for k in ("launches", "peak_gb") if k in r_}
        out[tag]["ms"] = r_.get("ms", (r_.get("step_ms") or [None])[0])
        out[tag]["loss"] = r_.get("loss", (r_.get("metrics") or [{}])[0].get("loss"))
    if rank == 0:
        for tag, (_, opt_name, _) in CHIP2_OPT_RUNS.items():
            out[tag]["worst_displacement"] = worst_displacement(
                res[tag]["weights"], refs[f"opt_{opt_name}"]["weights"], start)
        for tag, ref in (("dp", refs["dp"]), ("dp_fault", refs["dp"]), ("tp", refs["tp"]),
                         ("tp_fault", refs["tp"]), ("seg", refs["seg"]),
                         ("seg_fault", refs["seg"]), ("mae_tp", refs["mae_tp"]),
                         ("mae_tp_fault", refs["mae_tp"])):
            out[tag]["grad_rel_l2"] = rel_l2(res[tag]["grads"], ref["grads"])
            ref_loss = ref.get("loss", (ref.get("metrics") or [{}])[0].get("loss"))
            out[tag]["loss_rel"] = abs(out[tag]["loss"] - ref_loss) / abs(ref_loss)
        out["single"] = {tag: {"ms": ref.get("ms", (ref.get("step_ms") or [None])[0]),
                               "peak_gb": ref["peak_gb"], "launches": ref["launches"]}
                         for tag, ref in refs.items()}
    dist.barrier()
    dist.destroy_process_group()
    return out


def main(mode: str, workdir: str, opts: dict) -> int:
    """``chip``: two processes; rank 0 runs :func:`chip1` alone while rank 1
    waits at the Gloo rendezvous, then both run :func:`chip2`."""
    if mode != "chip":
        raise SystemExit(f"unknown mode {mode!r}")
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True, warn_only=True)
    _, rank, _ = M.launch_env()
    results = {}
    if rank == 0:
        results["chip1"] = chip1(workdir)
    results["chip2"] = chip2(workdir)
    for name, out in results.items():
        with open(os.path.join(workdir, f"{name}_r{rank}.json"), "w") as f:
            json.dump(out, f, default=float)
    print(f"mp_chip r{rank} OK", flush=True)
    return 0

"""Matched-trajectory runners of the port: the six stages of the JAX
package's scripts/parity_trajectory.py, each driven through the port's
production code, and the reductions of the three trajectory instruments
(parity_trajectory.py's divergence onset, parity_finetune_envelope.py's
smoothing and seed envelope, parity_bf16_drift.py's windowed gaps). It
imports torch and numpy only.

Stages (each runner returns its per-step curves and the trained model):

- ``run_vae`` (stage 0, parity_trajectory.py:100): the discrete VAE through
  ``make_vae_train_step`` with injected Gumbel noise, plain Adam, the clip
  and one ``VaeAnnealState`` (the reference's per-10k-steps quirk).
- ``run_pretrain`` (stage A, :182): masked event modeling through
  ``make_pretrain_train_step`` with a frozen VAE tokenizer, AdamW (0.9, 0.95),
  the cosine lr schedule and clip 3.0.
- ``run_finetune`` (stage B, :265): stage A's weights through
  ``surgery_for_finetune`` into ``ft_vit``, ``make_finetune_train_step``
  (layer decay 0.9, label smoothing 0.1) and ``make_finetune_eval_step``
  each epoch (top-1).
- ``run_seg`` (stage C, :600): EvBEiT + UPerNet through ``make_seg_steps``
  on ``SegBatchIterator`` batches (poly lr, layer decay 0.65); mIoU through
  the eval step, BatchNorm running statistics in use.
- ``run_mae`` (stage D, :374): the MAE through ``make_mae_train_step``.
- ``run_mae_finetune`` (stage E, :461): stage D's encoder through
  ``surgery_for_mae_finetune`` into the global-pool classifier.

The reference's pins hold: fresh masks (``mask_pool_size=0``), f32 unless a
runner is asked for bf16, mixup, EMA and RandAugment off, dropout and
drop-path 0. Widths default to the reference's (IMG 32, PATCH 8, DIM 64,
DEPTH 4, HEADS 4, VOCAB 64, B 16) and are a :class:`Geometry`, so the same
runner drives ViT-B at full width.

What a caller injects, so that two frameworks can see the same thing:

- initial weights, as state_dicts (``mem_tpu_torch.utils.weights``
  converts another framework's trees);
- the device randomness of the steps (``noise``): the VAE's Gumbel noise
  (the reference harness draws it on the host, :func:`gumbel_noise`) and
  the MAE's shuffle noise (the JAX step draws it from its mask key);
- per-step images, through the steps' existing view hooks (``images``):
  stages 0, A, B and E take them (the VAE and finetune steps' ``image``
  batch through ``image_preproc``, the pretraining step's ``patches`` /
  ``vae_view``); stages C and D run the port's own preprocessing (their
  steps have no such hook, and under the pins the preprocessing draws
  nothing on the device).

Entry points run on the card unless the caller asks for the CPU
(``device="cpu"``).
"""
from __future__ import annotations

import dataclasses
import itertools
import os
import time

import numpy as np
import torch

from mem_tpu_torch.data.device_pipeline import PreprocConfig, with_train_draws
from mem_tpu_torch.data.folder import NpyFolder, caltech_npy_loader
from mem_tpu_torch.data.pipeline import EventBatchIterator, PipelineConfig
from mem_tpu_torch.data.prefetch import device_prefetch, prefetch, to_device
from mem_tpu_torch.models.discrete_vae import DiscreteVAE
from mem_tpu_torch.models.registry import create_model
from mem_tpu_torch.train import optim
from mem_tpu_torch.train.schedules import VaeAnnealState, cosine_scheduler, poly_lr_schedule
from mem_tpu_torch.train.steps import (make_finetune_eval_step, make_finetune_train_step,
                                       make_mae_train_step, make_pretrain_train_step,
                                       make_seg_steps, make_vae_train_step)
from mem_tpu_torch.utils.surgery import surgery_for_finetune, surgery_for_mae_finetune


@dataclasses.dataclass(frozen=True)
class Geometry:
    """The model and batch widths of a trajectory (parity_trajectory.py:49-53)."""
    img: int = 32
    patch: int = 8
    dim: int = 64
    depth: int = 4
    heads: int = 4
    vocab: int = 64
    batch: int = 16
    classes: int = 4
    canvas: int = 64
    slice_max_evs: int = 256

    @property
    def grid(self) -> int:
        return self.img // self.patch


# the tokenizer of stages 0 and A (parity_trajectory.py:124-131, 204-210)
VAE_KW = dict(codebook_dim=8, num_layers=3, num_resnet_blocks=1, hidden_dim=16)
MAE_DECODER = dict(decoder_embed_dim=32, decoder_depth=1, decoder_num_heads=2)
SEG_NCLS, SEG_DIM, SEG_DEPTH, SEG_B = 3, 32, 2, 4
SEG_HEADS = dict(head_channels=32, aux_channels=16, dropout_ratio=0.0)


def seg_backbone() -> dict:
    """The harness's EvBEiT (parity_trajectory.py:639-645)."""
    return dict(img_size=64, patch_size=16, embed_dim=SEG_DIM, depth=SEG_DEPTH, num_heads=2,
                drop_path_rate=0.0,
                out_indices=tuple(max(0, SEG_DEPTH - 4 + k) for k in range(4)))


# -- the synthetic data (numpy copies of the reference harness's) -------------

_CENTERS = [(12, 12), (36, 36), (12, 36), (36, 12), (24, 24)]


def make_dataset(root: str, n_per_class: int = 8, seed: int = 3, n_classes: int = 4,
                 extent: int = 48, events=(150, 256)) -> str:
    """Caltech-like (N, 4) [x, y, t, p] float .npy samples under
    ``root/class<c>/s<i>.npy`` (parity_trajectory.py:56 through
    scripts/mp_worker.py ``make_tiny_dataset``): each class concentrates its
    events around a centre of its own, so finetuning has signal. The
    defaults write the reference's files byte for byte; ``extent`` scales
    the canvas, the centres and the spread, ``events`` is the [low, high)
    range of each sample's event count."""
    rng = np.random.default_rng(seed)
    s = extent / 48
    for c in range(n_classes):
        d = os.path.join(root, f"class{c}")
        os.makedirs(d, exist_ok=True)
        cx, cy = _CENTERS[c % len(_CENTERS)]
        cx, cy = cx * s, cy * s
        for i in range(n_per_class):
            n = int(rng.integers(*events))
            ev = np.zeros((n, 4))
            ev[:, 0] = np.clip(rng.normal(cx, 7 * s, n).round(), 0, extent - 1)
            ev[:, 1] = np.clip(rng.normal(cy, 7 * s, n).round(), 0, extent - 1)
            ev[:, 2] = np.sort(rng.random(n))
            ev[:, 3] = rng.choice([-1.0, 1.0], n)
            np.save(os.path.join(d, f"s{i}.npy"), ev)
    return root


def make_seg_dataset(root: str, n_train: int = 8, n_val: int = 4, seed: int = 5,
                     events=(2000, 4000)) -> str:
    """Synthetic DSEC-like pairs (parity_trajectory.py:576): event .npy
    (x < 640, y < 480 with the y >= 440 crop band, p in {0, 1}) and a label
    .png with an ignore stripe. The harness's ``events`` a sample (2,000 to
    4,000) leave every eval image blank after the hot-pixel filter; 20,000
    or more, sliced at that many (``run_seg(max_evs=...)``), do not."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    for split, n in (("train", n_train), ("val", n_val)):
        os.makedirs(os.path.join(root, "imgs", split, "s"), exist_ok=True)
        os.makedirs(os.path.join(root, "anns", split, "s"), exist_ok=True)
        for i in range(n):
            ne = int(rng.integers(*events))
            ev = np.zeros((ne, 4), np.float32)
            ev[:, 0] = rng.integers(0, 640, ne)
            ev[:, 1] = rng.integers(0, 480, ne)
            ev[:, 3] = rng.integers(0, 2, ne)
            np.save(os.path.join(root, "imgs", split, "s", f"{i:04d}.npy"), ev)
            lab = rng.integers(0, SEG_NCLS, (440, 640)).astype(np.uint8)
            lab[:16] = 255
            Image.fromarray(lab).save(os.path.join(root, "anns", split, "s", f"{i:04d}.png"))
    return root


def make_iterator(data_dir: str, is_train: bool, masking: bool,
                  geo: Geometry = Geometry()) -> EventBatchIterator:
    """The harness's iterator (parity_trajectory.py:85): fresh BEiT masks
    of half the patches, numpy host path."""
    return EventBatchIterator(NpyFolder(data_dir, loader=caltech_npy_loader), PipelineConfig(
        batch_size=geo.batch, slice_max_evs=geo.slice_max_evs, is_train=is_train,
        canvas_h=geo.canvas, canvas_w=geo.canvas, masking="block" if masking else None,
        window_size=(geo.grid, geo.grid), num_mask_patches=geo.grid ** 2 // 2,
        min_mask_patches_per_block=1, mask_pool_size=0, seed=7, num_workers=0,
        use_native=False))


def host_batches(data_dir: str, steps: int, geo: Geometry = Geometry()) -> list:
    """The first ``steps`` masked training batches of ``make_iterator`` with
    their draws, as numpy (what ``run_pretrain`` reads from the iterator)."""
    return list(_batches(make_iterator(data_dir, True, masking=True, geo=geo), preproc(geo),
                         1 << 30, steps))


def preproc(geo: Geometry = Geometry()) -> PreprocConfig:
    """parity_trajectory.py:67-71: the hot-pixel filter and the event
    normalisation on, RandAugment and ColorJitter off."""
    return PreprocConfig(input_h=geo.img, input_w=geo.img, canvas_h=geo.canvas,
                         canvas_w=geo.canvas, hotpixfilter=True, rand_aug=False,
                         normalize_events=True, color_jitter=0.0)


def _cosine(base: float, final: float, epochs: int, spe: int, warmup_steps=None):
    total = epochs * spe
    warm = min(5, total // 4) if warmup_steps is None else warmup_steps
    return cosine_scheduler(base, final, epochs=epochs, niter_per_ep=spe, warmup_steps=warm)


def _batches(it: EventBatchIterator, pp: PreprocConfig, epochs: int, steps=None, images=None,
             keys=("image",)):
    """The numpy training batches of ``epochs`` epochs with their draws (and
    ``images(batch, True)`` under ``keys`` when a caller feeds images),
    stopping after ``steps`` when given."""
    t = 0
    for epoch in range(epochs):
        for batch in with_train_draws(it.epoch(epoch), pp):
            if steps is not None and t >= steps:
                return
            yield _fed(batch, images, True, keys)
            t += 1


def _fed(batch: dict, images, is_train: bool, keys=("image",)) -> dict:
    if images is not None:
        img = np.array(images(batch, is_train), np.float32)
        batch = dict(batch, **{k: img for k in keys})
    return batch


def _on_device(batches, device):
    """The CLIs' feed (data/prefetch.py): host batches made in a thread,
    each copied to ``device`` one batch ahead."""
    return device_prefetch(prefetch(batches), device)


def _as_is(batch, generator=None):
    return batch["image"]


def _values(xs) -> list:
    """0-d tensors (read once, at the end: no host sync per step) -> floats."""
    return torch.stack([x.detach().float().reshape(()) for x in xs]).cpu().tolist() if xs else []


def _load(model: torch.nn.Module, state: dict) -> torch.nn.Module:
    dev = next(model.parameters()).device
    model.load_state_dict({k: torch.as_tensor(np.asarray(v)).to(dev) for k, v in state.items()},
                          strict=True)
    return model


def set_fused_attention(model: torch.nn.Module, fused: bool) -> None:
    """Every block's ``Attention.fused`` (models/vit.py): off, attention
    takes the plain einsum path; on, the attention kernels."""
    for m in model.modules():
        if hasattr(m, "fused") and hasattr(m, "use_fused"):
            m.fused = fused


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


# -- stage 0: the discrete VAE --------------------------------------------------

def gumbel_noise(rng: np.random.Generator, shape) -> np.ndarray:
    """The reference harness's host Gumbel draw (parity_trajectory.py:154-155)."""
    u = rng.random(shape) * (1 - 2e-12) + 1e-12
    return (-np.log(-np.log(u))).astype(np.float32)


def run_vae(data_dir: str, epochs: int, init_state: dict, noise, geo: Geometry = Geometry(),
            images=None, device="cuda"):
    """Stage 0. ``init_state``: the VAE's state_dict; ``noise(step)`` -> the
    (B, h, w, vocab) Gumbel noise of a step (the reference harness draws it
    on the host with :func:`gumbel_noise`). Returns (vae, {"loss": [...]})."""
    device = torch.device(device)
    pp = preproc(geo)
    vae = _load(DiscreteVAE((geo.img, geo.img), num_tokens=geo.vocab, device=device, **VAE_KW),
                init_state)
    opt = torch.optim.Adam(vae.parameters(), lr=1.0, betas=(0.9, 0.999), eps=1e-8)
    step = make_vae_train_step(vae, opt, pp, 1e-2, inject_noise=True,
                               image_preproc=_as_is if images is not None else None)
    sched = VaeAnnealState(1e-3, 0.99)
    it = make_iterator(data_dir, True, masking=False, geo=geo)
    spe = it.steps_per_epoch()
    losses = []
    for t, batch in enumerate(_on_device(_batches(it, pp, epochs, images=images), device)):
        g = torch.from_numpy(np.array(noise(t), np.float32)).to(device)
        losses.append(step(batch, g, sched.lr, sched.temp)["loss"])
        sched.after_step(t % spe)
    return vae, {"loss": _values(losses)}


# -- stage A: masked event modeling ---------------------------------------------

def run_pretrain(data_dir: str, epochs: int, model_state: dict, vae_state: dict,
                 geo: Geometry = Geometry(), images=None, device="cuda",
                 dtype=torch.float32, vae_dtype=None, steps=None, warmup_steps=None,
                 fused_attention: bool = True, batches=None, first_grads: bool = False):
    """Stage A. ``model_state``: pt_vit's state_dict; ``vae_state``: the
    frozen tokenizer's (``geo.vocab`` tokens, VAE_KW, or the conf's
    tokenizer where ``vae_state`` carries ``"hparams"``); ``steps``: stop
    after this many steps (the schedule spans the epochs that hold them,
    parity_bf16_drift.py:106-108); ``fused_attention`` False sends every
    block's attention down the plain einsum path; ``batches``: the host
    batches of this iterator (``host_batches``), made once for several
    runs; ``first_grads``: also return the first step's gradients (on the
    CPU) under "first_grads". Returns (model, {"loss", "mlm_acc",
    "seconds"})."""
    device = torch.device(device)
    pp = preproc(geo)
    model = create_model("pt_vit", vocab_size=geo.vocab, img_size=(geo.img, geo.img),
                         patch_size=(geo.patch, geo.patch), embed_dim=geo.dim, depth=geo.depth,
                         num_heads=geo.heads, init_values=0.1, use_shared_rel_pos_bias=True,
                         dtype=dtype, device=device)
    _load(model, model_state)
    set_fused_attention(model, fused_attention)
    vae = make_tokenizer(vae_state, geo, device, vae_dtype or dtype)
    it = make_iterator(data_dir, True, masking=True, geo=geo)
    spe = it.steps_per_epoch()
    if steps is not None:
        epochs = -(-steps // spe)
    lr = _cosine(1e-3, 1e-5, epochs, spe, warmup_steps)
    wd = np.full(len(lr), 0.05)
    opt = optim.create_optimizer(model, float(lr[0]), 0.05)
    step = make_pretrain_train_step(model, vae, opt, pp, lr, wd, clip_grad=3.0)
    losses, accs = [], []
    t0 = time.perf_counter()
    if batches is None:
        batches = _batches(it, pp, epochs, steps, images, ("patches", "vae_view"))
    grads = None
    for t, batch in enumerate(_on_device(itertools.islice(batches, steps), device)):
        m = step(batch, t)
        losses.append(m["loss"])
        accs.append(m["mlm_acc"])
        if first_grads and t == 0:
            grads = {n: p.grad.detach().float().cpu() for n, p in model.named_parameters()}
    _sync(device)
    out = {"loss": _values(losses), "mlm_acc": _values(accs),
           "seconds": time.perf_counter() - t0}
    if grads is not None:
        out["first_grads"] = grads
    return model, out


def make_tokenizer(vae_state: dict, geo: Geometry, device, dtype) -> DiscreteVAE:
    """The frozen VAE of stage A: the harness's small one, or the one a
    ``{"model", "hparams"}`` payload describes (the pretraining CLI's
    ``--discrete_vae_weight_path`` format)."""
    if "hparams" in vae_state:
        hp = vae_state["hparams"]
        vae = DiscreteVAE((hp["input_H"], hp["input_W"]), num_tokens=hp["num_tokens"],
                          codebook_dim=hp["emb_dim"], num_layers=hp["num_layers"],
                          num_resnet_blocks=hp["num_resnet_blocks"], hidden_dim=hp["hidden_dim"],
                          channels=hp["channels"], dtype=dtype, device=device)
        state = vae_state["model"]
    else:
        vae = DiscreteVAE((geo.img, geo.img), num_tokens=geo.vocab, dtype=dtype, device=device,
                          **VAE_KW)
        state = vae_state
    _load(vae, state)
    return vae.eval().requires_grad_(False)


# -- stages B and E: classification finetunes ------------------------------------

def _finetune_loop(model, data_dir, val_dir, epochs, geo, images, device, lr_peak=4e-3):
    pp, pp_val = preproc(geo), preproc(geo)
    it = make_iterator(data_dir, True, masking=False, geo=geo)
    val_it = make_iterator(val_dir, False, masking=False, geo=geo)
    spe = it.steps_per_epoch()
    lr = _cosine(lr_peak, 1e-6, epochs, spe)
    wd = np.full(len(lr), 0.05)
    opt = optim.create_optimizer(model, float(lr[0]), 0.05, layer_decay=0.9,
                                 num_layers=geo.depth, betas=(0.9, 0.999))
    hook = _as_is if images is not None else None
    step = make_finetune_train_step(model, opt, pp, geo.classes, lr, wd, smoothing=0.1,
                                    clip_grad=3.0, image_preproc=hook)
    evaluate = make_finetune_eval_step(model, pp_val)
    losses, top1 = [], []
    for t, batch in enumerate(_on_device(_batches(it, pp, epochs, images=images), device)):
        losses.append(step([batch], t)["loss"])
        if (t + 1) % spe == 0:
            correct = n = 0
            for vb in val_it.epoch(0):
                bs = vb["label"].shape[0]
                acc = evaluate(to_device(_fed(vb, images, False), device))["acc1"].item()
                correct += acc / 100.0 * bs
                n += bs
            top1.append(100.0 * correct / n)
    return {"loss": _values(losses), "top1": top1}


def run_finetune(data_dir: str, val_dir: str, epochs: int, pt_state: dict, init_state: dict,
                 geo: Geometry = Geometry(), images=None, device="cuda"):
    """Stage B. ``pt_state``: stage A's pt_vit state_dict, carried into
    ``init_state`` (ft_vit's initial state_dict: the fresh head and
    fc_norm) by ``surgery_for_finetune`` at the token grid. Returns (model,
    {"loss": per step, "top1": per epoch})."""
    device = torch.device(device)
    model = create_model("ft_vit", num_classes=geo.classes, img_size=(geo.img, geo.img),
                         patch_size=(geo.patch, geo.patch), embed_dim=geo.dim, depth=geo.depth,
                         num_heads=geo.heads, init_values=0.1, use_rel_pos_bias=True,
                         device=device)
    _load(model, surgery_for_finetune(_numpy(pt_state), _numpy(init_state),
                                      (geo.grid, geo.grid)))
    return model, _finetune_loop(model, data_dir, val_dir, epochs, geo, images, device)


def run_mae_finetune(data_dir: str, val_dir: str, epochs: int, mae_state: dict,
                     init_state: dict, geo: Geometry = Geometry(), images=None, device="cuda"):
    """Stage E. ``mae_state``: stage D's MAE state_dict, carried into
    ``init_state`` (the global-pool classifier's) by
    ``surgery_for_mae_finetune``. Returns (model, {"loss", "top1"})."""
    from mem_tpu_torch.models.mae_classifier import MAEVisionTransformer

    device = torch.device(device)
    model = MAEVisionTransformer(img_size=(geo.img, geo.img), patch_size=geo.patch,
                                 num_classes=geo.classes, embed_dim=geo.dim, depth=geo.depth,
                                 num_heads=geo.heads, device=device)
    _load(model, surgery_for_mae_finetune(_numpy(mae_state), _numpy(init_state),
                                          src_grid=geo.grid))
    return model, _finetune_loop(model, data_dir, val_dir, epochs, geo, images, device)


def _numpy(state: dict) -> dict:
    return {k: v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
            for k, v in state.items()}


# -- stage D: the MAE --------------------------------------------------------------

def run_mae(data_dir: str, epochs: int, init_state: dict, noise, geo: Geometry = Geometry(),
            device="cuda"):
    """Stage D. ``init_state``: the MAE's state_dict; ``noise(step)`` -> the
    (B, L) uniform shuffle noise of a step. Returns (model, {"loss"})."""
    from mem_tpu_torch.models.mae import MaskedAutoencoderViT

    device = torch.device(device)
    pp = preproc(geo)
    model = _load(MaskedAutoencoderViT(img_size=geo.img, patch_size=geo.patch,
                                       embed_dim=geo.dim, depth=geo.depth, num_heads=geo.heads,
                                       device=device, **MAE_DECODER), init_state)
    it = make_iterator(data_dir, True, masking=False, geo=geo)
    spe = it.steps_per_epoch()
    lr = _cosine(1e-3, 1e-5, epochs, spe)
    wd = np.full(len(lr), 0.05)
    opt = optim.create_optimizer(model, float(lr[0]), 0.05)
    step = make_mae_train_step(model, opt, pp, lr, wd, clip_grad=3.0)
    losses = []
    for t, batch in enumerate(_on_device(_batches(it, pp, epochs), device)):
        nz = torch.from_numpy(np.array(noise(t), np.float32)).to(device)
        losses.append(step(batch, t, noise=nz)["loss"])
    return model, {"loss": _values(losses)}


# -- stage C: DSEC segmentation ----------------------------------------------------

def run_seg(data_root: str, iters: int, init_state: dict, device="cuda", eval_at=None,
            max_evs: int = 4096, stop: int | None = None):
    """Stage C. ``init_state``: the segmentor's state_dict (BatchNorm
    buffers included); ``eval_at``: the iterations after which the val split
    goes through the eval step (default: after the last); ``max_evs``: the
    events a sample is sliced to (the harness's 4096); ``stop``: the
    iterations run of the ``iters``-iteration schedule (default all).
    Returns (model, {"loss": per iteration, "miou": per eval, "aacc": per
    eval})."""
    from mem_tpu_torch.data.seg_pipeline import (SegBatchIterator, SegPipelineConfig,
                                                 scan_seg_pairs)
    from mem_tpu_torch.models.segmentation import EncoderDecoder, seg_metrics

    device = torch.device(device)
    train_it = SegBatchIterator(scan_seg_pairs(data_root, "imgs/train", "anns/train"),
                                SegPipelineConfig(batch_size=SEG_B, is_train=True,
                                                  max_evs=max_evs, seed=13))
    val_it = SegBatchIterator(scan_seg_pairs(data_root, "imgs/val", "anns/val"),
                              SegPipelineConfig(batch_size=SEG_B, is_train=False,
                                                max_evs=max_evs, seed=13))
    model = _load(EncoderDecoder(num_classes=SEG_NCLS, backbone_cfg=seg_backbone(),
                                 dtype=torch.float32, device=device, **SEG_HEADS), init_state)
    lr0, wd = 1e-3, 0.05
    lr_fn = poly_lr_schedule(lr0, iters, warmup_iters=max(2, iters // 8))
    opt = optim.create_optimizer(model, lr0, wd, layer_decay=0.65, num_layers=SEG_DEPTH,
                                 betas=(0.9, 0.999))
    train_step, eval_step = make_seg_steps(model, opt, lr_fn, wd, SEG_NCLS, rand_aug=False,
                                           y_sorted=True)
    eval_at = {iters} if eval_at is None else set(eval_at)
    losses, miou, aacc = [], [], []
    batches = train_it.batches()
    for t in range(iters if stop is None else stop):
        losses.append(train_step(to_device(next(batches), device), t)["loss"])
        if t + 1 in eval_at:
            cm = np.zeros((SEG_NCLS, SEG_NCLS))
            for vb in val_it.eval_batches():
                w = int(vb.pop("n_real")) / vb["label"].shape[0]
                cm += eval_step(to_device(vb, device)).double().cpu().numpy() * w
            m = seg_metrics(cm)
            miou.append(float(m["mIoU"]))
            aacc.append(float(m["aAcc"]))
    return model, {"loss": _values(losses), "miou": miou, "aacc": aacc}


# -- the reductions -------------------------------------------------------------------

def loss_gaps(ref, got) -> dict:
    """parity_trajectory.py ``summarize`` of two loss curves, ``got`` in the
    place of its torch twin (the denominator of the relative gaps): steps,
    final losses, the largest absolute and relative gaps and the mean
    relative gap."""
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    d = np.abs(ref - got)
    rel = d / np.maximum(np.abs(got), 1e-6)
    return {"steps": len(ref), "final_ref": float(ref[-1]), "final": float(got[-1]),
            "max_abs": float(d.max()), "max_rel": float(rel.max()),
            "mean_rel": float(rel.mean())}


def onset(ref, got, thresh: float = 1e-4):
    """The first step whose relative loss gap (over ``got``) passes
    ``thresh``, or "never" (parity_trajectory.py ``_onset``)."""
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    rel = np.abs(ref - got) / np.maximum(np.abs(got), 1e-6)
    idx = np.nonzero(rel > thresh)[0]
    return int(idx[0]) if len(idx) else "never"


def smooth(x, w: int = 5) -> np.ndarray:
    """The running mean of parity_finetune_envelope.py:47."""
    x = np.asarray(x, np.float64)
    if len(x) < w:
        return x
    return np.convolve(x, np.ones(w) / w, mode="valid")


def window_stats(a, b, w: int = 50) -> np.ndarray:
    """|mean(a) - mean(b)| / |mean(b)| over consecutive ``w``-step windows
    (parity_bf16_drift.py:131)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    rows = []
    for i in range(len(a) // w):
        x, y = a[i * w:(i + 1) * w].mean(), b[i * w:(i + 1) * w].mean()
        rows.append(abs(x - y) / max(abs(y), 1e-6))
    return np.asarray(rows)


def seed_envelope(oracle: dict, cross: dict, seeds: list, w: int = 5) -> dict:
    """parity_finetune_envelope.py:55-139: ``oracle`` and every run are
    {"loss": per step, "top1": per epoch}; ``cross`` is the other
    framework's run from the oracle's init, ``seeds`` the oracle's own
    framework from redrawn heads. Passes when the cross smoothed-loss gap
    and the cross top-1 gap each stay within the seeds' largest."""
    lo = smooth(oracle["loss"], w)
    t1 = np.asarray(oracle["top1"], np.float64)

    def loss_dev(r):
        return float(np.abs(smooth(r["loss"], w) - lo).max())

    def top1_dev(r):
        return float(np.abs(np.asarray(r["top1"], np.float64) - t1).max())

    out = {"cross_smoothed_loss_dev": loss_dev(cross),
           "seed_envelope_loss_dev": max(loss_dev(r) for r in seeds),
           "cross_top1_dev_pts": top1_dev(cross),
           "seed_envelope_top1_dev_pts": max(top1_dev(r) for r in seeds),
           "cross_final_top1_dev_pts": float(abs(cross["top1"][-1] - t1[-1])),
           "seed_envelope_final_top1_dev_pts": max(float(abs(r["top1"][-1] - t1[-1]))
                                                   for r in seeds),
           "n_seed_runs": len(seeds)}
    out["pass"] = bool(out["cross_smoothed_loss_dev"] <= out["seed_envelope_loss_dev"]
                       and out["cross_top1_dev_pts"] <= out["seed_envelope_top1_dev_pts"])
    return out


def drift_envelope(oracle, same, low, redrawn, w: int = 50, final_rel: float = 0.05) -> dict:
    """parity_bf16_drift.py:154-185 on loss curves: ``same`` (the
    step-locked arm from the oracle's init), ``low`` (the arm under test,
    e.g. bf16, same init) and ``redrawn`` (the oracle's stack from another
    init: the run-to-run yardstick). ``low`` passes when its largest
    windowed gap is within ``redrawn``'s and its final-window loss within
    ``final_rel`` of the oracle's."""
    r_same, r_low, r_seed = (window_stats(x, oracle, w) for x in (same, low, redrawn))
    final_o, final_low = float(np.mean(oracle[-w:])), float(np.mean(low[-w:]))
    out = {"steps": len(oracle), "window": w,
           "same_windowed_rel_dev": r_same.tolist(), "low_windowed_rel_dev": r_low.tolist(),
           "redrawn_windowed_rel_dev": r_seed.tolist(),
           "max_windowed_rel_dev_same": float(r_same.max()),
           "max_windowed_rel_dev_low": float(r_low.max()),
           "seed_run_to_run_dev": float(r_seed.max()),
           "oracle_final_window_loss": final_o, "low_final_window_loss": final_low,
           "same_final_window_loss": float(np.mean(same[-w:])),
           "redrawn_final_window_loss": float(np.mean(redrawn[-w:])),
           "final_rel_dev_low": abs(final_low - final_o) / abs(final_o),
           "same_onset": onset(oracle, same)}
    out["pass_final"] = bool(out["final_rel_dev_low"] < final_rel)
    out["pass_envelope"] = bool(out["max_windowed_rel_dev_low"] <= out["seed_run_to_run_dev"])
    return out


# -- parity_bf16_drift.py's arms with the port alone, on one device ------------------

# the card's drift check (chip_smoke.py trajectory_card): pt_vit at full width
# (768, 12 heads, patch 16, 224^2, vocab 8192) cut to depth 4, B=32, the
# conf's f32 tokenizer, 64 class-structured samples of 4,000-8,000 events
# (two steps an epoch; the 8,192-event cap slices none)
CARD_GEO = Geometry(img=224, patch=16, dim=768, depth=4, heads=12, vocab=8192, batch=32,
                    classes=4, canvas=256, slice_max_evs=8_192)
CARD_VAE = dict(input_H=224, input_W=224, num_tokens=8192, emb_dim=32, num_layers=4,
                num_resnet_blocks=3, hidden_dim=384, channels=3)
DRIFT_KERNELS = ("hist_planes_cols", "fused_attention_flat", "fused_attention_flat_bwd")


def drift_inputs(root: str, rng: np.random.Generator, geo: Geometry = CARD_GEO,
                 vae_hp: dict = CARD_VAE, per_class: int = 16, events=(4_000, 8_000)):
    """(data_dir, tokenizer payload, [init, redrawn init]) from ``rng``: a
    seeded class-structured set at the geometry's extent, the seeded
    tokenizer ``vae_hp`` describes, two seeded pt_vit inits (f32, CPU)."""
    data = make_dataset(os.path.join(root, "drift"), n_per_class=per_class,
                        seed=int(rng.integers(2**31)), n_classes=geo.classes, extent=geo.img,
                        events=events)
    vae = DiscreteVAE((vae_hp["input_H"], vae_hp["input_W"]), num_tokens=vae_hp["num_tokens"],
                      codebook_dim=vae_hp["emb_dim"], num_layers=vae_hp["num_layers"],
                      num_resnet_blocks=vae_hp["num_resnet_blocks"],
                      hidden_dim=vae_hp["hidden_dim"], channels=vae_hp["channels"])
    vae.init_weights(torch.Generator().manual_seed(int(rng.integers(2**31))))
    inits = []
    for _ in range(2):
        m = create_model("pt_vit", vocab_size=geo.vocab, img_size=(geo.img, geo.img),
                         patch_size=(geo.patch, geo.patch), embed_dim=geo.dim, depth=geo.depth,
                         num_heads=geo.heads, init_values=0.1, use_shared_rel_pos_bias=True)
        m.init_weights(torch.Generator().manual_seed(int(rng.integers(2**31))))
        inits.append(m.state_dict())
    return data, {"model": vae.state_dict(), "hparams": dict(vae_hp)}, inits


def drift_arms(data_dir: str, tokenizer: dict, inits: list, device, steps: int,
               warmup_steps: int, faults: dict, geo: Geometry = CARD_GEO) -> dict:
    """The arms of parity_bf16_drift.py with the port alone, on the same
    host batches, draws and masks (made once): "oracle" (f32, every block's attention on
    the plain einsum path, ``inits[0]``), "A" (f32 through the attention
    kernels), "B" (bf16 through the kernels), "C" (the oracle's stack from
    ``inits[1]``), and B again under each context manager of ``faults``
    ({name: factory}). Each arm: its loss curve, ms per step and the
    launches of ``DRIFT_KERNELS`` in its run. ``one_step``: the first step
    of B and of each fault against the oracle's first step (the plain f32
    step), {name: {"loss_rel", "grad_rel_l2" (the largest per-parameter
    relative L2 of the gradients), "worst" (its parameter)}}."""
    import contextlib

    from mem_tpu_torch.kernels import launch_counts, reset_launch_counts

    f32, bf16 = torch.float32, torch.bfloat16
    plan = [("oracle", 0, f32, False, None), ("A", 0, f32, True, None),
            ("B", 0, bf16, True, None), ("C", 1, f32, False, None)]
    plan += [(name, 0, bf16, True, fault) for name, fault in faults.items()]
    host = host_batches(data_dir, steps, geo)
    runs = {}
    for name, init, dtype, fused, fault in plan:
        with fault() if fault else contextlib.nullcontext():
            reset_launch_counts()             # just before the arm's run
            _, c = run_pretrain(data_dir, 0, inits[init], tokenizer, geo=geo, device=device,
                                dtype=dtype, vae_dtype=f32, steps=steps,
                                warmup_steps=warmup_steps, fused_attention=fused,
                                batches=host, first_grads=name not in ("A", "C"))
            c["launches"] = {k: launch_counts().get(k, 0) for k in DRIFT_KERNELS}
        c["ms_per_step"] = 1e3 * c["seconds"] / steps
        runs[name] = c
    ref_loss, ref = runs["oracle"]["loss"][0], runs["oracle"].pop("first_grads")
    one_step = {}
    for name in ["B", *faults]:
        grads = runs[name].pop("first_grads")
        rel = {n: float(torch.linalg.norm(g.double() - ref[n].double())
                        / torch.linalg.norm(ref[n].double())) for n, g in grads.items()}
        worst = max(rel, key=rel.get)
        one_step[name] = {"loss_rel": abs(runs[name]["loss"][0] - ref_loss) / abs(ref_loss),
                          "grad_rel_l2": rel[worst], "worst": worst}
    return {"runs": runs, "one_step": one_step}

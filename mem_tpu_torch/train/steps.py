"""Train and eval steps: the discrete VAE, port of mem_tpu/train/steps.py
``make_vae_train_step`` / ``make_vae_eval_step`` (:51-130) (the reference's
train_vae.py:304-399), MEM pretraining, port of
mem_tpu/train/steps.py ``make_pretrain_train_step`` / ``make_pretrain_eval_step`` (:135-210)
(the reference's engine_for_pretraining.py:108-287), MAE pretraining, port
of ``make_mae_train_step`` (:213-252), classification
finetuning, port of ``make_finetune_train_step`` / ``make_finetune_eval_step``
(:262-419) (engine_for_finetuning.py:41-244), and DSEC segmentation, port of
mem_tpu/cli/train_seg.py ``make_seg_steps`` (:129-162).

One VAE train step: on-device preprocessing with the training
augmentations (kernel K1) -> the VAE's Gumbel-softmax forward (noise from
the step's generator, or injected) -> reconstruction loss + KL -> backward
-> the pre-clip global grad norm and the clip -> plain Adam with the lr
passed in (the reference's ``scale_by_adam`` and ``-lr * u``). The f32
path runs its convolutions without TF32, backward included.

One pretraining train step: on-device preprocessing with the training augmentations
-> frozen-VAE codebook labels under ``torch.no_grad()`` -> the masked ViT
forward (bf16 compute, f32 params; drop-path from a generator seeded by
(seed, step)) -> cross-entropy at the masked positions -> backward (kernel
K2b inside attention) -> the pre-clip global grad norm and the clip ->
the ``--opt`` optimizer (AdamW by default) with this step's lr / wd. No loss scaling: bf16 has f32's exponent
range, as in the reference. The step returns its metrics as 0-d device
tensors and never waits on the device; the caller reads them when it logs.
The reference's chained dispatch (``--steps_per_dispatch``) has no
counterpart here yet: the port dispatches step by step.

One MAE train step: the same preprocessing -> the shuffle-mask noise from
the step's generator (or injected) -> the MAE forward (encoder on the
visible tokens, decoder on all; K2f inside attention) -> the pixel loss in
f32 -> backward (K2b) -> the pre-clip global grad norm and the clip -> AdamW
with this step's lr / wd. No tokenizer is involved.

One segmentation train step: the train preprocessing on the 440x640 canvas
(kernel K4) -> the segmentor with ``train=True`` (BatchNorm over the batch,
dropout and drop-path from the step's generator; K3f inside attention) ->
``seg_loss`` -> backward (kernel K3b) -> the global grad norm (no clip) ->
AdamW with this step's lr times each group's layer-decay scale.

One finetune train step: for each of ``update_freq`` micro-batches, the
train preprocessing (kernel K1) -> mixup / cutmix from the host's draws ->
``ft_vit`` in training mode (attention through K2f/K2b, or K5a/K5c and the
MLPs through K6f/K6b under the model toggles) -> cross-entropy (soft
targets, label smoothing or hard labels) divided by ``update_freq`` ->
backward, the gradients adding up; then the global grad norm, the clip,
the ``--opt`` optimizer (AdamW by default) with this step's lr and wd, and
the EMA of the parameters.
"""
from __future__ import annotations

import numpy as np
import torch

from mem_tpu_torch.data.device_pipeline import PreprocConfig, preprocess_batch
from mem_tpu_torch.data.seg_pipeline import IGNORE_INDEX, seg_preprocess_batch
from mem_tpu_torch.models.discrete_vae import cudnn_full_f32
from mem_tpu_torch.models.segmentation import confusion_matrix, seg_loss
from mem_tpu_torch.models.pretrain import masked_cross_entropy, masked_cross_entropy_gathered
from mem_tpu_torch.train.mixup import MIXUP_KEYS, MixupConfig, mixup_apply, one_hot_smoothed
from mem_tpu_torch.train.optim import clip_grad_global_norm, set_schedule
from mem_tpu_torch.train.schedules import at


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The dropout / drop-path generator of one step, seeded from
    (seed, step) on ``device``."""
    g = torch.Generator(device=device)
    g.manual_seed(int(np.random.SeedSequence((int(seed), int(step))).generate_state(1)[0]))
    return g


def make_vae_train_step(vae, optimizer: torch.optim.Optimizer, preproc: PreprocConfig,
                        clip: float, seed: int = 0, inject_noise: bool = False):
    """Returns ``step(batch, rng, lr, temp) -> {"loss", "grad_norm"}``.
    ``batch``: device tensors (events or events_xyp, n_valid, extents,
    flips, shift and the draw_train_aug draws); ``rng``: the global step,
    which seeds the step's Gumbel generator, or with ``inject_noise`` the
    pre-drawn (B, h, w, num_tokens) noise itself (the reference's
    ``inject_noise``); ``lr`` and ``temp``: this step's values of the
    anneal (``VaeAnnealState``). ``optimizer``: ``torch.optim.Adam`` over
    ``vae.parameters()`` with betas (0.9, 0.999), eps 1e-8 and no weight
    decay; its lr is set before each update."""
    params = [p for p in vae.parameters() if p.requires_grad]

    def step(batch: dict, rng, lr: float, temp: float) -> dict:
        images = preprocess_batch(batch, preproc, is_train=True)
        vae.train()
        with cudnn_full_f32():
            if inject_noise:
                loss = vae(images, temp, gumbel_noise=rng)
            else:
                loss = vae(images, temp, generator=step_generator(seed, rng, images.device))
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
        gnorm = clip_grad_global_norm(params, clip)
        for g in optimizer.param_groups:
            g["lr"] = lr
        optimizer.step()
        return {"loss": loss.detach(), "grad_norm": gnorm}

    return step


def make_vae_eval_step(vae, preproc: PreprocConfig):
    """Returns ``step(batch) -> {"loss", "ids", "images", "recon"}``: the
    eval preprocessing, the argmax codes, their decoding, and the MSE of
    the reconstruction against the unnormalized images (steps.py:122); the
    images and the reconstruction ride along for the panels."""

    def step(batch: dict) -> dict:
        vae.eval()
        with torch.no_grad():
            images = preprocess_batch(batch, preproc, is_train=False)
            ids = vae.get_codebook_indices(images)
            recon = vae.decode_indices(ids)
            mse = ((images - recon.float()) ** 2).mean()
        return {"loss": mse, "ids": ids, "images": images, "recon": recon}

    return step


def _loss(model, images, mask, labels, generator=None):
    out = model(images, mask, generator=generator)
    if getattr(model, "num_masked_tokens", None) is not None:
        logits, idx = out
        return masked_cross_entropy_gathered(logits, idx, labels, mask)
    return masked_cross_entropy(out, labels, mask)


def make_pretrain_train_step(model, vae, optimizer: torch.optim.Optimizer,
                             preproc: PreprocConfig, lr_schedule: np.ndarray,
                             wd_schedule: np.ndarray, clip_grad=None, seed: int = 0):
    """Returns ``step(batch, it) -> {"loss", "mlm_acc", "grad_norm"}``.
    ``batch``: device tensors (events or events_xyp, n_valid, extents,
    flips, shift, mask, and the draw_train_aug draws); ``it``: the global
    step, which indexes the schedules and seeds the step's generator."""
    params = [p for p in model.parameters() if p.requires_grad]

    def step(batch: dict, it: int) -> dict:
        images = preprocess_batch(batch, preproc, is_train=True)
        mask = batch["mask"]
        with torch.no_grad():
            labels = vae.get_codebook_indices(images)
        model.train()
        loss, acc = _loss(model, images, mask, labels,
                          step_generator(seed, it, images.device))
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        gnorm = clip_grad_global_norm(params, clip_grad)
        set_schedule(optimizer, at(lr_schedule, it), at(wd_schedule, it))
        optimizer.step()
        return {"loss": loss.detach(), "mlm_acc": acc.detach(), "grad_norm": gnorm}

    return step


def make_mae_train_step(model, optimizer: torch.optim.Optimizer, preproc: PreprocConfig,
                        lr_schedule: np.ndarray, wd_schedule: np.ndarray, clip_grad=None,
                        seed: int = 0):
    """Returns ``step(batch, it, noise=None) -> {"loss", "grad_norm"}`` for a
    ``MaskedAutoencoderViT``. ``batch``: device tensors (events or
    events_xyp, n_valid, extents, flips, shift and the draw_train_aug draws;
    no mask); ``it``: the global step, which indexes the schedules and seeds
    the step's generator, from which the (B, L) shuffle noise is drawn unless
    ``noise`` passes it in (the reference's step takes its mask key
    explicitly, steps.py:224-233)."""
    params = [p for p in model.parameters() if p.requires_grad]

    def step(batch: dict, it: int, noise=None) -> dict:
        images = preprocess_batch(batch, preproc, is_train=True)
        model.train()
        loss, _, _ = model(images, noise=noise,
                           generator=step_generator(seed, it, images.device))
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        gnorm = clip_grad_global_norm(params, clip_grad)
        set_schedule(optimizer, at(lr_schedule, it), at(wd_schedule, it))
        optimizer.step()
        return {"loss": loss.detach(), "grad_norm": gnorm}

    return step


def make_pretrain_eval_step(model, vae, preproc: PreprocConfig):
    """Returns ``step(batch) -> {"loss", "mlm_acc"}`` (eval preprocessing,
    deterministic forward, no gradients)."""

    def step(batch: dict) -> dict:
        with torch.no_grad():
            images = preprocess_batch(batch, preproc, is_train=False)
            labels = vae.get_codebook_indices(images)
            model.eval()
            loss, acc = _loss(model, images, batch["mask"], labels)
        return {"loss": loss, "mlm_acc": acc}

    return step


def make_seg_steps(model, optimizer: torch.optim.Optimizer, lr_fn, weight_decay: float,
                   num_classes: int, rand_aug: bool, rand_aug_batch_ops: bool = False,
                   y_sorted: bool = False, seed: int = 0):
    """Returns ``(train_step, eval_step)``. ``train_step(batch, it) ->
    {"loss", "grad_norm"}`` on a device batch (events_xyp or events, n_valid,
    label, flip, resize_jitter and, with ``rand_aug``, the draw_seg_train_aug
    draws); ``it`` is the global iteration, which ``lr_fn`` maps to the lr and
    which seeds the step's generator. ``eval_step(batch)`` -> the
    (num_classes, num_classes) f32 confusion matrix of the batch."""
    params = [p for p in model.parameters() if p.requires_grad]

    def train_step(batch: dict, it: int) -> dict:
        with torch.no_grad():
            images, labels = seg_preprocess_batch(batch, True, rand_aug, rand_aug_batch_ops,
                                                  y_sorted)
        model.train()
        logits, aux = model(images, train=True,
                            generator=step_generator(seed, it, images.device))
        loss = seg_loss(logits, aux, labels, num_classes)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        gnorm = clip_grad_global_norm(params, None)
        set_schedule(optimizer, lr_fn(it), weight_decay)
        optimizer.step()
        return {"loss": loss.detach(), "grad_norm": gnorm}

    def eval_step(batch: dict) -> torch.Tensor:
        model.eval()
        with torch.no_grad():
            images, labels = seg_preprocess_batch(batch, False, y_sorted=y_sorted)
            pred = model(images)[0].argmax(dim=-1)
            return confusion_matrix(pred, labels, num_classes, IGNORE_INDEX)

    return train_step, eval_step


def finetune_cross_entropy(logits, targets, num_classes: int, smoothing: float = 0.0):
    """The three forms of steps.py:282-295 on f32 logits: soft targets
    (``targets`` shaped as the logits), label smoothing
    (``(1 - eps) onehot + eps / K``), or hard labels."""
    lp = torch.log_softmax(logits.float(), dim=-1)
    if targets.ndim == logits.ndim:
        return -(targets * lp).sum(dim=-1).mean()
    if smoothing > 0:
        return -(one_hot_smoothed(targets, num_classes, smoothing) * lp).sum(dim=-1).mean()
    return -lp.gather(-1, targets.long()[..., None])[..., 0].mean()


def make_finetune_train_step(model, optimizer: torch.optim.Optimizer, preproc: PreprocConfig,
                             num_classes: int, lr_schedule: np.ndarray,
                             wd_schedule: np.ndarray, mixup: MixupConfig | None = None,
                             smoothing: float = 0.0, update_freq: int = 1,
                             ema: list | None = None, ema_decay: float | None = None,
                             clip_grad=None, seed: int = 0):
    """Returns ``step(micro_batches, it) -> {"loss", "grad_norm"}``.
    ``micro_batches``: ``update_freq`` device batches (events or events_xyp,
    n_valid, extents, flips, shift, label, the draw_train_aug draws and, with
    ``mixup``, the draw_mixup draws); loss and gradients are their mean
    (steps.py:315-335). ``it``: the optimizer step, which indexes the
    schedules and seeds the micro-batches' generators. ``ema``: f32 tensors in
    the order of ``model.parameters()``, updated in place after the step as
    ``decay * ema + (1 - decay) * param``; None (with ``ema_decay`` None)
    keeps no EMA at all."""
    if (ema is None) != (ema_decay is None):
        raise ValueError("pass both ema and ema_decay, or neither")
    params = [p for p in model.parameters() if p.requires_grad]
    all_params = list(model.parameters())

    def step(micro_batches, it: int) -> dict:
        if len(micro_batches) != update_freq:
            raise ValueError(f"expected {update_freq} micro-batches, got {len(micro_batches)}")
        model.train()
        optimizer.zero_grad(set_to_none=True)
        total = None
        for i, batch in enumerate(micro_batches):
            with torch.no_grad():
                images = preprocess_batch(batch, preproc, is_train=True)
                targets = batch["label"]
                if mixup is not None:
                    images, targets = mixup_apply(images, targets,
                                                  {k: batch[k] for k in MIXUP_KEYS}, mixup)
            logits = model(images, generator=step_generator(seed, it * update_freq + i,
                                                            images.device))
            loss = finetune_cross_entropy(logits, targets, num_classes, smoothing) / update_freq
            loss.backward()
            total = loss.detach() if total is None else total + loss.detach()
        gnorm = clip_grad_global_norm(params, clip_grad)
        set_schedule(optimizer, at(lr_schedule, it), at(wd_schedule, it))
        optimizer.step()
        if ema is not None:
            with torch.no_grad():
                torch._foreach_mul_(ema, ema_decay)
                torch._foreach_add_(ema, [p.detach() for p in all_params],
                                    alpha=1.0 - ema_decay)
        return {"loss": total, "grad_norm": gnorm}

    return step


def make_finetune_eval_step(model, preproc: PreprocConfig, with_predictions: bool = False):
    """Returns ``step(batch) -> {"loss", "acc1", "acc5"}`` (eval
    preprocessing, deterministic forward, hard-label cross-entropy, top-1 and
    top-5 in percent); ``with_predictions`` adds the per-sample top-k class
    ids and probabilities (steps.py:389-419)."""
    k = 5

    def step(batch: dict) -> dict:
        model.eval()
        with torch.no_grad():
            images = preprocess_batch(batch, preproc, is_train=False)
            logits = model(images).float()
            targets = batch["label"].long()
            lp = torch.log_softmax(logits, dim=-1).gather(-1, targets[:, None])[:, 0]
            top1 = (logits.argmax(dim=-1) == targets).float()
            topk_p, topk_ids = torch.softmax(logits, dim=-1).topk(min(k, logits.shape[-1]),
                                                                  dim=-1)
            top5 = (topk_ids == targets[:, None]).any(dim=-1).float()
            out = {"loss": -lp.mean(), "acc1": top1.mean() * 100.0,
                   "acc5": top5.mean() * 100.0}
            if with_predictions:
                out["topk_ids"] = topk_ids
                out["topk_probs"] = topk_p
        return out

    return step

"""Train and eval steps: MEM pretraining, port of mem_tpu/train/steps.py
``make_pretrain_train_step`` / ``make_pretrain_eval_step`` (:135-210)
(the reference's engine_for_pretraining.py:108-287), and DSEC segmentation,
port of mem_tpu/cli/train_seg.py ``make_seg_steps`` (:129-162).

One train step: on-device preprocessing with the training augmentations
-> frozen-VAE codebook labels under ``torch.no_grad()`` -> the masked ViT
forward (bf16 compute, f32 params; drop-path from a generator seeded by
(seed, step)) -> cross-entropy at the masked positions -> backward (kernel
K2b inside attention) -> the pre-clip global grad norm and the clip ->
AdamW with this step's lr / wd. No loss scaling: bf16 has f32's exponent
range, as in the reference. The step returns its metrics as 0-d device
tensors and never waits on the device; the caller reads them when it logs.
The reference's chained dispatch (``--steps_per_dispatch``) has no
counterpart here yet: the port dispatches step by step.

One segmentation train step: the train preprocessing on the 440x640 canvas
(kernel K4) -> the segmentor with ``train=True`` (BatchNorm over the batch,
dropout and drop-path from the step's generator; K3f inside attention) ->
``seg_loss`` -> backward (kernel K3b) -> the global grad norm (no clip) ->
AdamW with this step's lr times each group's layer-decay scale.
"""
from __future__ import annotations

import numpy as np
import torch

from mem_tpu_torch.data.device_pipeline import PreprocConfig, preprocess_batch
from mem_tpu_torch.data.seg_pipeline import IGNORE_INDEX, seg_preprocess_batch
from mem_tpu_torch.models.segmentation import confusion_matrix, seg_loss
from mem_tpu_torch.models.pretrain import masked_cross_entropy, masked_cross_entropy_gathered
from mem_tpu_torch.train.optim import clip_grad_global_norm, set_schedule
from mem_tpu_torch.train.schedules import at


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The dropout / drop-path generator of one step, seeded from
    (seed, step) on ``device``."""
    g = torch.Generator(device=device)
    g.manual_seed(int(np.random.SeedSequence((int(seed), int(step))).generate_state(1)[0]))
    return g


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

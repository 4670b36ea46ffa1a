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

Every train-step factory takes ``chain=True`` as the JAX factories do
(steps.py:16-28): it then returns a :class:`~mem_tpu_torch.train.chain.Chain`
of the same step, ``chain(block, it0) -> {metric: (k,) tensor}`` over a
(k, ...) block of device batches (finetune: (k, update_freq, B, ...)), one
generator per chunk (train/chain.py), an eager loop or one replayed CUDA
graph. The VAE's chain takes ``sched={"lr": [...], "temp": [...]}``, the
anneal walked over the chunk's steps.

On the IMNET image path (``--data_set IMNET``) a batch carries images made
on the host instead of events: the pretraining step takes the two views
``patches`` (the model's) and ``vae_view`` (the tokenizer's) as they are;
the VAE and finetune train steps pass an ``image`` batch to the injected
``image_preproc`` (data/device_pipeline.preprocess_image_cls with the run's
settings) with the step's generator, which feeds the erasing noise; the eval
steps take ``image`` as it is (steps.py:69-70, 114-116, 144-147, 196-197,
298-299, 398-400). The MAE step has no image branch, as in the reference.

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

Every factory takes ``placement`` (parallel/mesh.py ``place_train_state``;
None: one process), and must be called after the model and optimizer are
placed. Under a placement the losses and the metrics are those of the global
batch (the counts summed over the "data" processes), the gradients are
reduced before the global norm (which is that of the whole gradient), the
update is the placement's (ZeRO-1: the owned parameters, then a broadcast),
the step generator is seeded with ``seed + data rank`` (the reference's
``seed + process_index``: tensor-parallel ranks of one data rank draw
alike), and the eval steps' sums are taken over the "data" processes.
"""
from __future__ import annotations

import numpy as np
import torch

from mem_tpu_torch.data.device_pipeline import PreprocConfig, preprocess_batch
from mem_tpu_torch.data.seg_pipeline import IGNORE_INDEX, seg_preprocess_batch
from mem_tpu_torch.models.discrete_vae import cudnn_full_f32
from mem_tpu_torch.models.segmentation import confusion_matrix, seg_loss
from mem_tpu_torch.models.pretrain import masked_cross_entropy, masked_cross_entropy_gathered
from mem_tpu_torch.parallel.mesh import global_quotient, psum_metrics
from mem_tpu_torch.train.chain import Chain, chunk_seed, step_of
from mem_tpu_torch.train.mixup import MIXUP_KEYS, MixupConfig, mixup_apply, one_hot_smoothed
from mem_tpu_torch.train.optim import clip_grad_global_norm, set_schedule
from mem_tpu_torch.train.schedules import at


def _batch_device(batch: dict) -> torch.device:
    return next(v.device for v in batch.values() if isinstance(v, torch.Tensor))


def _group(placement):
    return None if placement is None else placement.data_group


def _seed(seed: int, placement) -> int:
    return seed + (0 if placement is None else placement.data_rank)


def _reduce_and_norm(params, clip, placement) -> torch.Tensor:
    """The placement's gradient reduction, then the pre-clip global norm and
    the clip."""
    if placement is not None:
        placement.reduce_gradients(params)
    return clip_grad_global_norm(params, clip, placement and placement.sharded())


def _update(optimizer, placement) -> None:
    if placement is None:
        optimizer.step()
    else:
        placement.step(optimizer)


def _mean(metrics: dict, placement) -> dict:
    """The metrics averaged over the "data" processes (each rank's is its
    share of the global quotient, or a value every rank holds)."""
    if _group(placement) is None:
        return metrics
    return psum_metrics(metrics, placement.data_group, average=True)


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The dropout / drop-path generator of one step, seeded from
    (seed, step) on ``device``."""
    g = torch.Generator(device=device)
    g.manual_seed(chunk_seed(seed, step))
    return g


def _param_device(module) -> torch.device:
    return next(module.parameters()).device


def _set_lr(optimizer, lr) -> None:
    """The VAE's lr (its Adam has one scale-free group, no decay)."""
    if getattr(optimizer, "device_schedule", None) is not None:
        optimizer.device_schedule.write(lr, 0.0)
        return
    for g in optimizer.param_groups:
        g["lr"] = lr


def make_vae_train_step(vae, optimizer: torch.optim.Optimizer, preproc: PreprocConfig,
                        clip: float, seed: int = 0, inject_noise: bool = False,
                        image_preproc=None, placement=None, chain: bool = False):
    """Returns ``step(batch, rng, lr, temp) -> {"loss", "grad_norm"}``.
    ``batch``: device tensors (events or events_xyp, n_valid, extents,
    flips, shift and the draw_train_aug draws); ``rng``: the global step,
    which seeds the step's Gumbel generator, or with ``inject_noise`` the
    pre-drawn (B, h, w, num_tokens) noise itself (the reference's
    ``inject_noise``); ``lr`` and ``temp``: this step's values of the
    anneal (``VaeAnnealState``). ``optimizer``: ``torch.optim.Adam`` over
    ``vae.parameters()`` with betas (0.9, 0.999), eps 1e-8 and no weight
    decay; its lr is set before each update. An IMNET batch (``image``)
    goes through ``image_preproc(batch, generator=...)`` with the step's
    generator (the global one under ``inject_noise``). ``chain=True``: the
    :class:`Chain` of this step, called ``chain(block, it0, sched={"lr":
    [...], "temp": [...]})``; a block may carry each step's pre-drawn noise
    under ``gumbel_noise`` (the ``inject_noise`` of a chain)."""
    params = [p for p in vae.parameters() if p.requires_grad]
    seed = _seed(seed, placement)

    def body(batch: dict, gen, sched: dict, noise=None) -> dict:
        if "image" in batch:
            images = image_preproc(batch, generator=gen)
        else:
            images = preprocess_batch(batch, preproc, is_train=True)
        vae.train()
        with cudnn_full_f32():
            if noise is not None:
                loss = vae(images, sched["temp"], gumbel_noise=noise)
            else:
                loss = vae(images, sched["temp"], generator=gen)
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
        gnorm = _reduce_and_norm(params, clip, placement)
        _set_lr(optimizer, sched["lr"])
        _update(optimizer, placement)
        return {**_mean({"loss": loss.detach()}, placement), "grad_norm": gnorm}

    if chain:
        return Chain(lambda b, gen, sched: body(b, gen, sched, b.get("gumbel_noise")),
                     device=_param_device(vae), seed=seed, optimizer=optimizer,
                     placement=placement)

    def step(batch: dict, rng, lr: float, temp: float) -> dict:
        if inject_noise:
            return body(batch, None, {"lr": lr, "temp": temp}, noise=rng)
        return body(batch, step_generator(seed, rng, _batch_device(batch)),
                    {"lr": lr, "temp": temp})

    return step


def make_vae_eval_step(vae, preproc: PreprocConfig, placement=None):
    """Returns ``step(batch) -> {"loss", "ids", "images", "recon"}``: the
    eval preprocessing, the argmax codes, their decoding, and the MSE of
    the reconstruction against the unnormalized images (steps.py:122); the
    images and the reconstruction ride along for the panels. An IMNET
    batch's ``image`` is used as it is."""

    def step(batch: dict) -> dict:
        vae.eval()
        with torch.no_grad():
            images = _eval_images(batch, preproc)
            ids = vae.get_codebook_indices(images)
            recon = vae.decode_indices(ids)
            mse = ((images - recon.float()) ** 2).mean()
        return {**_mean({"loss": mse}, placement), "ids": ids, "images": images,
                "recon": recon}

    return step


def _eval_images(batch: dict, preproc: PreprocConfig) -> torch.Tensor:
    if "image" in batch:      # IMNET: the host resized and center-cropped
        return batch["image"].to(torch.float32)
    return preprocess_batch(batch, preproc, is_train=False)


def _pretrain_views(batch: dict, preproc: PreprocConfig, is_train: bool):
    """(the model's images, the tokenizer's images): an IMNET batch's two
    host views, or one preprocessed event image for both."""
    if "patches" in batch:
        return batch["patches"], batch["vae_view"]
    images = preprocess_batch(batch, preproc, is_train=is_train)
    return images, images


def _loss(model, images, mask, labels, generator=None, group=None):
    out = model(images, mask, generator=generator)
    if getattr(model, "num_masked_tokens", None) is not None:
        logits, idx = out
        return masked_cross_entropy_gathered(logits, idx, labels, mask, group)
    return masked_cross_entropy(out, labels, mask, group)


def make_pretrain_train_step(model, vae, optimizer: torch.optim.Optimizer,
                             preproc: PreprocConfig, lr_schedule: np.ndarray,
                             wd_schedule: np.ndarray, clip_grad=None, seed: int = 0,
                             placement=None, chain: bool = False):
    """Returns ``step(batch, it) -> {"loss", "mlm_acc", "grad_norm"}``, or
    with ``chain`` its :class:`Chain`.
    ``batch``: device tensors (events or events_xyp, n_valid, extents,
    flips, shift, mask, and the draw_train_aug draws; on IMNET patches,
    vae_view and mask); ``it``: the global step, which indexes the schedules
    and seeds the step's generator."""
    params = [p for p in model.parameters() if p.requires_grad]
    seed, group = _seed(seed, placement), _group(placement)

    def body(batch: dict, gen, sched: dict) -> dict:
        images, vae_images = _pretrain_views(batch, preproc, True)
        mask = batch["mask"]
        with torch.no_grad():
            labels = vae.get_codebook_indices(vae_images)
        model.train()
        loss, acc = _loss(model, images, mask, labels, gen, group)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        gnorm = _reduce_and_norm(params, clip_grad, placement)
        set_schedule(optimizer, sched["lr"], sched["wd"])
        _update(optimizer, placement)
        return {**_mean({"loss": loss.detach(), "mlm_acc": acc.detach()}, placement),
                "grad_norm": gnorm}

    return _stepper(body, model, optimizer, placement, seed,
                    _schedules(lr_schedule, wd_schedule), chain)


def make_mae_train_step(model, optimizer: torch.optim.Optimizer, preproc: PreprocConfig,
                        lr_schedule: np.ndarray, wd_schedule: np.ndarray, clip_grad=None,
                        seed: int = 0, placement=None, chain: bool = False):
    """Returns ``step(batch, it, noise=None) -> {"loss", "grad_norm"}`` for a
    ``MaskedAutoencoderViT``. ``batch``: device tensors (events or
    events_xyp, n_valid, extents, flips, shift and the draw_train_aug draws;
    no mask); ``it``: the global step, which indexes the schedules and seeds
    the step's generator, from which the (B, L) shuffle noise is drawn unless
    ``noise`` passes it in (the reference's step takes its mask key
    explicitly, steps.py:224-233). ``chain=True``: its :class:`Chain` (the
    noise from the chunk's generator, or each step's from the block's
    ``noise``)."""
    params = [p for p in model.parameters() if p.requires_grad]
    seed, group = _seed(seed, placement), _group(placement)

    def body(batch: dict, gen, sched: dict, noise=None) -> dict:
        images = preprocess_batch(batch, preproc, is_train=True)
        model.train()
        loss, _, _ = model(images, noise=noise, generator=gen, group=group)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        gnorm = _reduce_and_norm(params, clip_grad, placement)
        set_schedule(optimizer, sched["lr"], sched["wd"])
        _update(optimizer, placement)
        return {**_mean({"loss": loss.detach()}, placement), "grad_norm": gnorm}

    sched_fn = _schedules(lr_schedule, wd_schedule)
    if chain:
        return _stepper(lambda b, gen, sched: body(b, gen, sched, b.get("noise")), model,
                        optimizer, placement, seed, sched_fn, True)

    def step(batch: dict, it: int, noise=None) -> dict:
        return body(batch, step_generator(seed, it, _batch_device(batch)), sched_fn(it),
                    noise=noise)

    return step


def _schedules(lr_schedule, wd_schedule):
    """it -> the step's lr and wd from the per-step schedule arrays."""
    return lambda it: {"lr": at(lr_schedule, it), "wd": at(wd_schedule, it)}


def _stepper(body, model, optimizer, placement, seed: int, sched_fn, chain: bool):
    """``body(batch, generator, sched)`` as ``step(batch, it)`` (the step's
    own generator and schedule values) or, with ``chain``, as a Chain."""
    if chain:
        return Chain(body, device=_param_device(model), seed=seed, optimizer=optimizer,
                     placement=placement, sched_fn=sched_fn)

    def step(batch: dict, it: int) -> dict:
        return body(batch, step_generator(seed, it, _batch_device(batch)), sched_fn(it))

    return step


def make_pretrain_eval_step(model, vae, preproc: PreprocConfig, placement=None):
    """Returns ``step(batch) -> {"loss", "mlm_acc"}`` (eval preprocessing,
    deterministic forward, no gradients)."""

    def step(batch: dict) -> dict:
        with torch.no_grad():
            images, vae_images = _pretrain_views(batch, preproc, False)
            labels = vae.get_codebook_indices(vae_images)
            model.eval()
            loss, acc = _loss(model, images, batch["mask"], labels, None, _group(placement))
        return _mean({"loss": loss, "mlm_acc": acc}, placement)

    return step


def make_seg_steps(model, optimizer: torch.optim.Optimizer, lr_fn, weight_decay: float,
                   num_classes: int, rand_aug: bool, rand_aug_batch_ops: bool = False,
                   y_sorted: bool = False, seed: int = 0, placement=None, chain: bool = False):
    """Returns ``(train_step, eval_step)``. ``train_step(batch, it) ->
    {"loss", "grad_norm"}`` on a device batch (events_xyp or events, n_valid,
    label, flip, resize_jitter and, with ``rand_aug``, the draw_seg_train_aug
    draws); ``it`` is the global iteration, which ``lr_fn`` maps to the lr and
    which seeds the step's generator. ``eval_step(batch)`` -> the
    (num_classes, num_classes) f32 confusion matrix of this process's batch
    (the CLI sums the processes' totals with :func:`sum_confusion`). With
    ``chain`` the train step is its :class:`Chain` (BatchNorm buffers
    updated in place by every step)."""
    params = [p for p in model.parameters() if p.requires_grad]
    seed, group = _seed(seed, placement), _group(placement)

    def body(batch: dict, gen, sched: dict) -> dict:
        with torch.no_grad():
            images, labels = seg_preprocess_batch(batch, True, rand_aug, rand_aug_batch_ops,
                                                  y_sorted)
        model.train()
        logits, aux = model(images, train=True, generator=gen)
        loss = seg_loss(logits, aux, labels, num_classes, group=group)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        gnorm = _reduce_and_norm(params, None, placement)
        set_schedule(optimizer, sched["lr"], sched["wd"])
        _update(optimizer, placement)
        return {**_mean({"loss": loss.detach()}, placement), "grad_norm": gnorm}

    train_step = _stepper(body, model, optimizer, placement, seed,
                          lambda it: {"lr": lr_fn(it), "wd": weight_decay}, chain)

    def eval_step(batch: dict) -> torch.Tensor:
        model.eval()
        with torch.no_grad():
            images, labels = seg_preprocess_batch(batch, False, y_sorted=y_sorted)
            pred = model(images)[0].argmax(dim=-1)
            return confusion_matrix(pred, labels, num_classes, IGNORE_INDEX)

    return train_step, eval_step


def sum_confusion(cm: np.ndarray) -> np.ndarray:
    """A host confusion matrix summed over every process (one all-reduce in
    f64; the CPU tensor goes over Gloo, or through the card under NCCL)."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() == 1:
        return cm
    t = torch.from_numpy(np.ascontiguousarray(cm, dtype=np.float64))
    if dist.get_backend() == "nccl":
        t = t.cuda()
    dist.all_reduce(t)
    return t.cpu().numpy()


def _batch_mean(per_sample: torch.Tensor, group=None) -> torch.Tensor:
    """The mean over the batch, over the global batch with ``group``."""
    if group is None:
        return per_sample.mean()
    return global_quotient(per_sample.sum(), torch.tensor(float(per_sample.shape[0]),
                                                          device=per_sample.device), group)


def finetune_cross_entropy(logits, targets, num_classes: int, smoothing: float = 0.0,
                           group=None):
    """The three forms of steps.py:282-295 on f32 logits: soft targets
    (``targets`` shaped as the logits), label smoothing
    (``(1 - eps) onehot + eps / K``), or hard labels; the mean over the
    global batch with ``group`` (the "data" processes)."""
    lp = torch.log_softmax(logits.float(), dim=-1)
    if targets.ndim == logits.ndim:
        return _batch_mean(-(targets * lp).sum(dim=-1), group)
    if smoothing > 0:
        return _batch_mean(-(one_hot_smoothed(targets, num_classes, smoothing) * lp)
                           .sum(dim=-1), group)
    return _batch_mean(-lp.gather(-1, targets.long()[..., None])[..., 0], group)


def make_finetune_train_step(model, optimizer: torch.optim.Optimizer, preproc: PreprocConfig,
                             num_classes: int, lr_schedule: np.ndarray,
                             wd_schedule: np.ndarray, mixup: MixupConfig | None = None,
                             smoothing: float = 0.0, update_freq: int = 1,
                             ema: list | None = None, ema_decay: float | None = None,
                             clip_grad=None, seed: int = 0, image_preproc=None,
                             placement=None, chain: bool = False):
    """Returns ``step(micro_batches, it) -> {"loss", "grad_norm"}``.
    ``micro_batches``: ``update_freq`` device batches (events or events_xyp,
    n_valid, extents, flips, shift, label, the draw_train_aug draws and, with
    ``mixup``, the draw_mixup draws); loss and gradients are their mean
    (steps.py:315-335). ``it``: the optimizer step, which indexes the
    schedules and seeds the micro-batches' generators. ``ema``: f32 tensors in
    the order of ``model.parameters()``, updated in place after the step as
    ``decay * ema + (1 - decay) * param``; None (with ``ema_decay`` None)
    keeps no EMA at all. An IMNET micro-batch (``image``, label and the
    draw_image_aug draws) goes through ``image_preproc(batch, generator=...)``
    with the micro-batch's generator before the mixup. ``chain=True``: its
    :class:`Chain` over (k, update_freq, B, ...) blocks, every micro-batch
    drawing from the chunk's generator."""
    if (ema is None) != (ema_decay is None):
        raise ValueError("pass both ema and ema_decay, or neither")
    params = [p for p in model.parameters() if p.requires_grad]
    all_params = list(model.parameters())
    seed, group = _seed(seed, placement), _group(placement)
    sched_fn = _schedules(lr_schedule, wd_schedule)

    def body(micro_batches, gens, sched: dict) -> dict:
        if len(micro_batches) != update_freq:
            raise ValueError(f"expected {update_freq} micro-batches, got {len(micro_batches)}")
        model.train()
        optimizer.zero_grad(set_to_none=True)
        total = None
        for i, batch in enumerate(micro_batches):
            gen = gens(i, batch)
            with torch.no_grad():
                if "image" in batch:
                    images = image_preproc(batch, generator=gen)
                else:
                    images = preprocess_batch(batch, preproc, is_train=True)
                targets = batch["label"]
                if mixup is not None:
                    images, targets = mixup_apply(images, targets,
                                                  {k: batch[k] for k in MIXUP_KEYS}, mixup)
            logits = model(images, generator=gen)
            loss = finetune_cross_entropy(logits, targets, num_classes, smoothing,
                                          group) / update_freq
            loss.backward()
            total = loss.detach() if total is None else total + loss.detach()
        gnorm = _reduce_and_norm(params, clip_grad, placement)
        set_schedule(optimizer, sched["lr"], sched["wd"])
        _update(optimizer, placement)
        if ema is not None:
            with torch.no_grad():
                torch._foreach_mul_(ema, ema_decay)
                torch._foreach_add_(ema, [p.detach() for p in all_params],
                                    alpha=1.0 - ema_decay)
        return {**_mean({"loss": total}, placement), "grad_norm": gnorm}

    if chain:
        def chained(batch: dict, gen, sched: dict) -> dict:
            return body([step_of(batch, j) for j in range(update_freq)],
                        lambda i, b: gen, sched)

        return Chain(chained, device=_param_device(model), seed=seed, optimizer=optimizer,
                     placement=placement, sched_fn=sched_fn)

    def step(micro_batches, it: int) -> dict:
        return body(micro_batches,
                    lambda i, b: step_generator(seed, it * update_freq + i, _batch_device(b)),
                    sched_fn(it))

    return step


def make_finetune_eval_step(model, preproc: PreprocConfig, with_predictions: bool = False,
                            placement=None):
    """Returns ``step(batch) -> {"loss", "acc1", "acc5"}`` (eval
    preprocessing, deterministic forward, hard-label cross-entropy, top-1 and
    top-5 in percent); ``with_predictions`` adds the per-sample top-k class
    ids and probabilities (steps.py:389-419)."""
    k = 5

    def step(batch: dict) -> dict:
        model.eval()
        with torch.no_grad():
            images = _eval_images(batch, preproc)
            logits = model(images).float()
            targets = batch["label"].long()
            lp = torch.log_softmax(logits, dim=-1).gather(-1, targets[:, None])[:, 0]
            top1 = (logits.argmax(dim=-1) == targets).float()
            topk_p, topk_ids = torch.softmax(logits, dim=-1).topk(min(k, logits.shape[-1]),
                                                                  dim=-1)
            top5 = (topk_ids == targets[:, None]).any(dim=-1).float()
            group = _group(placement)
            out = _mean({"loss": _batch_mean(-lp, group),
                         "acc1": _batch_mean(top1, group) * 100.0,
                         "acc5": _batch_mean(top5, group) * 100.0}, placement)
            if with_predictions:
                out["topk_ids"] = topk_ids
                out["topk_probs"] = topk_p
        return out

    return step

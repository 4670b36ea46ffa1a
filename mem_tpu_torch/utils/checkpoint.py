"""Checkpoints for the port: PyTorch ``.pth`` files.

Port of mem_tpu/utils/checkpoint.py ``latest_checkpoint`` /
``load_checkpoint`` / ``save_checkpoint`` for the format ``python -m
mem_tpu.cli.export_torch`` writes, ``{"model": state_dict, "epoch": n}``
(export_torch.py:57-60), which is also the reference's own checkpoint
format; the training CLIs add ``"optimizer"``. Segmentation training saves
by iteration: ``checkpoint-{it}.pth`` holds the segmentor's state_dict in
the ``export_seg_params`` keys (BatchNorm buffers included), the optimizer
and ``"epoch": it + 1``, the iteration to continue at;
``checkpoint-final.pth`` holds no optimizer, and ``test_seg --checkpoint``
reads either as it is. Classification finetuning saves by epoch:
``checkpoint-{epoch}.pth`` holds the model, the optimizer, ``"ema"`` (a
state_dict of the EMA weights under the parameters' names, present only when
EMA is on), ``"epoch"`` and ``"best_acc"``; ``checkpoint-best.pth`` holds the
model, its epoch and its top-1 and is not resumable, so the finetune CLI
resumes from :func:`latest_numbered_checkpoint` and takes a checkpoint
written under the other ``--model_ema`` setting too (a missing EMA is
re-seeded from the weights, a surplus one dropped). Orbax checkpoint
directories are out of reach:
reading them needs jax; export them to .pth first.

``prune_checkpoints`` is the pipeline scripts' stage-boundary pruning
(train-pipeline.sbatch:87-101): it keeps ``final``, ``best`` and the newest
numbered checkpoint. The reference's orbax cases map so: the temporary
directory of an interrupted async save is, here, the ``.tmp`` file of an
interrupted :func:`save_checkpoint` (removed the same way); a ``.pth``
carries its metadata inside, so there is no ``.meta.json`` sidecar.
"""
from __future__ import annotations

import os
import re
from typing import Any, Dict, Optional

# torch is imported where a checkpoint is read or written: the pipeline
# scripts run prune_checkpoints in a process of its own between stages


def latest_checkpoint(output_dir: str) -> Optional[str]:
    """The newest ``*.pth`` in ``output_dir`` (by modification time), or
    None when it is not a directory or holds none."""
    if not os.path.isdir(output_dir):
        return None
    paths = [os.path.join(output_dir, n) for n in os.listdir(output_dir)
             if n.endswith(".pth")]
    return max(paths, key=os.path.getmtime) if paths else None


def latest_numbered_checkpoint(output_dir: str) -> Optional[str]:
    """``checkpoint-{N}.pth`` with the highest N in ``output_dir`` (the
    reference's ``latest_checkpoint``, utils.py:539-557: ``final`` and other
    tags do not count), or None."""
    if not os.path.isdir(output_dir):
        return None
    tags = [int(m.group(1)) for m in (re.fullmatch(r"checkpoint-(\d+)\.pth", n)
                                      for n in os.listdir(output_dir)) if m]
    return os.path.join(output_dir, f"checkpoint-{max(tags)}.pth") if tags else None


def load_checkpoint(path: str) -> Dict[str, Any]:
    """Load a .pth checkpoint onto the CPU (tensors and plain values only)."""
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory without a .pth checkpoint; orbax checkpoints "
            f"need jax to read -- convert one with `python -m "
            f"mem_tpu.cli.export_torch --checkpoint {path} --output model.pth`")
    import torch

    return torch.load(path, map_location="cpu", weights_only=True)


def save_checkpoint(output_dir: str, tag, payload: Dict[str, Any]) -> str:
    """Write ``payload`` to ``output_dir/checkpoint-{tag}.pth`` atomically
    (a temporary file, then a rename); returns the path. In a multi-process
    run every process calls it with the single-process payload
    (parallel/mesh.py ``Placement.model_state_dict`` /
    ``optimizer_state_dict`` gather it), rank 0 writes, and a barrier follows
    the write, so no process reads or prunes a half-written file."""
    import torch
    import torch.distributed as dist

    path = os.path.join(output_dir, f"checkpoint-{tag}.pth")
    multi = dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1
    if not multi or dist.get_rank() == 0:
        os.makedirs(output_dir, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)
    if multi:
        dist.barrier()
    return path


def prune_checkpoints(output_dir: str, keep_tags=("final", "best")) -> None:
    """Remove every ``checkpoint-*.pth`` in ``output_dir`` but those tagged
    ``keep_tags`` and the highest numbered one, and the ``.tmp`` files that
    an interrupted save left (mem_tpu/utils/checkpoint.py:190-222). A
    relative ``output_dir`` is taken from the current directory."""
    output_dir = os.path.abspath(output_dir)
    if not os.path.isdir(output_dir):
        return
    latest = latest_numbered_checkpoint(output_dir)
    for name in os.listdir(output_dir):
        full = os.path.join(output_dir, name)
        if re.fullmatch(r"checkpoint-.+\.pth\.\d+\.tmp", name):
            os.remove(full)
            continue
        m = re.fullmatch(r"checkpoint-(.+)\.pth", name)
        if not m or m.group(1) in keep_tags or full == latest:
            continue
        os.remove(full)

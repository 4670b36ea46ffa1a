"""Dataset preprocessing CLI: raw event recordings -> .npy, the port's own
copy of mem_tpu/cli/process_dataset.py (no jax; host numpy and the native
decoders).

Same surface as the reference (process_data/process_dataset.py:11-21):
  --dataset {ncaltech101,ncars,nimagenet,dsec} --input --output --cores
  --split --class_folder
The raw files are decoded by the C++ decoders of ``mem_tpu_torch.native``
where that library builds, else by numpy; both write the same bytes.

The output tree and file names are the reference's:
  ncaltech101: <output>/{train,val}/<class>/<stem>.npy, routed by the split
    file (a file named in neither list is skipped; without --split every
    file is);
  ncars:     <input>/n-cars_{train,test}/<class>/ -> <output>/{train,val}/<class>/;
  nimagenet: <input>/extracted_{train,val}/<class>/ -> <output>/{train,val}/<class>/;
  dsec:      <input>/{train,test}_events/<seq>/events/right/events.h5 ->
             <output>/{train,test}_events/<seq>/events_right_npy/<i:06d>.npy,
             20 Hz windows of [x, y, 0, p] (needs h5py).
``--cores N`` splits the class folders over N spawned worker processes
(folder i goes to worker i mod N); the worker is a module-level function, so
the output is the same under any multiprocessing start method.

Usage:
  python -m mem_tpu_torch.cli.process_dataset --dataset ncaltech101 \\
      --input Caltech101 --output datasets/ncaltech101 \\
      --split configs/splits/ncaltech101.txt --cores 8
"""
from __future__ import annotations

import argparse
import multiprocessing
import os

import numpy as np

from mem_tpu_torch.events.decoders import decode_ncaltech101_file, decode_ncars_file


def get_args(argv=None):
    p = argparse.ArgumentParser("event dataset processing")
    p.add_argument("--dataset", required=True,
                   choices=["ncaltech101", "ncars", "nimagenet", "dsec"])
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--cores", default=1, type=int)
    p.add_argument("--split", type=str, default=None)
    p.add_argument("--class_folder", type=str, default=None)
    return p.parse_args(argv)


def _read_split(split_path: str, folder: str):
    """(train stems, val stems) of ``folder`` in the split file: a line
    naming the folder goes to val if it holds "val", else to train if it
    holds "train"; the stem is the last path part without its ".npy\\n"."""
    train_set, val_set = [], []
    with open(split_path) as f:
        for line in f:
            if folder not in line:
                continue
            stem = line.split("/")[-1][:-5].strip()
            if "val" in line:
                val_set.append(stem)
            elif "train" in line:
                train_set.append(stem)
    return train_set, val_set


def ncaltech101(folder: str, args) -> None:
    """Reference process_dataset.py:24-63: route the files by the split
    file, decode ATIS bytes, save float64 [y, x, t, p = +-1]."""
    train_set, val_set = ([], [])
    if args.split is not None:
        train_set, val_set = _read_split(args.split, folder)
    src = os.path.join(args.input, folder)
    for filename in os.listdir(src):
        stem = filename.split(".")[0]
        if stem in train_set:
            split = "train"
        elif stem in val_set:
            split = "val"
        else:
            continue
        dst = os.path.join(args.output, split, folder)
        os.makedirs(dst, exist_ok=True)
        events = decode_ncaltech101_file(os.path.join(src, filename))
        np.save(os.path.join(dst, stem + ".npy"), events)


def ncars(folder: str, args) -> None:
    """Reference process_dataset.py:66-105: n-cars_train / n-cars_test ->
    train / val; save float64 [y, x, t, p in {0, 1}]."""
    for split, split_name in (("train", "n-cars_train"), ("val", "n-cars_test")):
        src = os.path.join(args.input, split_name, folder)
        if not os.path.isdir(src):
            continue
        dst = os.path.join(args.output, split, folder)
        os.makedirs(dst, exist_ok=True)
        for filename in os.listdir(src):
            events = decode_ncars_file(os.path.join(src, filename))
            np.save(os.path.join(dst, filename.split(".")[0]), events)


def nimagenet(folder: str, args) -> None:
    """Reference process_dataset.py:108-117: repack npz['event_data']."""
    for split, split_name in (("train", "extracted_train"), ("val", "extracted_val")):
        src = os.path.join(args.input, split_name, folder)
        if not os.path.isdir(src):
            continue
        dst = os.path.join(args.output, split, folder)
        os.makedirs(dst, exist_ok=True)
        for filename in os.listdir(src):
            data = np.load(os.path.join(src, filename))["event_data"]
            np.save(os.path.join(dst, filename.split(".")[0] + ".npy"), data)


def dsec(folders, args) -> None:
    """Reference process_dataset.py:120-170: slice events.h5 into 20 Hz
    windows; save [x, y, 0, p] per frame, with the complete EventSlicer."""
    import h5py

    from mem_tpu_torch.events.slicer import EventSlicer

    STEREO = "right"
    H, W = 480, 640
    for split_name in ("train_events", "test_events"):
        for seq in folders:
            base = os.path.join(args.input, split_name)
            if not os.path.isdir(os.path.join(base, seq)):
                continue
            datapath = os.path.join(base, seq, "events", STEREO)
            if not os.path.exists(os.path.join(datapath, "events.h5")):
                print(f"warning: no events at {datapath}")
                continue
            out = os.path.join(args.output, split_name, seq, f"events_{STEREO}_npy")
            os.makedirs(out, exist_ok=True)
            with h5py.File(os.path.join(datapath, "events.h5"), "r") as evfile:
                slicer = EventSlicer(evfile)
                t0 = int(evfile["events"]["t"][0])
                t1 = int(evfile["events"]["t"][-1])
                t_offset = int(np.asarray(evfile["t_offset"]))
                dt_us = t1 - t0
                tss_us = np.linspace(t0, t1, int(dt_us * 1e-6 * 20), dtype=np.int64)[1:] + t_offset
                dt_avg_us = np.diff(tss_us).mean()
                for i, ts in enumerate(tss_us):
                    sl = slicer.get_events(ts - dt_avg_us, ts)
                    if sl is None:
                        continue
                    assert (sl["x"] < W).all() and (sl["y"] < H).all()
                    ev = np.stack((sl["x"], sl["y"], sl["y"] * 0, sl["p"])).T
                    np.save(os.path.join(out, f"{i:06d}.npy"), ev)


PROCESSORS = {"ncaltech101": ncaltech101, "ncars": ncars, "nimagenet": nimagenet}


def _worker(dataset: str, folders, args) -> None:
    """One ``--cores`` worker: process its share of the class folders."""
    for f in folders:
        PROCESSORS[dataset](f, args)


def class_folders(args):
    """The class folders to process: ``--class_folder``, else every folder
    under the input (under its train split for N-Cars and N-ImageNet)."""
    if args.class_folder:
        return [args.class_folder]
    probe = {"ncars": os.path.join(args.input, "n-cars_train"),
             "nimagenet": os.path.join(args.input, "extracted_train")}.get(args.dataset,
                                                                         args.input)
    return sorted(d for d in os.listdir(probe) if os.path.isdir(os.path.join(probe, d)))


def main(argv=None):
    args = get_args(argv)
    if args.dataset == "dsec":
        seqs = [args.class_folder] if args.class_folder else sorted(os.listdir(args.input))
        dsec(seqs, args)
        return
    folders = class_folders(args)
    if args.cores <= 1:
        _worker(args.dataset, folders, args)
        return
    # spawned, not forked: the caller may hold threads (torch, CUDA) that a
    # forked child would inherit mid-lock
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_worker, args=(args.dataset, folders[i::args.cores], args))
             for i in range(args.cores)]
    for p in procs:
        p.start()
    for p in procs:
        p.join()
    bad = [p.exitcode for p in procs if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"process_dataset: {len(bad)} worker(s) failed "
                           f"(exit codes {bad})")


if __name__ == "__main__":
    main()

"""Label-efficiency subset generator, the port's own copy of
mem_tpu/cli/make_subsets.py (numpy only; the same seeded draw, so the same
files).

The reference ships fixed N-Caltech101 split files plus 2/5/10/20/50%
label-efficiency subsets (configs/splits/fig1-subsets/, SURVEY §2.10). This
utility generates equivalent subset split files from any full split file:
per class, keep ``fraction`` of the train entries (at least one), keeping
all val entries.

Usage:
  python -m mem_tpu_torch.cli.make_subsets --split splits/ncaltech101.txt \
      --fractions 0.02 0.05 0.1 0.2 0.5 --output_dir splits/subsets --seed 0
"""
from __future__ import annotations

import argparse
import os
from collections import defaultdict

import numpy as np


def make_subset(lines, fraction: float, seed: int = 0):
    by_class = defaultdict(list)
    val_lines = []
    for line in lines:
        line = line.strip()
        if not line:
            continue
        if "val" in line.split("/")[0]:
            val_lines.append(line)
        else:
            cls = line.split("/")[1] if "/" in line else ""
            by_class[cls].append(line)
    rng = np.random.default_rng(seed)
    out = []
    for cls in sorted(by_class):
        entries = sorted(by_class[cls])
        k = max(1, int(round(len(entries) * fraction)))
        idx = rng.choice(len(entries), size=k, replace=False)
        out.extend(entries[i] for i in sorted(idx))
    return out + val_lines


def main(argv=None):
    p = argparse.ArgumentParser("label-efficiency subset split generator")
    p.add_argument("--split", required=True)
    p.add_argument("--fractions", type=float, nargs="+",
                   default=[0.02, 0.05, 0.1, 0.2, 0.5])
    p.add_argument("--output_dir", required=True)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    with open(args.split) as f:
        lines = f.readlines()
    os.makedirs(args.output_dir, exist_ok=True)
    base = os.path.splitext(os.path.basename(args.split))[0]
    for frac in args.fractions:
        out = make_subset(lines, frac, args.seed)
        path = os.path.join(args.output_dir, f"{base}_{int(frac * 100)}pct.txt")
        with open(path, "w") as f:
            f.write("\n".join(out) + "\n")
        print(f"{path}: {len(out)} entries")


if __name__ == "__main__":
    main()

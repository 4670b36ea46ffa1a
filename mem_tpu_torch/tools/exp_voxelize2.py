"""Voxelizer kernel experiments X2a, X2b, X2c: y-sorted events and a row-band
accumulator that skips the (band, chunk) pairs a chunk's rows miss (the
algorithmic cut of the one-hot contraction), its int8 variant, and the cost
of the packed-key sort, on the H100 beside the production K1 and K4.

Port of scripts/exp_voxelize2.py. Its three Pallas bodies are kept as the
one-hot contraction on the tensor cores (csrc/exp_voxelize2.cu, on X1's
block, csrc/exp_voxelize.cuh):

- X2a ``exp_voxelize2_fused_i8``: X1b's dense contraction with int8
  one-hots and int32 sums (mma.sync m16n8k32): K1's (B, H, 2W) function as
  int32. The chunk must be a multiple of 32 (one int8 k-step).
- X2b ``exp_voxelize2_tiled``: bands of TH rows (a multiple of 32); a band
  computes a chunk of ``chunk`` events only when the chunk's
  [min ys, max ys] meets it, the reference's test, exact for any event
  order. bf16 one-hots, f32 sums; output (B, n_tiles * TH, 2W), n_tiles =
  ceil(H / TH), whose rows H <= y < n_tiles * TH count too (the reference
  crops [:, :H]).
- X2c ``exp_voxelize2_tiled_i8``: X2b in int8 with int32 sums.

The packed-key sort ``sort_packed`` (key = ys * 4096 + col, one sort per
sample, split back by floor division and modulo) is ``jnp.sort`` in the
reference, XLA's own and outside any Pallas kernel; here it is ``torch.sort``
on the int32 key, no kernel of the port's. ``e2e_sort_tiled`` is the
reference's ``e2e``: the sort, then X2b or X2c. The kernels mask the ragged
last chunk, so nothing is padded.

CPU tensors take the plain versions; CUDA tensors launch the kernels or
raise. On the card, run from the repo root::

    python -m mem_tpu_torch.tools.exp_voxelize2 [main|main2|main3|all]

``main`` (the reference's ``__main__``) times the sort, X2a unsorted at chunk
2048 and X2b on sorted events at (TH, chunk) in (128, 2048), (128, 4096),
(64, 2048), (128, 8192), K4 on the same sorted events, then the sort and X2b
(128, 4096) from unsorted events; ``main2`` X2b at (32, 2048), (64, 1024),
X2c at (64, 2048), (32, 2048), (64, 1024) and the sort with X2c (64, 2048);
``main3`` the classification shape (B=64, N=30,720, 256x256): X2a at chunk
2048 and 4096 and the production K1. It prints the card's name and power
limit, then one ``== name: ms -> Gev/s`` line per variant under the
reference's names, each the median of RUNS CUDA-event timings after WARMUP
calls, on the reference's seeded events (B=8, N=180,224, 440x640). Each
variant is first held bit for bit against its plain version on the whole
batch ("WRONG RESULT" and exit 1 otherwise). Without a card it exits 2.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from mem_tpu_torch.kernels import count_launch
from mem_tpu_torch.ops.attention import MAX_SMEM_BYTES
from mem_tpu_torch.ops.voxelize_hist import (KEY_COLS, _check_cuda_events,
                                             hist_planes_cols_reference,
                                             hist_planes_cols_sorted, pack_cols,
                                             voxelize_planes)
from mem_tpu_torch.tools import time_ms

RUNS, WARMUP = 10, 2
SEG = (8, 180_224, 440, 640)   # exp_voxelize2.py:21
CLS = (64, 30_720, 256, 256)   # main3, exp_voxelize2.py:277
# (dtype, TH, chunk) of the reference's sweeps, in its order
MAIN_TILED = (("bf16", 128, 2048), ("bf16", 128, 4096), ("bf16", 64, 2048), ("bf16", 128, 8192))
MAIN_E2E = ("bf16", 128, 4096)
MAIN2_TILED = (("bf16", 32, 2048), ("bf16", 64, 1024), ("i8", 64, 2048), ("i8", 32, 2048),
               ("i8", 64, 1024))
MAIN2_E2E = ("i8", 64, 2048)
MAIN_DENSE_CHUNK = 2048
CLS_DENSE_CHUNKS = (2048, 4096)
WARP_ROWS = 32   # a warp's slice of the kernels' 64-row tile lies in one band


def n_rows(H: int, TH: int) -> int:
    """Rows of the tiled output: n_tiles * TH, n_tiles = ceil(H / TH)."""
    return -(-H // TH) * TH


def _check_args(name: str, col, ys, chunk: int, step: int, TH: int | None = None) -> None:
    """What every device asks of the arguments: int32 (B, N) events of one
    shape, a chunk that is a positive multiple of the k-step ``step`` and
    fits a block's shared memory (chunk events of col and ys), a TH that is
    a positive multiple of 32."""
    if col.dtype != torch.int32 or ys.dtype != torch.int32:
        raise ValueError(f"{name} takes int32 col and ys, got {col.dtype} / {ys.dtype}")
    if col.dim() != 2 or col.shape != ys.shape:
        raise ValueError(f"{name}: shapes {tuple(col.shape)} vs {tuple(ys.shape)}")
    if chunk <= 0 or chunk % step:
        raise ValueError(f"{name}: chunk {chunk} must be a positive multiple of {step}")
    if chunk * 2 * 4 > MAX_SMEM_BYTES:
        raise ValueError(f"{name}: chunk {chunk} needs {chunk * 8} B of shared memory, "
                         f"above the {MAX_SMEM_BYTES} B a block may use")
    if TH is not None and (TH <= 0 or TH % WARP_ROWS):
        raise ValueError(f"{name}: TH {TH} must be a positive multiple of {WARP_ROWS}")


def exp_voxelize2_fused_i8_reference(col, ys, H: int, W: int) -> torch.Tensor:
    """Plain version of X2a: K1's plain version, (B, H, 2W) int32."""
    return hist_planes_cols_reference(col, ys, H, W)


def exp_voxelize2_tiled_reference(col, ys, H: int, W: int, TH: int,
                                  dtype=torch.float32) -> torch.Tensor:
    """Plain version of X2b (f32) and X2c (int32): a scatter-add of ones into
    (B, n_tiles * TH, 2W) over rows [0, n_tiles * TH) and columns [0, 2W)."""
    return hist_planes_cols_reference(col, ys, n_rows(H, TH), W).to(dtype)


def exp_voxelize2_fused_i8(col, ys, H: int, W: int, chunk: int = 2048) -> torch.Tensor:
    """X2a: (B, N) int32 packed col / ys -> (B, H, 2W) int32 count planes,
    staged ``chunk`` events at a time."""
    name = "exp_voxelize2_fused_i8"
    _check_args(name, col, ys, chunk, 32)
    if col.device.type == "cpu":
        return exp_voxelize2_fused_i8_reference(col, ys, H, W)
    _check_cuda_events(name, col, ys)
    return _launch(name, "mem_exp_voxelize2_fused_i8", col, ys, H, W, torch.int32, None, chunk)


def exp_voxelize2_tiled(col, ys, H: int, W: int, TH: int, chunk: int) -> torch.Tensor:
    """X2b: (B, N) int32 col / ys -> (B, n_tiles * TH, 2W) f32 count planes
    by bands of TH rows, skipping the chunks of ``chunk`` events whose y range
    misses a band (bf16 one-hots)."""
    name = "exp_voxelize2_tiled"
    _check_args(name, col, ys, chunk, 16, TH)
    if col.device.type == "cpu":
        return exp_voxelize2_tiled_reference(col, ys, H, W, TH)
    _check_cuda_events(name, col, ys)
    return _launch(name, "mem_exp_voxelize2_tiled", col, ys, H, W, torch.float32, TH, chunk)


def exp_voxelize2_tiled_i8(col, ys, H: int, W: int, TH: int, chunk: int) -> torch.Tensor:
    """X2c: X2b with int8 one-hots -> (B, n_tiles * TH, 2W) int32."""
    name = "exp_voxelize2_tiled_i8"
    _check_args(name, col, ys, chunk, 32, TH)
    if col.device.type == "cpu":
        return exp_voxelize2_tiled_reference(col, ys, H, W, TH, torch.int32)
    _check_cuda_events(name, col, ys)
    return _launch(name, "mem_exp_voxelize2_tiled_i8", col, ys, H, W, torch.int32, TH, chunk)


def _launch(name, entry, col, ys, H, W, dtype, TH, chunk):
    """Launch the kernel at ``entry`` into new planes (tiled when TH is
    given, with its bounds scratch) and count the launch under ``name``."""
    from mem_tpu_torch.kernels import build

    B, N = col.shape
    lib = build.library(col.device)
    rows = H if TH is None else n_rows(H, TH)
    out = torch.empty(B, rows, 2 * W, dtype=dtype, device=col.device)
    stream = torch.cuda.current_stream(out.device).cuda_stream
    if TH is None:
        rc = getattr(lib, entry)(col.data_ptr(), ys.data_ptr(), out.data_ptr(), B, N, H, W,
                                 chunk, stream)
    else:
        bounds = torch.empty(B, max(-(-N // chunk), 1), 2, dtype=torch.int32,
                             device=col.device)
        rc = getattr(lib, entry)(col.data_ptr(), ys.data_ptr(), out.data_ptr(),
                                 bounds.data_ptr(), B, N, H, W, TH, chunk, stream)
    build.check(name, rc)
    count_launch(name)
    return out


def sort_packed(col, ys):
    """The reference's packed-key sort (exp_voxelize2.py:104-109): key =
    ys * 4096 + col (int32), sorted per sample, split by floor division and
    modulo. Returns (col, ys) sorted by y, then by col."""
    key = torch.sort(ys * KEY_COLS + col, dim=1).values
    return torch.remainder(key, KEY_COLS), torch.div(key, KEY_COLS, rounding_mode="floor")


def e2e_sort_tiled(col, ys, H: int, W: int, TH: int, chunk: int, int8: bool = False):
    """The reference's ``e2e``: ``sort_packed``, then X2c (``int8``) or X2b
    on the sorted events."""
    if 2 * W >= KEY_COLS:
        raise ValueError(f"e2e_sort_tiled: 2W = {2 * W} does not fit the 12 bits the "
                         f"packed key keeps for the column")
    c, y = sort_packed(col, ys)
    c, y = c.contiguous(), y.contiguous()
    return (exp_voxelize2_tiled_i8 if int8 else exp_voxelize2_tiled)(c, y, H, W, TH, chunk)


def make_inputs(B: int, N: int, H: int, W: int, sort: bool, device):
    """The reference's seeded events (exp_voxelize2.py:65-77), not padded:
    (col, ys) on ``device``, y-sorted per sample (stable) with ``sort``."""
    rng = np.random.default_rng(0)
    xs = rng.integers(0, W, (B, N)).astype(np.int32)
    ys = rng.integers(0, H, (B, N)).astype(np.int32)
    pol = rng.choice([0, 1], (B, N)).astype(np.int32)
    col = (xs + W * (1 - pol)).astype(np.int32)
    if sort:
        order = np.argsort(ys, axis=1, kind="stable")
        ys = np.take_along_axis(ys, order, axis=1)
        col = np.take_along_axis(col, order, axis=1)
    return torch.from_numpy(col).to(device), torch.from_numpy(ys).to(device)


def _variant(name: str, fn, want, events: int) -> bool:
    """Hold ``fn()`` to ``want`` bit for bit, then time it and print its line."""
    got = fn()
    if not torch.equal(got, want):
        print(f"{name}: WRONG RESULT (max abs err "
              f"{(got.double() - want.double()).abs().max().item()})", flush=True)
        return False
    ms = time_ms(fn, RUNS, WARMUP)
    print(f"== {name}: {ms:.4f} ms -> {events / ms / 1e6:.3f} Gev/s", flush=True)
    return True


def _run_tiled(sweep, col, ys, H, W, tagged) -> bool:
    """X2b / X2c at each (dtype, TH, chunk) of ``sweep``, named as the
    reference names them (main2 ``tagged`` with the dtype)."""
    ok = True
    for dt, TH, chunk in sweep:
        fn = exp_voxelize2_tiled_i8 if dt == "i8" else exp_voxelize2_tiled
        want = exp_voxelize2_tiled_reference(col, ys, H, W, TH,
                                             torch.int32 if dt == "i8" else torch.float32)
        name = f"sorted_tiled_{dt}_t{TH}_c{chunk}" if tagged else f"sorted_tiled_t{TH}_c{chunk}"
        ok &= _variant(name, lambda: fn(col, ys, H, W, TH, chunk), want, col.numel())
    return ok


def _run_e2e(name, spec, col, ys, H, W) -> bool:
    """The sort and the tiled kernel from unsorted events, against the plain
    version of the same composition."""
    dt, TH, chunk = spec
    c, y = sort_packed(col, ys)
    want = exp_voxelize2_tiled_reference(c, y, H, W, TH,
                                         torch.int32 if dt == "i8" else torch.float32)
    return _variant(name, lambda: e2e_sort_tiled(col, ys, H, W, TH, chunk, dt == "i8"), want,
                    col.numel())


def run_main() -> bool:
    """The reference's ``main`` at the seg shape."""
    B, N, H, W = SEG
    col, ys = make_inputs(B, N, H, W, False, "cuda")
    print(f"---- main: B={B} N={N} {H}x{W} ----", flush=True)
    ms = time_ms(lambda: sort_packed(col, ys), RUNS, WARMUP)
    print(f"== onchip_sort(8x180k): {ms:.4f} ms -> {B * N / ms / 1e6:.3f} Gev/s", flush=True)
    ok = _variant("int8_dense", lambda: exp_voxelize2_fused_i8(col, ys, H, W, MAIN_DENSE_CHUNK),
                  exp_voxelize2_fused_i8_reference(col, ys, H, W), B * N)
    cols, yss = make_inputs(B, N, H, W, True, "cuda")
    ok &= _run_tiled(MAIN_TILED, cols, yss, H, W, tagged=False)
    # the production K4 on the same sorted events
    ok &= _variant("sorted_k4_presorted",
                   lambda: hist_planes_cols_sorted(cols, yss, H, W, presorted=True),
                   hist_planes_cols_reference(cols, yss, H, W), B * N)
    return ok & _run_e2e("e2e_sort_tiled", MAIN_E2E, col, ys, H, W)


def run_main2() -> bool:
    """The reference's ``main2`` at the seg shape."""
    B, N, H, W = SEG
    col, ys = make_inputs(B, N, H, W, False, "cuda")
    cols, yss = make_inputs(B, N, H, W, True, "cuda")
    print(f"---- main2: B={B} N={N} {H}x{W} ----", flush=True)
    ok = _run_tiled(MAIN2_TILED, cols, yss, H, W, tagged=True)
    dt, TH, chunk = MAIN2_E2E
    return ok & _run_e2e(f"e2e_sort_tiled_{dt}_t{TH}_c{chunk}", MAIN2_E2E, col, ys, H, W)


def run_main3() -> bool:
    """The reference's ``main3``: X2a at the classification shape, and the
    production K1 (``voxelize_planes`` packs and routes this canvas to K1) on
    the reference's own draws of raw events."""
    B, N, H, W = CLS
    col, ys = make_inputs(B, N, H, W, False, "cuda")
    print(f"---- main3: B={B} N={N} {H}x{W} ----", flush=True)
    want = exp_voxelize2_fused_i8_reference(col, ys, H, W)
    ok = True
    for chunk in CLS_DENSE_CHUNKS:
        ok &= _variant(f"cls_int8_dense_c{chunk}",
                       lambda: exp_voxelize2_fused_i8(col, ys, H, W, chunk), want, B * N)
    rng = np.random.default_rng(0)
    xs = torch.from_numpy(rng.integers(0, W, (B, N)).astype(np.int32)).cuda()
    ys2 = torch.from_numpy(rng.integers(0, H, (B, N)).astype(np.int32)).cuda()
    wp = torch.from_numpy((rng.random((B, N)) < 0.5).astype(np.float32)).cuda()
    wn = 1.0 - wp
    want = hist_planes_cols_reference(*pack_cols(xs, ys2, wp, wn, H, W), H, W)
    return ok & _variant("cls_prod_current", lambda: voxelize_planes(xs, ys2, wp, wn, H, W),
                         want, B * N)


RUNNERS = {"main": run_main, "main2": run_main2, "main3": run_main3}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    which = argv[0] if argv else "main"
    if which not in (*RUNNERS, "all"):
        print(f"exp_voxelize2: unknown part {which!r} (main, main2, main3 or all)",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("exp_voxelize2: no CUDA device is available; the experiment runs on the card only",
              file=sys.stderr)
        return 2
    from mem_tpu_torch.utils.env import nvidia_smi

    print(nvidia_smi() or torch.cuda.get_device_name(0), flush=True)
    ok = True
    for part, run in RUNNERS.items():
        if which in (part, "all"):
            ok &= run()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

"""Step timers and profilers of the port's measuring tools (``trace_*``,
``bench_*``) and of chip_smoke.py's kernel timers.

- :func:`kernel_device_ms`, :func:`call_device_profile`,
  :func:`body_device_ms`, :func:`kernels_ms`: torch.profiler's device time
  of named kernels, of every kernel a call launches, of a body's kernels and
  of every kernel but the optimizer's annotations.
- :func:`device_records`: a profile's kernels as (name, launches recorded,
  us) records, the input of :func:`analyze`.
- :data:`KERNEL_STEMS`: each launch counter of the hand-written kernels
  (``mem_tpu_torch.kernels.launch_counts``) and the CUDA kernel names it
  launches; :func:`family`: the family of any other kernel (or CPU op).
- :func:`trace_steps`: a window of steps timed by CUDA events, then the same
  steps again under torch.profiler, with the launch counts of the profiled
  window and the peak memory of both; :func:`analyze` prints its breakdown,
  :func:`trace_train` runs a train step's window through both.
- The trace tools' shared arguments: :func:`parse_args`, :func:`refuse`,
  :func:`toggles`, :func:`gpu_name`, :func:`resolved`.
- :func:`time_steps`: the CUDA-event median of a train step's calls.
- :func:`time_optimizers`: each ``--opt`` update on the full ft_vit against
  its bound (``python -m mem_tpu_torch.tools.step_timers optimizers``).

The CUDA-event timer of single calls, the H100's peaks and the bounds stay in
``mem_tpu_torch.tools``."""
from __future__ import annotations

import contextlib
import json
import os
import statistics
import sys
import time
import warnings

import torch

# launch counter -> (anchors: kernels it launches exactly once a call, one of
# them whatever its route; stems: every kernel it may launch). Stems are
# fragments of the mangled CUDA names (csrc/*.cu).
_K2F = (("attention_long_fwd", "attention_fwd_flat"), ("attention_long_fwd", "attention_fwd_flat"))
_K2B = (("attention_long_bwd_rows", "attention_bwd_flat"),
        ("attention_long_bwd", "attention_bwd_flat", "attention_bwd_bias_sum"))
_K3F = (("attention_long_fwd",), ("attention_long_fwd",))
_K3B = (("attention_long_bwd_rows",), ("attention_long_bwd",))
KERNEL_STEMS = {
    "hist_planes_cols": (("hist_band_kernel",), ("hist_band_kernel",)),
    "hist_planes_cols_sorted": (("hist_band_kernel",), ("hist_band_kernel", "chunk_bounds_kernel")),
    "fused_attention_flat": _K2F,
    "fused_attention_flat_bwd": _K2B,
    "fused_attention_flat_long": _K3F,
    "fused_attention_flat_long_bwd": _K3B,
    "fused_attention": _K2F,
    "fused_attention_bwd": _K2B,
    "fused_attention_long": _K3F,
    "fused_attention_bwd_whole": _K3B,
    "fused_attention_bwd_long": _K3B,
    "mlp_fused": (("mlp_gemm_f1", "mlp_rows"), ("mlp_gemm_f", "mlp_rows")),
    "mlp_fused_bwd": (("mlp_gemm_b1", "mlp_cols"),
                      ("mlp_gemm_b", "mlp_gemm_wgrad", "mlp_colsum", "mlp_wgrad_sum", "mlp_cols")),
}
HAND_WRITTEN = tuple(sorted({s for _, stems in KERNEL_STEMS.values() for s in stems}))

# kernel-name (or CPU op) fragment -> family, first match wins; cuDNN's
# convolutions are implicit GEMMs, so their fragments come before the GEMMs'
FAMILIES = (("fprop", "convolutions"), ("dgrad", "convolutions"), ("wgrad", "convolutions"),
            ("conv", "convolutions"), ("cudnn", "convolutions"), ("implicit", "convolutions"),
            ("nchw", "layout changes"), ("nhwc", "layout changes"),
            ("nvjet", "GEMMs"), ("gemm", "GEMMs"), ("cutlass", "GEMMs"), ("aten::mm", "GEMMs"),
            ("aten::addmm", "GEMMs"), ("aten::bmm", "GEMMs"), ("aten::baddbmm", "GEMMs"),
            ("softmax", "softmax"), ("multi_tensor", "optimizer"), ("_foreach", "optimizer"),
            ("reduce", "reductions"), ("aten::sum", "reductions"), ("aten::mean", "reductions"),
            ("sort", "sort"), ("scatter", "gather / scatter"), ("gather", "gather / scatter"),
            ("index", "gather / scatter"), ("pool", "pooling"),
            ("elementwise", "elementwise"), ("copy", "elementwise"), ("cat", "elementwise"),
            ("fill", "elementwise"), ("where", "elementwise"), ("aten::add", "elementwise"),
            ("aten::mul", "elementwise"), ("aten::sub", "elementwise"),
            ("aten::div", "elementwise"))


NOT_PORTED = {"remat": "models.vit.REMAT_MLP", "pad_attn": "models.vit.PAD_ATTN"}
TOP_OPS = 25


def parse_args(argv):
    """The reference's ``key=value`` arguments as a dict."""
    return dict(a.split("=", 1) for a in argv)


def refuse(tool: str, kv: dict):
    """The exit code and message for arguments this tool does not run
    (None where it runs): a toggle the port leaves out, or the card asked for
    where there is none."""
    for key, name in NOT_PORTED.items():
        if key in kv:
            return 2, (f"{tool}: {key}={kv[key]} sets {name}, an XLA scheduling toggle the "
                       f"port does not port (ROADMAP.md, 'Not ported')")
    if kv.get("device", "cuda") != "cpu" and not torch.cuda.is_available():
        return 2, f"{tool}: no CUDA device is available (pass device=cpu to run on the CPU)"
    return None


@contextlib.contextmanager
def toggles(kv: dict):
    """``fa``, ``flat``, ``flat_long``, ``fused_mlp`` and ``int8`` of ``kv``
    set on the port's modules for the block, and put back after."""
    from mem_tpu_torch.models import vit
    from mem_tpu_torch.ops import attention

    names = {"fa": (attention, "ENABLED"), "flat": (vit, "FLAT_ATTN"),
             "flat_long": (vit, "FLAT_ATTN_LONG"), "fused_mlp": (vit, "FUSED_MLP"),
             "int8": (vit, "INT8_GEMM")}
    saved = {k: getattr(*names[k]) for k in names}
    try:
        for k, (mod, attr) in names.items():
            if k in kv:
                setattr(mod, attr, bool(int(kv[k])))
        yield
    finally:
        for k, (mod, attr) in names.items():
            setattr(mod, attr, saved[k])


def gpu_name(device) -> str:
    """The card's name and power limit as nvidia-smi prints them ("cpu" on
    the CPU)."""
    if torch.device(device).type != "cuda":
        return "cpu"
    from mem_tpu_torch.utils.env import nvidia_smi

    return nvidia_smi() or f"{torch.cuda.get_device_name(0)}, power limit not read"


def dtype_of(name):
    return None if name is None else getattr(torch, name)


def resolved(kw: dict) -> dict:
    """``kw`` with its ``dtype`` / ``moment_dtype`` names as torch dtypes."""
    return {k: dtype_of(v) if k in ("dtype", "moment_dtype") else v for k, v in kw.items()}


def family(name: str) -> str:
    """The family of a library kernel or a CPU op (the hand-written kernels
    are read by their launch counters instead): int8 GEMMs, convolutions,
    GEMMs, elementwise, ... or "other"."""
    n = name.lower()
    if any(f in n for f in ("gemm_s8", "s8s8", "i8i8", "_i8_", "imma", "igemm", "int8",
                            "_int_mm")):
        return "int8 GEMMs"
    return next((fam for frag, fam in FAMILIES if frag in n), "other")


def _is_annotation(e) -> bool:
    # the optimizer's annotation ("Optimizer.step#AdamW.step") and other user
    # ranges span kernels that are counted on their own
    return (getattr(e, "is_user_annotation", False) or "#" in e.key
            or e.key.startswith(("Optimizer.", "ProfilerStep")))


def device_records(prof, device_type: str = "cuda") -> list:
    """(name, launches recorded, total us) of every kernel a profile holds
    (``device_type`` "cuda"), or of every CPU op by its self time ("cpu":
    on the CPU the ops are what runs), user annotations left out."""
    out = []
    for e in prof.key_averages():
        if _is_annotation(e):
            continue
        if device_type == "cuda":
            if "cuda" not in str(getattr(e, "device_type", "")).lower():
                continue
            us = getattr(e, "self_device_time_total", 0.0)
        else:
            us = e.self_cpu_time_total
        if us > 0 and e.count:
            out.append((e.key, int(e.count), float(us)))
    return out


def kernel_device_ms(fn, fragments, n=20, per_launch=False, records=None):
    """Device time (ms per call) of the kernels whose names hold one of
    ``fragments``, from torch.profiler over ``n`` calls: what the card spends
    in them, without the host's launch overhead that CUDA events around one
    short call include. ``per_launch`` sums each kernel's mean per launch
    recorded instead of dividing by ``n`` (for a call that launches each of
    its kernels once: the mean stays right when the trace drops some).
    ``records``, a dict, receives each kernel's launches recorded and mean
    us per launch. A profile that recorded none of them is taken again;
    None where three show no device time."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if "cuda" in str(getattr(e, "device_type", "")).lower()
                  and any(f in e.key for f in fragments)]
        us = sum(getattr(e, "self_device_time_total", 0.0) for e in events)
        if us > 0:
            if records is not None:
                records.update({e.key: (e.count, e.self_device_time_total / e.count)
                                for e in events if e.count})
            if per_launch:
                return sum(e.self_device_time_total / e.count for e in events if e.count) / 1e3
            return us / 1e3 / n
    return None


def call_device_profile(fn, n=20, anchor="hist_band_kernel"):
    """(device ms per call of every kernel ``fn`` launches, kernels a call,
    their names), from torch.profiler over ``n`` calls after 3 warm-up
    calls. The trace can lose records, so each kernel counts with its mean
    time per launch recorded, times its launches a call: its recorded
    launches over those of ``anchor``, a kernel launched once a call,
    rounded (a profile that recorded no ``anchor`` is taken again, up to
    three times). Raises where none of the three recorded it."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages() if getattr(e, "self_device_time_total", 0) > 0]
        calls = sum(e.count for e in evs if anchor in e.key)
        if calls:
            break
    else:
        raise RuntimeError(f"the profiler recorded no {anchor} launch in three tries")
    per_call = {e.key: (e.self_device_time_total / e.count, max(1, round(e.count / calls)))
                for e in evs}
    return (sum(us * k for us, k in per_call.values()) / 1e3,
            sum(k for _, k in per_call.values()), sorted(per_call))


def body_device_ms(fn, fragments, n=5):
    """Device time per call of ``fn`` whose kernels (named by ``fragments``)
    each launch once a call: the sum of each kernel's mean time per launch
    that torch.profiler recorded over ``n`` calls (robust to a trace that
    drops launches). None where one of them shows no device time."""
    parts = [kernel_device_ms(fn, (f,), n=n, per_launch=True) for f in fragments]
    return None if None in parts else sum(parts)


def kernels_ms(fn, n=3):
    """Device ms per call of every kernel ``fn`` launches (torch.profiler
    over ``n`` calls after 2 warm-up calls), without the GPU-side spans of
    the profiler's user annotations (``Optimizer.step#...``), which cover
    the kernels a second time."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return sum(us for _, _, us in device_records(prof)) / 1e3 / n or None


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def trace_steps(steps, device, trace_path=None) -> dict:
    """``steps``: zero-argument callables, one a traced step, each on inputs
    of its own. They run twice: first timed (CUDA events around each on the
    card, the host clock on the CPU), then under torch.profiler (CUDA
    activity on the card, CPU ops on the CPU) with the launch counters set
    to 0 just before and read just after. Returns ``wall_ms`` (the median
    ms per step), ``records`` (:func:`device_records` of the
    profiled window), ``counted`` (the launch counts of the profiled
    window), ``peak_bytes`` (the card's peak memory over both windows, None
    on the CPU) and the last step's output. With ``trace_path`` the profile
    is also written there as a Chrome trace."""
    from torch.profiler import ProfilerActivity, profile

    from mem_tpu_torch.kernels import launch_counts, reset_launch_counts

    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    per_step = []
    for fn in steps:
        if cuda:
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            per_step.append((a, b))
        else:
            t0 = time.perf_counter()
            fn()
            per_step.append((time.perf_counter() - t0) * 1e3)
    _sync(device)
    if cuda:
        per_step = [a.elapsed_time(b) for a, b in per_step]
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        reset_launch_counts()
        for fn in steps:
            out = fn()
        _sync(device)
        counted = launch_counts()
    if trace_path:
        prof.export_chrome_trace(trace_path)
    return dict(wall_ms=statistics.median(per_step),
                records=device_records(prof, "cuda" if cuda else "cpu"), counted=counted,
                peak_bytes=torch.cuda.max_memory_allocated() if cuda else None, out=out)


def _hand_written_rows(records, counted):
    """records split into the hand-written kernels' rows (by launch counter:
    recorded anchor launches, recorded us) and the other records. A kernel
    that two counted launchers share is split between them by their counts;
    one no counted launcher claims goes under "uncounted"."""
    live = {w: c for w, c in (counted or {}).items() if c and w in KERNEL_STEMS}
    rows, rest = {}, []
    for name, count, us in records:
        if not any(s in name for s in HAND_WRITTEN):
            rest.append((name, count, us))
            continue
        owners = [w for w in live if any(s in name for s in KERNEL_STEMS[w][1])] or ["uncounted"]
        total = sum(live.get(w, 1) for w in owners)
        for w in owners:
            share = live.get(w, 1) / total
            row = rows.setdefault(w, dict(anchor_launches=0.0, us=0.0, kernels={}))
            anchor = w != "uncounted" and any(s in name for s in KERNEL_STEMS[w][0])
            row["anchor_launches"] += count * share if anchor else 0.0
            row["us"] += us * share
            row["kernels"][name[:90]] = count * share
    return rows, rest


def analyze(records, nsteps, counted=None, wall_ms=None, peak_bytes=None, gpu=None,
            quiet=False, tool="trace", batch=None, unit="samples",
            extra=None) -> dict:
    """The breakdown of ``records`` (``step_timers.device_records`` of
    ``nsteps`` traced steps: (name, launches recorded, us)), printed unless
    ``quiet`` and returned as a dict. ``counted``: the launch counters of the
    same window; ``wall_ms``: ms per step by CUDA events; ``peak_bytes``:
    the peak memory; ``gpu``: the card's name and power limit; ``batch``:
    the samples a step, for the rates; ``extra``: more fields for the dict
    (the losses). The busy share is device ms over wall ms as read, not
    capped: the two come from two windows (the profiled one and the timed
    one), and a share above 1 (kernels on two streams at once, records
    counted twice, a window that ran slower) is flagged by
    ``device_exceeds_wall`` and a line of its own. The last line printed is
    the dict as JSON."""
    total_us = sum(us for _, _, us in records)
    rows, rest = _hand_written_rows(records, counted)
    families = {}
    for name, _, us in rest:
        f = family(name)
        families[f] = families.get(f, 0.0) + us / nsteps / 1e3
    kernels, extrapolated_us = {}, total_us
    for w, row in sorted(rows.items()):
        families[w] = row["us"] / nsteps / 1e3
        c = (counted or {}).get(w)
        rec = row["anchor_launches"]
        scale = c / rec if c and rec else None
        if scale is not None:
            extrapolated_us += row["us"] * (scale - 1.0)
        kernels[w] = dict(recorded=round(rec, 3), counted=c,
                          mean_us=row["us"] / rec if rec else None,
                          device_ms_per_step=row["us"] * (scale or 1.0) / nsteps / 1e3,
                          extrapolated=scale is not None and scale != 1.0,
                          kernels=row["kernels"])
    for w, c in sorted((counted or {}).items()):
        if w in KERNEL_STEMS and c and w not in kernels:
            kernels[w] = dict(recorded=0, counted=c, mean_us=None, device_ms_per_step=None,
                              extrapolated=False, kernels={})
    ms = total_us / nsteps / 1e3
    top = sorted(((us / nsteps, name[:100]) for name, _, us in records), key=lambda t: -t[0])
    out = dict(tool=tool, steps=nsteps, device_ms_per_step=ms,
               device_ms_per_step_extrapolated=extrapolated_us / nsteps / 1e3,
               wall_ms_per_step=wall_ms,
               busy_share=ms / wall_ms if wall_ms else None,
               device_exceeds_wall=bool(wall_ms) and ms > wall_ms,
               families={k: families[k] for k in sorted(families, key=lambda k: -families[k])},
               kernels=kernels, counted=dict(counted or {}),
               top_ops=[[name, us] for us, name in top[:TOP_OPS]],
               peak_mem_gib=None if peak_bytes is None else peak_bytes / 2**30, gpu=gpu)
    if batch:
        out[f"{unit}_per_s_device"] = batch / (ms / 1e3) if ms else None
        out[f"{unit}_per_s_wall"] = batch / (wall_ms / 1e3) if wall_ms else None
    out.update(extra or {})
    if quiet:
        return out
    print(f"device time: {ms:.1f} ms/step (over {nsteps} steps; "
          f"{out['device_ms_per_step_extrapolated']:.1f} with the lost records extrapolated)")
    print(f"top ops (us per step, of {len(records)} kernels):")
    for us, name in top[:TOP_OPS]:
        print(f"  {us:9.0f} us/step  {name}")
    if wall_ms:
        clock = "the host clock" if gpu == "cpu" else "CUDA events"
        print(f"wall: {wall_ms:.1f} ms/step by {clock}; busy share {out['busy_share']:.3f}")
        if out["device_exceeds_wall"]:
            print(f"device ms {ms:.2f} exceed wall ms {wall_ms:.2f}: the profiled and the timed "
                  "windows disagree (overlapping streams or records counted twice)")
    print("by family (ms/step): " + ", ".join(f"{k} {v:.2f}" for k, v in out["families"].items()))
    for w, k in kernels.items():
        dms = k["device_ms_per_step"]
        print(f"  {w}: {k['recorded']:g} launches recorded, {k['counted']} counted"
              + (f"; {k['mean_us']:.1f} us a recorded launch -> {dms:.2f} ms/step"
                 + (" (extrapolated: recorded mean x counted launches)" if k["extrapolated"]
                    else "") if dms is not None and k["mean_us"] is not None else
                 "; no device time recorded"))
    if peak_bytes is not None:
        print(f"peak memory: {out['peak_mem_gib']:.2f} GiB")
    if batch and ms:
        print(f"-> {out[f'{unit}_per_s_device']:.1f} {unit}/s (device time), "
              + (f"{out[f'{unit}_per_s_wall']:.1f} {unit}/s (wall)" if wall_ms else ""))
    print(f"gpu: {gpu}")
    for k, v in (extra or {}).items():
        print(f"{k}: {v}")
    print(json.dumps(out), flush=True)
    return out


def trace_and_analyze(steps, device, nsteps, tool, batch, unit="samples", tdir=None,
                      label=None, extra=None) -> dict:
    """``step_timers.trace_steps`` of ``steps`` then :func:`analyze` (with
    the fields ``extra()`` gives after the steps); with ``tdir`` the
    profile's Chrome trace is written there."""
    path = None
    if tdir:
        os.makedirs(tdir, exist_ok=True)
        path = os.path.join(tdir, f"{tool.replace(' ', '_')}.pt.trace.json")
    res = trace_steps(steps, device, path)
    if path:
        print(f"traced {nsteps} steps -> {path}")
    if label:
        print(label)
    return analyze(res["records"], nsteps, res["counted"], res["wall_ms"], res["peak_bytes"],
                   gpu_name(device), tool=tool, batch=batch, unit=unit,
                   extra=extra() if extra else None) | {"out": res["out"]}


def trace_train(call, batches, device, nsteps, tool, batch, unit="samples", tdir=None,
                extra=None) -> dict:
    """Two warm-up steps ``call(batches[0], it)`` (it = 0, 1), then
    ``nsteps`` traced steps, one a batch of ``batches[1:]`` (the window runs
    twice, timed then profiled, ``it`` counting on) through
    :func:`trace_and_analyze`; every step's loss and ``extra()``'s fields
    ride in the dict."""
    losses = [float(call(batches[0], i)["loss"]) for i in range(2)]
    it = iter(range(2, 2 + 2 * nsteps))
    return trace_and_analyze(
        [lambda b=b: losses.append(call(b, next(it))["loss"]) for b in batches[1:]], device,
        nsteps, tool, batch, unit, tdir,
        extra=lambda: {"losses": [float(x) for x in losses], **(extra() if extra else {})})


def time_steps(step, n, warm=3) -> dict:
    """``step(i)`` for i < ``n`` on the card, each between two CUDA events:
    the median ms of the calls after the first ``warm``, the peak memory and
    the outputs."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    events, outs = [], []
    for i in range(n):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        outs.append(step(i))
        b.record()
        events.append((a, b))
    torch.cuda.synchronize()
    return dict(ms=statistics.median(a.elapsed_time(b) for a, b in events[warm:]),
                peak_bytes=torch.cuda.max_memory_allocated(), outs=outs)


def ft_vit_full(device, depth=12, seed=0):
    """ft_vit at full width (768, 12 heads, 101 classes) with every
    parameter drawn 0.02 N(0, 1) from a seed."""
    from mem_tpu_torch.models.registry import create_model

    model = create_model("ft_vit", num_classes=101, img_size=(224, 224), patch_size=(16, 16),
                         embed_dim=768, depth=depth, num_heads=12, init_values=0.1,
                         use_rel_pos_bias=True, use_abs_pos_emb=True, device=device)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(0.02 * torch.randn(p.shape, generator=g))
    return model


def time_optimizers(device, names=None) -> dict:
    """Each optimizer's update (``opt.step()`` on fixed gradients) on the
    full ft_vit (12 blocks, f32): CUDA-event ms of a step, the device time of
    its kernels, and the bound: p read and written, g read, each state tensor
    read and written, over the memory rate. ``names``: the ``--opt`` names
    (default: all but nesterov and nvnovograd, the aliases), each also with
    bf16 moments and Lookahead on AdamW."""
    from mem_tpu_torch.tools import PEAK_F32_FLOPS, bound, time_ms
    from mem_tpu_torch.train import optim

    names = list(names or [n for n in optim.OPTIMIZERS if n not in ("nesterov", "nvnovograd")])
    model = ft_vit_full(device)
    params = list(model.parameters())
    n = sum(p.numel() for p in params)
    g = torch.Generator(device=device).manual_seed(2)
    for p in params:
        p.grad = 1e-3 * torch.randn(p.shape, device=device, generator=g)
    out = {}
    for name in names + ["bf16_adamw", "lookahead_adamw"]:
        opt_name = name.removeprefix("bf16_")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            opt = optim.create_optimizer(
                model, 1e-5, 0.05, opt=opt_name, layer_decay=0.75, num_layers=12,
                moment_dtype=torch.bfloat16 if name != opt_name else None)
        optim.set_schedule(opt, 1e-5, 0.05)
        opt.step()
        state = optim.state_bytes(opt) - sum(s.numel() * s.element_size()
                                             for s in getattr(opt, "slow", []))
        nbytes = 12 * n + 2 * state
        if name.startswith("lookahead_"):
            nbytes += 16 * n / 6        # the sync: p and slow read, both written, 1 step in 6
        out[name] = dict(ms=time_ms(opt.step, runs=10, warmup=2), device_ms=kernels_ms(opt.step),
                         bound_ms=bound(nbytes, 0, PEAK_F32_FLOPS)[0],
                         bytes_per_param=nbytes / n, state_bytes=state)
        del opt
        torch.cuda.empty_cache()
    return dict(model="ft_vit", params=n, rows=out)


def main(argv=None) -> int:
    """``optimizers [names,...]``: :func:`time_optimizers` on the card, one
    JSON line after the card's name and power limit. Exits 2 without a
    card."""
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] != "optimizers":
        print("usage: python -m mem_tpu_torch.tools.step_timers optimizers [name,...]",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("step_timers: no CUDA device is available; the timers run on the card only",
              file=sys.stderr)
        return 2
    from mem_tpu_torch.utils.env import nvidia_smi

    gpu = nvidia_smi() or torch.cuda.get_device_name(0)
    print(gpu, flush=True)
    res = time_optimizers(torch.device("cuda"), argv[1].split(",") if len(argv) > 1 else None)
    print(json.dumps({"tool": "time_optimizers", "gpu": gpu, **res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

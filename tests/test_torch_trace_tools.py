"""The port's trace tools (mem_tpu_torch/tools/trace_*.py) and
bench_pretrain_step.py against the reference's scripts (scripts/trace_*.py,
scripts/bench_pretrain_step.py).

(a) Configuration: each reference script's ``build`` runs with spies in
place of the heavy constructors it names (``create_model``,
``DiscreteVAE``, ``EncoderDecoder``, ``create_optimizer``, ``shard_batch``,
...; ``jax.jit`` as the identity) and is stopped before any full-width work;
the batch arrays, the model names and keyword arguments, the
``PreprocConfig`` fields, the schedules and the optimizers' settings it
passed are held equal (arrays bit for bit) to the port tool's ``config``.
(b) ``trace_pretrain.analyze`` (``step_timers.analyze``) on a hand-made
record list (exact per-step ms, top-op order, family sums, the
recorded-vs-counted extrapolation and the busy share as read) and on a CPU
profile of a tiny step. (c) Each tool's ``build`` at depth 1-2 and
width 64 on the CPU takes two steps with finite losses (the steps themselves
are held against mem_tpu by test_torch_{train,finetune,mae_train,vae_train,
seg_train}.py). (d) The refusals: no card without ``device=cpu``, and the
toggles the port leaves out."""
import dataclasses
import importlib
import sys
import types

import jax
import numpy as np
import pytest
import torch

from mem_tpu_torch.tools import (bench_host_feed, bench_pretrain_step, step_timers,
                                 trace_finetune, trace_infer, trace_mae, trace_pretrain,
                                 trace_seg, trace_vae)

CPU = torch.device("cpu")


def _import_reference(name):
    """Import a reference script from this checkout, undoing its
    process-wide edits (it points jax's compilation cache at a TPU directory
    and prepends a fixed path to sys.path): each import runs on this
    checkout's sys.path, restored after it."""
    cache, path = jax.config.jax_compilation_cache_dir, list(sys.path)
    for module in ("mem_tpu.ops.attention", "scripts.trace_pretrain", name):
        try:
            importlib.import_module(module)
        finally:
            jax.config.update("jax_compilation_cache_dir", cache)
            sys.path[:] = path
    return sys.modules[name]


class _Stop(Exception):
    """Raised by the last spy: the reference's build goes no further."""


class _Model:
    def __init__(self, record, name, kw):
        record["model"] = (name, kw)

    def init(self, *args, **kw):
        return {"params": {}, "batch_stats": {}}


def _jax_shim():
    """``jax`` as the scripts use it, with ``jit`` the identity."""
    return types.SimpleNamespace(jit=lambda f, **kw: f, tree=jax.tree, random=types.SimpleNamespace(
        key=lambda i: i, fold_in=lambda k, i: k), block_until_ready=lambda x: x)


def _spy(monkeypatch, ref, record, stop_at, **extra):
    """Spies on ``ref``'s module-level names; the one named ``stop_at``
    records its arguments and raises _Stop."""
    def recorder(name, ret=None):
        def f(*args, **kw):
            record.setdefault(name, []).append((args, kw))
            if name == stop_at:
                raise _Stop
            return ret(*args, **kw) if callable(ret) else (args[0] if ret == "arg0" else ret)
        return f

    spies = {
        "create_model": lambda name, **kw: _Model(record, name, kw),
        "DiscreteVAE": lambda **kw: record.__setitem__("vae", kw) or _Model({}, "vae", kw),
        "EncoderDecoder": lambda **kw: _Model(record, "EncoderDecoder", kw),
        "get_mesh": lambda: None,
        "shard_batch": recorder("shard_batch", "arg0"),
        "replicate": recorder("replicate", "arg0"),
        "preprocess_batch": recorder("preprocess_batch"),
        "as_schedule_fn": recorder("as_schedule_fn", "arg0"),
        "create_optimizer": recorder("create_optimizer",
                                     lambda *a, **k: types.SimpleNamespace(init=lambda p: {})),
        "jax": _jax_shim(),
    }
    spies.update(extra)
    spies.setdefault(stop_at, recorder(stop_at))
    for name, fn in spies.items():
        if hasattr(ref, name):
            monkeypatch.setattr(ref, name, fn)


def _run_to_stop(fn, *args, **kw):
    with pytest.raises(_Stop):
        fn(*args, **kw)


def _dtype_names(kw):
    return {k: (np.dtype(v).name if k in ("dtype", "moment_dtype") and v is not None else v)
            for k, v in kw.items()}


def _assert_batches_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)


def _pp_equal(port_pp, ref_pp):
    assert dataclasses.asdict(port_pp) == dataclasses.asdict(ref_pp)


# -- (a) configuration parity ------------------------------------------------

@pytest.mark.parametrize("batch_ops,gathered,bf16_moments",
                         [(True, True, False), (False, False, True)])
def test_trace_pretrain_config_equals_reference(monkeypatch, batch_ops, gathered, bf16_moments):
    ref = _import_reference("scripts.trace_pretrain")
    rec = {}
    _spy(monkeypatch, ref, rec, "create_optimizer")
    _run_to_stop(ref.build, batch_ops, gathered, B=3, N=40, bf16_moments=bf16_moments)
    cfg = trace_pretrain.config(batch_ops, gathered, B=3, N=40, bf16_moments=bf16_moments)
    _assert_batches_equal(cfg["batch"], rec["shard_batch"][0][0][0])
    name, kw = rec["model"]
    assert cfg["model"] == (name, _dtype_names(kw))
    assert cfg["vae"] == _dtype_names(rec["vae"])
    _pp_equal(cfg["preproc"], rec["preprocess_batch"][0][0][1])
    np.testing.assert_array_equal(cfg["lr"], rec["as_schedule_fn"][0][0][0])
    kw = _dtype_names(rec["create_optimizer"][0][1])
    assert cfg["optimizer"] == kw


@pytest.mark.parametrize("mae", [False, True])
def test_trace_finetune_config_equals_reference(monkeypatch, mae):
    ref = _import_reference("scripts.trace_finetune")
    rec = {}
    _spy(monkeypatch, ref, rec, "make_finetune_train_step",
         make_mixup=lambda *a, **k: rec.__setitem__("mixup", (a, k)))
    _run_to_stop(ref.build, B=3, N=40, mae=mae)
    cfg = trace_finetune.config(B=3, N=40, mae=mae)
    (batch, _), kw = rec["shard_batch"][0]
    assert kw == {"axis_pos": 1}
    _assert_batches_equal(cfg["batch"], batch)
    name, mkw = rec["model"]
    assert cfg["model"] == (name, _dtype_names(mkw))
    _pp_equal(cfg["preproc"], rec["preprocess_batch"][0][0][1])
    np.testing.assert_array_equal(cfg["lr"], rec["as_schedule_fn"][0][0][0])
    assert cfg["optimizer"] == rec["create_optimizer"][0][1]
    a, k = rec["mixup"]
    names = ("num_classes", "mixup_alpha", "cutmix_alpha", "prob", "switch_prob",
             "label_smoothing")
    assert cfg["mixup"] == dict(zip(names, a), **k)
    args, kw = rec["make_finetune_train_step"][0]
    assert cfg["step"]["num_classes"] == args[3]
    _pp_equal(cfg["preproc"], args[2])
    assert {k: cfg["step"][k] for k in ("smoothing", "update_freq", "ema_decay")} == {
        k: kw[k] for k in ("smoothing", "update_freq", "ema_decay")}


def test_trace_mae_config_equals_reference(monkeypatch):
    ref = _import_reference("scripts.trace_mae")
    rec = {}
    monkeypatch.setattr(sys.modules["mem_tpu.data.device_pipeline"], "preprocess_batch",
                        lambda b, pp, t: rec.setdefault("pp", pp))
    _spy(monkeypatch, ref, rec, "make_mae_train_step")
    _run_to_stop(ref.build, B=3, N=40)
    cfg = trace_mae.config(B=3, N=40)
    _assert_batches_equal(cfg["batch"], rec["shard_batch"][0][0][0])
    name, kw = rec["model"]
    assert cfg["model"] == (name, _dtype_names(kw))
    _pp_equal(cfg["preproc"], rec["pp"])
    np.testing.assert_array_equal(cfg["lr"], rec["as_schedule_fn"][0][0][0])
    assert cfg["optimizer"] == rec["create_optimizer"][0][1]


@pytest.mark.parametrize("batch_ops", [True, False])
def test_trace_vae_config_equals_reference(monkeypatch, batch_ops):
    ref = _import_reference("scripts.trace_vae")
    rec = {}
    monkeypatch.setattr(sys.modules["mem_tpu.data.device_pipeline"], "preprocess_batch",
                        lambda b, pp, t: rec.setdefault("pp", pp))
    adam = lambda **kw: rec.__setitem__("adam", kw) or types.SimpleNamespace(  # noqa: E731
        init=lambda p: {})
    _spy(monkeypatch, ref, rec, "make_vae_train_step",
         optax=types.SimpleNamespace(scale_by_adam=adam))
    _run_to_stop(ref.build, B=3, N=40, batch_ops=batch_ops)
    cfg = trace_vae.config(B=3, N=40, batch_ops=batch_ops)
    _assert_batches_equal(cfg["batch"], rec["shard_batch"][0][0][0])
    assert cfg["vae"] == _dtype_names(rec["vae"])
    _pp_equal(cfg["preproc"], rec["pp"])
    assert cfg["optimizer"] == {"betas": (rec["adam"]["b1"], rec["adam"]["b2"]),
                                "eps": rec["adam"]["eps"]}

    def fake_build(*a, **k):     # main's step arguments: lr, temperature, clip
        def step(p, o, jb, key, lr, temp, clip):
            rec["step"] = dict(lr=float(lr), temp=float(temp), clip=float(clip))
            raise _Stop
        return step, None, None, None

    monkeypatch.setattr(ref, "build", fake_build)
    monkeypatch.setattr(sys, "argv", ["trace_vae"])
    _run_to_stop(ref.main)
    assert {k: np.float32(v) for k, v in cfg["step"].items()} == {
        k: np.float32(v) for k, v in rec["step"].items()}


@pytest.mark.parametrize("batch_ops", [True, False])
def test_trace_seg_config_equals_reference(monkeypatch, batch_ops):
    ref = _import_reference("scripts.trace_seg")
    rec = {}
    monkeypatch.setattr(sys.modules["mem_tpu.data.seg_pipeline"], "seg_preprocess_batch",
                        lambda *a, **k: (None, None))
    _spy(monkeypatch, ref, rec, "make_seg_steps",
         build_lr_scale_tree=lambda t, d, n: rec.__setitem__("layer_decay", (d, n)) or {
             "params": None},
         build_wd_mask_tree=lambda t: {"params": None},
         scheduled_adamw=lambda *a, **k: rec.__setitem__("adamw", (a, k)) or
         types.SimpleNamespace(init=lambda p: {}),
         poly_lr_schedule=lambda base, iters: rec.__setitem__("poly", (base, iters)) or base)
    _run_to_stop(ref.build, B=2, N=50, batch_ops=batch_ops)
    cfg = trace_seg.config(B=2, N=50, batch_ops=batch_ops)
    _assert_batches_equal(cfg["batch"], rec["shard_batch"][0][0][0])
    assert cfg["model"] == _dtype_names(rec["model"][1])
    assert (cfg["lr"]["base_lr"], cfg["lr"]["max_iters"]) == rec["poly"]
    (lr, wd, _, _), kw = rec["adamw"]
    o = cfg["optimizer"]
    assert (o["weight_decay"], o["betas"], o["eps"]) == (wd(0), (kw["b1"], kw["b2"]), kw["eps"])
    assert (o["layer_decay"], o["num_layers"]) == rec["layer_decay"]
    args, kw = rec["make_seg_steps"][0]
    s = cfg["step"]
    assert (s["num_classes"], s["rand_aug"], s["rand_aug_batch_ops"], s["y_sorted"]) == (
        args[2], args[3], args[4], kw["y_sorted"])


@pytest.mark.parametrize("mode", ["cls", "seg"])
def test_trace_infer_config_equals_reference(monkeypatch, mode):
    ref = _import_reference("scripts.trace_infer")
    rec = {}
    monkeypatch.setattr(sys.modules["mem_tpu.data.seg_pipeline"], "seg_preprocess_batch",
                        lambda *a, **k: (None, None))
    monkeypatch.setattr(sys.modules["mem_tpu.models.segmentation"], "EncoderDecoder",
                        lambda **kw: _Model(rec, "EncoderDecoder", kw))
    _spy(monkeypatch, ref, rec, "replicate")
    _run_to_stop(ref.cls if mode == "cls" else ref.seg, 1, 1, None)
    cfg = trace_infer.config(mode, 1, 1)
    sent = [a[0] for a, _ in rec["shard_batch"]]
    assert len(sent) == len(cfg["batches"]) == 3
    for got, want in zip(cfg["batches"], sent):
        _assert_batches_equal(got, want)
    if mode == "cls":
        name, kw = rec["model"]
        assert cfg["model"] == (name, _dtype_names(kw))
        _pp_equal(cfg["preproc"], rec["preprocess_batch"][0][0][1])
    else:
        assert cfg["model"] == _dtype_names(rec["model"][1])


def test_bench_pretrain_step_config_equals_reference(monkeypatch):
    ref = _import_reference("scripts.bench_pretrain_step")
    rec = {}
    _spy(monkeypatch, ref, rec, "make_pretrain_train_step")
    _run_to_stop(ref.main, batch_size=3, n_events=40, iters=1)
    cfg = trace_pretrain.config(True, True, B=3, N=40)
    _assert_batches_equal(cfg["batch"], rec["shard_batch"][0][0][0])
    name, kw = rec["model"]
    assert cfg["model"] == (name, _dtype_names(kw))
    assert cfg["vae"] == _dtype_names(rec["vae"])
    _pp_equal(cfg["preproc"], rec["make_pretrain_train_step"][0][0][3])
    np.testing.assert_array_equal(cfg["lr"], rec["as_schedule_fn"][0][0][0])
    assert cfg["optimizer"] == {**rec["create_optimizer"][0][1], "moment_dtype": None}


# -- (b) analyze -------------------------------------------------------------

def test_analyze_hand_made_records_exact(capsys):
    """Two steps; K2f recorded 20 of 24 launches (a lost record), K2b's three
    kernels 24 of 24, a GEMM, a cuDNN convolution and an elementwise
    kernel."""
    recs = [("void attention_long_fwd_wgmma_kernel<64>(CUtensorMap_st)", 20, 2000.0),
            ("void attention_long_bwd_rows_wgmma_kernel<64, false>()", 24, 4800.0),
            ("void attention_long_bwd_cols_wgmma_kernel<64>()", 24, 2400.0),
            ("attention_long_bwd_bias_sum_kernel(float const*)", 24, 240.0),
            ("nvjet_tst_128x256_64x4_2x1_v_bz_coopB_TNT", 10, 1000.0),
            ("sm90_xmma_fprop_implicit_gemm_bf16", 4, 600.0),
            ("void at::native::vectorized_elementwise_kernel<4>()", 50, 100.0)]
    counted = {"fused_attention_flat": 24, "fused_attention_flat_bwd": 24, "int8_mm": 0}
    out = trace_pretrain.analyze(recs, 2, counted, wall_ms=10.0, peak_bytes=2**31,
                                 gpu="NVIDIA H100 80GB HBM3, 700.00 W", batch=128)
    total_ms = sum(us for _, _, us in recs) / 2 / 1e3
    assert out["device_ms_per_step"] == total_ms
    assert out["busy_share"] == total_ms / 10.0
    assert [name for name, _ in out["top_ops"]] == [r[0][:100] for r in sorted(
        recs, key=lambda r: -r[2])]
    assert out["top_ops"][0][1] == 4800.0 / 2
    fam = out["families"]
    assert fam["fused_attention_flat"] == 2000.0 / 2 / 1e3
    assert fam["fused_attention_flat_bwd"] == (4800.0 + 2400.0 + 240.0) / 2 / 1e3
    assert fam["GEMMs"] == 1000.0 / 2 / 1e3 and fam["convolutions"] == 600.0 / 2 / 1e3
    assert fam["elementwise"] == 100.0 / 2 / 1e3
    assert sum(fam.values()) == pytest.approx(total_ms, rel=1e-12)
    k2f = out["kernels"]["fused_attention_flat"]
    assert (k2f["recorded"], k2f["counted"], k2f["mean_us"]) == (20, 24, 100.0)
    assert k2f["device_ms_per_step"] == pytest.approx(100.0 * 24 / 2 / 1e3, rel=1e-12)
    assert k2f["extrapolated"]
    k2b = out["kernels"]["fused_attention_flat_bwd"]
    assert (k2b["recorded"], k2b["counted"], k2b["extrapolated"]) == (24, 24, False)
    assert out["device_ms_per_step_extrapolated"] == pytest.approx(total_ms + 0.2, rel=1e-12)
    assert out["peak_mem_gib"] == 2.0 and out["gpu"].startswith("NVIDIA H100")
    assert out["samples_per_s_device"] == 128 / (total_ms / 1e3)
    text = capsys.readouterr().out
    assert "device time:" in text and "top ops" in text and "extrapolated" in text
    assert text.strip().splitlines()[-1].startswith("{")


def test_analyze_busy_share_not_capped(capsys):
    """Device ms above the wall ms of the timed window give a busy share
    above 1 as read, flagged and named on a line of its own; below, no
    flag."""
    recs = [("void at::native::vectorized_elementwise_kernel<4>()", 4, 30000.0)]
    out = step_timers.analyze(recs, 2, wall_ms=10.0)
    assert out["busy_share"] == 1.5 and out["device_exceeds_wall"]
    assert "exceed wall ms" in capsys.readouterr().out
    out = step_timers.analyze(recs, 2, wall_ms=20.0, quiet=True)
    assert out["busy_share"] == 0.75 and not out["device_exceeds_wall"]
    assert step_timers.analyze(recs, 2, quiet=True)["busy_share"] is None


def test_analyze_shared_kernel_split_by_counts():
    """A body two counted launchers share (K2f and K5a both launch the
    long forward) is split by their counts; a hand-written kernel no counted
    launcher claims goes under "uncounted"."""
    recs = [("attention_long_fwd_wgmma_kernel<64>", 30, 3000.0),
            ("hist_band_kernel(int const*)", 1, 50.0)]
    out = trace_pretrain.analyze(recs, 1, {"fused_attention_flat": 20, "fused_attention": 10},
                                 quiet=True)
    assert out["families"]["fused_attention_flat"] == pytest.approx(2.0)
    assert out["families"]["fused_attention"] == pytest.approx(1.0)
    assert out["families"]["uncounted"] == pytest.approx(0.05)
    assert out["kernels"]["fused_attention"]["recorded"] == pytest.approx(10.0)


def test_analyze_cpu_profile_families_within_total():
    """On a CPU torch.profiler run of a tiny pretraining step the families
    sum to no more than the total."""
    cfg = trace_pretrain.config(B=2, N=300)
    step, *_ = trace_pretrain.build(cfg, CPU, dict(embed_dim=64, depth=1, num_heads=2,
                                                   dtype="float32"),
                                    dict(hidden_dim=8, num_tokens=32, num_resnet_blocks=1,
                                         dtype="float32"))
    batches, _ = trace_pretrain.step_batches(cfg["batch"], cfg["preproc"], CPU, 2)
    res = step_timers.trace_steps([lambda b=b: step(b, 0) for b in batches], CPU)
    out = trace_pretrain.analyze(res["records"], 2, res["counted"], res["wall_ms"], quiet=True)
    assert out["device_ms_per_step"] > 0 and out["wall_ms_per_step"] > 0
    assert sum(out["families"].values()) <= out["device_ms_per_step"] * (1 + 1e-9)
    assert out["kernels"] == {} and res["counted"] == {}


# -- (c) each tool's build takes two steps ----------------------------------

_VIT = dict(embed_dim=64, depth=1, num_heads=2, dtype="float32")


def _two_losses(step, batches, *extra):
    return [float(step(b, i, *extra)["loss"]) for i, b in enumerate(batches)]


def test_trace_pretrain_build_two_steps():
    cfg = trace_pretrain.config(B=2, N=300)
    step, *_ = trace_pretrain.build(cfg, CPU, _VIT, dict(hidden_dim=8, num_tokens=32,
                                                         num_resnet_blocks=1))
    batches, _ = trace_pretrain.step_batches(cfg["batch"], cfg["preproc"], CPU, 2)
    assert np.isfinite(_two_losses(step, batches)).all()


@pytest.mark.parametrize("mae", [False, True])
def test_trace_finetune_build_two_steps(mae):
    cfg = trace_finetune.config(B=2, N=300, mae=mae)
    step, _, mix = trace_finetune.build(cfg, CPU, _VIT)
    batches = trace_finetune.micro_batches(cfg, mix, CPU, 2)
    assert np.isfinite(_two_losses(step, batches)).all()


def test_trace_mae_build_two_steps():
    cfg = trace_mae.config(B=2, N=300)
    step, _ = trace_mae.build(cfg, CPU, dict(img_size=224, embed_dim=64, depth=1, num_heads=2,
                                             decoder_embed_dim=32, decoder_depth=1,
                                             decoder_num_heads=2, dtype="float32"))
    batches, _ = trace_pretrain.step_batches(cfg["batch"], cfg["preproc"], CPU, 2)
    assert np.isfinite(_two_losses(step, batches)).all()


def test_trace_vae_build_two_steps():
    cfg = trace_vae.config(B=2, N=300)
    step, _ = trace_vae.build(cfg, CPU, dict(hidden_dim=8, num_tokens=32, num_resnet_blocks=1,
                                             dtype="float32"))
    batches, _ = trace_pretrain.step_batches(cfg["batch"], cfg["preproc"], CPU, 2)
    s = cfg["step"]
    assert np.isfinite(_two_losses(step, batches, s["lr"], s["temp"])).all()


def test_trace_seg_build_two_steps():
    cfg = trace_seg.config(B=2, N=2000)
    step, _ = trace_seg.build(cfg, CPU, dict(img_size=64, embed_dim=64, depth=2, num_heads=2,
                                             out_indices=(0, 0, 1, 1)))
    batch = trace_seg.device_batch(cfg, CPU)
    assert np.isfinite(_two_losses(step, [batch, batch])).all()


@pytest.mark.parametrize("mode", ["cls", "seg"])
def test_trace_infer_build_two_batches(mode):
    cfg = trace_infer.config(mode, 1, 0, N=500)
    kw = _VIT if mode == "cls" else dict(img_size=64, embed_dim=64, depth=2, num_heads=2,
                                         out_indices=(0, 0, 1, 1))
    infer, _ = trace_infer.build(cfg, CPU, kw)
    from mem_tpu_torch.data.prefetch import to_device

    with torch.inference_mode():
        preds = [infer(to_device({k: v for k, v in b.items() if k != "aug_seed"}, CPU))
                 for b in cfg["batches"]]
    assert len(preds) == 2
    assert preds[0].shape == ((1,) if mode == "cls" else (1, 440, 640))


def test_trace_tool_run_traces_on_the_cpu(capsys):
    """trace_vae's run end to end on the CPU: warm-up, traced steps, the
    breakdown and its JSON line."""
    cfg = trace_vae.config(B=2, N=300)
    out = trace_vae.run(cfg, CPU, 1, vae_kw=dict(hidden_dim=8, num_tokens=32,
                                                 num_resnet_blocks=1, dtype="float32"))
    assert out["device_ms_per_step"] > 0 and len(out["losses"]) == 4
    assert '"tool": "trace_vae"' in capsys.readouterr().out


# -- (d) refusals --------------------------------------------------------------

_CARD_TOOLS = [trace_pretrain, trace_finetune, trace_mae, trace_vae, trace_seg, trace_infer,
               bench_pretrain_step, bench_host_feed]


@pytest.mark.parametrize("tool", _CARD_TOOLS, ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_main_without_a_card_exits_2(monkeypatch, capsys, tool):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tool.main([]) == 2
    assert "no CUDA device" in capsys.readouterr().err


def test_step_timers_main_without_a_card_exits_2(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert step_timers.main(["optimizers"]) == 2
    assert "no CUDA device" in capsys.readouterr().err


@pytest.mark.parametrize("arg", ["remat=1", "pad_attn=1", "remat=0"])
@pytest.mark.parametrize("tool", [trace_pretrain, trace_finetune, trace_seg],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_unported_toggles_exit_2(capsys, tool, arg):
    assert tool.main([arg, "device=cpu"]) == 2
    assert "does not port" in capsys.readouterr().err


def test_toggles_set_and_restore():
    from mem_tpu_torch.models import vit
    from mem_tpu_torch.ops import attention

    before = (attention.ENABLED, vit.FLAT_ATTN, vit.FUSED_MLP, vit.FLAT_ATTN_LONG, vit.INT8_GEMM)
    with step_timers.toggles({"fa": "1", "flat": "0", "fused_mlp": "1", "flat_long": "0",
                              "int8": "1"}):
        assert (attention.ENABLED, vit.FLAT_ATTN, vit.FUSED_MLP, vit.FLAT_ATTN_LONG,
                vit.INT8_GEMM) == (True, False, True, False, True)
    assert (attention.ENABLED, vit.FLAT_ATTN, vit.FUSED_MLP, vit.FLAT_ATTN_LONG,
            vit.INT8_GEMM) == before

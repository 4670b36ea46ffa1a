"""Multi-process training of the port over torch.distributed (Gloo, two OS
processes) against one process and against the JAX package's GSPMD step.

Two launches of mem_tpu_torch/tools/mp_worker.py, two ranks each:

- ``train``: three pretraining steps of a tiny pt_vit (width 32, depth 2,
  2 heads, 32^2 images, a seeded VAE tokenizer) under DP, ZeRO-1 and FSDP
  with adamw and lamb, on a global batch of 8 whose halves mask 3-4 and 8-10
  of the 16 patches, against the same steps in this process over the whole
  batch (the reference's tolerances, test_multiprocess.py: weights rtol 2e-4
  / atol 2e-5, losses rtol 1e-4; the step-0 gradients rtol 3e-4 / atol 1e-6);
  a planted per-rank loss mean must fail those gates. Then tensor
  parallelism at tp = 2 on weights drawn by flax (biases and tables nonzero),
  loss and gradients against the JAX package's dp x tp GSPMD step on the
  8-device CPU mesh (test_tensor_parallel.py's rtol 1e-5 / atol 1e-4), with
  the MLP plain and through FUSED_MLP's plain K6; a planted fc2 bias added
  on every rank must fail. At width 128 (MLP 512: Adafactor factors every
  matrix, AdamP's projection fires on cut ones) every optimizer whose
  update reads a whole-tensor statistic runs under FSDP and under TP
  against one process (each tensor's displacement after three f32 steps
  within ``OPT_F32_REL`` relative L2, AdamP's decisions equal), each
  statistic taken over the local shard alone must miss that gate, and
  Adafactor's and Lookahead's checkpoints move between the placements and
  one process. One AdamP update at tp = 2 against the JAX package's GSPMD
  update; the MAE at tp = 2 (fc1 / fc2 cut, qkv / proj whole) against the
  JAX package's GSPMD loss and gradients and against one process's steps.
- ``seg``: three seg train steps of a tiny segmentor (the PSP BatchNorms
  damped to eps 0.1) whose halves ignore 10 and 200 label rows, against one
  process: the step-0 gradients rtol 3e-4 / atol 1e-6, the losses rtol 1e-4,
  the weights and BatchNorm buffers atol 4e-3 (Adam's first steps are
  +-lr sign(g), test_multiprocess.py); a planted unsynced BatchNorm must fail.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from mem_tpu_torch.tools.mp_worker import (FSDP_OPTS, LOCAL_STAT_FAULTS, RESUME_OPTS,
                                           TP_OPTS)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PT_CASES = ("dp_adamw", "zero1_adamw", "zero1_lamb", "fsdp_adamw", "fsdp_lamb")
# each tensor's displacement after three f32 steps, relative L2, two ranks
# against one process (4e-6 the worst seen; a local-shard statistic misses
# it by 2.5e-3 or more)
OPT_F32_REL = 1e-5
OPT_CASES = [f"fsdp_{o}" for o in FSDP_OPTS] + [f"tp_{o}" for o in TP_OPTS]
FAULT_CASES = [f"{pl}_{o}" for pl, opts in LOCAL_STAT_FAULTS.items() for o in opts]
RESUME_CASES = [(way, pl, o) for way in ("to_single", "from_single")
                for pl in ("fsdp", "tp") for o in RESUME_OPTS]
ADAMP_LR, ADAMP_WD = 1e-2, 0.05


def _env():
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    return env


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread here and in each rank: the tensors are small, and
    idle threads only spin against the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _launch(mode, workdir):
    from mem_tpu_torch.tools import mp_worker

    outs = mp_worker.launch(mode, str(workdir), 2, args=("threads=1",), env=_env(),
                            timeout=300, cwd=REPO)
    for rank, (code, out) in enumerate(outs):
        assert code == 0, f"{mode} rank {rank} exit {code}\n{out[-4000:]}"


def _load(workdir, tag, rank=0):
    with np.load(os.path.join(workdir, f"{tag}_r{rank}.npz")) as z:
        return {k: z[k] for k in z.files}


def _flat(result):
    out = {}
    for key in ("grads0", "weights", "grads"):
        for k, v in (result.get(key) or {}).items():
            out[f"{key}.{k}"] = v
    for i, m in enumerate(result.get("metrics", [])):
        for k, v in m.items():
            out[f"metrics.{i}.{k}"] = np.float64(v)
    return out


def _mismatches(got, want, weights_tol, grad_tol=(3e-4, 1e-6), loss_rtol=1e-4):
    """The keys of ``want`` that ``got`` misses by more than the gates."""
    bad = []
    for k, w in want.items():
        g = got[k]
        kind = k.split(".")[0]
        if kind == "metrics":
            if k.endswith(".loss") and not np.isclose(g, w, rtol=loss_rtol, atol=0):
                bad.append(k)
            continue
        rtol, atol = weights_tol if kind == "weights" else grad_tol
        if not np.allclose(g, w, rtol=rtol, atol=atol):
            bad.append(k)
    return bad


# -- pretraining: DP, ZeRO-1, FSDP; TP against GSPMD -----------------------------

def _redraw(tree, rng):
    """Products keep flax's init; biases, tables, LayerScale and tokens are
    redrawn away from 0 so a bias added twice shows."""
    def redraw(path, leaf):
        name = jax.tree_util.keystr(path)
        if "kernel" in name:
            return np.asarray(leaf)
        base = 1.0 if "scale" in name else 0.0
        return np.asarray(base + 0.2 * rng.standard_normal(leaf.shape), np.float32)

    return jax.tree_util.tree_map_with_path(redraw, jax.device_get(tree))


@pytest.fixture(scope="module")
def tp_reference():
    """The JAX package's dp x tp = 4 x 2 GSPMD loss and gradients of the
    masked CE (test_tensor_parallel.py's step) on weights drawn by flax."""
    from mem_tpu.models import create_model
    from mem_tpu.models.pretrain import masked_cross_entropy
    from mem_tpu.parallel import get_mesh
    from mem_tpu.parallel.mesh import shard_params
    from mem_tpu_torch.tools.mp_worker import TP_MODEL
    from mem_tpu_torch.utils.weights import from_jax_params

    rng = np.random.default_rng(1)
    model = create_model("pt_vit", vocab_size=32, img_size=(32, 32), patch_size=(8, 8),
                         embed_dim=32, depth=2, num_heads=2, dtype=jnp.float32)
    x = rng.random((8, 32, 32, 3)).astype(np.float32)
    mask = np.zeros((8, 16), bool)
    for b in range(8):
        mask[b, rng.choice(16, int(rng.integers(4, 11)), replace=False)] = True
    labels = rng.integers(0, 32, (8, 16)).astype(np.int64)
    params = _redraw(jax.jit(model.init)(jax.random.key(0), jnp.asarray(x),
                                         jnp.asarray(mask)), rng)

    def loss(p, xx, mm):
        return masked_cross_entropy(model.apply(p, xx, mm), jnp.asarray(labels), mm)[0]

    mesh = get_mesh(tp=2)
    assert dict(mesh.shape) == {"data": 4, "model": 2}
    p_tp = shard_params(params, mesh)
    xs, ms = (jax.device_put(jnp.asarray(v), NamedSharding(mesh, P("data", *[None] * (v.ndim - 1))))
              for v in (x, mask))
    value, grads = jax.jit(jax.value_and_grad(loss))(p_tp, xs, ms)
    inputs = {f"w.{k}": v.numpy() for k, v in from_jax_params(params).items()}
    inputs.update(x=x, mask=mask, labels=labels)
    assert set(TP_MODEL) >= {"embed_dim", "depth", "num_heads"}
    return inputs, float(value), from_jax_params(jax.device_get(grads))


@pytest.fixture(scope="module")
def mae_reference():
    """The JAX package's dp x tp = 4 x 2 GSPMD loss and gradients of the
    MAE (fc1 / fc2 cut by tp_param_specs, qkv / proj whole) on weights drawn
    by flax, and the shuffle noise its mask key draws."""
    import mem_tpu.models.mae as jax_mae
    from mem_tpu.parallel import get_mesh
    from mem_tpu.parallel.mesh import shard_params
    from mem_tpu_torch.tools.mp_worker import MAE_MODEL
    from mem_tpu_torch.utils.weights import mae_from_jax_params

    rng = np.random.default_rng(2)
    model = jax_mae.MaskedAutoencoderViT(dtype=jnp.float32, **MAE_MODEL)
    x = rng.random((8, 32, 32, 3)).astype(np.float32)
    key = jax.random.key(5)
    params = _redraw(jax.jit(model.init)({"params": jax.random.key(0), "mask": jax.random.key(1)},
                                         jnp.asarray(x[:1])), rng)
    mesh = get_mesh(tp=2)
    xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("data", None, None, None)))
    value, grads = jax.jit(jax.value_and_grad(
        lambda p, xx: model.apply(p, xx, rng=key)[0]))(shard_params(params, mesh), xs)
    inputs = {f"w.{k}": v.numpy() for k, v in mae_from_jax_params(params).items()}
    inputs.update(x=x, noise=np.asarray(jax.random.uniform(key, (8, 16))))
    return inputs, float(value), mae_from_jax_params(jax.device_get(grads))


@pytest.fixture(scope="module")
def adamp_reference():
    """One AdamP update of the JAX package on the dp x tp = 4 x 2 mesh
    (weights and gradients placed by tp_param_specs) from weights drawn by
    flax and test_torch_optim's gradients (a third orthogonal to the weight
    within each channel, a third to the whole tensor, a third leaning on it:
    the projection fires on both views)."""
    from mem_tpu.models import create_model
    from mem_tpu.parallel import get_mesh
    from mem_tpu.parallel.mesh import shard_params
    from mem_tpu.train import optim as jax_optim
    from mem_tpu.train.schedules import as_schedule_fn
    from mem_tpu_torch.utils.weights import from_jax_params
    from test_torch_optim import _grads

    rng = np.random.default_rng(3)
    model = create_model("pt_vit", vocab_size=32, img_size=(32, 32), patch_size=(8, 8),
                         embed_dim=32, depth=2, num_heads=2, dtype=jnp.float32)
    params = _redraw(jax.jit(model.init)(jax.random.key(0), jnp.zeros((1, 32, 32, 3)),
                                         jnp.zeros((1, 16), bool)), rng)
    grads = _grads(rng, params, 0)
    tx = jax_optim.create_optimizer(params, as_schedule_fn(np.array([ADAMP_LR])),
                                    wd_schedule=as_schedule_fn(np.array([ADAMP_WD])),
                                    weight_decay=ADAMP_WD, opt="adamp")
    mesh = get_mesh(tp=2)
    p_tp, g_tp = shard_params(params, mesh), shard_params(grads, mesh)
    updates, _ = jax.jit(tx.update)(g_tp, tx.init(p_tp), p_tp)
    after = jax.device_get(jax.tree.map(lambda p, u: p + u, p_tp, updates))
    inputs = {f"w.{k}": v.numpy() for k, v in from_jax_params(params).items()}
    inputs.update({f"g.{k}": v.numpy() for k, v in from_jax_params(grads).items()})
    return inputs, from_jax_params(params), from_jax_params(after)


@pytest.fixture(scope="module")
def opt_singles(tmp_path_factory):
    """One process's three steps at width 128 for every optimizer of the
    sharded cases (those of RESUME_OPTS also write their state after step
    SAVE_AT), and the seeded start weights."""
    from mem_tpu_torch.models.registry import create_model
    from mem_tpu_torch.tools import mp_worker

    ckpts = tmp_path_factory.mktemp("mp_single")
    runs = {}
    for opt in sorted(set(FSDP_OPTS) | set(TP_OPTS)):
        save = str(ckpts / f"ckpt_single_{opt}.pt") if opt in RESUME_OPTS else None
        runs[opt] = mp_worker.run_pretrain(opt, model_kw=mp_worker.OPT_MODEL,
                                           lr=mp_worker.opt_lr(opt), save=save)
    model = create_model("pt_vit", **mp_worker.OPT_MODEL)
    model.init_weights(torch.Generator().manual_seed(0))
    start = {k: v.numpy() for k, v in model.state_dict().items()}
    return runs, start, ckpts


@pytest.fixture(scope="module")
def train_run(tmp_path_factory, tp_reference, mae_reference, adamp_reference, opt_singles):
    """The ``train`` launch (with the TP, MAE and AdamP inputs and the
    single-process checkpoints written first) and the single-process
    references of this process."""
    import shutil

    from mem_tpu_torch.tools import mp_worker

    workdir = tmp_path_factory.mktemp("mp_train")
    np.savez(workdir / "tp_inputs.npz", **tp_reference[0])
    np.savez(workdir / "mae_inputs.npz", **mae_reference[0])
    np.savez(workdir / "adamp_inputs.npz", **adamp_reference[0])
    for opt in RESUME_OPTS:
        shutil.copy(opt_singles[2] / f"ckpt_single_{opt}.pt", workdir)
    _launch("train", workdir)
    single = {opt: _flat(mp_worker.run_pretrain(opt)) for opt in ("adamw", "lamb")}
    return str(workdir), single


@pytest.mark.parametrize("case", PT_CASES)
def test_two_rank_pretraining_matches_one_process(train_run, case):
    """Three steps on two ranks (each its half of the batch, losses over the
    global masked count) against one process over the whole batch."""
    workdir, single = train_run
    want = single[case.split("_")[1]]
    got = _load(workdir, case)
    assert set(got) >= set(want)
    bad = _mismatches(got, want, weights_tol=(2e-4, 2e-5))
    assert not bad, bad[:10]


def test_planted_rank_mean_fails_the_gates(train_run):
    """Each rank's loss divided by its own masked count (then averaged by
    DP) is not the global quotient: the same gates must fail."""
    workdir, single = train_run
    bad = _mismatches(_load(workdir, "fault_rank_mean"), single["adamw"],
                      weights_tol=(2e-4, 2e-5))
    assert any(k.startswith("grads0") for k in bad) and any(k.endswith(".loss") for k in bad)


@pytest.mark.parametrize("case", ["dp_adamw", "zero1_adamw", "fsdp_lamb"])
def test_ranks_hold_the_same_weights(train_run, case):
    """Both processes end with bit-identical weights in the single-process
    schema (FSDP: gathered)."""
    workdir, _ = train_run
    a, b = _load(workdir, case, 0), _load(workdir, case, 1)
    for k in a:
        if k.startswith("weights."):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("case", ["zero1_adamw", "fsdp_adamw"])
def test_optimizer_state_is_partitioned(train_run, case):
    """ZeRO-1 and FSDP keep about half of the optimizer state on each of the
    two ranks (ZeRO-1: whole tensors dealt by size; FSDP2: dim-0 shards);
    DP keeps all of it."""
    workdir, _ = train_run
    full = int(_load(workdir, "dp_adamw")["state_local"])
    parts = [int(_load(workdir, case, r)["state_local"]) for r in (0, 1)]
    assert sum(parts) >= full and max(parts) <= 0.6 * full, (parts, full)


@pytest.mark.parametrize("case", ["tp", "tp_fused"])
def test_tp_matches_jax_gspmd(train_run, tp_reference, case):
    """tp = 2 (each rank 1 of the 2 heads and half of the MLP's hidden
    columns; the shared rel-pos table's gradient summed over the ranks)
    against the JAX package's dp x tp GSPMD loss and gradients."""
    workdir, _ = train_run
    _, want_loss, want_grads = tp_reference
    got = _load(workdir, case)
    assert int(got["local_heads"]) == 1
    np.testing.assert_allclose(float(got["loss"]), want_loss, rtol=1e-5)
    for k, v in want_grads.items():
        np.testing.assert_allclose(got[f"grads.{k}"], v.numpy(), rtol=1e-5, atol=1e-4,
                                   err_msg=k)


def test_tp_planted_fc2_bias_fails(train_run, tp_reference):
    """fc2's bias added before the sum, on both ranks: the loss and the
    gradients miss the gates of test_tp_matches_jax_gspmd."""
    workdir, _ = train_run
    _, want_loss, want_grads = tp_reference
    got = _load(workdir, "fault_fc2_bias")
    assert not np.isclose(float(got["loss"]), want_loss, rtol=1e-5)
    assert any(not np.allclose(got[f"grads.{k}"], v.numpy(), rtol=1e-5, atol=1e-4)
               for k, v in want_grads.items())


def test_metrics_watchdog_and_stop_flag_agree_across_ranks(train_run):
    """SmoothedValue.synchronize_between_processes sums count and total
    (metrics.py:36-45); the RSS watchdog takes the max over the processes
    (preemption.py:79-86), so both ranks recycle when one is over the limit;
    a stop flag on one rank stops both; the eval loops run the least batch
    count."""
    import json

    workdir, _ = train_run
    for r in (0, 1):
        with open(os.path.join(workdir, f"sync_r{r}.json")) as f:
            got = json.load(f)
        assert got == {"count": 5, "total": 8.0, "rss_due": True, "any": True, "common": 5}


# -- the whole-tensor optimizers under FSDP and TP ---------------------------------

def _displacement_misses(got, want, start, bound=OPT_F32_REL):
    """{tensor: relative L2} of the tensors whose displacement from
    ``start`` in ``got`` (``weights.<name>``) misses ``want``'s by more
    than ``bound``."""
    bad = {}
    for k, w in want.items():
        d_want = np.float64(w) - start[k]
        d_got = np.float64(got[f"weights.{k}"]) - start[k]
        den = np.linalg.norm(d_want)
        rel = np.linalg.norm(d_got - d_want) / den if den > 0 else np.linalg.norm(d_got)
        if rel > bound:
            bad[k] = float(rel)
    return bad


def _probes(result, prefix):
    return {k[len(prefix):]: v for k, v in result.items() if k.startswith(prefix)}


@pytest.mark.parametrize("case", OPT_CASES)
def test_sharded_optimizer_matches_one_process(train_run, opt_singles, case):
    """Three f32 steps on two ranks (FSDP: dim-0 shards; TP: heads and hidden
    columns cut), each whole-tensor statistic (Lamb's and NovoGrad's norms,
    Adafactor's factored means, AdamP's channel and whole-tensor sums and
    cosine test) reduced across the cut, Lookahead's slow weights placed as
    their parameters (a sync at the third step): every tensor's
    displacement within OPT_F32_REL of one process's, and AdamP's decision
    on every tensor at every step equal to one process's."""
    workdir, _ = train_run
    runs, start, _ = opt_singles
    opt = case.split("_", 1)[1]
    got = _load(workdir, case)
    bad = _displacement_misses(got, runs[opt]["weights"], start)
    assert not bad, bad
    for r in (0, 1):
        assert _probes(_load(workdir, case, r), "probe.fired.") == {
            k[len("fired."):]: v for k, v in runs[opt]["probe"].items() if k.startswith("fired.")}


@pytest.mark.parametrize("case", FAULT_CASES)
def test_planted_local_statistic_fails(train_run, opt_singles, case):
    """Each optimizer's whole-tensor statistic taken over this rank's shard
    alone (no reduction across the cut): some tensor misses the gate of
    test_sharded_optimizer_matches_one_process."""
    workdir, _ = train_run
    runs, start, _ = opt_singles
    got = _load(workdir, f"fault_local_{case}")
    assert _displacement_misses(got, runs[case.split("_", 1)[1]]["weights"], start)


def test_factored_moments_and_the_projection_meet_cut_tensors(train_run):
    """The checks above compare something: under both placements Adafactor
    factors tensors whose statistics cross processes, and AdamP's
    projection fires on such a tensor."""
    workdir, _ = train_run
    for pl in ("fsdp", "tp"):
        got = _load(workdir, f"{pl}_adafactor")
        cut = _probes(got, "probe.cut.")
        factored = [k for k, v in _probes(got, "probe.factored.").items() if v]
        assert any(cut[k] for k in factored), pl
        got = _load(workdir, f"{pl}_adamp")
        fired = [k.split(".", 1)[1] for k, v in _probes(got, "probe.fired.").items() if v]
        assert any(_probes(got, "probe.cut.")[k] for k in fired), pl


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_shapes(v) for v in tree]
    return tuple(tree.shape) if torch.is_tensor(tree) else tree


@pytest.mark.parametrize("way,pl,opt", RESUME_CASES, ids=["-".join(c) for c in RESUME_CASES])
def test_checkpoint_moves_between_placements_and_one_process(train_run, opt_singles, way, pl,
                                                             opt):
    """After step SAVE_AT, the state gathered from two ranks (FSDP or TP) is
    the single-process schema (Adafactor's factored moments and Lookahead's
    slow weights at their whole shapes): one process restores it bit for bit
    and its next step matches the two ranks' next step; a one-process
    checkpoint placed on two ranks gathers back bit for bit and continues as
    the one process does."""
    from mem_tpu_torch.tools import mp_worker

    workdir, _ = train_run
    runs, start, ckpts = opt_singles
    if way == "to_single":
        path = os.path.join(workdir, f"ckpt_{pl}_{opt}.pt")
        assert _shapes(torch.load(path, weights_only=True)) == _shapes(
            torch.load(ckpts / f"ckpt_single_{opt}.pt", weights_only=True))
        r = mp_worker.run_pretrain(opt, model_kw=mp_worker.OPT_MODEL, lr=mp_worker.opt_lr(opt),
                                   resume=path)
        assert r["probe"]["regathered_equal"] == 1.0
        two = _load(workdir, f"{pl}_{opt}")
        want = {k[len("weights."):]: v for k, v in two.items() if k.startswith("weights.")}
        got = {f"weights.{k}": v for k, v in r["weights"].items()}
    else:
        got = _load(workdir, f"resume_{pl}_{opt}")
        assert got["probe.regathered_equal"] == 1.0
        want = runs[opt]["weights"]
    bad = _displacement_misses(got, want, start)
    assert not bad, bad


def test_tp_adamp_update_matches_jax_gspmd(train_run, adamp_reference):
    """One AdamP update at tp = 2 (weights and gradients cut, the channel
    and whole-tensor sums and the cosine test reduced over "model") against
    the JAX package's GSPMD update on the dp x tp mesh: every tensor's
    displacement within OPT_F32_REL relative L2, and the projection fired
    on a cut tensor."""
    workdir, _ = train_run
    _, start, after = adamp_reference
    got = _load(workdir, "tp_adamp_update")
    start = {k: v.numpy().astype(np.float64) for k, v in start.items()}
    bad = _displacement_misses(got, {k: v.numpy() for k, v in after.items()}, start)
    assert not bad, bad
    cut = _probes(got, "probe.cut.")
    assert any(cut[k.split(".", 1)[1]] for k, v in _probes(got, "probe.fired.").items() if v)


# -- the MAE under tensor parallelism -----------------------------------------------

def test_mae_tp_matches_jax_gspmd(train_run, mae_reference):
    """The MAE at tp = 2 (each rank half of every timm block's MLP hidden
    columns, qkv and proj whole, as the reference's rule cuts them) against
    the JAX package's GSPMD loss and gradients (test_tensor_parallel.py's
    rtol 1e-5 / atol 1e-4)."""
    workdir, _ = train_run
    _, want_loss, want_grads = mae_reference
    got = _load(workdir, "mae_tp")
    assert int(got["local_hidden"]) == 64
    np.testing.assert_allclose(float(got["loss"]), want_loss, rtol=1e-5)
    for k, v in want_grads.items():
        np.testing.assert_allclose(got[f"grads.{k}"], v.numpy(), rtol=1e-5, atol=1e-4,
                                   err_msg=k)


def test_mae_tp_planted_fc2_bias_fails(train_run, mae_reference):
    """Each timm block's fc2 bias added before the sum, on both ranks: the
    loss and the gradients miss the gates of test_mae_tp_matches_jax_gspmd."""
    workdir, _ = train_run
    _, want_loss, want_grads = mae_reference
    got = _load(workdir, "fault_mae_fc2_bias")
    assert not np.isclose(float(got["loss"]), want_loss, rtol=1e-5)
    assert any(not np.allclose(got[f"grads.{k}"], v.numpy(), rtol=1e-5, atol=1e-4)
               for k, v in want_grads.items())


def test_mae_tp_steps_match_one_process(train_run):
    """Three MAE pretraining steps at tp = 2 against one process: the gates
    of test_two_rank_pretraining_matches_one_process."""
    from mem_tpu_torch.tools import mp_worker

    workdir, _ = train_run
    bad = _mismatches(_load(workdir, "mae_tp_steps"), _flat(mp_worker.run_mae()),
                      weights_tol=(2e-4, 2e-5))
    assert not bad, bad[:10]


# -- segmentation: SyncBN over the two ranks --------------------------------------

@pytest.fixture(scope="module")
def seg_run(tmp_path_factory):
    from mem_tpu_torch.tools import mp_worker

    workdir = tmp_path_factory.mktemp("mp_seg")
    _launch("seg", workdir)
    return str(workdir), _flat(mp_worker.run_seg())


def test_two_rank_seg_matches_one_process(seg_run):
    """BatchNorm statistics and the loss's valid-pixel count over the global
    batch: step-0 gradients, losses, and the weights and buffers after
    three steps as one process's."""
    workdir, want = seg_run
    got = _load(workdir, "seg_dp")
    bad = _mismatches(got, want, weights_tol=(0.0, 4e-3))
    assert not bad, bad[:10]
    assert any(k.endswith("running_var") for k in want)


def test_planted_unsynced_batchnorm_fails(seg_run):
    """Each rank's BatchNorm over its own half: the gradients miss the gate."""
    workdir, want = seg_run
    bad = _mismatches(_load(workdir, "fault_unsynced_bn"), want, weights_tol=(0.0, 4e-3))
    assert any(k.startswith("grads0") for k in bad)



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
  on every rank must fail.
- ``seg``: three seg train steps of a tiny segmentor (the PSP BatchNorms
  damped to eps 0.1) whose halves ignore 10 and 200 label rows, against one
  process: the step-0 gradients rtol 3e-4 / atol 1e-6, the losses rtol 1e-4,
  the weights and BatchNorm buffers atol 4e-3 (Adam's first steps are
  +-lr sign(g), test_multiprocess.py); a planted unsynced BatchNorm must fail.
"""
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PT_CASES = ("dp_adamw", "zero1_adamw", "zero1_lamb", "fsdp_adamw", "fsdp_lamb")


def _env():
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    env.pop("JAX_PLATFORMS", None)
    return env


def _launch(mode, workdir):
    from mem_tpu_torch.tools import mp_worker

    outs = mp_worker.launch(mode, str(workdir), 2, env=_env(), timeout=300, cwd=REPO)
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
def train_run(tmp_path_factory, tp_reference):
    """The ``train`` launch (with the TP inputs written first) and the
    single-process references of this process."""
    from mem_tpu_torch.tools import mp_worker

    workdir = tmp_path_factory.mktemp("mp_train")
    np.savez(workdir / "tp_inputs.npz", **tp_reference[0])
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


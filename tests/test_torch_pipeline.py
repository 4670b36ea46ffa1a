"""GPipe over two processes (mem_tpu_torch/parallel/pipeline.py, Gloo) held
against the sequential stack and against the JAX package's
``mem_tpu.parallel.pipeline_apply`` on a two-device ("pipe",) mesh of the
8-device CPU mesh: the output, the gradients of the stage parameters and of
the input, at f32 1e-5, for a dense stage (tanh(a W + b), as
test_pipeline.py:26) and for ViT Blocks (test_pipeline.py:78). One launch of
the worker's ``pipeline`` mode, two ranks; rank s holds stage s."""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from mem_tpu.models.vit import Block as JaxBlock
from mem_tpu.parallel.pipeline import (pipeline_apply as jax_pipeline_apply,
                                       pipeline_param_sharding as jax_sharding,
                                       stack_stage_params as jax_stack)
from mem_tpu_torch.parallel.pipeline import stack_stage_params
from mem_tpu_torch.tools import mp_worker
from mem_tpu_torch.utils.weights import from_jax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S = 2
TOL = dict(rtol=1e-5, atol=1e-5)


def _block_params(p):
    """One flax Block's params in the port's Block names."""
    sd = from_jax_params({"params": {"encoder": {"blocks_0": p}}})
    return {k[len("blocks.0."):]: v.numpy() for k, v in sd.items()}


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    """Both stacks, their JAX pipeline and sequential results, and the
    two-rank run of the port."""
    rng = np.random.default_rng(0)
    out = {}
    # dense: B 16, D 32, 4 microbatches
    D = 32
    stages = [{"w": (rng.standard_normal((D, D)) * 0.3).astype(np.float32),
               "b": (rng.standard_normal(D) * 0.1).astype(np.float32)} for _ in range(S)]
    x = rng.standard_normal((16, D)).astype(np.float32)
    t = rng.standard_normal((16, D)).astype(np.float32)

    def dense(p, a):
        return jnp.tanh(a @ p["w"] + p["b"])

    out["dense"] = (stages, x, t, dense, 4)
    # ViT blocks: B 8, N 17, D 32, 2 heads, 2 microbatches
    block = JaxBlock(dim=32, num_heads=2, init_values=0.1, dtype=jnp.float32)
    xv = rng.standard_normal((8, 17, 32)).astype(np.float32)
    tv = rng.standard_normal((8, 17, 32)).astype(np.float32)
    flax_stages = [jax.device_get(jax.jit(block.init)(jax.random.key(i), jnp.asarray(xv))["params"])
                   for i in range(S)]
    out["vit"] = (flax_stages, xv, tv, lambda p, a: block.apply({"params": p}, a), 2)

    inputs, want = {}, {}
    mesh = Mesh(np.asarray(jax.devices()[:S]), ("pipe",))
    for tag, (st, xx, tt, fn, micro) in out.items():
        stacked = jax_stack([jax.tree.map(jnp.asarray, s) for s in st])

        def loss_pipe(p, a, fn=fn, micro=micro, tt=tt):
            return jnp.sum(jax_pipeline_apply(fn, p, a, mesh, num_microbatches=micro) * tt)

        def seq(p, a, fn=fn):
            for i in range(S):
                a = fn(jax.tree.map(lambda q: q[i], p), a)
            return a

        sharded = jax_sharding(stacked, mesh)
        y_pipe = jax.jit(lambda p, a, fn=fn, micro=micro: jax_pipeline_apply(
            fn, p, a, mesh, num_microbatches=micro))(sharded, jnp.asarray(xx))
        gp, gx = jax.jit(jax.grad(loss_pipe, argnums=(0, 1)))(sharded, jnp.asarray(xx))
        sp, sx = jax.grad(lambda p, a, tt=tt: jnp.sum(seq(p, a) * tt), argnums=(0, 1))(
            stacked, jnp.asarray(xx))
        want[tag] = dict(y_pipe=np.asarray(y_pipe), y_seq=np.asarray(seq(stacked, jnp.asarray(xx))),
                         gx_pipe=np.asarray(gx), gx_seq=np.asarray(sx),
                         gp_pipe=jax.device_get(gp), gp_seq=jax.device_get(sp))
        port_stages = st if tag == "dense" else [_block_params(s) for s in st]
        for k, v in stack_stage_params([{k: torch.from_numpy(np.asarray(v)) for k, v in s.items()}
                                        for s in port_stages]).items():
            inputs[f"{tag}.p.{k}"] = v.numpy()
        inputs[f"{tag}.x"], inputs[f"{tag}.t"] = xx, tt

    workdir = tmp_path_factory.mktemp("mp_pipe")
    np.savez(workdir / "pipe_inputs.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    for rank, (code, log) in enumerate(mp_worker.launch("pipeline", str(workdir), S, env=env,
                                                         timeout=300, cwd=REPO)):
        assert code == 0, f"rank {rank} exit {code}\n{log[-4000:]}"
    got = [dict(np.load(workdir / f"pipeline_r{r}.npz")) for r in range(S)]
    return want, got


def _port_grads(got, tag, stage):
    return {k[len(f"{tag}.g."):]: v[0] for k, v in got[stage].items()
            if k.startswith(f"{tag}.g.")}


@pytest.mark.parametrize("tag", ["dense", "vit"])
def test_pipeline_output_matches_jax_and_sequential(cases, tag):
    """Every rank gets y; it is the JAX pipeline's and the sequential stack's."""
    want, got = cases
    for r in range(S):
        np.testing.assert_allclose(got[r][f"{tag}.y"], want[tag]["y_pipe"], **TOL)
        np.testing.assert_allclose(got[r][f"{tag}.y"], want[tag]["y_seq"], **TOL)


@pytest.mark.parametrize("tag", ["dense", "vit"])
def test_pipeline_input_gradient_matches(cases, tag):
    """d sum(y * t) / dx on every rank (stage 0's, broadcast)."""
    want, got = cases
    for r in range(S):
        np.testing.assert_allclose(got[r][f"{tag}.gx"], want[tag]["gx_pipe"], **TOL)
        np.testing.assert_allclose(got[r][f"{tag}.gx"], want[tag]["gx_seq"], **TOL)


@pytest.mark.parametrize("tag", ["dense", "vit"])
def test_pipeline_stage_gradients_match(cases, tag):
    """Each rank's stage-parameter gradients: the JAX pipeline's and the
    sequential stack's slice of that stage."""
    want, got = cases
    for s in range(S):
        mine = _port_grads(got, tag, s)
        for ref in ("gp_pipe", "gp_seq"):
            tree = jax.tree.map(lambda a: np.asarray(a)[s], want[tag][ref])
            theirs = tree if tag == "dense" else _block_params(tree)
            assert set(mine) == set(theirs)
            for k, v in theirs.items():
                np.testing.assert_allclose(mine[k], v, err_msg=f"{ref} {k}", **TOL)

"""K2f / K2b at head dim 32 (the MAE decoder's 16 heads of 512) take K3's
Hopper bodies on the card: the forward's one pass over 64-key tiles with an
online softmax, the backward's two passes from the query side and one from
the key side. Their order of arithmetic, emulated in torch (``_one_pass`` and
``_two_sided`` of test_torch_attention_long.py, at the kernels' 64-key
tile), held against K2's own Pallas kernels (mem_tpu.ops.attention
``fused_attention_flat`` and its ``jax.vjp``, interpret mode) on the same
seeded operands at D = 32 with a bias ramped 0.1 per key (the online
softmax's rescale runs), within the card's gates (chip_smoke.K2_BF16_TOL
absolute for the forward in bf16, K2B_BF16_TOL / K2B_F32_TOL of each
gradient's max abs, db K2B_DB_REL relative L2; the f32 forward 1e-5)."""
import numpy as np
import pytest
import torch

from mem_tpu.ops.attention import fused_attention_flat as jax_fused_attention_flat
from mem_tpu_torch.ops import attention as A
from test_torch_attention_long import (KERNEL_TILE, _operands, check_one_pass_order,
                                       check_two_sided_order)

CASES = [(2, 197, 2, 32),   # the decoder's N: four 64-key tiles, the last holds 5 keys
         (2, 65, 2, 32),    # one key (and one query) past a tile
         (1, 99, 4, 32)]    # the encoder's N, four heads


def _max_grows(q, k, bias, scale, H):
    """Whether some row's maximum over all keys lies past the first tile:
    the online softmax's rescale by exp(m_old - m_new) then runs."""
    B, N, C = q.shape
    qh, kh = (torch.from_numpy(t).view(B, N, H, C // H).transpose(1, 2) for t in (q, k))
    s = qh @ kh.transpose(-1, -2) * scale + torch.from_numpy(bias)
    return bool((s[..., :KERNEL_TILE].amax(-1) < s.amax(-1)).any())


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("B,N,H,D", CASES)
def test_d32_one_pass_order_matches_pallas_interpret(rng, B, N, H, D, dtype):
    """The forward's one pass at D = 32, p~ rounded to bf16 unnormalised,
    against K2f's Pallas kernel."""
    q, k, v, bias = _operands(rng, B, N, H, D, True)
    assert _max_grows(q, k, bias, D ** -0.5, H)
    check_one_pass_order(jax_fused_attention_flat, q, k, v, bias, dtype, False)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("B,N,H,D", CASES)
def test_d32_two_sided_order_matches_pallas_interpret(rng, B, N, H, D, dtype):
    """The backward's order at D = 32 (statistics from an online pass, ds and
    dq from the query side, dk and dv from the key side, db in batch order)
    against ``jax.vjp`` of K2b's Pallas kernel; db also against the plain
    backward's, the comparison the card makes."""
    operands = _operands(rng, B, N, H, D, True)
    do = rng.standard_normal((B, N, H * D)).astype(np.float32)
    check_two_sided_order(jax_fused_attention_flat, A.fused_attention_flat_bwd_reference,
                          *operands, do, dtype, True)

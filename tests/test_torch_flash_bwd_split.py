"""The group split of kernel #3 (`flash_bwd_dkv`, csrc/flash_bwd.cu) on the
CPU, where its plan and its arithmetic live in Python.

- `dkv_split_plan`: every q head of a group falls into exactly one chunk,
  in order, chunks of ceil(G / n_chunks) heads (the kernel's own rule for
  chunk c's first head), none empty; no split where B * KV * ceil(S /
  key_block) CTAs fill the card or the group is one head (key_block 128,
  and 64 at head_dim 256, where a CTA of #3 owns 64 keys), else a grid of
  at least one CTA an SM; at Falcon-7B's training shape (B = 4, S = 2048,
  71 q heads over one KV head, D 64, 132 SMs) the 9 chunks the kernel runs
  (8 of 8 heads, one of 7) and its [9, 2, B, S, KV, D] f32 scratch of
  37,748,736 bytes; at GQA 32 over 2 (B = 1, S = 2048) 16 chunks of one
  head at D 96 (32 CTAs of 128 keys) and 8 of two at D 256 (64 of 64
  keys); none at GPT-J-6B's training shape.
- A plain model of split then combine: the plain backward of each chunk's
  q heads (f32 partial dk, dv), added in chunk order, equals the unsplit
  plain backward within f32 rounding (rtol 1e-5), and both equal jax.vjp
  of the JAX package's flash kernel in interpret mode at 2e-4 (the pin of
  tests/test_torch_falcon_phi_train.py), with partial last chunks and GQA.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas import flash_attention as JF
from deepspeed_tpu_torch.ops.cuda import flash_attention as PF

H100_SMS = 132
FLASH_TOL = dict(rtol=2e-4, atol=2e-4)
# (B, S, H, KV, D): the training shapes chip_smoke.py times (flagship,
# Falcon-7B, Phi-2, GQA 16 over 2 and 20 over 2 at B = 1), and small ones
# around the tiles and groups of the card tests
PLAN_SHAPES = [(8, 2048, 8, 8, 128), (4, 2048, 71, 1, 64), (2, 2048, 32, 32, 80),
               (1, 2048, 32, 2, 64), (1, 2048, 40, 2, 80), (1, 300, 71, 1, 64),
               (1, 1, 9, 1, 64), (3, 129, 16, 2, 128), (1, 65, 2, 2, 64), (44, 300, 71, 1, 64),
               (1, 8192, 32, 8, 128), (2, 63, 18, 2, 80),
               # GPT-NeoX-20B's and GPT-J-6B's training micro-batches, GQA 32
               # over 2 at both widths, and small D-256 grids around 64-key blocks
               (2, 2048, 64, 64, 96), (4, 2048, 16, 16, 256), (1, 2048, 32, 2, 96),
               (1, 2048, 32, 2, 256), (1, 65, 12, 1, 256), (2, 300, 16, 4, 256)]


def _cdiv(a, b):
    return -(-a // b)


@pytest.mark.parametrize("sms", [H100_SMS, 16])
@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_every_q_head_falls_in_one_chunk_in_order(shape, sms):
    B, S, H, KV, D = shape
    G = H // KV
    plan = PF.dkv_split_plan(B, S, H, KV, D, sms)
    assert plan.n_chunks == len(plan.chunks) >= 1
    assert [h for first, end in plan.chunks for h in range(first, end)] == list(range(G))
    size = _cdiv(G, plan.n_chunks)  # the kernel's chunk c: heads c * size onwards
    assert plan.chunks == tuple((c * size, min(G, (c + 1) * size)) for c in range(plan.n_chunks))
    assert all(end > first for first, end in plan.chunks)


@pytest.mark.parametrize("sms", [H100_SMS, 16])
@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_split_only_where_the_grid_leaves_sms_idle(shape, sms):
    B, S, H, KV, D = shape
    blocks = B * KV * _cdiv(S, 64 if D == 256 else 128)
    plan = PF.dkv_split_plan(B, S, H, KV, D, sms)
    if blocks >= sms or H == KV:
        assert (plan.n_chunks, plan.scratch_shape, plan.scratch_bytes) == (1, (), 0)
    else:
        assert plan.n_chunks > 1 and plan.n_chunks * blocks >= min(sms, blocks * H // KV)
        assert plan.scratch_shape == (plan.n_chunks, 2, B, S, KV, D)
        assert plan.scratch_bytes == 4 * plan.n_chunks * 2 * B * S * KV * D


def test_falcon_7b_plan_is_the_kernels():
    plan = PF.dkv_split_plan(4, 2048, 71, 1, 64, H100_SMS)
    assert plan.n_chunks == 9
    assert plan.chunks == tuple((8 * c, min(71, 8 * c + 8)) for c in range(9))
    assert plan.chunks[-1] == (64, 71)  # the partial last chunk
    assert plan.scratch_shape == (9, 2, 4, 2048, 1, 64)
    assert plan.scratch_bytes == 37_748_736


@pytest.mark.parametrize("D,n_chunks", [(96, 16), (256, 8)])
def test_gqa_32_over_2_plans_are_the_kernels(D, n_chunks):
    """chip_smoke.py's GQA 32 over 2 cases at S 2048: 32 CTAs of 128 keys
    at D 96 take one head a chunk; 64 CTAs of 64 keys at D 256 two."""
    plan = PF.dkv_split_plan(1, 2048, 32, 2, D, H100_SMS)
    size = 16 // n_chunks
    assert plan.n_chunks == n_chunks
    assert plan.chunks == tuple((size * c, size * c + size) for c in range(n_chunks))
    assert plan.scratch_shape == (n_chunks, 2, 1, 2048, 2, D)
    assert PF.dkv_split_plan(4, 2048, 16, 16, 256, H100_SMS).n_chunks == 1  # GPT-J-6B


# (S, H, KV, D, sms): S 100 is no multiple of the 64-row tiles; the SM
# counts make splits with partial last chunks (G 11 in 6 chunks: five of 2
# and one of 1; G 71 in 8: seven of 9 and one of 8; GQA, G 7 in 4: three
# of 2 and one of 1, at D 80 and 96; at D 256, two 64-key blocks, G 11 in
# 6 chunks again)
SPLIT_CASES = {"g11_over_1": (100, 11, 1, 64, 2), "g71_over_1": (64, 71, 1, 64, 2),
               "gqa_14_over_2_d80": (100, 14, 2, 80, 3), "gqa_14_over_2_d96": (100, 14, 2, 96, 3),
               "g11_over_1_d256": (100, 11, 1, 256, 4)}


def _inputs(case):
    S, H, KV, D, _ = SPLIT_CASES[case]
    rng = np.random.default_rng(3)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((1, S, H, D), (1, S, KV, D), (1, S, KV, D), (1, S, H, D)))


def _split_then_combine(q, k, v, lse, delta, do, plan):
    """The plain model of the split: each chunk's q heads (in every group)
    through the plain backward, its f32 dk and dv partials added in chunk
    order."""
    H, KV = q.shape[2], k.shape[2]
    G = H // KV
    dk = dv = None
    for first, end in plan.chunks:
        idx = torch.tensor([kv * G + g for kv in range(KV) for g in range(first, end)])
        _, pk, pv = PF._bwd_plain(q[:, :, idx], k, v, lse[:, idx], delta[:, idx], do[:, :, idx])
        dk = pk if dk is None else dk + pk
        dv = pv if dv is None else dv + pv
    return dk, dv


@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_split_then_combine_equals_unsplit_and_jax(case):
    S, H, KV, D, sms = SPLIT_CASES[case]
    plan = PF.dkv_split_plan(1, S, H, KV, D, sms)
    G = H // KV
    assert 1 < plan.n_chunks < G and plan.chunks[-1][1] - plan.chunks[-1][0] < plan.chunks[0][1]
    q, k, v, do = _inputs(case)
    pq, pk, pv, pdo = (torch.from_numpy(a) for a in (q, k, v, do))
    o, lse = PF.flash_attention_plain(pq, pk, pv)
    delta = PF._delta(o, pdo)
    dk, dv = _split_then_combine(pq, pk, pv, lse, delta, pdo, plan)
    _, rk, rv = PF.flash_attention_bwd_plain(pq, pk, pv, o, lse, pdo)
    for got, ref in ((dk, rk), (dv, rv)):
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5 * ref.abs().max().item())
    _, vjp = jax.vjp(lambda q, k, v: JF.flash_attention(q, k, v, causal=True, block_q=64,
                                                        block_k=64),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    _, jk, jv = vjp(jnp.asarray(do))
    np.testing.assert_allclose(dk.numpy(), np.asarray(jk), err_msg="dk", **FLASH_TOL)
    np.testing.assert_allclose(dv.numpy(), np.asarray(jv), err_msg="dv", **FLASH_TOL)


def test_the_cpu_wrapper_is_the_unsplit_plain_backward():
    """On CPU tensors flash_bwd_dkv takes the plain version whatever the
    plan; no scratch is made."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs("g11_over_1"))
    o, lse = PF.flash_attention_plain(q, k, v)
    delta = PF._delta(o, do)
    got = PF.flash_bwd_dkv(q, k, v, do, lse, delta)
    ref = PF.flash_attention_bwd_plain(q, k, v, o, lse, do)[1:]
    assert all(torch.equal(g, r) for g, r in zip(got, ref))

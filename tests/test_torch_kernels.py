"""Port kernels (deepspeed_tpu_torch/ops/cuda) held against the JAX package.

On the CPU each wrapper runs its plain PyTorch version; those are compared
with the JAX package's XLA oracles and with its Pallas kernels run in
interpret mode (how the JAX package's own tests run them off-TPU).
Tolerances: bit-exact for the KV write (a copy); 1e-5 for attention in
f32 (the same math summed in another order).

The CUDA kernels themselves are held against these plain versions on the
card by tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import model as JM
from deepspeed_tpu.ops import attention as JA
from deepspeed_tpu.ops.pallas import flash_attention as JF
from deepspeed_tpu.ops.pallas import paged_attention as JP
from deepspeed_tpu_torch.ops import attention as PA
from deepspeed_tpu_torch.ops import cuda as PK
from deepspeed_tpu_torch.ops.cuda import flash_attention as PF
from deepspeed_tpu_torch.ops.cuda import paged_attention as PP

F32_TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _np(t):
    return t.float().numpy()


def _arena(rng, nblk=12, bs=16, kv=2, d=128):
    return (rng.standard_normal((nblk, bs, kv, d)).astype(np.float32),
            rng.standard_normal((nblk, bs, kv, d)).astype(np.float32))


def _decode_case(rng, S=4, H=2, KV=2, D=128, bs=16, NB=4, nblk=20):
    """Rows with distinct tables and contexts; row 3 is a pad row (ctx 0,
    table on the last block)."""
    kc, vc = _arena(rng, nblk, bs, KV, D)
    q = rng.standard_normal((S, H, D)).astype(np.float32)
    perm = rng.permutation(nblk - 1)[: S * NB].reshape(S, NB).astype(np.int32)
    perm[-1] = nblk - 1
    ctx = np.array([1, 17, 40, 0][:S], np.int32)
    return q, kc, vc, perm, ctx


class TestKvWrite:
    def _case(self, rng, dtype):
        kc, vc = _arena(rng)
        T = 10
        kn = rng.standard_normal((T, 2, 128)).astype(np.float32)
        vn = rng.standard_normal((T, 2, 128)).astype(np.float32)
        slots = rng.permutation(12 * 16)[:T].astype(np.int32)
        slots[[2, 7]] = -1  # pad rows drop
        if dtype == "bf16":  # values on the bf16 grid, so both sides agree
            kc, vc, kn, vn = (np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
                              for a in (kc, vc, kn, vn))
        return kc, vc, kn, vn, slots

    @pytest.mark.parametrize("dtype", ["f32", "bf16"])
    def test_plain_matches_xla_scatter_bit_exact(self, rng, dtype):
        kc, vc, kn, vn, slots = self._case(rng, dtype)
        jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
        tdt = torch.float32 if dtype == "f32" else torch.bfloat16
        jk, jv = JM._write_kv_xla(*(jnp.asarray(a, jdt) for a in (kc, vc, kn, vn)),
                                  jnp.asarray(slots))
        pk, pv = _t(kc, tdt), _t(vc, tdt)
        out = PP.paged_kv_write_plain(pk, pv, _t(kn, tdt), _t(vn, tdt),
                                      torch.from_numpy(slots))
        assert out[0] is pk and out[1] is pv  # in place
        np.testing.assert_array_equal(_np(pk), np.asarray(jk, np.float32))
        np.testing.assert_array_equal(_np(pv), np.asarray(jv, np.float32))

    def test_plain_matches_interpret_kernel_bit_exact(self, rng):
        kc, vc, kn, vn, slots = self._case(rng, "f32")
        jk, jv = JP.paged_kv_write(*(jnp.asarray(a) for a in (kc, vc, kn, vn)),
                                   jnp.asarray(slots))
        pk, pv = _t(kc), _t(vc)
        PP.paged_kv_write_plain(pk, pv, _t(kn), _t(vn), torch.from_numpy(slots))
        np.testing.assert_array_equal(_np(pk), np.asarray(jk))
        np.testing.assert_array_equal(_np(pv), np.asarray(jv))

    def test_slot_past_the_arena_clamps_like_the_interpret_kernel(self, rng):
        """A slot past the arena lands in the last block at slot % bs, as
        the TPU kernel's _arena_block clamp puts it (bit-exact)."""
        kc, vc = _arena(rng)  # 12 blocks of 16
        T = 8
        kn = rng.standard_normal((T, 2, 128)).astype(np.float32)
        vn = rng.standard_normal((T, 2, 128)).astype(np.float32)
        slots = rng.permutation(11 * 16)[:T].astype(np.int32)  # blocks 0..10
        slots[2] = 12 * 16 + 5  # one block past: block 11, offset 5
        slots[5] = 40 * 16 + 9  # far past: block 11, offset 9
        slots[6] = -1
        jk, jv = JP.paged_kv_write(*(jnp.asarray(a) for a in (kc, vc, kn, vn)),
                                   jnp.asarray(slots))
        pk, pv = _t(kc), _t(vc)
        PP.paged_kv_write_plain(pk, pv, _t(kn), _t(vn), torch.from_numpy(slots))
        np.testing.assert_array_equal(_np(pk), np.asarray(jk))
        np.testing.assert_array_equal(_np(pv), np.asarray(jv))
        np.testing.assert_array_equal(_np(pk)[11, 5], kn[2])
        np.testing.assert_array_equal(_np(pv)[11, 9], vn[5])


class TestDecode:
    def test_plain_matches_xla_oracle(self, rng):
        q, kc, vc, tbl, ctx = _decode_case(rng)
        ref = JP.paged_decode_attention_xla(*(jnp.asarray(a) for a in (q, kc, vc)),
                                            jnp.asarray(tbl), jnp.asarray(ctx))
        out = PP.paged_decode_attention_plain(_t(q), _t(kc), _t(vc),
                                              torch.from_numpy(tbl), torch.from_numpy(ctx))
        live = ctx > 0  # the JAX oracle leaves pad rows as garbage
        np.testing.assert_allclose(_np(out)[live], np.asarray(ref)[live], **F32_TOL)
        assert not _np(out)[~live].any()  # pad rows output zeros

    def test_plain_gqa_matches_interpret_kernel(self, rng):
        q, kc, vc, tbl, ctx = _decode_case(rng, H=4, KV=2)
        ref = JP.paged_decode_attention(*(jnp.asarray(a) for a in (q, kc, vc)),
                                        jnp.asarray(tbl), jnp.asarray(ctx))
        out = PP.paged_decode_attention_plain(_t(q), _t(kc), _t(vc),
                                              torch.from_numpy(tbl), torch.from_numpy(ctx))
        live = ctx > 0
        np.testing.assert_allclose(_np(out)[live], np.asarray(ref)[live], **F32_TOL)

    def test_fused_plain_matches_interpret_fused_kernel(self, rng):
        q, kc, vc, tbl, ctx = _decode_case(rng)
        S, KV, D, bs = q.shape[0], kc.shape[2], kc.shape[3], kc.shape[1]
        kn = rng.standard_normal((S, KV, D)).astype(np.float32)
        vn = rng.standard_normal((S, KV, D)).astype(np.float32)
        pos = np.maximum(ctx - 1, 0)
        slots = np.where(ctx > 0, tbl[np.arange(S), pos // bs] * bs + pos % bs,
                         -1).astype(np.int32)
        ref, rk, rv = JP.paged_decode_fused(
            *(jnp.asarray(a) for a in (q, kc, vc)), jnp.asarray(tbl), jnp.asarray(ctx),
            jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(slots))
        pk, pv = _t(kc), _t(vc)
        out, ok, ov = PP.paged_decode_fused_plain(
            _t(q), pk, pv, torch.from_numpy(tbl), torch.from_numpy(ctx), _t(kn), _t(vn),
            torch.from_numpy(slots))
        assert ok is pk and ov is pv
        live = ctx > 0
        np.testing.assert_allclose(_np(out)[live], np.asarray(ref)[live], **F32_TOL)
        np.testing.assert_array_equal(_np(pk), np.asarray(rk))
        np.testing.assert_array_equal(_np(pv), np.asarray(rv))
        # and against the XLA oracle over the caches the JAX kernel wrote
        oracle = JP.paged_decode_attention_xla(jnp.asarray(q), rk, rv, jnp.asarray(tbl),
                                               jnp.asarray(ctx))
        np.testing.assert_allclose(_np(out)[live], np.asarray(oracle)[live], **F32_TOL)

    def test_dead_slots_never_reach_the_sum(self, rng):
        """NaN in every slot past the live length (unwritten or stale
        pages) must not change the output."""
        q, kc, vc, tbl, ctx = _decode_case(rng)
        clean = PP.paged_decode_attention_plain(_t(q), _t(kc), _t(vc),
                                                torch.from_numpy(tbl), torch.from_numpy(ctx))
        kd, vd = kc.copy(), vc.copy()
        bs = kc.shape[1]
        for s in range(q.shape[0]):
            for p in range(ctx[s], tbl.shape[1] * bs):
                kd[tbl[s, p // bs], p % bs] = np.nan
                vd[tbl[s, p // bs], p % bs] = np.nan
        dirty = PP.paged_decode_attention_plain(_t(q), _t(kd), _t(vd),
                                                torch.from_numpy(tbl), torch.from_numpy(ctx))
        np.testing.assert_array_equal(_np(dirty), _np(clean))


class TestFlash:
    @pytest.mark.parametrize("KV", [2, 1])
    def test_plain_matches_xla_attention(self, rng, KV):
        B, S, H, D = 2, 40, 2, 128
        q = rng.standard_normal((B, S, H, D)).astype(np.float32)
        k = rng.standard_normal((B, S, KV, D)).astype(np.float32)
        v = rng.standard_normal((B, S, KV, D)).astype(np.float32)
        rep = H // KV
        ref = JA._xla_attention(jnp.asarray(q), JA._repeat_kv(jnp.asarray(k), rep),
                                JA._repeat_kv(jnp.asarray(v), rep))
        out, _ = PF.flash_attention_plain(_t(q), _t(k), _t(v))
        np.testing.assert_allclose(_np(out), np.asarray(ref), **F32_TOL)
        dense = PA.causal_attention(_t(q), _t(k), _t(v), use_flash=False)
        np.testing.assert_allclose(_np(dense), np.asarray(ref), **F32_TOL)

    def test_plain_matches_interpret_kernel_with_lse(self, rng):
        B, S, H, KV, D = 1, 128, 4, 2, 128
        q = rng.standard_normal((B, S, H, D)).astype(np.float32)
        k = rng.standard_normal((B, S, KV, D)).astype(np.float32)
        v = rng.standard_normal((B, S, KV, D)).astype(np.float32)
        ref_o, ref_lse = JF.flash_attention_with_lse(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
            block_q=64, block_k=64)
        o, lse = PF.flash_attention_plain(_t(q), _t(k), _t(v))
        np.testing.assert_allclose(_np(o), np.asarray(ref_o), **F32_TOL)
        np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), **F32_TOL)


class TestWrappersOnCpu:
    def test_cpu_tensors_take_the_plain_version_and_count_nothing(self, rng):
        PK.reset_launch_counts()
        q, kc, vc, tbl, ctx = _decode_case(rng)
        args = (_t(q), _t(kc), _t(vc), torch.from_numpy(tbl), torch.from_numpy(ctx))
        np.testing.assert_array_equal(
            _np(PP.paged_decode_attention(*args)),
            _np(PP.paged_decode_attention_plain(*args)))
        x = _t(rng.standard_normal((1, 8, 2, 128)))
        np.testing.assert_array_equal(_np(PA.causal_attention(x, x, x)),
                                      _np(PF.flash_attention_plain(x, x, x)[0]))
        assert PK.launch_counts() == {n: 0 for n in PK.WRAPPERS}

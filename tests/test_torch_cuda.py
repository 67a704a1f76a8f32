"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test is marked `cuda` and skips without a CUDA device. This file
imports neither JAX nor the JAX package, so it runs on the GPU machine
(which has no JAX) without the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import functools
import hashlib
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops import cuda as PK
from deepspeed_tpu_torch.ops import evoformer_attention as PE
from deepspeed_tpu_torch.ops.cuda import evoformer_attention as PEV
from deepspeed_tpu_torch.ops.cuda import flash_attention as PF
from deepspeed_tpu_torch.ops.cuda import paged_attention as PP


@pytest.fixture
def rng():
    return np.random.default_rng(0)


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


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the CUDA kernels build and run only there")
    return torch.device("cuda")


def _bf16_cuda(a, dev):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dev, torch.bfloat16)


@pytest.mark.cuda
class TestKernelsOnCard:
    """Kernel vs plain version on the same bf16 inputs. Decode keeps f32
    probabilities, so the two differ by the bf16 rounding of the output:
    one bf16 ulp is at most 2^-7 of the value (rtol 8e-3), atol 1e-3 for
    values near zero. Flash also feeds bf16 probabilities to the tensor
    cores, a further 2^-9 relative per term: 2e-2 abs and rel."""

    DECODE_TOL = dict(rtol=8e-3, atol=1e-3)
    FLASH_TOL = dict(rtol=2e-2, atol=2e-2)

    def test_kv_write_bit_exact(self, rng, cuda_device):
        kc, vc = _arena(rng, 12, 16, 8, 128)
        T = 40
        kn = rng.standard_normal((T, 8, 128))
        vn = rng.standard_normal((T, 8, 128))
        slots = rng.permutation(11 * 16)[:T].astype(np.int32)  # blocks 0..10
        slots[::7] = -1
        slots[3] = 12 * 16 + 5  # past the arena: clamped into block 11
        slots[4] = 40 * 16 + 9
        ka, va = _bf16_cuda(kc, cuda_device), _bf16_cuda(vc, cuda_device)
        kb, vb = ka.clone(), va.clone()
        s = torch.from_numpy(slots).to(cuda_device)
        PP.paged_kv_write(ka, va, _bf16_cuda(kn, cuda_device), _bf16_cuda(vn, cuda_device), s)
        PP.paged_kv_write_plain(kb, vb, _bf16_cuda(kn, cuda_device),
                                _bf16_cuda(vn, cuda_device), s)
        torch.cuda.synchronize()
        assert torch.equal(ka, kb) and torch.equal(va, vb)

    @pytest.mark.parametrize("H,D", [(2, 128), (4, 128), (4, 64)])
    def test_decode_plain_mode(self, rng, cuda_device, H, D):
        q, kc, vc, tbl, ctx = _decode_case(rng, H=H, KV=2, D=D)
        d = cuda_device
        args = (_bf16_cuda(q, d), _bf16_cuda(kc, d), _bf16_cuda(vc, d),
                torch.from_numpy(tbl).to(d), torch.from_numpy(ctx).to(d))
        out = PP.paged_decode_attention(*args)
        ref = PP.paged_decode_attention_plain(*args)
        torch.testing.assert_close(out.float(), ref.float(), **self.DECODE_TOL)

    @pytest.mark.parametrize("H,D", [(2, 128), (4, 128), (4, 64)])
    def test_decode_fused_mode(self, rng, cuda_device, H, D):
        q, kc, vc, tbl, ctx = _decode_case(rng, H=H, KV=2, D=D)
        S, KV, D, bs = q.shape[0], kc.shape[2], kc.shape[3], kc.shape[1]
        pos = np.maximum(ctx - 1, 0)
        slots = np.where(ctx > 0, tbl[np.arange(S), pos // bs] * bs + pos % bs,
                         -1).astype(np.int32)
        kn = rng.standard_normal((S, KV, D))
        vn = rng.standard_normal((S, KV, D))
        d = cuda_device
        ka, va = _bf16_cuda(kc, d), _bf16_cuda(vc, d)
        kb, vb = ka.clone(), va.clone()
        rest = (torch.from_numpy(tbl).to(d), torch.from_numpy(ctx).to(d),
                _bf16_cuda(kn, d), _bf16_cuda(vn, d), torch.from_numpy(slots).to(d))
        out, _, _ = PP.paged_decode_fused(_bf16_cuda(q, d), ka, va, *rest)
        ref, _, _ = PP.paged_decode_fused_plain(_bf16_cuda(q, d), kb, vb, *rest)
        torch.testing.assert_close(out.float(), ref.float(), **self.DECODE_TOL)
        assert torch.equal(ka, kb) and torch.equal(va, vb)

    @pytest.mark.parametrize("S,KV,D", [(128, 2, 128), (200, 1, 128), (77, 1, 64), (1, 2, 128),
                                        (63, 1, 80), (129, 2, 64)])
    def test_flash(self, rng, cuda_device, S, KV, D):
        d = cuda_device
        q = _bf16_cuda(rng.standard_normal((2, S, 2, D)), d)
        k = _bf16_cuda(rng.standard_normal((2, S, KV, D)), d)
        v = _bf16_cuda(rng.standard_normal((2, S, KV, D)), d)
        o, lse = PF.flash_attention(q, k, v)
        ro, rlse = PF.flash_attention_plain(q, k, v)
        torch.testing.assert_close(o.float(), ro.float(), **self.FLASH_TOL)
        torch.testing.assert_close(lse, rlse, rtol=1e-3, atol=1e-3)

    def test_wrappers_reject_bad_inputs(self, cuda_device):
        q = torch.zeros((1, 8, 2, 128), device=cuda_device)  # f32, not bf16
        with pytest.raises(TypeError):
            PF.flash_attention(q, q, q)


def _flash_batches(S, H):
    """Batch sizes that put kernel #1 in each of its two CTA heights: 64-row
    CTAs while B * H * ceil(S / 128) leaves SMs idle, 128-row CTAs once it
    does not (the launcher's choice by shape)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    full = -(-sms // (H * -(-S // 128)))
    return sorted({1, full})


@pytest.mark.cuda
class TestFlashForwardOnCard:
    """Kernel #1 (wgmma, a TMA ring, register-resident softmax) against its
    plain version on the same bf16 inputs at the edges of its design: o
    under `bwd_mismatch` (P is rounded to bf16 for the tensor cores), lse
    at 1e-3. Sequence lengths around the 64- and 128-row tiles (the
    ragged last tile, a single tile, rows past S as TMA's zeros), whole
    query groups of 1, 2, 8 and 71 over their KV heads, head dims 64, 80
    (two swizzle atoms, the second zero past column 80) and 128; in each,
    both CTA heights, the causal band, windows 1, 63, 64, 65, 129 and S,
    each with and without ALiBi slopes."""

    @pytest.mark.parametrize("D", [64, 80, 128])
    @pytest.mark.parametrize("G", [1, 2, 8, 71])
    @pytest.mark.parametrize("S", [1, 63, 64, 65, 127, 128, 129, 200, 1000])
    def test_flash_forward(self, rng, cuda_device, S, G, D):
        KV = 1 if G == 71 else 2
        H = G * KV
        batches = _flash_batches(S, H)
        B = max(batches)
        q = _bf16_cuda(rng.standard_normal((B, S, H, D)), cuda_device)
        k = _bf16_cuda(rng.standard_normal((B, S, KV, D)), cuda_device)
        v = _bf16_cuda(rng.standard_normal((B, S, KV, D)), cuda_device)
        for b in batches:
            for window in sorted({0, 1, 63, 64, 65, 129, S}):
                for alibi in (None, _slopes(H, cuda_device)):
                    args = (q[:b], k[:b], v[:b], window, alibi)
                    what = (f"B={b} S={S} H={H} KV={KV} D={D} window={window} "
                            f"alibi={alibi is not None}")
                    o, lse = PF.flash_fwd(*args)
                    ro, rlse = PF.flash_attention_plain(*args)
                    _assert_grad_close(o, ro, f"o {what}")
                    torch.testing.assert_close(lse, rlse, rtol=1e-3, atol=1e-3,
                                               msg=lambda m: f"lse {what}: {m}")

    @pytest.mark.parametrize("B,S,H,KV,D", [(8, 2048, 8, 8, 128), (1, 512, 8, 8, 128),
                                            (1, 1920, 71, 1, 64), (1, 1000, 32, 32, 80)])
    def test_two_launches_bit_identical(self, rng, cuda_device, B, S, H, KV, D):
        q = _bf16_cuda(rng.standard_normal((B, S, H, D)), cuda_device)
        k = _bf16_cuda(rng.standard_normal((B, S, KV, D)), cuda_device)
        v = _bf16_cuda(rng.standard_normal((B, S, KV, D)), cuda_device)
        for window, alibi in ((0, None), (129, _slopes(H, cuda_device))):
            first = PF.flash_fwd(q, k, v, window, alibi)
            second = PF.flash_fwd(q, k, v, window, alibi)
            torch.cuda.synchronize()
            assert all(torch.equal(a, b) for a, b in zip(first, second)), (window, alibi)


def _int8_rows(rng, T, KV, D):
    """f32 rows [T, KV, D] to be rounded to bf16: unit normal, and three
    built rows: .5 ties (absmax 127, so the scale is exactly 1), zeros, and
    a subnormal absmax."""
    x = rng.standard_normal((T, KV, D)).astype(np.float32)
    x[0] = rng.integers(-126, 126, (KV, D)) + 0.5
    x[0, :, 0] = 127.0
    x[1] = 0.0
    x[2] = 3e-39
    x[2, :, ::3] = -5e-39
    return x


def _int8_pools(rng, dev, nblk, bs, KV, D):
    """int8 code pools and f32 scale pools on the card, filled by the plain
    quantizer from unit-normal bf16 rows."""
    kf = _bf16_cuda(rng.standard_normal((nblk * bs, KV, D)), dev)
    vf = _bf16_cuda(rng.standard_normal((nblk * bs, KV, D)), dev)
    qk, ks, qv, vs = PP.quantize_kv_rows(kf, vf)
    return (qk.reshape(nblk, bs, KV, D), qv.reshape(nblk, bs, KV, D),
            ks.reshape(nblk, bs, KV), vs.reshape(nblk, bs, KV))


@pytest.mark.cuda
class TestKvInt8OnCard:
    """The three int8 kernels against their plain versions on the same card
    inputs: codes and scales bit-exact (the in-kernel quantizer repeats
    quantize_kv_rows); attention output at the bf16 decode's tolerance
    (one bf16 ulp)."""

    DECODE_TOL = dict(rtol=8e-3, atol=1e-3)

    @pytest.mark.parametrize("KV,D", [(8, 128), (8, 64), (2, 128), (1, 64)])
    def test_kv_write_int8_bit_exact(self, rng, cuda_device, KV, D):
        """KV = 2 and 1 give [KV] f32 scale rows of 8 and 4 bytes, which the
        bf16 write's 16-byte rows would refuse."""
        d = cuda_device
        pools = _int8_pools(rng, d, 12, 16, KV, D)
        ref = [p.clone() for p in pools]
        T = 40
        kn = _bf16_cuda(_int8_rows(rng, T, KV, D), d)
        vn = _bf16_cuda(_int8_rows(rng, T, KV, D)[::-1].copy(), d)
        slots = rng.permutation(11 * 16)[:T].astype(np.int32)
        slots[5::7] = -1
        slots[3] = 12 * 16 + 5  # past the arena: clamped into block 11
        s = torch.from_numpy(slots).to(d)
        PP.paged_kv_write_int8(*pools, kn, vn, s)
        PP.paged_kv_write_quant_plain(*ref, kn, vn, s)
        torch.cuda.synchronize()
        for got, want in zip(pools, ref):
            assert torch.equal(got, want)
        sub = ref[2].view(-1, KV)[slots[2]]  # the subnormal row kept its scale
        assert 0 < sub.max().item() < torch.finfo(torch.float32).tiny

    def _decode_inputs(self, rng, d, H, D):
        q, _, _, tbl, ctx = _decode_case(rng, H=H, KV=8, D=D)
        pools = _int8_pools(rng, d, 20, 16, 8, D)
        return (_bf16_cuda(q, d), pools, torch.from_numpy(tbl).to(d),
                torch.from_numpy(ctx).to(d))

    @pytest.mark.parametrize("H,D", [(8, 128), (32, 128), (8, 64), (32, 64)])
    def test_decode_int8_plain_mode(self, rng, cuda_device, H, D):
        q, (kc, vc, ks, vs), tbl, ctx = self._decode_inputs(rng, cuda_device, H, D)
        out = PP.paged_decode_attention_int8(q, kc, vc, tbl, ctx, ks, vs)
        ref = PP.paged_decode_attention_plain(q, kc, vc, tbl, ctx, ks, vs)
        torch.testing.assert_close(out.float(), ref.float(), **self.DECODE_TOL)
        assert not out[3].any()  # the pad row

    @pytest.mark.parametrize("H,D", [(8, 128), (32, 128), (8, 64), (32, 64)])
    def test_decode_int8_fused_mode(self, rng, cuda_device, H, D):
        d = cuda_device
        q, pools, tbl, ctx = self._decode_inputs(rng, d, H, D)
        ref_pools = [p.clone() for p in pools]
        S, bs = q.shape[0], pools[0].shape[1]
        pos = (ctx - 1).clamp(min=0)
        slots = torch.where(ctx > 0, tbl[torch.arange(S, device=d), pos // bs] * bs + pos % bs,
                            -1).to(torch.int32)
        kn = _bf16_cuda(_int8_rows(rng, S, 8, D), d)
        vn = _bf16_cuda(_int8_rows(rng, S, 8, D)[::-1].copy(), d)
        out = PP.paged_decode_fused_int8(q, pools[0], pools[1], tbl, ctx, kn, vn, slots,
                                         pools[2], pools[3])[0]
        ref = PP.paged_decode_fused_plain(q, ref_pools[0], ref_pools[1], tbl, ctx, kn, vn,
                                          slots, ref_pools[2], ref_pools[3])[0]
        torch.testing.assert_close(out.float(), ref.float(), **self.DECODE_TOL)
        for got, want in zip(pools, ref_pools):  # codes and scales bit-exact
            assert torch.equal(got, want)

    def test_dequant_rounds_to_bf16(self, rng, cuda_device):
        """A code dequantizes to bf16(code * scale) before it meets P, as
        in the TPU kernel. With q = 0 every live column gets P = 1/64
        exactly, so the output is the exact mean of the 64 dequantized V
        rows, rounded once to bf16, in any summation order: the kernel
        must equal the plain version bit for bit. Codes 64..127 with
        scale 1 + 2^-9 make code * scale = code + code/512, which bf16
        rounds to code; the plain version without that rounding (its f32
        mode) must differ."""
        d = cuda_device
        S, H, D, bs, nblk = 4, 8, 128, 16, 20
        kc = torch.from_numpy(rng.integers(-127, 128, (nblk, bs, 8, D)).astype(np.int8)).to(d)
        vc = torch.from_numpy(rng.integers(64, 128, (nblk, bs, 8, D)).astype(np.int8)).to(d)
        ks = torch.rand((nblk, bs, 8), device=d) + 0.01
        vs = torch.full((nblk, bs, 8), 1 + 2.0 ** -9, device=d)
        tbl = torch.arange(S * 4, dtype=torch.int32, device=d).reshape(S, 4)
        ctx = torch.full((S,), 64, dtype=torch.int32, device=d)
        q = torch.zeros((S, H, D), dtype=torch.bfloat16, device=d)
        out = PP.paged_decode_attention_int8(q, kc, vc, tbl, ctx, ks, vs)
        ref = PP.paged_decode_attention_plain(q, kc, vc, tbl, ctx, ks, vs)
        assert torch.equal(out, ref)
        unrounded = PP.paged_decode_attention_plain(q.float(), kc, vc, tbl, ctx, ks, vs)
        assert (unrounded.to(torch.bfloat16) != out).sum() > S * H * D // 10

    def test_int8_wrappers_reject_bad_inputs(self, rng, cuda_device):
        d = cuda_device
        q, (kc, vc, ks, vs), tbl, ctx = self._decode_inputs(rng, d, 8, 128)
        with pytest.raises(TypeError):  # bf16 pools to an int8 kernel
            PP.paged_decode_attention_int8(q, kc.to(torch.bfloat16), vc.to(torch.bfloat16),
                                           tbl, ctx, ks, vs)
        with pytest.raises(TypeError):  # bf16 scales
            PP.paged_decode_attention_int8(q, kc, vc, tbl, ctx, ks.to(torch.bfloat16), vs)
        with pytest.raises(ValueError):  # scale pool not [NBLK, bs, KV]
            PP.paged_decode_attention_int8(q, kc, vc, tbl, ctx, ks[:, :8].contiguous(), vs)
        with pytest.raises(TypeError):  # int8 pools to the bf16 kernel
            PP.paged_decode_attention(q, kc, vc, tbl, ctx)
        rows = _bf16_cuda(rng.standard_normal((4, 8, 128)), d)
        slots = torch.zeros((4,), dtype=torch.int32, device=d)
        with pytest.raises(TypeError):  # f32 rows
            PP.paged_kv_write_int8(kc, vc, ks, vs, rows.float(), rows, slots)
        with pytest.raises(ValueError):  # rows of another head count
            PP.paged_kv_write_int8(kc, vc, ks, vs, rows[:, :4].contiguous(), rows, slots)
        with pytest.raises(ValueError):  # scales on the CPU
            PP.paged_kv_write_int8(kc, vc, ks.cpu(), vs, rows, rows, slots)
        with pytest.raises(TypeError):  # f32 new rows to the fused kernel
            PP.paged_decode_fused_int8(q, kc, vc, tbl, ctx, rows[:4].float(), rows[:4],
                                       slots, ks, vs)


def _bwd_case(rng, dev, B, S, H, KV, D):
    """bf16 q, k, v, dO on the card and the forward's o and lse (from the
    forward kernel, as the training step saves them)."""
    q = _bf16_cuda(rng.standard_normal((B, S, H, D)), dev)
    k = _bf16_cuda(rng.standard_normal((B, S, KV, D)), dev)
    v = _bf16_cuda(rng.standard_normal((B, S, KV, D)), dev)
    do = _bf16_cuda(rng.standard_normal((B, S, H, D)), dev)
    o, lse = PF.flash_fwd(q, k, v)
    return q, k, v, o, lse, do


def _assert_grad_close(got, ref, what):
    """Kernel gradient vs the plain backward on the same bf16 inputs (which
    rounds P and dS to bf16 where the kernels do), under `bwd_mismatch`'s stated tolerance: one
    bf16 ulp of the value (2^-7 relative) + 2^-5 of the plain row's RMS
    over the head dimension (a flipped rounding of one P or dS term) +
    2^-10 of the tensor's RMS."""
    stats = PF.bwd_mismatch(got, ref)
    assert stats["n_over"] == 0, f"{what}: {stats}"


def _rms(x):
    return x.float().square().mean().sqrt().item()


@pytest.mark.cuda
class TestFlashBackwardOnCard:
    """Kernels #2 (dq) and #3 (dk, dv) against the plain backward, and
    the autograd Function against autograd through the plain forward."""

    @pytest.mark.parametrize("S", [64, 200, 2048])
    @pytest.mark.parametrize("KV", [8, 2])
    @pytest.mark.parametrize("D", [64, 128])
    def test_kernels_match_plain(self, rng, cuda_device, S, KV, D):
        B = 1 if S == 2048 else 2
        q, k, v, o, lse, do = _bwd_case(rng, cuda_device, B, S, 8, KV, D)
        delta = PF._delta(o, do)
        dq = PF.flash_bwd_dq(q, k, v, do, lse, delta)
        dk, dv = PF.flash_bwd_dkv(q, k, v, do, lse, delta)
        rq, rk, rv = PF.flash_attention_bwd_plain(q, k, v, o, lse, do)
        torch.cuda.synchronize()
        for name, got, ref in (("dq", dq, rq), ("dk", dk, rk), ("dv", dv, rv)):
            _assert_grad_close(got, ref, f"{name} S={S} KV={KV} D={D}")

    @pytest.mark.parametrize("KV", [4, 1])
    def test_function_grads_match_autograd_through_plain(self, rng, cuda_device, KV):
        """The Function's gradients are the kernels' on the forward
        kernel's residuals (held at the tolerance above), and they are the
        gradient of attention: against autograd through the dense plain
        forward in f32, where the bf16 rounding of o (in delta), P and dS
        is what differs, the error's RMS stays within 2^-7 of the
        gradient's (a 2% scale error would be 2^-5.6)."""
        q, k, v, o, lse, do = _bwd_case(rng, cuda_device, 2, 300, 4, KV, 128)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        got = torch.autograd.grad(PF.flash_attention(*leaves)[0], leaves, do)
        same = PF.flash_attention_bwd_plain(q, k, v, o, lse, do)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        dense = torch.autograd.grad(PF.flash_attention_plain(*leaves)[0], leaves, do)
        for name, g, r, d in zip(("dq", "dk", "dv"), got, same, dense):
            assert g.abs().max() > 0, f"{name} is zero: no gradient reached the input"
            _assert_grad_close(g, r, name)
            assert _rms(g.float() - d.float()) <= 2.0 ** -7 * _rms(d), name

    def test_two_runs_bit_identical(self, rng, cuda_device):
        q, k, v, o, lse, do = _bwd_case(rng, cuda_device, 2, 520, 8, 2, 128)
        first = PF.flash_attention_bwd(q, k, v, o, lse, do)
        second = PF.flash_attention_bwd(q, k, v, o, lse, do)
        torch.cuda.synchronize()
        for a, b in zip(first, second):
            assert torch.equal(a, b)

    def test_backward_wrappers_reject_bad_inputs(self, rng, cuda_device):
        q, k, v, o, lse, do = _bwd_case(rng, cuda_device, 1, 64, 4, 2, 128)
        delta = PF._delta(o, do)
        with pytest.raises(TypeError):
            PF.flash_bwd_dq(q.float(), k, v, do, lse, delta)
        with pytest.raises(TypeError):
            PF.flash_bwd_dkv(q, k, v, do, lse.to(torch.bfloat16), delta)
        with pytest.raises(ValueError):
            PF.flash_bwd_dq(q, k, v, do, lse[:, :, :32].contiguous(), delta)
        with pytest.raises(ValueError):
            PF.flash_bwd_dkv(q, k[:, :32].contiguous(), v, do, lse, delta)
        with pytest.raises(ValueError):
            PF.flash_bwd_dq(q.transpose(1, 2), k, v, do, lse, delta)
        q96 = torch.zeros((1, 64, 4, 96), dtype=torch.bfloat16, device=cuda_device)
        with pytest.raises(ValueError):
            PF.flash_bwd_dq(q96, q96[:, :, :2].contiguous(), q96[:, :, :2].contiguous(), q96,
                            lse, delta)


def _evo_case(rng, dev, S, N, H, D, which, B=1):
    """bf16 q, k, v, dO [B, S, N, H, D] on the card and the biases of
    `which` ("both", "mask", "pair", "none"): an MSA mask bias (-1e9 on
    ~10% of the keys, key 0 never, so no row is masked whole) and a pair
    bias normal * 0.5."""
    q, k, v, do = (_bf16_cuda(rng.standard_normal((B, S, N, H, D)), dev) for _ in range(4))
    masked = rng.random((B, S, 1, 1, N)) < 0.1
    masked[..., 0] = False
    b1 = _bf16_cuda(np.where(masked, -1e9, 0.0), dev) if which in ("both", "mask") else None
    b2 = (_bf16_cuda(0.5 * rng.standard_normal((B, 1, H, N, N)), dev)
          if which in ("both", "pair") else None)
    return q, k, v, do, b1, b2


@pytest.mark.cuda
class TestEvoformerOnCard:
    """Kernels #7-#10 against their plain versions on the same bf16 inputs
    (the plain versions round P and dS to bf16 where the kernels do), under
    `bwd_mismatch`'s stated tolerance: one bf16 ulp of the value + 2^-5 of
    the row's RMS over the last axis (D for o, dq, dk, dv; the keys for the
    row sums and the bias gradients) + 2^-10 of the tensor's RMS. N = 48
    and 200 leave a ragged last tile; S = 4 makes db2 a sum over
    sequences."""

    @pytest.mark.parametrize("S", [1, 4])
    @pytest.mark.parametrize("which", ["both", "mask", "pair", "none"])
    @pytest.mark.parametrize("D", [32, 64])
    @pytest.mark.parametrize("N", [48, 200, 256])
    def test_kernels_match_plain(self, rng, cuda_device, N, D, which, S):
        q, k, v, do, b1, b2 = _evo_case(rng, cuda_device, S, N, 2, D, which)
        o, lse = PEV.evoformer_fwd(q, k, v, b1, b2)
        ro, rlse = PEV.evoformer_fwd_plain(q, k, v, b1, b2)
        torch.cuda.synchronize()
        _assert_grad_close(o, ro, f"o N={N} D={D} {which} S={S}")
        torch.testing.assert_close(lse, rlse, rtol=1e-4, atol=1e-4)
        delta = PEV._delta(o, do)
        args = (q, k, v, b1, b2, do, lse, delta)
        got = {"dq": PEV.evoformer_bwd_dq(*args)}
        got["dk"], got["dv"], got["dsum"] = PEV.evoformer_bwd_dkv(*args)
        ref = dict(zip(("dq", "dk", "dv", "dsum", "db2"),
                       PEV._bwd_plain(q, k, v, b1, b2, lse, delta, do)))
        if b2 is not None:
            got["db2"] = PEV.evoformer_bwd_db2(*args)
        torch.cuda.synchronize()
        for name, g in got.items():
            _assert_grad_close(g, ref[name], f"{name} N={N} D={D} {which} S={S}")

    def test_function_grads_match_autograd_through_plain(self, rng, cuda_device):
        """One forward and backward through `ds4sci_evoformer_attention`
        launches each kernel once. Its gradients are the kernels' on the
        forward kernel's residuals (held at the tolerance above), and they
        are the gradient of attention: against autograd through the dense
        plain forward in f32, where the bf16 rounding of o (in delta), P
        and dS is what differs, the error's RMS stays within 2^-7 of the
        gradient's (a 2% scale error would be 2^-5.6)."""
        q, k, v, do, b1, b2 = _evo_case(rng, cuda_device, 4, 200, 4, 32, "both")
        leaves = [t.clone().requires_grad_() for t in (q, k, v, b1, b2)]
        PK.reset_launch_counts()
        out = PE.ds4sci_evoformer_attention(*leaves[:3], leaves[3:])
        got = torch.autograd.grad(out, leaves, do)
        counts = PK.launch_counts()
        assert counts == {n: int(n.startswith("evoformer")) for n in counts}, counts
        o, lse = PEV.evoformer_fwd(q, k, v, b1, b2)
        same = PEV.evoformer_bwd_plain(q, k, v, b1, b2, o, lse, do)
        leaves = [t.float().requires_grad_() for t in (q, k, v, b1, b2)]
        dense = torch.autograd.grad(PEV.evoformer_fwd_plain(*leaves)[0], leaves, do.float())
        for name, g, r, d in zip(("dq", "dk", "dv", "db1", "db2"), got, same, dense):
            assert g.abs().max() > 0, f"{name} is zero: no gradient reached the input"
            _assert_grad_close(g, r, name)
            assert _rms(g.float() - d.float()) <= 2.0 ** -7 * _rms(d), name

    def test_two_runs_bit_identical(self, rng, cuda_device):
        q, k, v, do, b1, b2 = _evo_case(rng, cuda_device, 4, 200, 4, 32, "both")
        o, lse = PEV.evoformer_fwd(q, k, v, b1, b2)
        first = PEV.evoformer_attention_bwd(q, k, v, b1, b2, o, lse, do)
        second = PEV.evoformer_attention_bwd(q, k, v, b1, b2, o, lse, do)
        torch.cuda.synchronize()
        for a, b in zip(first, second):
            assert torch.equal(a, b)

    def test_wrappers_reject_bad_inputs(self, rng, cuda_device):
        q, k, v, do, b1, b2 = _evo_case(rng, cuda_device, 2, 64, 2, 32, "both")
        with pytest.raises(TypeError):
            PEV.evoformer_fwd(q.float(), k, v, b1, b2)
        with pytest.raises(TypeError):
            PEV.evoformer_fwd(q, k, v, b1.float(), b2)
        with pytest.raises(ValueError):
            PEV.evoformer_fwd(q, k.transpose(2, 3), v, b1, b2)  # not contiguous
        with pytest.raises(ValueError):
            PEV.evoformer_fwd(q, k, v, b1, b2.transpose(-1, -2))
        with pytest.raises(ValueError):
            PEV.evoformer_fwd(q, k.cpu(), v, b1, b2)
        with pytest.raises(ValueError):
            PEV.evoformer_fwd(q, k, v, b1[:, :1].contiguous(), b2)
        q48 = torch.zeros((1, 2, 64, 2, 48), dtype=torch.bfloat16, device=cuda_device)
        with pytest.raises(ValueError):
            PEV.evoformer_fwd(q48, q48, q48)
        o, lse = PEV.evoformer_fwd(q, k, v, b1, b2)
        delta = PEV._delta(o, do)
        with pytest.raises(TypeError):
            PEV.evoformer_bwd_dq(q, k, v, b1, b2, do, lse.to(torch.bfloat16), delta)
        with pytest.raises(ValueError):
            PEV.evoformer_bwd_dkv(q, k, v, b1, b2, do, lse[:, :32].contiguous(), delta)
        with pytest.raises(ValueError):
            PEV.evoformer_bwd_db2(q, k, v, b1, None, do, lse, delta)


def _evo_check(q, k, v, do, b1, b2, what):
    """#7 (o under bwd_mismatch, lse at 1e-4) and, with bias2, #10 against
    their plain versions; returns (o, lse, db2 or None)."""
    o, lse = PEV.evoformer_fwd(q, k, v, b1, b2)
    ro, rlse = PEV.evoformer_fwd_plain(q, k, v, b1, b2)
    torch.cuda.synchronize()
    _assert_grad_close(o, ro, f"o {what}")
    torch.testing.assert_close(lse, rlse, rtol=1e-4, atol=1e-4, msg=f"lse {what}")
    if b2 is None:
        return o, lse, None
    delta = PEV._delta(o, do)
    db2 = PEV.evoformer_bwd_db2(q, k, v, b1, b2, do, lse, delta)
    torch.cuda.synchronize()
    if q.shape[2] == 1:
        # one key: P = 1 and dS = dO (v - o) = 0, so db2 is zero up to
        # rounding (as window 1's flash dq and dk, TestWindowOnCard): held
        # below 2^-10 of delta's largest value
        assert db2.float().abs().max().item() <= 2.0 ** -10 * delta.abs().max().item(), what
    else:
        _assert_grad_close(db2, PEV._bwd_plain(q, k, v, b1, b2, lse, delta, do)[4],
                           f"db2 {what}")
    return o, lse, db2


def _evo_units(B, N, H, which):
    """CTAs a sequence run of #7 (128-row query tiles) or #10 (128 x 64 db2
    tiles); a batch of at least 4 waves of them is not split."""
    return B * H * -(-N // 128) * (-(-N // 64) if which == "db2" else 1)


EVO_BWD = ("dq", "dk", "dv", "dsum")


def _evo_bwd(args, n_runs=None):
    """#8 and #9 on the backward's arguments: {dq, dk, dv, dsum}."""
    out = (PEV.evoformer_bwd_dq(*args, n_runs=n_runs),) + PEV.evoformer_bwd_dkv(*args,
                                                                                n_runs=n_runs)
    return dict(zip(EVO_BWD, out))


def _evo_bwd_check(q, k, v, do, b1, b2, what):
    """#8 and #9 against the plain backward on the forward kernel's o and
    lse under `bwd_mismatch`, and the same bits with the run count forced
    to 1 and to S as in the plan's runs. With one key (N = 1) P = 1 and dS =
    dO (v - o) is zero up to rounding, so dq, dk and the row sums are held
    below 2^-10 of dv's RMS (as window 1's flash dq and dk). Returns the
    plan's outputs and the plain ones."""
    o, lse = PEV.evoformer_fwd(q, k, v, b1, b2)
    args = (q, k, v, b1, b2, do, lse, PEV._delta(o, do))
    got = _evo_bwd(args)
    ref = dict(zip(EVO_BWD, PEV._bwd_plain(q, k, v, b1, b2, lse, args[7], do)[:4]))
    for n_runs in (1, q.shape[1]):
        forced = _evo_bwd(args, n_runs)
        torch.cuda.synchronize()
        for t in EVO_BWD:
            assert torch.equal(forced[t], got[t]), f"{t} {what}: {n_runs} runs differ from the plan's"
    for t in EVO_BWD:
        if q.shape[2] == 1 and t != "dv":
            assert _rms(got[t]) <= 2.0 ** -10 * _rms(got["dv"]), f"{t} {what}"
        else:
            _assert_grad_close(got[t], ref[t], f"{t} {what}")
    return got, ref


def _evo_fwd_digest(o, lse):
    """The first 16 hex digits of the sha256 of o's and lse's bytes."""
    h = hashlib.sha256(o.view(torch.int16).cpu().numpy().tobytes())
    h.update(lse.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


# #7's o and lse on an H100 (_evo_fwd_digest) for the inputs _evo_case makes
# from numpy seed 0 with both biases, at (S, N, H, D): those of the kernel
# before its band helpers moved to csrc/evoformer_band.cuh (shared with
# #8): the move changed no bit. The last shape takes no band (bias2 from
# device memory).
EVO_FWD_DIGESTS = {(3, 200, 2, 32): "fd83e8404656a171", (3, 129, 2, 64): "1fe44b1c7102a197",
                   (17, 256, 2, 32): "0308ea8c472cb2e9", (3, 600, 1, 32): "8ed119d16b44c1b2"}


@pytest.mark.cuda
class TestEvoformerHopperOnCard:
    """Kernels #7 (the forward) and #10 (db2) in their wgmma/TMA design,
    against their plain versions on the same bf16 inputs under
    `bwd_mismatch`, #7's lse at 1e-4 (at N = 1 db2 is zero up to rounding
    and is held below 2^-10 of delta): N at the edges of the 64- and 128-row
    tiles and odd (the band's element loads, bias1 words of either parity),
    N past the band's limit of 512 (bias2 read from device memory), S 1, 3,
    4, 17 and 128 (runs of #7 and chunks of #10, partial last ones), D 32
    (64-byte swizzle) and 64, every bias set. Then two launches
    bit-identical; the sequence split against none (#7 bit-identical, its
    runs change no arithmetic; #10 within f32 rounding, its chunks add in
    another order); a bias1 that starts 2 bytes past a 4-byte boundary;
    peak memory with #10's scratch; and planted faults aimed at the
    design, which the checks must catch."""

    @pytest.mark.parametrize("D", [32, 64])
    @pytest.mark.parametrize("N", [1, 37, 48, 63, 64, 65, 129, 200, 256, 384])
    def test_kernels_match_plain(self, rng, cuda_device, N, D):
        for S in (1, 3, 4, 17, 128):
            for which in ("both", "mask", "pair", "none"):
                q, k, v, do, b1, b2 = _evo_case(rng, cuda_device, S, N, 2, D, which)
                _evo_check(q, k, v, do, b1, b2, f"N={N} D={D} S={S} {which}")

    @pytest.mark.parametrize("D", [32, 64])
    @pytest.mark.parametrize("N", [520, 999])
    def test_past_the_band(self, rng, cuda_device, N, D):
        """N above 512: no band fits beside the ring, bias2 comes from
        device memory in the fragment layout (odd N: element loads)."""
        q, k, v, do, b1, b2 = _evo_case(rng, cuda_device, 3, N, 1, D, "both")
        _evo_check(q, k, v, do, b1, b2, f"N={N} D={D}")

    def test_bias1_off_a_word_boundary(self, rng, cuda_device):
        for N in (37, 200):
            q, k, v, do, b1, b2 = _evo_case(rng, cuda_device, 5, N, 2, 32, "both")
            b1 = b1 + _bf16_cuda(rng.standard_normal(b1.shape), cuda_device)  # distinct per key
            flat = torch.empty(b1.numel() + 1, dtype=torch.bfloat16, device=cuda_device)
            flat[1:] = b1.reshape(-1)
            shifted = flat[1:].view(b1.shape)
            assert shifted.data_ptr() % 4 == 2
            _evo_check(q, k, v, do, shifted, b2, f"N={N} bias1 at 2 mod 4")

    @pytest.mark.parametrize("B,S,N,H,D", [(1, 128, 256, 8, 32), (1, 17, 200, 2, 64),
                                           (2, 9, 37, 3, 32)])
    def test_two_launches_bit_identical(self, rng, cuda_device, B, S, N, H, D):
        q, k, v, do, b1, b2 = _evo_case(rng, cuda_device, S, N, H, D, "both", B=B)
        first = PEV.evoformer_fwd(q, k, v, b1, b2)
        second = PEV.evoformer_fwd(q, k, v, b1, b2)
        delta = PEV._delta(first[0], do)
        args = (q, k, v, b1, b2, do, first[1], delta)
        d1, d2 = PEV.evoformer_bwd_db2(*args), PEV.evoformer_bwd_db2(*args)
        b1_, b2_ = _evo_bwd(args), _evo_bwd(args)
        torch.cuda.synchronize()
        assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])
        assert torch.equal(d1, d2)
        for t in EVO_BWD:
            assert torch.equal(b1_[t], b2_[t]), t

    def test_split_and_unsplit_agree(self, rng, cuda_device):
        """Batch row 0 alone (B = 1: its grid leaves SMs idle, so #7 walks
        runs of sequences and #10 sums chunks) and inside a batch of at
        least four waves of CTAs (no split). #7: bit-identical (every
        sequence takes the same arithmetic in any run). #10: within f32
        rounding (the chunks' partial sums add in another order): under
        the tolerance, and equal bits in all but a few elements."""
        S, N, H, D = 17, 200, 2, 32
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        for which in ("fwd", "db2"):
            B = -(-PEV.SPLIT_WAVES * sms // _evo_units(1, N, H, which))
            plan = PEV.fwd_run_plan if which == "fwd" else (
                lambda *a: PEV.db2_split_plan(*a[:4], D, a[4]))
            assert plan(1, S, N, H, sms).n > 1 and plan(B, S, N, H, sms).n == 1
            q, k, v, do, b1, b2 = _evo_case(rng, cuda_device, S, N, H, D, "both", B=B)
            one = lambda t: t[:1].contiguous()
            o, lse = PEV.evoformer_fwd(q, k, v, b1, b2)
            o1, lse1 = PEV.evoformer_fwd(one(q), one(k), one(v), one(b1), one(b2))
            if which == "fwd":
                torch.cuda.synchronize()
                assert torch.equal(o1, o[:1]) and torch.equal(lse1, lse[: S * H])
                continue
            delta = PEV._delta(o, do)
            whole = PEV.evoformer_bwd_db2(q, k, v, b1, b2, do, lse, delta)[:1]
            split = PEV.evoformer_bwd_db2(one(q), one(k), one(v), one(b1), one(b2), one(do),
                                          lse[: S * H].contiguous(), delta[: S * H].contiguous())
            torch.cuda.synchronize()
            _assert_grad_close(split, whole, "db2 split vs unsplit")
            assert (split != whole).float().mean().item() < 0.01

    def test_peak_memory_with_the_scratch(self, rng, cuda_device):
        """E1's shape: #10's scratch (2 chunks of [B H, N, N] f32 on an
        H100's 132 SMs) is allocated within the call and counted, and a
        forward and backward through the Function stays under one f32
        [G, N, N] logits tensor."""
        B, S, N, H, D = 1, 128, 256, 8, 32
        q, k, v, do, b1, b2 = _evo_case(rng, cuda_device, S, N, H, D, "both", B=B)
        o, lse = PEV.evoformer_fwd(q, k, v, b1, b2)
        delta = PEV._delta(o, do)
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        plan = PEV.db2_split_plan(B, S, N, H, D, sms)
        logits = 4 * B * S * H * N * N
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        PEV.evoformer_bwd_db2(q, k, v, b1, b2, do, lse, delta)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - before
        assert plan.scratch_bytes + b2.numel() * 2 <= peak < logits
        leaves = [t.clone().requires_grad_() for t in (q, k, v, b1, b2)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        out = PE.ds4sci_evoformer_attention(*leaves[:3], leaves[3:])
        torch.autograd.grad(out, leaves, do)
        torch.cuda.synchronize()
        assert torch.cuda.max_memory_allocated() - before < logits

    @pytest.mark.parametrize("D", [32, 64])
    def test_design_faults_are_caught(self, rng, cuda_device, D):
        """Each fault, made by running the kernel on altered inputs, must
        fail its check against the plain version on the true ones: a K/V
        ring tile consumed before its barrier (key tile 1 holding tile 0's
        rows), the bias2 band of the wrong head or of the other 128-row
        query tile, bias1 staged one key off (its word parity wrong), and
        one chunk of #10's split left out of the combining pass."""
        S, N, H = 17, 256, 2
        bn = 128 if D == 32 else 64  # #7's key tile
        q, k, v, do, b1, b2 = _evo_case(rng, cuda_device, S, N, H, D, "both")
        b1 = b1 + _bf16_cuda(rng.standard_normal(b1.shape), cuda_device)
        ro, rlse = PEV.evoformer_fwd_plain(q, k, v, b1, b2)
        stale = lambda x: torch.cat([x[:, :, :bn], x[:, :, :bn], x[:, :, 2 * bn:]], 2)
        o_faults = {
            "stale_ring_tile": PEV.evoformer_fwd(q, stale(k), stale(v), b1, b2)[0],
            "band_of_the_wrong_head": PEV.evoformer_fwd(q, k, v, b1, b2.roll(1, 2))[0],
            "band_of_the_other_query_tile": PEV.evoformer_fwd(q, k, v, b1, b2.roll(128, 3))[0],
            "bias1_one_key_off": PEV.evoformer_fwd(q, k, v, b1.roll(1, -1), b2)[0]}
        for fault, o in o_faults.items():
            assert PEV.bwd_mismatch(o, ro)["n_over"] > 0, fault
        o, lse = PEV.evoformer_fwd(q, k, v, b1, b2)
        delta = PEV._delta(o, do)
        ref = PEV._bwd_plain(q, k, v, b1, b2, lse, delta, do)[4]
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        plan = PEV.db2_split_plan(1, S, N, H, D, sms)
        assert plan.n > 1
        first, end = plan.runs[1]
        keep = torch.tensor([s for s in range(S) if not first <= s < end], device=q.device)
        pick = lambda t: t.index_select(1, keep).contiguous()
        rows = lambda x: x.reshape(S, H, N).index_select(0, keep).reshape(-1, N).contiguous()
        left_out = PEV.evoformer_bwd_db2(pick(q), pick(k), pick(v), pick(b1), b2, pick(do),
                                         rows(lse), rows(delta))
        assert PEV.bwd_mismatch(left_out, ref)["n_over"] > 0

    @pytest.mark.parametrize("D", [32, 64])
    @pytest.mark.parametrize("N", [1, 37, 48, 63, 64, 65, 127, 128, 129, 200, 256, 384])
    def test_backward_matches_plain(self, rng, cuda_device, N, D):
        """#8 and #9 (dq; dk, dv and the dS row sums) in their wgmma/TMA
        design: N at the edges of the 64- and 128-row tiles and odd (the
        bands' element loads, bias1 words of either parity), S 1, 3 and 17
        (17 walks several runs at two heads), every bias set; the run count
        forced to 1 and to S gives the plan's bits."""
        for S in (1, 3, 17):
            for which in ("both", "mask", "pair", "none"):
                q, k, v, do, b1, b2 = _evo_case(rng, cuda_device, S, N, 2, D, which)
                _evo_bwd_check(q, k, v, do, b1, b2, f"N={N} D={D} S={S} {which}")

    @pytest.mark.parametrize("D", [32, 64])
    @pytest.mark.parametrize("N", [520, 999])
    def test_backward_past_the_band(self, rng, cuda_device, N, D):
        """N past the bands' limits: #8 reads bias2 from device memory at
        both (its 128 x N band does not fit beside its rings), #9 at 999 and
        at D 64 (its N x 128 band still fits at 520 and D 32)."""
        q, k, v, do, b1, b2 = _evo_case(rng, cuda_device, 3, N, 1, D, "both")
        _evo_bwd_check(q, k, v, do, b1, b2, f"N={N} D={D}")

    @pytest.mark.parametrize("D", [32, 64])
    def test_backward_design_faults_are_caught(self, rng, cuda_device, D):
        """Each fault, made by running #8 or #9 on altered inputs or by
        altering its output, must fail its check against the plain backward
        on the true inputs: a K/V ring tile of #8 consumed before its barrier
        (key tile 1 holding tile 0's rows), a Q/dO ring tile of #9 (query
        tile 1 holding tile 0's), the band of the wrong head or of the other
        128-row tile (#8: query rows; #9: keys), bias1 one key off, and a
        sequence's dq, dk and dv with the previous sequence of its run left
        in the accumulators."""
        S, N, H = 17, 256, 2
        bn = 128 if D == 32 else 64  # #8's key tile
        q, k, v, do, b1, b2 = _evo_case(rng, cuda_device, S, N, H, D, "both")
        b1 = b1 + _bf16_cuda(rng.standard_normal(b1.shape), cuda_device)
        got, ref = _evo_bwd_check(q, k, v, do, b1, b2, f"D={D}")
        o, lse = PEV.evoformer_fwd(q, k, v, b1, b2)
        bwd = dict(q=q, k=k, v=v, b1=b1, b2=b2, do=do, lse=lse, delta=PEV._delta(o, do))
        on = lambda **alt: tuple({**bwd, **alt}.values())
        stale = lambda x, tile: torch.cat([x[:, :, :tile], x[:, :, :tile], x[:, :, 2 * tile:]], 2)
        faults = {
            "dq_stale_ring_tile": ("dq", PEV.evoformer_bwd_dq(*on(k=stale(k, bn), v=stale(v, bn)))),
            "dq_band_of_the_wrong_head": ("dq", PEV.evoformer_bwd_dq(*on(b2=b2.roll(1, 2)))),
            "dq_band_of_the_other_query_tile": ("dq",
                                                PEV.evoformer_bwd_dq(*on(b2=b2.roll(128, 3)))),
            "dq_bias1_one_key_off": ("dq", PEV.evoformer_bwd_dq(*on(b1=b1.roll(1, -1)))),
            "dkv_stale_ring_tile": ("dk", PEV.evoformer_bwd_dkv(
                *on(q=stale(q, 64), do=stale(do, 64)))[0]),
            "dkv_band_of_the_wrong_head": ("dk", PEV.evoformer_bwd_dkv(*on(b2=b2.roll(1, 2)))[0]),
            "dkv_band_of_the_other_key_tile": ("dk",
                                               PEV.evoformer_bwd_dkv(*on(b2=b2.roll(128, 4)))[0]),
            "dkv_bias1_one_key_off": ("dk", PEV.evoformer_bwd_dkv(*on(b1=b1.roll(1, -1)))[0])}
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        plan = PEV.bwd_run_plan(1, S, N, H, D, sms)
        assert plan.n > 1
        for t in ("dq", "dk", "dv"):
            left = got[t].float()
            for first, end in plan.runs:
                left[:, first + 1:end] += got[t][:, first:end - 1].float()
            faults[f"{t}_previous_sequence_left"] = (t, left.to(got[t].dtype))
        for fault, (t, out) in faults.items():
            assert PEV.bwd_mismatch(out, ref[t])["n_over"] > 0, fault

    @pytest.mark.parametrize("shape", sorted(EVO_FWD_DIGESTS))
    def test_forward_bits_unchanged_by_the_header_move(self, cuda_device, shape):
        """#7's o and lse on fixed inputs are the bits the kernel gave before
        its band helpers moved to csrc/evoformer_band.cuh."""
        S, N, H, D = shape
        q, k, v, _, b1, b2 = _evo_case(np.random.default_rng(0), cuda_device, S, N, H, D, "both")
        o, lse = PEV.evoformer_fwd(q, k, v, b1, b2)
        torch.cuda.synchronize()
        assert _evo_fwd_digest(o, lse) == EVO_FWD_DIGESTS[shape]


def _window_decode_case(rng, dev, H, KV, D, quant, bs=16, NB=8, nblk=56):
    """Paged decode rows on the card around windows of 40 and 57: ctx 5
    (before both), 40 (at the first), 41 (one past it), 100 (window starts
    mid-block: 60 and 43), 128 (the whole table) and a pad row (ctx 0)."""
    S = 6
    q = _bf16_cuda(rng.standard_normal((S, H, D)), dev)
    if quant:
        pools = _int8_pools(rng, dev, nblk, bs, KV, D)
    else:
        pools = tuple(_bf16_cuda(a, dev) for a in _arena(rng, nblk, bs, KV, D))
    tbl = rng.permutation(nblk - 1)[: S * NB].reshape(S, NB).astype(np.int32)
    tbl[-1] = nblk - 1
    ctx = np.array([5, 40, 41, 100, 128, 0], np.int32)
    return q, pools, torch.from_numpy(tbl).to(dev), torch.from_numpy(ctx).to(dev)


def _window_decode(mode, q, pools, tbl, ctx, window, kn=None, vn=None, slots=None,
                   alibi=None, allowed=None):
    """(kernel output, plain output) of one decode mode ("plain", "fused",
    "int8", "fused_int8") at `window` (and with ALiBi slopes `alibi`, the
    layout bitmap `allowed`), each on its own copy of the pools; the fused
    modes also check the written pools bit for bit."""
    got, ref = [p.clone() for p in pools], [p.clone() for p in pools]
    scales = lambda ps: ps[2:]
    kw = dict(window=window, alibi_slopes=alibi, allowed_slots=allowed)
    if mode in ("plain", "int8"):
        kern = PP.paged_decode_attention_int8 if mode == "int8" else PP.paged_decode_attention
        out = kern(q, got[0], got[1], tbl, ctx, *scales(got), **kw)
        want = PP.paged_decode_attention_plain(q, ref[0], ref[1], tbl, ctx, *scales(ref), **kw)
    else:
        kern = PP.paged_decode_fused_int8 if mode == "fused_int8" else PP.paged_decode_fused
        out = kern(q, got[0], got[1], tbl, ctx, kn, vn, slots, *scales(got), **kw)[0]
        want = PP.paged_decode_fused_plain(q, ref[0], ref[1], tbl, ctx, kn, vn, slots,
                                           *scales(ref), **kw)[0]
        torch.cuda.synchronize()
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
    torch.cuda.synchronize()
    return out, want


def _n_over(got, ref, atol, rtol):
    return int(((got.float() - ref.float()).abs() > atol + rtol * ref.float().abs()).sum())


@pytest.mark.cuda
class TestWindowOnCard:
    """The sliding-window modes of kernels #1-#5 against their plain
    versions on the same bf16 inputs: decode at the tolerance of the causal
    mode above; flash o, dq, dk, dv under `bwd_mismatch` (a limit scaled to
    each output row, since a wide window averages many V rows into values
    far below 2e-2); window >= S (or >= ctx) bit-identical to window 0 for
    the same kernel; and planted faults that the checks must catch: a band
    one column wider than asked (the kernel run at window + 1), a decode
    that starts at column 0 (the kernel run without its window), and two
    faults of the forward's output alone (lse untouched): one K/V tile's
    PV term dropped, and the PV sum scaled by 1.02."""

    DECODE_TOL = dict(rtol=8e-3, atol=1e-3)
    MODES = ["plain", "fused", "int8", "fused_int8"]

    def _flash_inputs(self, rng, d, S, KV, D, B=2, H=4):
        q = _bf16_cuda(rng.standard_normal((B, S, H, D)), d)
        k = _bf16_cuda(rng.standard_normal((B, S, KV, D)), d)
        v = _bf16_cuda(rng.standard_normal((B, S, KV, D)), d)
        do = _bf16_cuda(rng.standard_normal((B, S, H, D)), d)
        return q, k, v, do

    @pytest.mark.parametrize("window", [1, 5, 63, 64, 65, 100, 129, 1000])
    @pytest.mark.parametrize("S,KV,D", [(300, 2, 128), (200, 1, 64)])
    def test_flash_forward(self, rng, cuda_device, S, KV, D, window):
        q, k, v, _ = self._flash_inputs(rng, cuda_device, S, KV, D)
        o, lse = PF.flash_fwd(q, k, v, window)
        ro, rlse = PF.flash_attention_plain(q, k, v, window)
        _assert_grad_close(o, ro, f"o S={S} KV={KV} D={D} window={window}")
        torch.testing.assert_close(lse, rlse, rtol=1e-3, atol=1e-3)

    @pytest.mark.parametrize("window", [2, 5, 63, 64, 100, 1000])
    @pytest.mark.parametrize("S,KV,D", [(300, 2, 128), (200, 1, 64)])
    def test_flash_backward(self, rng, cuda_device, S, KV, D, window):
        q, k, v, do = self._flash_inputs(rng, cuda_device, S, KV, D)
        o, lse = PF.flash_fwd(q, k, v, window)
        delta = PF._delta(o, do)
        got = (PF.flash_bwd_dq(q, k, v, do, lse, delta, window),) + PF.flash_bwd_dkv(
            q, k, v, do, lse, delta, window)
        ref = PF.flash_attention_bwd_plain(q, k, v, o, lse, do, window)
        torch.cuda.synchronize()
        for name, g, r in zip(("dq", "dk", "dv"), got, ref):
            _assert_grad_close(g, r, f"{name} S={S} KV={KV} D={D} window={window}")

    def test_flash_window_one(self, rng, cuda_device):
        """Window 1: each row attends to itself alone, so o = v of its KV
        head, dv sums dO over the group, and dq, dk are zero up to rounding
        (P = 1 makes dP - delta the difference of two f32 sums of one
        product): held below 2^-10 of dv's RMS."""
        q, k, v, do = self._flash_inputs(rng, cuda_device, 200, 2, 128)
        o, lse = PF.flash_fwd(q, k, v, 1)
        torch.testing.assert_close(o, v.repeat_interleave(2, dim=2), rtol=0, atol=0)
        delta = PF._delta(o, do)
        dq = PF.flash_bwd_dq(q, k, v, do, lse, delta, 1)
        dk, dv = PF.flash_bwd_dkv(q, k, v, do, lse, delta, 1)
        _assert_grad_close(dv, PF.flash_attention_bwd_plain(q, k, v, o, lse, do, 1)[2], "dv")
        for name, g in (("dq", dq), ("dk", dk)):
            assert g.float().abs().max().item() <= 2.0 ** -10 * _rms(dv), name

    def test_flash_window_at_least_s_is_causal_bit_for_bit(self, rng, cuda_device):
        q, k, v, do = self._flash_inputs(rng, cuda_device, 300, 2, 128)
        o0, lse0 = PF.flash_fwd(q, k, v)
        delta = PF._delta(o0, do)
        ref = (PF.flash_bwd_dq(q, k, v, do, lse0, delta),) + PF.flash_bwd_dkv(
            q, k, v, do, lse0, delta)
        for window in (300, 301, 10 ** 6):
            o, lse = PF.flash_fwd(q, k, v, window)
            got = (PF.flash_bwd_dq(q, k, v, do, lse0, delta, window),) + PF.flash_bwd_dkv(
                q, k, v, do, lse0, delta, window)
            torch.cuda.synchronize()
            assert torch.equal(o, o0) and torch.equal(lse, lse0), window
            for g, r in zip(got, ref):
                assert torch.equal(g, r), window

    def test_flash_one_wider_band_is_caught(self, rng, cuda_device):
        """The planted fault: the kernels at window 2 where window 1 was
        asked fail the checks above (o against the plain forward; dq
        against zero; dv against the plain backward)."""
        q, k, v, do = self._flash_inputs(rng, cuda_device, 200, 2, 128)
        o, lse = PF.flash_fwd(q, k, v, 2)
        ro, rlse = PF.flash_attention_plain(q, k, v, 1)
        assert PF.bwd_mismatch(o, ro)["n_over"] > 0
        delta = PF._delta(o, do)
        dq = PF.flash_bwd_dq(q, k, v, do, lse, delta, 2)
        dv = PF.flash_bwd_dkv(q, k, v, do, lse, delta, 2)[1]
        ref_dv = PF.flash_attention_bwd_plain(q, k, v, ro, rlse, do, 1)[2]
        assert dq.float().abs().max().item() > 2.0 ** -10 * _rms(ref_dv)
        assert PF.bwd_mismatch(dv, ref_dv)["n_over"] > 0

    def test_flash_output_faults_are_caught(self, rng, cuda_device):
        """At window 100 over S=300, the forward with one 64-row K/V tile's
        PV term dropped (its V rows zeroed: lse unchanged), and the forward
        with its PV sum scaled by 1.02, both fail the o check above."""
        q, k, v, _ = self._flash_inputs(rng, cuda_device, 300, 2, 128)
        ro, rlse = PF.flash_attention_plain(q, k, v, 100)
        dropped = v.clone()
        dropped[:, 128:192] = 0
        o, lse = PF.flash_fwd(q, k, dropped, 100)
        torch.testing.assert_close(lse, rlse, rtol=1e-3, atol=1e-3)
        assert PF.bwd_mismatch(o, ro)["n_over"] > 0
        o = PF.flash_fwd(q, k, v, 100)[0]
        assert PF.bwd_mismatch((o.float() * 1.02).to(o.dtype), ro)["n_over"] > 0

    def _decode_args(self, rng, d, mode, H=32, KV=8, D=128):
        q, pools, tbl, ctx = _window_decode_case(rng, d, H, KV, D, "int8" in mode)
        S, bs = q.shape[0], pools[0].shape[1]
        pos = (ctx - 1).clamp(min=0)
        slots = torch.where(ctx > 0, tbl[torch.arange(S, device=d), pos // bs] * bs + pos % bs,
                            -1).to(torch.int32)
        kn = _bf16_cuda(rng.standard_normal((S, KV, D)), d)
        vn = _bf16_cuda(rng.standard_normal((S, KV, D)), d)
        return q, pools, tbl, ctx, kn, vn, slots

    @pytest.mark.parametrize("window", [1, 40, 57])
    @pytest.mark.parametrize("mode", MODES)
    @pytest.mark.parametrize("H,D", [(32, 128), (8, 64)])
    def test_decode(self, rng, cuda_device, mode, window, H, D):
        q, pools, tbl, ctx, kn, vn, slots = self._decode_args(rng, cuda_device, mode, H, 8, D)
        out, ref = _window_decode(mode, q, pools, tbl, ctx, window, kn, vn, slots)
        torch.testing.assert_close(out.float(), ref.float(), **self.DECODE_TOL)
        assert not out[-1].any()  # the pad row

    @pytest.mark.parametrize("mode", MODES)
    def test_decode_window_at_least_ctx_is_causal_bit_for_bit(self, rng, cuda_device, mode):
        args = self._decode_args(rng, cuda_device, mode)
        base, _ = _window_decode(mode, *args[:4], 0, *args[4:])
        for window in (128, 129, 10 ** 6):
            out, _ = _window_decode(mode, *args[:4], window, *args[4:])
            assert torch.equal(out, base), window

    @pytest.mark.parametrize("mode", MODES)
    def test_decode_planted_faults_are_caught(self, rng, cuda_device, mode):
        """Window 1 run as 2 (one column wider), and window 40 run as 0 (the
        column loop started at 0): both fail the decode tolerance on the
        rows past the window."""
        args = self._decode_args(rng, cuda_device, mode)
        for asked, run in ((1, 2), (40, 0)):
            out, _ = _window_decode(mode, *args[:4], run, *args[4:])
            _, ref = _window_decode(mode, *args[:4], asked, *args[4:])
            assert _n_over(out, ref, 1e-3, 8e-3) > 0, (asked, run)

    def test_window_launches_are_counted(self, rng, cuda_device):
        PK.reset_launch_counts()
        q, k, v, do = self._flash_inputs(rng, cuda_device, 128, 2, 128)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        torch.autograd.grad(PF.flash_attention(*leaves, window=16)[0], leaves, do)
        PF.flash_fwd(q, k, v)
        counts, windowed = PK.launch_counts(), PK.mode_launch_counts("window")
        assert counts["flash_fwd"] == 2 and windowed["flash_fwd[window]"] == 1
        assert counts["flash_bwd_dq"] == windowed["flash_bwd_dq[window]"] == 1
        assert counts["flash_bwd_dkv"] == windowed["flash_bwd_dkv[window]"] == 1
        assert windowed["paged_decode_fused[window]"] == 0


def _slopes(H, dev, scale=1.0):
    from deepspeed_tpu_torch.ops.attention import alibi_slopes

    return (alibi_slopes(H) * scale).to(dev)


@pytest.mark.cuda
class TestAlibiOnCard:
    """The ALiBi modes of kernels #1, #4 and #5 against their plain versions
    on the same bf16 inputs, at the tolerances of the modes above (flash o
    under `bwd_mismatch`, lse 1e-3; decode one bf16 ulp); all-zero slopes
    and windows >= S (or ctx) bit-identical to the existing modes; and
    planted faults the checks must catch: the slopes rotated by one head,
    the flash bias with its sign flipped, with GQA each q head given its
    KV head's slope, and the fused decode's new column biased at position
    0 instead of ctx - 1."""

    DECODE_TOL = dict(rtol=8e-3, atol=1e-3)
    MODES = ["plain", "fused", "int8", "fused_int8"]

    def _flash_inputs(self, rng, d, S, H, KV, D, B=1):
        return (_bf16_cuda(rng.standard_normal((B, S, H, D)), d),
                _bf16_cuda(rng.standard_normal((B, S, KV, D)), d),
                _bf16_cuda(rng.standard_normal((B, S, KV, D)), d))

    @pytest.mark.parametrize("window", [0, 100])
    @pytest.mark.parametrize("S,H,KV,D,scale", [(512, 32, 32, 128, 1.0), (300, 32, 32, 64, 0.125),
                                                (300, 8, 2, 128, 1.0), (200, 6, 3, 64, 1.0)])
    def test_flash_forward(self, rng, cuda_device, S, H, KV, D, scale, window):
        q, k, v = self._flash_inputs(rng, cuda_device, S, H, KV, D)
        sl = _slopes(H, cuda_device, scale)
        o, lse = PF.flash_fwd(q, k, v, window, sl)
        ro, rlse = PF.flash_attention_plain(q, k, v, window, sl)
        _assert_grad_close(o, ro, f"o S={S} H={H} KV={KV} D={D} window={window}")
        torch.testing.assert_close(lse, rlse, rtol=1e-3, atol=1e-3)

    def test_flash_off_and_wide_window_are_bit_identical(self, rng, cuda_device):
        q, k, v = self._flash_inputs(rng, cuda_device, 300, 8, 2, 128)
        sl = _slopes(8, cuda_device)
        base = PF.flash_fwd(q, k, v)
        zero = PF.flash_fwd(q, k, v, 0, torch.zeros_like(sl))
        alibi = PF.flash_fwd(q, k, v, 0, sl)
        for window in (300, 10 ** 6):
            wide = PF.flash_fwd(q, k, v, window, sl)
            assert all(torch.equal(a, b) for a, b in zip(wide, alibi)), window
        assert all(torch.equal(a, b) for a, b in zip(zero, base))

    def test_flash_planted_faults_are_caught(self, rng, cuda_device):
        H, KV = 8, 2
        q, k, v = self._flash_inputs(rng, cuda_device, 300, H, KV, 128)
        sl = _slopes(H, cuda_device)
        ro, _ = PF.flash_attention_plain(q, k, v, 0, sl)
        kv_slope = sl[torch.arange(H, device=cuda_device) // (H // KV) * (H // KV)]
        for fault in (torch.roll(sl, 1), -sl, kv_slope):
            o = PF.flash_fwd(q, k, v, 0, fault)[0]
            assert PF.bwd_mismatch(o, ro)["n_over"] > 0

    def _decode_args(self, rng, d, mode, H=32, KV=32, D=128):
        q, pools, tbl, ctx = _window_decode_case(rng, d, H, KV, D, "int8" in mode)
        S, bs = q.shape[0], pools[0].shape[1]
        pos = (ctx - 1).clamp(min=0)
        slots = torch.where(ctx > 0, tbl[torch.arange(S, device=d), pos // bs] * bs + pos % bs,
                            -1).to(torch.int32)
        kn = _bf16_cuda(rng.standard_normal((S, KV, D)), d)
        vn = _bf16_cuda(rng.standard_normal((S, KV, D)), d)
        return q, pools, tbl, ctx, kn, vn, slots

    @pytest.mark.parametrize("window", [0, 40])
    @pytest.mark.parametrize("mode", MODES)
    @pytest.mark.parametrize("H,KV,D", [(32, 32, 128), (8, 2, 64)])
    def test_decode(self, rng, cuda_device, mode, window, H, KV, D):
        q, pools, tbl, ctx, kn, vn, slots = self._decode_args(rng, cuda_device, mode, H, KV, D)
        out, ref = _window_decode(mode, q, pools, tbl, ctx, window, kn, vn, slots,
                                  alibi=_slopes(H, cuda_device))
        torch.testing.assert_close(out.float(), ref.float(), **self.DECODE_TOL)
        assert not out[-1].any()  # the pad row

    @pytest.mark.parametrize("mode", MODES)
    def test_decode_off_and_wide_window_are_bit_identical(self, rng, cuda_device, mode):
        args = self._decode_args(rng, cuda_device, mode)
        sl = _slopes(32, cuda_device)
        base, _ = _window_decode(mode, *args[:4], 0, *args[4:])
        zero, _ = _window_decode(mode, *args[:4], 0, *args[4:], alibi=torch.zeros_like(sl))
        assert torch.equal(zero, base)
        alibi, _ = _window_decode(mode, *args[:4], 0, *args[4:], alibi=sl)
        for window in (128, 10 ** 6):
            out, _ = _window_decode(mode, *args[:4], window, *args[4:], alibi=sl)
            assert torch.equal(out, alibi), window

    @pytest.mark.parametrize("mode", MODES)
    def test_decode_planted_faults_are_caught(self, rng, cuda_device, mode):
        """The slopes rotated by one head; in the fused modes, the new
        column biased at position 0 (_new_col_at_zero)."""
        q, pools, tbl, ctx, kn, vn, slots = self._decode_args(rng, cuda_device, mode)
        sl = _slopes(32, cuda_device)
        _, ref = _window_decode(mode, q, pools, tbl, ctx, 0, kn, vn, slots, alibi=sl)
        out, _ = _window_decode(mode, q, pools, tbl, ctx, 0, kn, vn, slots,
                                alibi=torch.roll(sl, 1))
        assert _n_over(out, ref, 1e-3, 8e-3) > 0
        if "fused" in mode:
            got = _new_col_at_zero(mode, q, pools, tbl, ctx, kn, vn, slots, sl)
            assert _n_over(got, ref, 1e-3, 8e-3) > 0

    def test_alibi_launches_are_counted(self, rng, cuda_device):
        PK.reset_launch_counts()
        q, k, v = self._flash_inputs(rng, cuda_device, 128, 4, 2, 128)
        PF.flash_attention(q, k, v, alibi=_slopes(4, cuda_device))
        PF.flash_fwd(q, k, v, 16)
        args = self._decode_args(rng, cuda_device, "plain")
        _window_decode("plain", *args[:4], 0, *args[4:], alibi=_slopes(32, cuda_device))
        counts, alibi = PK.launch_counts(), PK.mode_launch_counts("alibi")
        assert counts["flash_fwd"] == 2 and alibi["flash_fwd[alibi]"] == 1
        assert counts["paged_decode_attention"] == alibi["paged_decode_attention[alibi]"] == 1
        assert alibi["paged_decode_fused[alibi]"] == 0
        assert PK.mode_launch_counts("window")["flash_fwd[window]"] == 1


@pytest.mark.cuda
class TestAlibiBackwardOnCard:
    """The ALiBi modes of kernels #2 (dq) and #3 (dk, dv) against the plain
    backward on the forward kernel's o and lse, on the same bf16 inputs,
    under `bwd_mismatch`; all-zero slopes bit-identical to the backward
    without ALiBi and windows >= S to the causal ALiBi backward (on the
    same lse and delta); planted faults in the backward alone (the
    forward's lse kept) caught: the slopes rotated by one head, the bias's
    sign flipped, the bias dropped, and with GQA each q head given the
    slope of its KV head's index (dk, dv); the [alibi] launch counters;
    and the Function's gradients."""

    def _case(self, rng, d, B, S, H, KV, D, window=0, scale=1.0):
        q, k, v, do = (_bf16_cuda(rng.standard_normal(s), d)
                       for s in ((B, S, H, D), (B, S, KV, D), (B, S, KV, D), (B, S, H, D)))
        sl = _slopes(H, d, scale)
        o, lse = PF.flash_fwd(q, k, v, window, sl)
        return q, k, v, do, sl, o, lse, PF._delta(o, do)

    @staticmethod
    def _bwd(q, k, v, do, lse, delta, window, sl):
        return (PF.flash_bwd_dq(q, k, v, do, lse, delta, window, sl),) + \
            PF.flash_bwd_dkv(q, k, v, do, lse, delta, window, sl)

    @pytest.mark.parametrize("window", [0, 100])
    @pytest.mark.parametrize("S,H,KV,D,scale", [(2048, 32, 32, 128, 1.0), (300, 32, 32, 64, 0.125),
                                                (300, 8, 2, 128, 1.0), (200, 6, 3, 64, 1.0)])
    def test_kernels_match_plain(self, rng, cuda_device, S, H, KV, D, scale, window):
        q, k, v, do, sl, o, lse, delta = self._case(rng, cuda_device, 1 if S > 1000 else 2, S,
                                                    H, KV, D, window, scale)
        got = self._bwd(q, k, v, do, lse, delta, window, sl)
        ref = PF.flash_attention_bwd_plain(q, k, v, o, lse, do, window, sl)
        torch.cuda.synchronize()
        for name, g, r in zip(("dq", "dk", "dv"), got, ref):
            _assert_grad_close(g, r, f"{name} S={S} H={H} KV={KV} D={D} window={window}")

    @pytest.mark.parametrize("D", [64, 128])
    def test_off_and_wide_window_are_bit_identical(self, rng, cuda_device, D):
        q, k, v, do, sl, o, lse, delta = self._case(rng, cuda_device, 2, 300, 8, 2, D)
        base = self._bwd(q, k, v, do, lse, delta, 0, None)
        zero = self._bwd(q, k, v, do, lse, delta, 0, torch.zeros_like(sl))
        alibi = self._bwd(q, k, v, do, lse, delta, 0, sl)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(zero, base))
        for window in (300, 10 ** 6):
            wide = self._bwd(q, k, v, do, lse, delta, window, sl)
            assert all(torch.equal(a, b) for a, b in zip(wide, alibi)), window

    def test_planted_faults_are_caught(self, rng, cuda_device):
        H, KV = 8, 2
        q, k, v, do, sl, o, lse, delta = self._case(rng, cuda_device, 2, 300, H, KV, 128)
        ref = PF.flash_attention_bwd_plain(q, k, v, o, lse, do, 0, sl)
        kv_index = sl[torch.arange(H, device=cuda_device) // (H // KV)]
        for fault, hit in ((torch.roll(sl, 1), 3), (-sl, 3), (None, 3), (kv_index, 2)):
            got = self._bwd(q, k, v, do, lse, delta, 0, fault)
            for g, r in list(zip(got, ref))[3 - hit:]:  # kv_index: dk and dv
                assert PF.bwd_mismatch(g, r)["n_over"] > 0

    def test_alibi_launches_are_counted(self, rng, cuda_device):
        q, k, v, do, sl, o, lse, delta = self._case(rng, cuda_device, 1, 128, 4, 2, 128)
        PK.reset_launch_counts()
        self._bwd(q, k, v, do, lse, delta, 0, sl)
        self._bwd(q, k, v, do, lse, delta, 16, None)
        counts, alibi = PK.launch_counts(), PK.mode_launch_counts("alibi")
        assert counts["flash_bwd_dq"] == counts["flash_bwd_dkv"] == 2
        assert alibi["flash_bwd_dq[alibi]"] == alibi["flash_bwd_dkv[alibi]"] == 1
        assert PK.mode_launch_counts("window")["flash_bwd_dkv[window]"] == 1

    @pytest.mark.parametrize("window", [0, 40])
    def test_function_grads_match_plain_backward(self, rng, cuda_device, window):
        """flash_attention's gradients with slopes are the kernels' on the
        forward kernel's residuals, under `bwd_mismatch`, and the gradient
        of ALiBi attention: against autograd through the dense plain
        forward in f32 within 2^-7 of the gradient's RMS (as the causal
        Function test above)."""
        q, k, v, do, sl, o, lse, delta = self._case(rng, cuda_device, 2, 300, 8, 2, 128, window)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        PK.reset_launch_counts()
        got = torch.autograd.grad(PF.flash_attention(*leaves, window=window, alibi=sl)[0],
                                  leaves, do)
        assert PK.mode_launch_counts("alibi")["flash_bwd_dkv[alibi]"] == 1
        same = PF.flash_attention_bwd_plain(q, k, v, o, lse, do, window, sl)
        leaves = [t.float().clone().requires_grad_() for t in (q, k, v)]
        dense = torch.autograd.grad(PF.flash_attention_plain(*leaves, window, sl)[0], leaves,
                                    do.float())
        for name, g, r, d in zip(("dq", "dk", "dv"), got, same, dense):
            _assert_grad_close(g, r, name)
            assert _rms(g.float() - d) <= 2.0 ** -7 * _rms(d), name

    def test_wrappers_reject_bad_slopes(self, rng, cuda_device):
        q, k, v, do, sl, o, lse, delta = self._case(rng, cuda_device, 1, 64, 4, 2, 128)
        with pytest.raises(ValueError):
            PF.flash_bwd_dq(q, k, v, do, lse, delta, 0, sl[:2].contiguous())
        with pytest.raises(TypeError):
            PF.flash_bwd_dkv(q, k, v, do, lse, delta, 0, sl.double())
        with pytest.raises(ValueError):
            PF.flash_bwd_dkv(q, k, v, do, lse, delta, 0, sl.cpu())


def _new_col_at_zero(mode, q, pools, tbl, ctx, kn, vn, slots, slopes):
    """What a fused kernel that biased its new column at position 0 (not
    ctx - 1) would output: the plain fused version's written pools,
    attended densely in f32 with that one bias moved."""
    got = [p.clone() for p in pools]
    PP.paged_decode_fused_plain(q, got[0], got[1], tbl, ctx, kn, vn, slots, *got[2:],
                                alibi_slopes=slopes)
    S, H, D = q.shape
    KV = got[0].shape[2]
    t = tbl.long()
    k, v = (x[t].reshape(S, -1, KV, D) for x in got[:2])
    if mode == "fused_int8":
        k = PP.dequantize(k, got[2][t].reshape(S, -1, KV), q.dtype)
        v = PP.dequantize(v, got[3][t].reshape(S, -1, KV), q.dtype)
    k, v = (x.float().repeat_interleave(H // KV, 2) for x in (k, v))
    pos = torch.arange(k.shape[1], device=q.device)
    bias = (slopes[None, :, None] * pos.float()).expand(S, H, -1).clone()
    live = ctx > 0
    bias[torch.arange(S, device=q.device)[live], :, (ctx[live] - 1).long()] = 0.0
    logits = torch.einsum("shd,skhd->shk", q.float(), k) / D ** 0.5 + bias
    logits = logits.masked_fill(~(pos[None, :] < ctx[:, None])[:, None, :], float("-inf"))
    out = torch.einsum("shk,skhd->shd", torch.nan_to_num(logits.softmax(-1)), v)
    return out.to(q.dtype)


def _sparse_decode_case(rng, dev, mode, bs, H=8, KV=2, D=128):
    """Decode rows on the card for the layout bitmap: at bs 128, ctx 5, 300
    (mid-block), 700, 1024 (the whole table) and a pad row; at bs 16 (a
    64-column tile spans four cache blocks) ctx 5, 100, 333, 640 and a pad
    row. Bitmaps: each row's fixed layout row (local 2, global 1, block =
    bs) and a random one that keeps the row's own block; the pad row's are
    all ones."""
    from deepspeed_tpu_torch.ops.sparse_attention import SparsityConfig

    S, NB = 5, 8 if bs == 128 else 40
    nblk = S * NB + 1
    q = _bf16_cuda(rng.standard_normal((S, H, D)), dev)
    if "int8" in mode:
        pools = _int8_pools(rng, dev, nblk, bs, KV, D)
    else:
        pools = tuple(_bf16_cuda(a, dev) for a in _arena(rng, nblk, bs, KV, D))
    tbl = rng.permutation(nblk - 1)[: S * NB].reshape(S, NB).astype(np.int32)
    tbl[-1] = nblk - 1
    ctx = np.array([5, 300, 700, 1024, 0] if bs == 128 else [5, 100, 333, 640, 0], np.int32)
    pos = np.maximum(ctx - 1, 0)
    lay = SparsityConfig(block=bs, num_local_blocks=2, num_global_blocks=1).layout(NB * bs)
    fixed = lay[pos // bs].astype(np.int32)
    rand = rng.integers(0, 2, (S, NB)).astype(np.int32)
    rand[np.arange(S), pos // bs] = 1
    fixed[-1] = rand[-1] = 1
    slots = np.where(ctx > 0, tbl[np.arange(S), pos // bs] * bs + pos % bs, -1)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    kn = _bf16_cuda(rng.standard_normal((S, KV, D)), dev)
    vn = _bf16_cuda(rng.standard_normal((S, KV, D)), dev)
    return (q, pools, t(tbl), t(ctx), kn, vn, t(slots.astype(np.int32)),
            {"fixed": t(fixed), "random": t(rand)})


@pytest.mark.cuda
class TestSparseOnCard:
    """The layout-bitmap mode of kernels #4 and #5 (all four decode modes)
    against the plain versions on the same bf16 inputs, at bs 128 (a tile
    inside one block) and bs 16 (a tile across four blocks), at the decode
    tolerance; an all-ones bitmap bit-identical to none, also with a window
    and with ALiBi; NaN in every disallowed block leaving the output
    bit-identical (no byte of one is read); and a bitmap shifted by one
    block, which the check must catch."""

    DECODE_TOL = dict(rtol=8e-3, atol=1e-3)
    MODES = ["plain", "fused", "int8", "fused_int8"]

    @pytest.mark.parametrize("bitmap", ["fixed", "random"])
    @pytest.mark.parametrize("bs", [128, 16])
    @pytest.mark.parametrize("mode", MODES)
    def test_decode(self, rng, cuda_device, mode, bs, bitmap):
        q, pools, tbl, ctx, kn, vn, slots, bitmaps = _sparse_decode_case(rng, cuda_device,
                                                                        mode, bs)
        out, ref = _window_decode(mode, q, pools, tbl, ctx, 0, kn, vn, slots,
                                  allowed=bitmaps[bitmap])
        torch.testing.assert_close(out.float(), ref.float(), **self.DECODE_TOL)
        assert not out[-1].any()  # the pad row
        dense, _ = _window_decode(mode, q, pools, tbl, ctx, 0, kn, vn, slots)
        assert _n_over(out, dense, 1e-3, 8e-3) > 0  # the bitmap bites

    @pytest.mark.parametrize("bs", [128, 16])
    @pytest.mark.parametrize("mode", MODES)
    def test_all_ones_is_bit_identical_to_none(self, rng, cuda_device, mode, bs):
        q, pools, tbl, ctx, kn, vn, slots, _ = _sparse_decode_case(rng, cuda_device, mode, bs)
        ones = torch.ones(tbl.shape, dtype=torch.int32, device=cuda_device)
        for kw in ({}, {"alibi": _slopes(8, cuda_device)}):
            for window in (0, 200):
                base, _ = _window_decode(mode, q, pools, tbl, ctx, window, kn, vn, slots, **kw)
                got, _ = _window_decode(mode, q, pools, tbl, ctx, window, kn, vn, slots,
                                        allowed=ones, **kw)
                assert torch.equal(got, base), (kw, window)

    @pytest.mark.parametrize("bs", [128, 16])
    @pytest.mark.parametrize("mode", MODES)
    def test_disallowed_blocks_are_never_read(self, rng, cuda_device, mode, bs):
        """NaN in every K/V row (on int8 pools: every scale) of each row's
        disallowed blocks: the kernel's output stays bit-identical."""
        q, pools, tbl, ctx, kn, vn, slots, bitmaps = _sparse_decode_case(rng, cuda_device,
                                                                        mode, bs)
        allow = bitmaps["fixed"]
        clean, _ = _window_decode(mode, q, pools, tbl, ctx, 0, kn, vn, slots, allowed=allow)
        dead = tbl[allow == 0].long()
        poisoned = [p.clone() for p in pools]
        for p in (poisoned[2:] if "int8" in mode else poisoned):
            p[dead] = float("nan")
        kern = {"plain": PP.paged_decode_attention, "int8": PP.paged_decode_attention_int8,
                "fused": PP.paged_decode_fused, "fused_int8": PP.paged_decode_fused_int8}[mode]
        extra = (kn, vn, slots) if "fused" in mode else ()
        got = kern(q, poisoned[0], poisoned[1], tbl, ctx, *extra, *poisoned[2:],
                   allowed_slots=allow)
        got = got[0] if "fused" in mode else got
        torch.cuda.synchronize()
        assert dead.numel() > 0 and torch.isfinite(got.float()).all()
        assert torch.equal(got, clean)

    @pytest.mark.parametrize("bs", [128, 16])
    @pytest.mark.parametrize("mode", MODES)
    def test_shifted_bitmap_is_caught(self, rng, cuda_device, mode, bs):
        q, pools, tbl, ctx, kn, vn, slots, bitmaps = _sparse_decode_case(rng, cuda_device,
                                                                        mode, bs)
        allow = bitmaps["fixed"]
        _, ref = _window_decode(mode, q, pools, tbl, ctx, 0, kn, vn, slots, allowed=allow)
        out, _ = _window_decode(mode, q, pools, tbl, ctx, 0, kn, vn, slots,
                                allowed=torch.roll(allow, 1, dims=1))
        assert _n_over(out, ref, 1e-3, 8e-3) > 0

    def test_sparse_launches_are_counted(self, rng, cuda_device):
        PK.reset_launch_counts()
        q, pools, tbl, ctx, kn, vn, slots, bitmaps = _sparse_decode_case(rng, cuda_device,
                                                                        "plain", 128)
        _window_decode("plain", q, pools, tbl, ctx, 0, allowed=bitmaps["fixed"])
        _window_decode("fused", q, pools, tbl, ctx, 0, kn, vn, slots)
        counts, sparse = PK.launch_counts(), PK.mode_launch_counts("sparse")
        assert counts["paged_decode_attention"] == 1 and counts["paged_decode_fused"] == 1
        assert sparse["paged_decode_attention[sparse]"] == 1
        assert sparse["paged_decode_fused[sparse]"] == 0
        with pytest.raises(TypeError):
            PP.paged_decode_attention(q, *pools, tbl, ctx, allowed_slots=bitmaps["fixed"].bool())
        with pytest.raises(ValueError):
            PP.paged_decode_attention(q, *pools, tbl, ctx,
                                      allowed_slots=bitmaps["fixed"][:, :4].contiguous())


def _group_decode_case(rng, dev, mode, H, KV, D, bs=16):
    """The window cases' decode rows (_window_decode_case) with new K/V
    rows and their slots for the fused modes."""
    q, pools, tbl, ctx = _window_decode_case(rng, dev, H, KV, D, "int8" in mode, bs=bs)
    S = q.shape[0]
    pos = (ctx - 1).clamp(min=0).long()
    slots = torch.where(ctx > 0, tbl[torch.arange(S, device=dev), pos // bs] * bs + pos % bs,
                        -1).to(torch.int32)
    kn = _bf16_cuda(rng.standard_normal((S, KV, D)), dev)
    vn = _bf16_cuda(rng.standard_normal((S, KV, D)), dev)
    return q, pools, tbl, ctx, kn, vn, slots


def _chunk0_heads(q, KV):
    """Each query head of chunk c > 0 of every KV head's group given the
    query of head g % 8 of chunk 0: what a kernel whose chunks c > 0 read
    chunk 0's heads attends with."""
    S, H, D = q.shape
    G = H // KV
    idx = torch.arange(G, device=q.device) % 8
    return q.view(S, KV, G, D)[:, :, idx].reshape(S, H, D).contiguous()


@pytest.mark.cuda
class TestWideGroupAndHeadDim80OnCard:
    """The wide-group mode (more than 8 query heads per KV head: a grid
    axis over chunks of 8; Falcon-7B has 71 over one) and the head_dim-80
    mode (Phi-2: blocks of 96 threads, lanes past 80 idle, the quantizer
    padded with zeros) of kernels #1, #4, #5 and #6 against their plain
    versions on the same bf16 inputs, at the tolerances of the modes
    above (decode one bf16 ulp; flash o under bwd_mismatch, lse 1e-3;
    writes, codes and scales bit-exact), with the window and ALiBi
    composed; and the planted faults the checks must catch: chunks c > 0
    given chunk 0's query heads, the partial last chunk dropped, in the
    int8 fused mode chunks c > 0 attending the un-rounded new column, at
    head_dim 80 the output's columns 64-79 left zero and the scores taken
    over the first 64 dims."""

    DECODE_TOL = dict(rtol=8e-3, atol=1e-3)
    MODES = ["plain", "fused", "int8", "fused_int8"]
    SHAPES = {"falcon_71_over_1": (71, 1, 64), "mqa_12_over_1_d80": (12, 1, 80),
              "gqa_16_over_2": (32, 2, 128), "phi_mha_d80": (8, 8, 80),
              "gqa_20_over_2_d80": (40, 2, 80)}

    @pytest.mark.parametrize("shape", sorted(SHAPES))
    @pytest.mark.parametrize("mode", MODES)
    def test_decode(self, rng, cuda_device, mode, shape):
        H, KV, D = self.SHAPES[shape]
        args = _group_decode_case(rng, cuda_device, mode, H, KV, D)
        q, pools, tbl, ctx, kn, vn, slots = args
        for window, alibi in ((0, None), (57, None), (0, _slopes(H, cuda_device))):
            out, ref = _window_decode(mode, q, pools, tbl, ctx, window, kn, vn, slots,
                                      alibi=alibi)
            torch.testing.assert_close(out.float(), ref.float(), **self.DECODE_TOL)
            assert not out[-1].any()  # the pad row

    @pytest.mark.parametrize("shape", ["falcon_71_over_1", "gqa_16_over_2"])
    @pytest.mark.parametrize("mode", MODES)
    def test_chunk_given_chunk_0_heads_is_caught(self, rng, cuda_device, mode, shape):
        H, KV, D = self.SHAPES[shape]
        q, pools, tbl, ctx, kn, vn, slots = _group_decode_case(rng, cuda_device, mode, H, KV, D)
        _, ref = _window_decode(mode, q, pools, tbl, ctx, 0, kn, vn, slots)
        bad, _ = _window_decode(mode, _chunk0_heads(q, KV), pools, tbl, ctx, 0, kn, vn, slots)
        assert _n_over(bad, ref, 1e-3, 8e-3) > 0

    @pytest.mark.parametrize("mode", MODES)
    def test_dropped_last_chunk_is_caught(self, rng, cuda_device, mode):
        H, KV, D = self.SHAPES["falcon_71_over_1"]
        q, pools, tbl, ctx, kn, vn, slots = _group_decode_case(rng, cuda_device, mode, H, KV, D)
        out, ref = _window_decode(mode, q, pools, tbl, ctx, 0, kn, vn, slots)
        out[:, 64:] = 0
        assert _n_over(out, ref, 1e-3, 8e-3) > 0

    @pytest.mark.parametrize("shape", ["falcon_71_over_1", "gqa_16_over_2",
                                       "gqa_20_over_2_d80"])
    def test_int8_fused_unrounded_new_column_is_caught(self, rng, cuda_device, shape):
        """Queries 4 x the new key make the new column dominate each
        softmax: the kernel still passes there, while an output whose
        chunks c > 0 attended the raw bf16 new row (not its dequantized
        codes) does not."""
        H, KV, D = self.SHAPES[shape]
        G = H // KV
        q, pools, tbl, ctx, kn, vn, slots = _group_decode_case(rng, cuda_device, "fused_int8",
                                                               H, KV, D)
        q = (4.0 * kn.float()).repeat_interleave(G, dim=1).to(torch.bfloat16).contiguous()
        written = [p.clone() for p in pools]
        out = PP.paged_decode_fused_int8(q, written[0], written[1], tbl, ctx, kn, vn, slots,
                                         *written[2:])[0]
        _, ref = _window_decode("fused_int8", q, pools, tbl, ctx, 0, kn, vn, slots)
        torch.testing.assert_close(out.float(), ref.float(), **self.DECODE_TOL)
        k = PP.dequantize(written[0], written[2], torch.bfloat16)
        v = PP.dequantize(written[1], written[3], torch.bfloat16)
        live = slots >= 0
        k.view(-1, KV, D)[slots[live].long()] = kn[live]
        v.view(-1, KV, D)[slots[live].long()] = vn[live]
        raw = PP.paged_decode_attention_plain(q, k, v, tbl, ctx)
        fault = out.clone()
        S = q.shape[0]
        fault.view(S, KV, G, D)[:, :, 8:] = raw.view(S, KV, G, D)[:, :, 8:]
        assert _n_over(fault, ref, 1e-3, 8e-3) > 0

    @pytest.mark.parametrize("mode", MODES)
    def test_d80_faults_are_caught(self, rng, cuda_device, mode):
        H, KV, D = self.SHAPES["phi_mha_d80"]
        q, pools, tbl, ctx, kn, vn, slots = _group_decode_case(rng, cuda_device, mode, H, KV, D)
        out, ref = _window_decode(mode, q, pools, tbl, ctx, 0, kn, vn, slots)
        zeroed = out.clone()
        zeroed[..., 64:] = 0
        assert _n_over(zeroed, ref, 1e-3, 8e-3) > 0
        q64 = q.clone()
        q64[..., 64:] = 0
        first64, _ = _window_decode(mode, q64, pools, tbl, ctx, 0, kn, vn, slots)
        assert _n_over(first64, ref, 1e-3, 8e-3) > 0

    @pytest.mark.parametrize("S,H,KV,D", [(77, 4, 4, 80), (300, 8, 2, 80), (200, 71, 1, 64),
                                          (130, 20, 1, 80)])
    def test_flash(self, rng, cuda_device, S, H, KV, D):
        d = cuda_device
        q = _bf16_cuda(rng.standard_normal((2, S, H, D)), d)
        k = _bf16_cuda(rng.standard_normal((2, S, KV, D)), d)
        v = _bf16_cuda(rng.standard_normal((2, S, KV, D)), d)
        for window, alibi in ((0, None), (50, None), (0, _slopes(H, d))):
            o, lse = PF.flash_fwd(q, k, v, window, alibi)
            ro, rlse = PF.flash_attention_plain(q, k, v, window, alibi)
            torch.cuda.synchronize()
            assert PF.bwd_mismatch(o, ro)["n_over"] == 0
            torch.testing.assert_close(lse, rlse, rtol=1e-3, atol=1e-3)
        if D == 80:
            o, _ = PF.flash_fwd(q, k, v)
            ro, _ = PF.flash_attention_plain(q, k, v)
            zeroed = o.clone()
            zeroed[..., 64:] = 0
            q64 = q.clone()
            q64[..., 64:] = 0
            assert PF.bwd_mismatch(zeroed, ro)["n_over"] > 0
            assert PF.bwd_mismatch(PF.flash_fwd(q64, k, v)[0], ro)["n_over"] > 0

    @pytest.mark.parametrize("KV", [32, 1])
    def test_kv_writes_d80_bit_exact(self, rng, cuda_device, KV):
        d, D, T = cuda_device, 80, 40
        slots = rng.permutation(11 * 16)[:T].astype(np.int32)
        slots[5::7] = -1
        slots[3] = 12 * 16 + 5  # past the arena: clamped into block 11
        s = torch.from_numpy(slots).to(d)
        kn = _bf16_cuda(_int8_rows(rng, T, KV, D), d)
        vn = _bf16_cuda(_int8_rows(rng, T, KV, D)[::-1].copy(), d)
        arena = [_bf16_cuda(a, d) for a in _arena(rng, 12, 16, KV, D)]
        ref = [a.clone() for a in arena]
        PP.paged_kv_write(*arena, kn, vn, s)
        PP.paged_kv_write_plain(*ref, kn, vn, s)
        pools = _int8_pools(rng, d, 12, 16, KV, D)
        ref8 = [p.clone() for p in pools]
        PP.paged_kv_write_int8(*pools, kn, vn, s)
        PP.paged_kv_write_quant_plain(*ref8, kn, vn, s)
        torch.cuda.synchronize()
        for got, want in zip(arena + list(pools), ref + ref8):
            assert torch.equal(got, want)

    def test_flash_backward_raises_before_launch_at_d80(self, rng, cuda_device):
        """(Named when the backward kernels lacked head_dim 80.) A forward
        whose inputs need a gradient at head_dim 80 launches, and its
        backward launches both backward kernels in their head_dim-80 mode,
        never the plain version: the gradients equal the wrappers' own on
        the forward's residuals, and match the plain backward."""
        q, k, v, do = (_bf16_cuda(rng.standard_normal(s), cuda_device)
                       for s in ((1, 64, 4, 80), (1, 64, 4, 80), (1, 64, 4, 80), (1, 64, 4, 80)))
        PK.reset_launch_counts()
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        o, lse = PF.flash_attention(*leaves)
        got = torch.autograd.grad(o, leaves, do)
        counts = PK.all_launch_counts()
        for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            assert counts[name] == counts[f"{name}[d80]"] == 1, counts
        delta = PF._delta(o.detach(), do)
        same = (PF.flash_bwd_dq(q, k, v, do, lse, delta),) + PF.flash_bwd_dkv(q, k, v, do, lse,
                                                                                delta)
        ref = PF.flash_attention_bwd_plain(q, k, v, o.detach(), lse, do)
        for name, g, s_, r in zip(("dq", "dk", "dv"), got, same, ref):
            assert torch.equal(g, s_), name
            _assert_grad_close(g, r, name)

    def test_new_mode_launches_are_counted(self, rng, cuda_device):
        PK.reset_launch_counts()
        for shape in ("falcon_71_over_1", "phi_mha_d80", "gqa_16_over_2"):
            H, KV, D = self.SHAPES[shape]
            q, pools, tbl, ctx, kn, vn, slots = _group_decode_case(rng, cuda_device, "fused",
                                                                   H, KV, D)
            PP.paged_decode_fused(q, *[p.clone() for p in pools], tbl, ctx, kn, vn, slots)
        counts = PK.all_launch_counts()
        assert counts["paged_decode_fused"] == 3
        assert counts["paged_decode_fused[wide_group]"] == 2
        assert counts["paged_decode_fused[d80]"] == 1


def _drop_last_chunk(q, do, lse, delta, KV):
    """q, dO, lse and delta of each group's query heads without the
    group's last chunk of 8 (at 71 over 1: the first 64 heads)."""
    H = q.shape[2]
    G = H // KV
    keep = torch.arange(H, device=q.device).view(KV, G)[:, :8 * ((G - 1) // 8)].flatten()
    return (q.index_select(2, keep).contiguous(), do.index_select(2, keep).contiguous(),
            lse.index_select(1, keep).contiguous(), delta.index_select(1, keep).contiguous())


@pytest.mark.cuda
class TestFlashBackwardWideGroupAndHeadDim80OnCard:
    """Kernels #2 (dq) and #3 (dk, dv) in their head_dim-80 mode (Phi-2)
    and their wide-group mode (more than 8 query heads per KV head:
    Falcon-7B's 71 over one; dkv's block walks the whole group) against the
    plain backward on the forward kernel's o and lse, under `bwd_mismatch`,
    with the window and ALiBi composed; the planted faults the check must
    catch (at head_dim 80 the gradients' columns 64-79 zeroed and the
    scores taken over the first 64 dims; in a wide group dk and dv summed
    without the group's last chunk of 8 heads, and each q head given KV
    head (h // 8) % KV); and the autograd Function at 80 and at 71 over 1."""

    SHAPES = {"phi_mha_d80": (32, 32, 80), "gqa_20_over_2_d80": (40, 2, 80),
              "falcon_71_over_1": (71, 1, 64), "gqa_16_over_2": (32, 2, 64),
              "gqa_12_over_1_d128": (12, 1, 128)}

    @staticmethod
    def _bwd(q, k, v, do, lse, delta, window=0, alibi=None):
        return (PF.flash_bwd_dq(q, k, v, do, lse, delta, window, alibi),) + \
            PF.flash_bwd_dkv(q, k, v, do, lse, delta, window, alibi)

    @pytest.mark.parametrize("S", [77, 300])
    @pytest.mark.parametrize("shape", sorted(SHAPES))
    def test_kernels_match_plain(self, rng, cuda_device, shape, S):
        H, KV, D = self.SHAPES[shape]
        q, k, v, _, _, do = _bwd_case(rng, cuda_device, 2, S, H, KV, D)
        for window, alibi in ((0, None), (50, None), (0, _slopes(H, cuda_device))):
            o, lse = PF.flash_fwd(q, k, v, window, alibi)
            delta = PF._delta(o, do)
            PK.reset_launch_counts()
            got = self._bwd(q, k, v, do, lse, delta, window, alibi)
            counts = PK.all_launch_counts()
            for name in ("flash_bwd_dq", "flash_bwd_dkv"):
                assert counts[f"{name}[d80]"] == int(D == 80)
                assert counts[f"{name}[wide_group]"] == int(H // KV > 8)
            ref = PF.flash_attention_bwd_plain(q, k, v, o, lse, do, window, alibi)
            for name, g, r in zip(("dq", "dk", "dv"), got, ref):
                _assert_grad_close(g, r, f"{shape} window {window} alibi {alibi is not None} "
                                         f"{name}")

    @pytest.mark.parametrize("shape", ["phi_mha_d80", "gqa_20_over_2_d80"])
    def test_d80_faults_are_caught(self, rng, cuda_device, shape):
        H, KV, D = self.SHAPES[shape]
        q, k, v, o, lse, do = _bwd_case(rng, cuda_device, 1, 200, H, KV, D)
        delta = PF._delta(o, do)
        ref = PF.flash_attention_bwd_plain(q, k, v, o, lse, do)
        got = self._bwd(q, k, v, do, lse, delta)
        q64 = q.clone()
        q64[..., 64:] = 0
        first64 = self._bwd(q64, k, v, do, lse, delta)
        for name, g, f, r in zip(("dq", "dk", "dv"), got, first64, ref):
            zeroed = g.clone()
            zeroed[..., 64:] = 0
            assert PF.bwd_mismatch(zeroed, r)["n_over"] > 0, name
            assert PF.bwd_mismatch(f, r)["n_over"] > 0, name

    @pytest.mark.parametrize("shape", ["falcon_71_over_1", "gqa_16_over_2", "gqa_20_over_2_d80"])
    def test_last_chunk_dropped_is_caught(self, rng, cuda_device, shape):
        H, KV, D = self.SHAPES[shape]
        q, k, v, o, lse, do = _bwd_case(rng, cuda_device, 1, 200, H, KV, D)
        delta = PF._delta(o, do)
        ref = PF.flash_attention_bwd_plain(q, k, v, o, lse, do)
        q_, do_, lse_, delta_ = _drop_last_chunk(q, do, lse, delta, KV)
        dk, dv = PF.flash_bwd_dkv(q_, k, v, do_, lse_, delta_)
        assert PF.bwd_mismatch(dk, ref[1])["n_over"] > 0
        assert PF.bwd_mismatch(dv, ref[2])["n_over"] > 0

    def test_group_capped_at_8_is_caught(self, rng, cuda_device):
        H, KV, D = self.SHAPES["gqa_16_over_2"]
        B, S = 1, 200
        q, k, v, o, lse, do = _bwd_case(rng, cuda_device, B, S, H, KV, D)
        delta = PF._delta(o, do)
        ref = PF.flash_attention_bwd_plain(q, k, v, o, lse, do)
        idx = torch.arange(H // 8, device=cuda_device) % KV
        dq, dk8, dv8 = self._bwd(q, k[:, :, idx].contiguous(), v[:, :, idx].contiguous(), do,
                                 lse, delta)
        fold = lambda t: t.float().view(B, S, H // 8 // KV, KV, D).sum(2).to(t.dtype)
        for name, g, r in zip(("dq", "dk", "dv"), (dq, fold(dk8), fold(dv8)), ref):
            assert PF.bwd_mismatch(g, r)["n_over"] > 0, name

    @pytest.mark.parametrize("shape", ["phi_mha_d80", "falcon_71_over_1"])
    def test_function_grads_match_autograd_through_plain(self, rng, cuda_device, shape):
        """As TestFlashBackwardOnCard's Function test: the Function's
        gradients are the kernels' on the forward kernel's residuals (under
        `bwd_mismatch`), every launch in the shape's mode, and against
        autograd through the dense plain forward in f32 the error's RMS
        stays within 2^-7 of the gradient's."""
        H, KV, D = self.SHAPES[shape]
        q, k, v, o, lse, do = _bwd_case(rng, cuda_device, 2, 300, H, KV, D)
        mode = "d80" if D == 80 else "wide_group"
        PK.reset_launch_counts()
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        got = torch.autograd.grad(PF.flash_attention(*leaves)[0], leaves, do)
        counts = PK.all_launch_counts()
        for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            assert counts[name] == counts[f"{name}[{mode}]"] == 1, counts
        same = PF.flash_attention_bwd_plain(q, k, v, o, lse, do)
        leaves = [t.float().clone().requires_grad_() for t in (q, k, v)]
        dense = torch.autograd.grad(PF.flash_attention_plain(*leaves)[0], leaves, do.float())
        for name, g, r, d in zip(("dq", "dk", "dv"), got, same, dense):
            _assert_grad_close(g, r, name)
            assert _rms(g.float() - d) <= 2.0 ** -7 * _rms(d), name


def _dkv_batches(S, KV, H):
    """Batch sizes that put kernel #3 in each of its launch forms: B = 1
    (one consumer warpgroup of 64 keys, or with a group of several heads
    the group split) and the least B at which B * KV * ceil(S / 128) CTAs
    of 128 keys fill the card (no split); and kernel #2 likewise in both
    CTA heights (_flash_batches)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sorted({1, -(-sms // (KV * -(-S // 128))), *_flash_batches(S, H)})


def _plain_bwd_rows(q, k, v, o, lse, do, window=0, alibi=None):
    """The plain backward one batch row at a time (the rows are
    independent; one [1, H, S, S] f32 tensor at a time)."""
    rows = [PF.flash_attention_bwd_plain(*(t[b:b + 1] for t in (q, k, v, o, lse, do)), window,
                                         alibi) for b in range(q.shape[0])]
    return tuple(torch.cat(parts) for parts in zip(*rows))


def _bwd_diag_tile_unmasked(q, k, v, lse, delta, do, tile=64):
    """What kernels #2 and #3 would output if they took their diagonal
    tile x tile tiles unmasked: the plain backward's math with each row
    also seeing the later keys of its own diagonal tile (P and dS rounded
    to bf16 as the kernels round them)."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    pos = torch.arange(S, device=q.device)
    seen = (pos[None, :] <= pos[:, None]) | (pos[None, :] // tile == pos[:, None] // tile)
    kf, vf = PF._repeat_kv(k, G).float(), PF._repeat_kv(v, G).float()
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) / D ** 0.5
    p = torch.exp(logits.masked_fill(~seen, float("-inf")) - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), vf)
    ds = p * (dp - delta[..., None]) / D ** 0.5
    p, ds = p.to(q.dtype).float(), ds.to(q.dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()).reshape(B, S, KV, G, D).sum(3)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.float()).reshape(B, S, KV, G, D).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _ring_stages(B, S, heads, split=False):
    """The ring depth of kernels #2 and #3: three stages with two
    warpgroups (where B * heads * ceil(S / 128) fills the card, and in
    dkv's group split), two with one."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return 3 if split or B * heads * -(-S // 128) >= sms else 2


def _stale_tile(x, dim, stages, tile=64):
    """x with rows [stages * tile, (stages + 1) * tile) of axis `dim` (the
    first tile a ring of `stages` stages loads into a used stage) holding
    tile 0's rows: what a kernel that read a ring stage before its full
    barrier landed would see."""
    y = x.clone()
    y.narrow(dim, stages * tile, tile).copy_(x.narrow(dim, 0, tile))
    return y


@pytest.mark.cuda
class TestFlashBackwardHopperOnCard:
    """Kernels #2 (dq) and #3 (dk, dv) in their wgmma/TMA design against
    the plain backward on the forward kernel's o and lse, under
    `bwd_mismatch`: sequence lengths at the edges of the 64- and 128-row
    tiles (a single row, the ragged last tile, rows past S as TMA's
    zeros), whole query groups of 1, 2, 8, 9, 16 and 71 over their KV
    heads (the group split on a grid that leaves SMs idle, its last chunk
    partial where the chunk size does not divide G), head dims 64, 80 and
    128; in each, every launch form (_dkv_batches), the causal band and
    windows 1, 2, S - 1, S and S + 5, each with and without ALiBi slopes
    (where every row sees one key, window 1 or S = 1, dq and dk are zero
    up to rounding and are held below 2^-10 of dv's RMS, as in
    TestWindowOnCard).
    Then two launches bit-identical, a split and an unsplit result of the
    same rows within the tolerance, and planted faults aimed at the
    design that the check must catch."""

    @staticmethod
    def _bwd(q, k, v, do, lse, delta, window=0, alibi=None):
        return (PF.flash_bwd_dq(q, k, v, do, lse, delta, window, alibi),) + \
            PF.flash_bwd_dkv(q, k, v, do, lse, delta, window, alibi)

    def _check(self, q, k, v, do, S, what):
        H = q.shape[2]
        for window in sorted({0, 1, 2, max(S - 1, 0), S, S + 5}):
            for alibi in (None, _slopes(H, q.device)):
                o, lse = PF.flash_fwd(q, k, v, window, alibi)
                delta = PF._delta(o, do)
                got = self._bwd(q, k, v, do, lse, delta, window, alibi)
                ref = _plain_bwd_rows(q, k, v, o, lse, do, window, alibi)
                for name, g, r in zip(("dq", "dk", "dv"), got, ref):
                    case = f"{name} {what} window={window} alibi={alibi is not None}"
                    if name != "dv" and (window == 1 or S == 1):
                        # every row sees one key: P = 1 and dq, dk are zero up to
                        # rounding (TestWindowOnCard.test_flash_window_one)
                        assert g.float().abs().max().item() <= 2.0 ** -10 * _rms(got[2]), case
                    else:
                        _assert_grad_close(g, r, case)

    @pytest.mark.parametrize("D", [64, 80, 128])
    @pytest.mark.parametrize("G", [1, 2, 8, 9, 16, 71])
    @pytest.mark.parametrize("S", [1, 63, 64, 65, 127, 129, 300])
    def test_kernels_match_plain(self, rng, cuda_device, S, G, D):
        KV = 1 if G == 71 else 2
        H = G * KV
        batches = _dkv_batches(S, KV, H)
        B = max(batches)
        q = _bf16_cuda(rng.standard_normal((B, S, H, D)), cuda_device)
        k = _bf16_cuda(rng.standard_normal((B, S, KV, D)), cuda_device)
        v = _bf16_cuda(rng.standard_normal((B, S, KV, D)), cuda_device)
        do = _bf16_cuda(rng.standard_normal((B, S, H, D)), cuda_device)
        for b in batches:
            self._check(q[:b], k[:b], v[:b], do[:b], S, f"B={b} S={S} H={H} KV={KV} D={D}")

    @pytest.mark.parametrize("D", [64, 80, 128])
    @pytest.mark.parametrize("H,KV", [(2, 2), (71, 1)])
    def test_kernels_match_plain_at_2048(self, rng, cuda_device, H, KV, D):
        S = 2048
        for b in (1, _dkv_batches(S, KV, H)[-1]):
            q = _bf16_cuda(rng.standard_normal((b, S, H, D)), cuda_device)
            k = _bf16_cuda(rng.standard_normal((b, S, KV, D)), cuda_device)
            v = _bf16_cuda(rng.standard_normal((b, S, KV, D)), cuda_device)
            do = _bf16_cuda(rng.standard_normal((b, S, H, D)), cuda_device)
            self._check(q, k, v, do, S, f"B={b} S={S} H={H} KV={KV} D={D}")

    @pytest.mark.parametrize("B,S,H,KV,D", [(8, 2048, 8, 8, 128), (4, 2048, 71, 1, 64),
                                            (2, 2048, 32, 32, 80), (1, 300, 16, 2, 128)])
    def test_two_launches_bit_identical(self, rng, cuda_device, B, S, H, KV, D):
        q, k, v, o, lse, do = _bwd_case(rng, cuda_device, B, S, H, KV, D)
        delta = PF._delta(o, do)
        for window, alibi in ((0, None), (129, _slopes(H, cuda_device))):
            first = self._bwd(q, k, v, do, lse, delta, window, alibi)
            second = self._bwd(q, k, v, do, lse, delta, window, alibi)
            torch.cuda.synchronize()
            assert all(torch.equal(a, b) for a, b in zip(first, second)), (window, alibi)

    def test_split_and_unsplit_agree(self, rng, cuda_device):
        """The same batch row through the group split (B = 1: 3 key blocks
        of one KV head leave SMs idle) and unsplit (within a batch that
        fills the card) agree within the tolerance."""
        S, H, KV, D = 300, 71, 1, 64
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        B = _dkv_batches(S, KV, H)[-1]
        assert PF.dkv_split_plan(1, S, H, KV, D, sms).n_chunks > 1
        assert PF.dkv_split_plan(B, S, H, KV, D, sms).n_chunks == 1
        q, k, v, o, lse, do = _bwd_case(rng, cuda_device, B, S, H, KV, D)
        delta = PF._delta(o, do)
        one = lambda t: t[:1].contiguous()
        split = PF.flash_bwd_dkv(one(q), one(k), one(v), one(do), one(lse), one(delta))
        whole = PF.flash_bwd_dkv(q, k, v, do, lse, delta)
        for name, s, w in zip(("dk", "dv"), split, whole):
            _assert_grad_close(s, w[:1], f"{name} split vs unsplit")

    @pytest.mark.parametrize("H,KV", [(8, 2), (71, 1)])
    def test_design_faults_are_caught(self, rng, cuda_device, H, KV):
        """A ring stage read before its barrier (dkv: Q/dO whose tile
        `stages` holds tile 0's rows; dq: K/V), and the diagonal tiles taken
        unmasked, each fail the check in every gradient it touches; at 71
        over 1, so does one chunk of the group split left out of the
        combining pass."""
        B, S, D = 1, 300, 64
        q, k, v, o, lse, do = _bwd_case(rng, cuda_device, B, S, H, KV, D)
        delta = PF._delta(o, do)
        ref = PF.flash_attention_bwd_plain(q, k, v, o, lse, do)
        plan = PF.dkv_split_plan(B, S, H, KV, D,
                                 torch.cuda.get_device_properties(0).multi_processor_count)
        n = _ring_stages(B, S, KV, plan.n_chunks > 1)
        m = _ring_stages(B, S, H)
        faults = {"dkv_stale_ring_stage": (("dk", "dv"), (None,) + PF.flash_bwd_dkv(
                      _stale_tile(q, 1, n), k, v, _stale_tile(do, 1, n), _stale_tile(lse, 2, n),
                      _stale_tile(delta, 2, n))),
                  "dq_stale_ring_stage": (("dq",), (PF.flash_bwd_dq(
                      q, _stale_tile(k, 1, m), _stale_tile(v, 1, m), do, lse, delta),)),
                  "diagonal_tile_unmasked": (("dq", "dk", "dv"), _bwd_diag_tile_unmasked(
                      q, k, v, lse, delta, do))}
        if KV == 1:
            assert plan.n_chunks > 1
            first, end = plan.chunks[1]
            keep = torch.tensor([h for h in range(H) if not first <= h < end], device=q.device)
            pick = lambda t, dim: t.index_select(dim, keep).contiguous()
            faults["chunk_left_out"] = (("dk", "dv"), (None,) + PF.flash_bwd_dkv(
                pick(q, 2), k, v, pick(do, 2), pick(lse, 1), pick(delta, 1)))
        for fault, (hit, grads) in faults.items():
            for i, name in enumerate(("dq", "dk", "dv")):
                if name in hit:
                    assert PF.bwd_mismatch(grads[i], ref[i])["n_over"] > 0, (fault, name)


def _split_case(rng, dev, mode, H, KV, D, bs, span=1024):
    """Seven decode rows over tables of `span` positions, around the split
    boundary of the plan at this shape (split_len L): ctx 1, L - 1, L,
    L + 1, L + 37 (a window of 100 then starts mid-block), the whole span,
    and a pad row (ctx 0, table on the scratch block). Returns (q, pools,
    tables, ctx, k_new, v_new, slots, plan)."""
    S, NB = 7, span // bs
    nblk = S * NB + 1
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = PP.decode_split_plan(S, KV, H // KV, D, span, sms)
    L = plan.split_len
    ctx_np = np.minimum(np.array([1, L - 1, L, L + 1, L + 37, span, 0]), span).astype(np.int32)
    tbl_np = rng.permutation(nblk - 1)[: S * NB].reshape(S, NB).astype(np.int32)
    tbl_np[-1] = nblk - 1
    if "int8" in mode:
        pools = _int8_pools(rng, dev, nblk, bs, KV, D)
    else:
        pools = tuple(_bf16_cuda(a, dev) for a in _arena(rng, nblk, bs, KV, D))
    q = _bf16_cuda(rng.standard_normal((S, H, D)), dev)
    tbl, ctx = torch.from_numpy(tbl_np).to(dev), torch.from_numpy(ctx_np).to(dev)
    pos = (ctx - 1).clamp(min=0).long()
    slots = torch.where(ctx > 0, tbl[torch.arange(S, device=dev), pos // bs] * bs + pos % bs,
                        -1).to(torch.int32)
    kn = _bf16_cuda(rng.standard_normal((S, KV, D)), dev)
    vn = _bf16_cuda(rng.standard_normal((S, KV, D)), dev)
    return q, pools, tbl, ctx, kn, vn, slots, plan


def _decode_kernel(mode, q, pools, tbl, ctx, kn, vn, slots, window=0, **opts):
    """One decode mode's kernel output on `pools` (written in place by the
    fused modes); `opts` are the wrapper's (alibi_slopes, allowed_slots)."""
    if mode in ("plain", "int8"):
        kern = PP.paged_decode_attention_int8 if mode == "int8" else PP.paged_decode_attention
        return kern(q, pools[0], pools[1], tbl, ctx, *pools[2:], window=window, **opts)
    kern = PP.paged_decode_fused_int8 if mode == "fused_int8" else PP.paged_decode_fused
    return kern(q, pools[0], pools[1], tbl, ctx, kn, vn, slots, *pools[2:], window=window,
                **opts)[0]


@functools.lru_cache(maxsize=None)
def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _dense_f32(q, pools, tbl, ctx, live, bias=None):
    """chip_smoke.py's dense f32 decode over written pools at the positions
    `live` [S, NB * bs] holds, each score plus `bias` when given."""
    return _chip_smoke()._dense_decode(PP, q, pools, tbl, ctx, live, bias)


@pytest.mark.cuda
class TestDecodeSplitOnCard:
    """Kernels #4/#5 in their split-K design (csrc/paged_decode.cu: a CTA
    per (row, KV head, split) holding the whole group, a cp.async ring,
    mma.sync, partials added in split order) against their plain versions
    at one bf16 ulp: groups of 1, 4, 8, 16, 71 and 130 at head dims 64, 80 and
    128 and cache blocks of 16, 32 and 128, rows at a split boundary and
    one position either side, at ctx 1, over the whole span, with a window
    starting mid-block, with ALiBi, and a pad row, in all four modes (the
    fused pools bit-exact); two launches bit-identical; a window past ctx,
    an all-ones bitmap and zero slopes bit-identical to none; the scratch
    within the plan's bytes; NaN in every dead pool row leaving the output
    bit-identical; and planted faults aimed at the design that the check
    must catch."""

    DECODE_TOL = dict(rtol=8e-3, atol=1e-3)
    MODES = ["plain", "fused", "int8", "fused_int8"]

    @pytest.mark.parametrize("bs", [16, 32, 128])
    @pytest.mark.parametrize("D", [64, 80, 128])
    @pytest.mark.parametrize("G", [1, 4, 8, 16, 71, 130])
    def test_modes_match_plain(self, rng, cuda_device, G, D, bs):
        KV = 1 if G > 16 else 2  # 130: two CTAs of the group (128 + 2 heads)
        H = G * KV
        for mode in self.MODES:
            q, pools, tbl, ctx, kn, vn, slots, plan = _split_case(rng, cuda_device, mode, H, KV,
                                                                  D, bs)
            assert plan.n > 1
            for window, alibi in ((0, None), (100, None), (0, _slopes(H, cuda_device))):
                out, ref = _window_decode(mode, q, pools, tbl, ctx, window, kn, vn, slots,
                                          alibi=alibi)
                torch.testing.assert_close(out.float(), ref.float(), **self.DECODE_TOL)
                assert not out[-1].any()  # the pad row

    @pytest.mark.parametrize("mode", MODES)
    @pytest.mark.parametrize("H,KV,D,window", [(71, 1, 64, 0), (32, 8, 128, 600)])
    def test_two_launches_bit_identical(self, rng, cuda_device, mode, H, KV, D, window):
        q, pools, tbl, ctx, kn, vn, slots, plan = _split_case(rng, cuda_device, mode, H, KV, D,
                                                              128, span=2048)
        assert plan.n > 1
        runs = [_decode_kernel(mode, q, [p.clone() for p in pools], tbl, ctx, kn, vn, slots,
                               window) for _ in range(2)]
        torch.cuda.synchronize()
        assert torch.equal(runs[0], runs[1])

    @pytest.mark.parametrize("mode", MODES)
    def test_neutral_options_bit_identical_to_none(self, rng, cuda_device, mode):
        """The split boundaries do not move with the window, the bitmap or
        the slopes: a window past every row's ctx, an all-ones bitmap and
        zero slopes give none's output bit for bit, on a split shape."""
        H, KV = 32, 8
        q, pools, tbl, ctx, kn, vn, slots, plan = _split_case(rng, cuda_device, mode, H, KV, 128,
                                                              32, span=2048)
        assert plan.n > 1
        run = lambda **opts: _decode_kernel(mode, q, [p.clone() for p in pools], tbl, ctx, kn, vn,
                                            slots, **opts)
        base = run()
        neutral = {"window_past_ctx": run(window=tbl.shape[1] * 32 + 1),
                   "all_ones_bitmap": run(allowed_slots=torch.ones_like(tbl)),
                   "zero_slopes": run(alibi_slopes=torch.zeros(H, device=cuda_device))}
        torch.cuda.synchronize()
        for name, out in neutral.items():
            assert torch.equal(out, base), name

    def test_scratch_within_the_plan(self, rng, cuda_device):
        """At Falcon-7B's phase-2 decode shape (8 rows, 71 heads over one KV
        head, 2048-position tables): 16 splits, ~2.4 MB of f32 partials and
        16 KB of arrival counters allocated by the first launch, nothing
        beside the output by the next."""
        S, H, KV, D, bs, NB = 8, 71, 1, 64, 128, 16
        sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
        plan = PP.decode_split_plan(S, KV, H, D, NB * bs, sms)
        assert plan.n > 1 and plan.scratch_bytes <= 2_500_000
        nblk = S * NB + 1
        pools = [_bf16_cuda(a, cuda_device) for a in _arena(rng, nblk, bs, KV, D)]
        tbl = torch.from_numpy(rng.permutation(nblk - 1)[: S * NB].reshape(S, NB)
                               .astype(np.int32)).to(cuda_device)
        ctx = torch.full((S,), NB * bs, dtype=torch.int32, device=cuda_device)
        q = _bf16_cuda(rng.standard_normal((S, H, D)), cuda_device)
        PP._WORKSPACE.clear()
        # the bytes the launches ask the allocator for: the bytes it hands
        # out can exceed them by up to 1 MB, where it does not split a free
        # block whose tail would be shorter (which blocks are free depends
        # on the tests before this one)
        requested = lambda: torch.cuda.memory_stats(cuda_device)["requested_bytes.all.current"]
        extras = []
        for _ in range(2):
            torch.cuda.synchronize()
            before = requested()
            torch.cuda.reset_peak_memory_stats(cuda_device)
            out = PP.paged_decode_attention(q, *pools, tbl, ctx)
            torch.cuda.synchronize()
            extras.append(torch.cuda.memory_stats(cuda_device)["requested_bytes.all.peak"]
                          - before)
        counters = 4 * 4096
        assert extras[0] <= plan.scratch_bytes + counters + out.numel() * 2 + 3 * 512, (extras,
                                                                                       plan)
        assert extras[1] <= out.numel() * 2 + 512, extras

    @pytest.mark.parametrize("mode", MODES)
    @pytest.mark.parametrize("window", [0, 300])
    def test_nan_in_dead_rows_leaves_the_output_bit_identical(self, rng, cuda_device, mode,
                                                              window):
        """NaN in every pool row no decode row may read (past its live
        length, left of its window, blocks of no table; on int8 pools the
        scales) changes no bit of the output."""
        q, pools, tbl, ctx, kn, vn, slots, plan = _split_case(rng, cuda_device, mode, 16, 2, 128,
                                                              16)
        S, NB = tbl.shape
        bs = pools[0].shape[1]
        pos = torch.arange(NB * bs, device=cuda_device)[None, :]
        live = (pos < ctx[:, None]) & ((pos >= ctx[:, None] - window) if window else True)
        dead = torch.ones(pools[0].shape[0] * bs, dtype=torch.bool, device=cuda_device)
        flat = (tbl.long()[:, :, None] * bs + torch.arange(bs, device=cuda_device)).reshape(S, -1)
        dead[flat[live]] = False
        clean = _decode_kernel(mode, q, [p.clone() for p in pools], tbl, ctx, kn, vn, slots,
                               window)
        dirty = [p.clone() for p in pools]
        for p in dirty:
            if p.is_floating_point():
                p.view(-1, *p.shape[2:])[dead] = float("nan")
        got = _decode_kernel(mode, q, dirty, tbl, ctx, kn, vn, slots, window)
        torch.cuda.synchronize()
        assert torch.isfinite(got.float()).all() and torch.equal(got, clean)

    @pytest.mark.parametrize("mode", MODES)
    def test_design_faults_are_caught(self, rng, cuda_device, mode):
        """Outputs the check against the plain version must fail: one split
        left out of the combine, each split's last cache position dropped,
        the fused new column attended by every split (its weight x n), and
        the kernel run on pools whose fourth tile of each split holds its
        first tile's rows (a ring stage consumed before its copies landed)."""
        H, KV, D, bs = 32, 8, 128, 16
        q, pools, tbl, ctx, kn, vn, slots, plan = _split_case(rng, cuda_device, mode, H, KV, D,
                                                              bs, span=2048)
        L, n = plan.split_len, plan.n
        assert n > 1 and L >= 4 * 64
        written = [p.clone() for p in pools]
        out = _decode_kernel(mode, q, written, tbl, ctx, kn, vn, slots)
        _, ref = _window_decode(mode, q, pools, tbl, ctx, 0, kn, vn, slots)
        torch.testing.assert_close(out.float(), ref.float(), **self.DECODE_TOL)
        S, NB = tbl.shape
        fused = "fused" in mode
        pos = torch.arange(NB * bs, device=cuda_device)[None, :]
        live = pos < ctx[:, None]
        assert _n_over(_dense_f32(q, written, tbl, ctx, live), ref, 1e-3, 8e-3) == 0
        limit = ctx.long() - int(fused)
        last = torch.zeros_like(live)
        for c in range(n):
            end = limit.clamp(max=(c + 1) * L) - 1
            ok = end >= c * L
            last[torch.arange(S, device=cuda_device)[ok], end[ok]] = True
        faults = {"split_left_out": _dense_f32(q, written, tbl, ctx,
                                               live & ((pos < L) | (pos >= 2 * L))),
                  "last_position_dropped": _dense_f32(q, written, tbl, ctx, live & ~last)}
        if fused:
            bias = torch.zeros(S, NB * bs, device=cuda_device)
            bias[torch.arange(S, device=cuda_device), (ctx - 1).clamp(min=0).long()] = \
                float(np.log(n))
            faults["new_column_in_every_split"] = _dense_f32(q, written, tbl, ctx, live, bias)
        stale = [p.clone() for p in pools]
        for s in range(S):  # each split's tile 3 <- its tile 0 (the ring has 3 stages)
            for sp0 in range(0, NB * bs, L):
                for r in range(64):
                    src, dst = sp0 + r, sp0 + 192 + r
                    if dst >= min(sp0 + L, int(limit[s])):
                        break
                    fs = int(tbl[s, src // bs]) * bs + src % bs
                    fd = int(tbl[s, dst // bs]) * bs + dst % bs
                    for p in stale:
                        p.view(-1, *p.shape[2:])[fd] = p.view(-1, *p.shape[2:])[fs]
        faults["stale_ring_stage"] = _decode_kernel(mode, q, stale, tbl, ctx, kn, vn, slots)
        for name, bad in faults.items():
            assert _n_over(bad, ref, 1e-3, 8e-3) > 0, name


@pytest.mark.cuda
class TestKvWriteTilesOnCard:
    """Kernel #6's int8 write in its tiled design (csrc/paged_kv_write.cu:
    tiles of head slices, 16-lane groups of vector chunks, the quantizer's
    short division route) against its plain version, bit for bit: at the
    four shapes chip_smoke.py times (KV_WRITE_CASES: rows of .5 ties,
    zeros, subnormals, NaN and inf) and on ragged writes, two launches
    bit-identical; #4's fused int8 write with
    NaN and inf in its new rows; the quantizer's two division routes on
    every (x, amax) pair; the planted faults of chip_smoke.py's
    kv_write_design_checks; no register spills."""

    @staticmethod
    def _randn(dev, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        return lambda *shape: torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    @pytest.mark.parametrize("case", ["flagship_wave", "phi_2_prefill", "mistral_prefill",
                                      "falcon_7b_prefill"])
    def test_bit_exact_at_the_chip_shapes(self, cuda_device, case):
        C = _chip_smoke()
        x = C._kv_write_fixture(PP, self._randn(cuda_device, 3), cuda_device,
                                C.KV_WRITE_CASES[case])
        runs = []
        for write in (PP.paged_kv_write_int8, PP.paged_kv_write_int8,
                      PP.paged_kv_write_quant_plain):
            pools = [p.clone() for p in x["pools"]]
            write(*pools, x["kn"], x["vn"], x["slots"])
            runs.append(pools)
        torch.cuda.synchronize()
        assert C._pools_off(runs[0], runs[2]) == 0
        assert C._pools_off(runs[0], runs[1]) == 0  # two launches
        assert torch.isinf(runs[0][2]).any()  # the inf rows reached the pools

    @pytest.mark.parametrize("KV,D", [(1, 64), (2, 80), (8, 128), (32, 80), (130, 64), (3, 128)])
    def test_ragged_writes_bit_exact(self, rng, cuda_device, KV, D):
        """T = 45 rows, scattered slots, dropped and past-arena rows, a NaN
        and an inf row, the last tile partial where 90 KV slices do not
        fill it; KV 130 spans several tiles a row."""
        d, T = cuda_device, 45
        slots = rng.permutation(11 * 16)[:T].astype(np.int32)
        slots[5::7] = -1
        slots[3] = 12 * 16 + 5
        s = torch.from_numpy(slots).to(d)
        rows = _int8_rows(rng, T, KV, D)
        rows[6, :, 3], rows[9, :, 1] = np.nan, np.inf
        kn, vn = _bf16_cuda(rows, d), _bf16_cuda(rows[::-1].copy(), d)
        pools = _int8_pools(rng, d, 12, 16, KV, D)
        ref = [p.clone() for p in pools]
        PP.paged_kv_write_int8(*pools, kn, vn, s)
        PP.paged_kv_write_quant_plain(*ref, kn, vn, s)
        torch.cuda.synchronize()
        assert _chip_smoke()._pools_off(pools, ref) == 0

    @pytest.mark.parametrize("H,KV,D", [(8, 8, 128), (32, 32, 80), (71, 1, 64)])
    def test_fused_int8_write_with_nonfinite_rows(self, cuda_device, H, KV, D):
        C = _chip_smoke()
        x, _, run = C._decode_fixture(PP, self._randn(cuda_device, 5), cuda_device, H, KV, D,
                                      16, 8, [5, 17, 40, 100, 128, 1, 64, 90], 7)
        C._nonfinite_rows(x["k_new"], range(4))
        C._nonfinite_rows(x["v_new"], range(3, -1, -1))
        (o, pools), (ref, ref_pools) = (run("paged_decode_fused_int8", 0),
                                       run("paged_decode_fused_int8", 0, kernel=False))
        torch.cuda.synchronize()
        assert C._pools_off(pools, ref_pools) == 0
        torch.testing.assert_close(o[4:].float(), ref[4:].float(), rtol=8e-3, atol=1e-3)

    def test_division_routes_agree_on_every_pair(self, cuda_device):
        out = PP.quantizer_route_check(cuda_device)
        assert out["pairs"] > 2**30 and out["codes_off"] == 0, out

    @pytest.mark.parametrize("KV,D", [(8, 128), (32, 80), (1, 64)])
    def test_design_faults_are_caught(self, cuda_device, KV, D):
        C = _chip_smoke()
        case = dict(KV=KV, D=D, T=301, bucket=301, live=301,
                    serve=dict(kv_block_size=16, num_kv_blocks=31))
        x = C._kv_write_fixture(PP, self._randn(cuda_device, 9), cuda_device, case)
        pools, kn, vn, slots = x["pools"], x["kn"], x["vn"], x["slots"]
        got = [p.clone() for p in pools]
        PP.paged_kv_write_int8(*got, kn, vn, slots)
        tile = PP.KV8_TILE
        faults = {
            "stale_tile": C._emulated_write(PP, pools, *C._stale_tile_rows(kn, vn, tile), slots),
            "scale_to_the_next_head": C._emulated_write(PP, pools, kn, vn, slots,
                                                        scale_shift=True),
            "last_tile_left_unwritten": C._emulated_write(
                PP, pools, kn, vn, slots, skip_from=(2 * 301 * KV - 1) // tile * tile),
            "ties_away_from_zero": C._emulated_write(PP, pools, kn, vn, slots,
                                                     "ties_away_from_zero"),
            "nan_dropping_absmax": C._emulated_write(PP, pools, kn, vn, slots,
                                                     "nan_dropping_absmax")}
        if D == 80:
            faults["amax_first_64_columns"] = C._emulated_write(PP, pools, kn, vn, slots,
                                                                "amax_first_64_columns")
        torch.cuda.synchronize()
        assert C._pools_off(got, C._emulated_write(PP, pools, kn, vn, slots)) == 0
        off = {name: C._pools_off(got, f) for name, f in faults.items()}
        assert all(off.values()), off

    def test_no_register_spills(self, cuda_device):
        from deepspeed_tpu_torch.ops.cuda import build

        build.load("paged_kv_write")
        regs = _chip_smoke()._ptxas_registers(build, "paged_kv_write", ("kv_write_int8_kernel",))
        assert len(regs) == 3 and not any(r.get("spill_stores") for r in regs.values()), regs

    def test_rejects_unaligned_rows(self, rng, cuda_device):
        d = cuda_device
        pools = _int8_pools(rng, d, 4, 16, 2, 64)
        rows = _bf16_cuda(rng.standard_normal((5 * 2 * 64 + 4,)), d)
        kn = rows[4:].view(5, 2, 64)  # contiguous, 8 bytes off a 16-byte boundary
        with pytest.raises(ValueError):
            PP.paged_kv_write_int8(*pools, kn, kn, torch.zeros(5, dtype=torch.int32, device=d))


# a tiny Llama served from 16-token blocks over 2048-position tables: the
# decode splits its rows' tables (a split workspace at every width here)
GRAPH_MODEL = dict(vocab_size=512, n_layers=2, n_heads=2, d_model=256, max_seq=2048,
                   variant="llama")
GRAPH_SERVE = dict(max_seq_len=2048, kv_block_size=16, num_kv_blocks=320,
                   min_prefill_bucket=16, max_batch_size=64)
GRAPH_LANE = dict(do_sample=True, temperature=0.9, top_k=40, top_p=0.95)


@pytest.mark.cuda
class TestGraphsOnCard:
    """warmup()'s CUDA graphs (inference/graphs.py) against eager decode:
    bit identity, the capture order of the decode workspace, block tables
    and weights that change after capture, clones, a failing capture."""

    def _engine(self, dev, rows=16, seed=0, **over):
        from deepspeed_tpu_torch import init_inference
        from deepspeed_tpu_torch.models import transformer as T

        cfg = T.TransformerConfig(**GRAPH_MODEL)
        params = T.init(cfg, torch.Generator(device=dev).manual_seed(seed), device=dev,
                        dtype=torch.bfloat16)
        eng = init_inference(params, cfg, dict(GRAPH_SERVE, **over))
        r = np.random.default_rng(seed)
        uids = list(range(rows))
        lg = eng.put(uids, [r.integers(0, 512, 5 + 3 * (i % 13)).astype(np.int32) for i in uids])
        return eng, uids, lg.argmax(-1).astype(np.int32)

    def _rows(self, eng, uids):
        tables = eng.state.block_table(uids, eng.config.blocks_per_seq, eng.pad_block)
        ctx = np.array([eng.state.get(u).seen_tokens + 1 for u in uids], np.int32)
        return tables, ctx

    def _same(self, a, b):
        return _chip_smoke()._same_bits(a, b)

    def _replay_and_eager(self, eng, fn, args):
        got = fn(eng.params, eng.cache, *args)
        want = fn(dict(eng.params), eng.cache, *args)  # not the engine's dict: eager
        torch.cuda.synchronize()
        return got, want

    @pytest.mark.parametrize("width", [8, 16])
    def test_greedy_replay_bit_identical(self, cuda_device, width):
        eng, uids, toks = self._engine(cuda_device, rows=width)
        out = eng.warmup(widths=[width], decode_chunks=[6])
        assert out["graphs"] == 3 and out["programs"] == 4
        fn = eng.decode_multi_fn(width, 6)
        tables, ctx = self._rows(eng, uids)
        r0 = eng.graphs.replays
        got, want = self._replay_and_eager(eng, fn, (toks, tables, ctx))
        assert eng.graphs.replays == r0 + 1
        assert self._same(got[0], want[0]) and self._same(got[1], want[1])
        assert eng.warmup_footprints[width]["peak_hbm_bytes"] > 0

    def test_sampled_replay_matches_eager_and_oracle(self, cuda_device):
        from deepspeed_tpu_torch.inference.sampling import SamplingConfig, host_oracle_token

        eng, uids, toks = self._engine(cuda_device, rows=8)
        eng.warmup(sampling=GRAPH_LANE, widths=[8], decode_chunks=[1, 5])
        cfg = SamplingConfig(**GRAPH_LANE)
        tables, ctx = self._rows(eng, uids)
        keys = eng._row_keys(0, np.arange(8))
        got, want = self._replay_and_eager(eng, eng.decode_multi_fn(8, 5, sampling=cfg),
                                           (toks, tables, ctx, keys, ctx))
        assert self._same(got[0], want[0]) and self._same(got[1], want[1])
        one = eng.decode_multi_fn(8, 1, sampling=cfg)
        g, lg, _, _ = one(eng.params, eng.cache, toks, tables, ctx, keys, ctx)
        lg, kh = lg.cpu().numpy(), keys.cpu().numpy()
        for s in range(8):
            assert host_oracle_token(lg[s], cfg, kh[s], int(ctx[s])) == int(g[0, s])

    def test_put_decode_rows_replay(self, cuda_device):
        eng, uids, toks = self._engine(cuda_device, rows=8)
        twin, _, _ = self._engine(cuda_device, rows=8)
        eng.warmup(widths=[8])
        r0 = eng.graphs.replays
        a = eng.put(uids, [np.array([t], np.int32) for t in toks])
        b = twin.put(uids, [np.array([t], np.int32) for t in toks])
        assert eng.graphs.replays == r0 + 1 and twin.graphs.replays == 0
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))

    def test_capture_order_keeps_earlier_workspace(self, cuda_device):
        """Width 8 captured first, then wider ones whose split plans need a
        larger workspace: the replaced workspace stays alive for the width-8
        graph, whose replay still equals eager."""
        eng, uids, toks = self._engine(cuda_device, rows=64)
        retired = len(PP._RETIRED)
        eng.warmup(widths=[8], decode_chunks=[4])
        eng.warmup(widths=[16, 32, 64], decode_chunks=[4])
        assert len(PP._RETIRED) > retired, "no wider plan grew the workspace"
        tables, ctx = self._rows(eng, uids[:8])
        got, want = self._replay_and_eager(eng, eng.decode_multi_fn(8, 4),
                                           (toks[:8], tables, ctx))
        assert self._same(got[0], want[0]) and self._same(got[1], want[1])

    def test_replay_reads_new_tables(self, cuda_device):
        eng, uids, toks = self._engine(cuda_device, rows=8)
        eng.warmup(widths=[8], decode_chunks=[3])
        fn = eng.decode_multi_fn(8, 3)
        tables, ctx = self._rows(eng, uids)
        fn(eng.params, eng.cache, toks, tables, ctx)
        # row 0's first page moved to a free block, the old one overwritten
        used = {b for u in eng.state.tracked_uids for b in eng.state.get(u).blocks}
        free = next(b for b in range(eng.config.num_kv_blocks) if b not in used)
        moved = tables.copy()
        moved[0, 0] = free
        eng._copy_block(int(tables[0, 0]), free)
        eng._copy_block(int(tables[1, 0]), int(tables[0, 0]))
        got, want = self._replay_and_eager(eng, fn, (toks, moved, ctx))
        assert self._same(got[0], want[0]) and self._same(got[1], want[1])

    def test_refresh_params_drops_graphs(self, cuda_device):
        eng, uids, toks = self._engine(cuda_device, rows=8)
        eng.warmup(widths=[8], decode_chunks=[3])
        fn = eng.decode_multi_fn(8, 3)
        tables, ctx = self._rows(eng, uids)
        before = fn(eng.params, eng.cache, toks, tables, ctx)[1]
        half = lambda x: x * 0.5 if x.is_floating_point() else x
        eng.refresh_params({k: ([{n: half(w) for n, w in lp.items()} for lp in v]
                                if k == "layers" else half(v)) for k, v in eng.params.items()})
        assert len(eng.graphs) == 0
        r0 = eng.graphs.replays
        eager = fn(eng.params, eng.cache, toks, tables, ctx)[1]
        assert eng.graphs.replays == r0 and not self._same(eager, before)
        eng.warmup(widths=[8], decode_chunks=[3])
        got, want = self._replay_and_eager(eng, fn, (toks, tables, ctx))
        assert eng.graphs.replays == r0 + 1
        assert self._same(got[1], want[1]) and self._same(got[1], eager)

    def test_replay_returns_clones(self, cuda_device):
        eng, uids, toks = self._engine(cuda_device, rows=8)
        eng.warmup(widths=[8], decode_chunks=[3])
        fn = eng.decode_multi_fn(8, 3)
        tables, ctx = self._rows(eng, uids)
        first = fn(eng.params, eng.cache, toks, tables, ctx)
        kept = (first[0].clone(), first[1].clone())
        second = fn(eng.params, eng.cache, (toks + 1) % 512, tables, ctx)
        torch.cuda.synchronize()
        assert not self._same(second[1], kept[1])
        assert self._same(first[0], kept[0]) and self._same(first[1], kept[1])

    def test_failed_capture_raises(self, cuda_device, monkeypatch):
        from deepspeed_tpu_torch.inference import model as M

        eng, _, _ = self._engine(cuda_device, rows=8)
        real = M.decode_step

        def syncing(*a, **k):  # a host read of a device value: fine eagerly, not in a capture
            out = real(*a, **k)
            out[0].sum().item()
            return out

        monkeypatch.setattr(M, "decode_step", syncing)
        with pytest.raises(RuntimeError, match="capturing"):
            eng.warmup(widths=[8])
        assert len(eng.graphs) == 0


# the W8A16 GEMM's cases: decode rows over the flagship's and Falcon-7B's
# products (K 4544 = 71 x 64, q/k/v N 73 x 64), tails in K (16 past a
# 64-deep slice) and N (odd; past a 128-column tile), every CTA height
# (16, 32, 64, 128 rows), a prefill, the tied logits
INT8_MM_CASES = [(1, 3072, 1024), (8, 1024, 1024), (8, 4672, 4544), (5, 133, 4560),
                 (33, 4673, 48), (64, 1000, 2816), (130, 333, 208), (512, 4096, 1024),
                 (8, 32000, 1024), (768, 4544, 1040), (768, 1024, 2816)]


@pytest.mark.cuda
class TestInt8MatmulOnCard:
    """The W8A16 GEMM (csrc/int8_matmul.cu) against its plain version on
    the same inputs: its error against the exact product (f64) within 1.5x
    (RMS) and 2x (max) of the plain bf16 version's, chip_smoke.py's
    tolerance; two launches bit-identical; any grid (tiles cut between CTAs
    or not) and any token width within the same tolerance, its counters
    left for the next launch; chip_smoke.py's planted faults failing and
    the rows past M left untouched; a per-channel int8 engine's replays
    bit-identical to eager, every product on the kernel."""

    def _inputs(self, M, N, K, dev, seed=0):
        return _chip_smoke()._int8_mm_inputs(N, K, M, dev, seed)

    def _within(self, x, q, s, got, plain):
        cs = _chip_smoke()
        st = cs._int8_mm_errors(x, q, s, got, plain)
        return cs._int8_mm_within(st), st

    @pytest.mark.parametrize("f32", [False, True])
    @pytest.mark.parametrize("M,N,K", INT8_MM_CASES)
    def test_kernel_vs_plain(self, cuda_device, M, N, K, f32):
        from deepspeed_tpu_torch.ops.cuda import int8_matmul as IM

        x, q, s = self._inputs(M, N, K, cuda_device)
        n0 = IM.int8_matmul.launches
        got = IM.int8_matmul(x, q, s, f32)
        again = IM.int8_matmul(x, q, s, f32)
        torch.cuda.synchronize()
        assert IM.int8_matmul.launches == n0 + 2
        assert got.dtype == (torch.float32 if f32 else torch.bfloat16) and got.shape == (M, N)
        assert _chip_smoke()._same_bits(got, again)
        ok, st = self._within(x, q, s, got, IM.int8_matmul_plain(x, q, s, f32))
        assert ok, st
        assert (got[:, N // 2] == 0).all()  # the zero column

    @pytest.mark.parametrize("M,N,K", [(8, 1024, 4096), (16, 4673, 4560), (64, 300, 2816),
                                       (200, 1024, 2816)])
    def test_every_split_count(self, cuda_device, monkeypatch, M, N, K):
        """Every grid from one CTA to one a unit, at every token width that
        holds M: the same tolerance, two launches the same bits."""
        from deepspeed_tpu_torch.ops.cuda import int8_matmul as IM

        x, q, s = self._inputs(M, N, K, cuda_device, seed=1)
        plain = IM.int8_matmul_plain(x, q, s)
        for tn in (t for t in IM.TOKEN_WIDTHS if t >= min(M, 128)):
            for n in (1, 2, 3, 5, 8, 64, 132, 10**6):
                plan = IM.matmul_split_plan_for(M, N, K, n, tn)
                monkeypatch.setattr(IM, "matmul_split_plan", lambda *a, plan=plan: plan)
                got = IM.int8_matmul(x, q, s)
                again = IM.int8_matmul(x, q, s)  # the counters were left at 0
                torch.cuda.synchronize()
                assert _chip_smoke()._same_bits(got, again), plan
                ok, st = self._within(x, q, s, got, plain)
                assert ok, (plan, st)

    def test_planted_faults(self, cuda_device):
        from deepspeed_tpu_torch.ops.cuda import int8_matmul as IM

        faults = _chip_smoke()._int8_mm_faults(IM, cuda_device)  # raises if one passes
        assert {"split_left_out", "stale_ring_stage", "warpgroup_given_the_next_64_channels",
                "tile_stored_untransposed", "rows_past_m_stored_m5",
                "rows_past_m_stored_m33"} <= set(faults)

    @pytest.mark.parametrize("M", [1, 5, 33, 100])  # M below its token width
    def test_rows_past_m_untouched(self, cuda_device, M):
        from deepspeed_tpu_torch.ops.cuda import int8_matmul as IM

        rep = _chip_smoke()._int8_mm_rows_past_m(IM, cuda_device, M)
        assert rep["genuine_rows_past_m_untouched"]

    def test_rejects_what_it_does_not_take(self, cuda_device):
        from deepspeed_tpu_torch.ops.cuda import int8_matmul as IM

        x, q, s = self._inputs(4, 64, 64, cuda_device)
        with pytest.raises(ValueError, match="multiple of 16"):
            IM.int8_matmul(x[:, :40].contiguous(), q[:, :40].contiguous(), s)
        with pytest.raises(TypeError):
            IM.int8_matmul(x.float(), q, s)
        with pytest.raises(ValueError, match="shape"):
            IM.int8_matmul(x, q, s[:10])

    def test_quantized_engine_replay_and_launches(self, cuda_device):
        from deepspeed_tpu_torch import init_inference
        from deepspeed_tpu_torch.inference import model as M
        from deepspeed_tpu_torch.models import transformer as T

        cfg = T.TransformerConfig(**GRAPH_MODEL)
        params = T.init(cfg, torch.Generator(device=cuda_device).manual_seed(0),
                        device=cuda_device, dtype=torch.bfloat16)
        eng = init_inference(params, cfg, dict(GRAPH_SERVE),
                             quantization={"bits": 8, "per_channel": True})
        r = np.random.default_rng(0)
        uids = list(range(8))
        PK.reset_launch_counts()
        # prompts of 5-12 tokens: one prefill wave in the 16-token bucket
        lg = eng.put(uids, [r.integers(0, 512, 5 + i).astype(np.int32) for i in uids])
        torch.cuda.synchronize()
        per_forward = 4 * cfg.n_layers + 1  # q/k/v, out, gate|up, down; the logits
        assert PK.launch_counts()["int8_matmul"] == per_forward
        toks = lg.argmax(-1).astype(np.int32)
        eng.warmup(widths=[8], decode_chunks=[4])
        tables = eng.state.block_table(uids, eng.config.blocks_per_seq, eng.pad_block)
        ctx = np.array([eng.state.get(u).seen_tokens + 1 for u in uids], np.int32)
        fn = eng.decode_multi_fn(8, 4)
        got = fn(eng.params, eng.cache, toks, tables, ctx)
        PK.reset_launch_counts()
        want = fn(dict(eng.params), eng.cache, toks, tables, ctx)
        torch.cuda.synchronize()
        assert PK.launch_counts()["int8_matmul"] == 4 * per_forward
        same = _chip_smoke()._same_bits
        assert same(got[0], want[0]) and same(got[1], want[1])
        # the kernel path against the plain path on the same codes
        t = torch.as_tensor(toks, device=cuda_device)
        tb, cx = torch.as_tensor(tables, device=cuda_device), torch.as_tensor(ctx, device=cuda_device)
        outs = []
        for use_kernel in (True, False):
            cache = _chip_smoke()._pool_copies(eng.cache, torch.bfloat16)
            outs.append(M.decode_step(eng.params, cache, t, tb, cx, cfg, use_kernel=use_kernel,
                                      unique_rows=True)[0].float())
        np.testing.assert_allclose(outs[0].cpu().numpy(), outs[1].cpu().numpy(),
                                   atol=0.05 * float(outs[1].abs().max()), rtol=0)

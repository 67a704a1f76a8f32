"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test is marked `cuda` and skips without a CUDA device. This file
imports neither JAX nor the JAX package, so it runs on the GPU machine
(which has no JAX) without the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

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

    @pytest.mark.parametrize("S,KV,D", [(128, 2, 128), (200, 1, 128), (77, 1, 64)])
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

"""The port's evoformer attention held against the JAX package on the CPU,
from the same numpy-made inputs:

- `ds4sci_evoformer_attention` (f32; on CPU tensors the autograd Function
  runs the plain forward and the plain recompute-from-lse backward of
  kernels #7-#10) against the JAX package's, which runs its Pallas
  kernels in interpret mode: forward within 2e-4 and every gradient (q, k,
  v and the biases present) within 3e-3, the JAX package's own pins
  (tests/test_evoformer_indexed.py), for each set of biases and again with
  S = 4 so bias2's gradient sums over several sequences;
- the chunked `evoformer_attention` against the JAX package's at chunk 16
  (four checkpointed chunks): forward within 2e-5, gradients within 1e-4;
- N = 48, off the JAX tiling, where the JAX package takes its chunked path
  and the port its Function: within 2e-4;
- in bf16, the plain backward (which rounds P and dS to bf16 as the CUDA
  and TPU kernels do) against jax.grad through the interpret-mode kernels
  under the tolerance the CUDA kernels are held to on the card
  (`bwd_mismatch`); planted faults (every gradient x 1.02, bias2's
  gradient without its last sequence) fail it;
- CPU tensors launch no kernel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import evoformer_attention as JE
from deepspeed_tpu.ops.pallas import evoformer_attention as JEP
from deepspeed_tpu_torch.ops import cuda as PK
from deepspeed_tpu_torch.ops import evoformer_attention as PE
from deepspeed_tpu_torch.ops.cuda import evoformer_attention as PEK

FWD_TOL = dict(rtol=2e-4, atol=2e-4)
GRAD_TOL = dict(rtol=3e-3, atol=3e-3)
BIAS_SETS = {"both": (True, True), "pair_only": (False, True), "mask_only": (True, False),
             "none": (False, False)}


def _inputs(rng, B=1, S=2, N=128, H=2, D=32):
    """q, k, v, dO, an MSA mask bias (-1e9 on ~20% of the keys, never a
    whole row) and a pair bias, as numpy f32."""
    q, k, v, do = (rng.standard_normal((B, S, N, H, D)).astype(np.float32) for _ in range(4))
    masked = rng.random((B, S, 1, 1, N)) < 0.2
    masked[..., 0] = False
    mask = np.where(masked, -1e9, 0.0).astype(np.float32)
    pair = rng.standard_normal((B, 1, H, N, N)).astype(np.float32)
    return q, k, v, do, mask, pair


def _biases(mask, pair, which):
    has_mask, has_pair = BIAS_SETS[which]
    if not has_pair:
        return [mask] if has_mask else []
    return [mask if has_mask else None, pair]


def _jax_vjp(fn, arrays, do, dtype=jnp.float32):
    """fn(*arrays) and its gradients for the cotangent do, at the highest
    matmul precision."""
    xs = [jnp.asarray(a, dtype) for a in arrays]
    with jax.default_matmul_precision("highest"):
        out, pull = jax.vjp(fn, *xs)
        grads = pull(jnp.asarray(do, out.dtype))
    return np.asarray(out.astype(jnp.float32)), [np.asarray(g.astype(jnp.float32))
                                                  for g in grads]


def _torch_vjp(fn, arrays, do, dtype=torch.float32):
    xs = [torch.from_numpy(a).to(dtype).requires_grad_() for a in arrays]
    out = fn(*xs)
    grads = torch.autograd.grad(out, xs, torch.from_numpy(do).to(out.dtype))
    return out.detach().float().numpy(), [g.float().numpy() for g in grads]


def _split(biases_template):
    """(the slots of the present biases, a function that puts values back
    in those slots)."""
    slots = [i for i, b in enumerate(biases_template) if b is not None]

    def fill(values):
        out = [None] * len(biases_template)
        for i, x in zip(slots, values):
            out[i] = x
        return out

    return slots, fill


class TestDs4sciAgainstJax:
    @pytest.mark.parametrize("which,S", [("both", 2), ("pair_only", 2), ("mask_only", 2),
                                         ("none", 2), ("both", 4)])
    def test_forward_and_grads_match_jax_kernels(self, rng, which, S):
        q, k, v, do, mask, pair = _inputs(rng, S=S)
        template = _biases(mask, pair, which)
        slots, fill = _split(template)
        arrays = [q, k, v] + [template[i] for i in slots]

        def jfn(q, k, v, *bs):
            return JE.ds4sci_evoformer_attention(q, k, v, fill(bs))

        def pfn(q, k, v, *bs):
            return PE.ds4sci_evoformer_attention(q, k, v, fill(bs))

        jo, jg = _jax_vjp(jfn, arrays, do)
        po, pg = _torch_vjp(pfn, arrays, do)
        np.testing.assert_allclose(po, jo, **FWD_TOL)
        names = ["dq", "dk", "dv"] + [("dbias1", "dbias2")[i] for i in slots]
        for name, a, b in zip(names, pg, jg):
            assert np.abs(a).max() > 0, name
            np.testing.assert_allclose(a, b, err_msg=name, **GRAD_TOL)

    def test_off_jax_tiling_matches_jax_chunked(self, rng):
        """N = 48: the JAX package falls back to its chunked path; the port
        keeps the Function (its kernels mask the ragged tile)."""
        q, k, v, do, mask, pair = _inputs(rng, N=48)
        arrays = [q, k, v, mask, pair]
        jo, jg = _jax_vjp(lambda q, k, v, m, p: JE.ds4sci_evoformer_attention(
            q, k, v, [m, p], chunk_size=48), arrays, do)
        po, pg = _torch_vjp(lambda q, k, v, m, p: PE.ds4sci_evoformer_attention(
            q, k, v, [m, p], chunk_size=48), arrays, do)
        np.testing.assert_allclose(po, jo, **FWD_TOL)
        for a, b in zip(pg, jg):
            np.testing.assert_allclose(a, b, **GRAD_TOL)


class TestChunkedAgainstJax:
    @pytest.mark.parametrize("chunk", [16, 64])
    def test_chunked_matches_jax_chunked(self, rng, chunk):
        """chunk 16 runs four checkpointed key chunks; 64 the dense step."""
        q, k, v, do, mask, pair = _inputs(rng, N=64)
        arrays = [q, k, v, mask, pair]
        jo, jg = _jax_vjp(lambda q, k, v, m, p: JE.evoformer_attention(
            q, k, v, [m, p], chunk_size=chunk), arrays, do)
        po, pg = _torch_vjp(lambda q, k, v, m, p: PE.evoformer_attention(
            q, k, v, [m, p], chunk_size=chunk), arrays, do)
        np.testing.assert_allclose(po, jo, rtol=2e-5, atol=2e-5)
        for a, b in zip(pg, jg):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)

    def test_chunk_must_divide_n(self, rng):
        q = torch.zeros((1, 1, 48, 2, 32))
        with pytest.raises(ValueError):
            PE.evoformer_attention(q, q, q, chunk_size=32)

    @pytest.mark.parametrize("case", ["use_kernel_false", "rank4", "bias_off_contract"])
    def test_dispatch_takes_chunked_path_as_the_reference(self, rng, case, monkeypatch):
        """Off-contract inputs and use_kernel=False take the chunked path,
        as in the reference: the Function is never applied and the result
        is the chunked path's, bit for bit."""
        q, k, v, _, mask, pair = (torch.from_numpy(a) for a in _inputs(rng, N=32))
        biases, kwargs = [mask, pair], {}
        if case == "use_kernel_false":
            kwargs = {"use_kernel": False}
        elif case == "rank4":
            q, k, v, biases = q[0], k[0], v[0], [mask[0], pair[0]]
        else:  # a pair bias broadcast over heads
            biases = [mask, pair[:, :, :1]]
        want = PE.evoformer_attention(q, k, v, biases, chunk_size=16)

        def not_applied(*args):
            raise AssertionError("the fused Function took off-contract inputs")

        monkeypatch.setattr(PE.EvoformerAttention, "apply", not_applied)
        got = PE.ds4sci_evoformer_attention(q, k, v, biases, chunk_size=16, **kwargs)
        torch.testing.assert_close(got, want, rtol=0, atol=0)


class TestPlainBackwardBf16:
    @pytest.mark.parametrize("fault", [None, "scale_1.02", "drop_last_sequence"])
    def test_rounding_matches_jax_kernels_in_bf16(self, rng, fault):
        """From the JAX forward kernel's own o and lse on bf16 inputs, the
        port's plain backward is held against jax.grad through the
        interpret-mode backward kernels under `bwd_mismatch` (one bf16 ulp
        + 2^-5 of the row's RMS over the last axis + 2^-10 of the tensor's
        RMS). Planted faults in the JAX gradients must fail it."""
        q, k, v, do, mask, pair = _inputs(rng, S=4)
        jq, jk, jv, jdo, jm, jp = (jnp.asarray(a, jnp.bfloat16)
                                   for a in (q, k, v, do, mask, pair))
        o, lse = JEP.evoformer_flash_fwd(jq, jk, jv, jm, jp, with_lse=True)
        ref = jax.grad(lambda *a: jnp.sum(JE.ds4sci_evoformer_attention(
            a[0], a[1], a[2], [a[3], a[4]]).astype(jnp.float32) * jdo.astype(jnp.float32)),
            argnums=(0, 1, 2, 3, 4))(jq, jk, jv, jm, jp)
        t = lambda a: torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16)
        got = PEK.evoformer_bwd_plain(t(jq), t(jk), t(jv), t(jm), t(jp), t(o),
                                      torch.from_numpy(np.array(lse)), t(jdo))
        last = PEK.evoformer_bwd_plain(*(t(x[:, -1:]) for x in (jq, jk, jv, jm)), t(jp),
                                       t(o[:, -1:]), torch.from_numpy(np.array(lse))
                                       .reshape(1, 4, 2, -1)[:, -1].reshape(2, -1), t(jdo[:, -1:]))
        caught = []
        for i, name in enumerate(("dq", "dk", "dv", "dbias1", "dbias2")):
            jax_grad = torch.from_numpy(np.array(ref[i].astype(jnp.float32)))
            if fault is None:
                stats = PEK.bwd_mismatch(jax_grad, got[i])
                assert stats["n_over"] == 0, (name, stats)
                continue
            if fault == "scale_1.02":
                jax_grad = jax_grad * 1.02
            elif name == "dbias2":
                jax_grad = jax_grad - last[4].float()
            else:
                continue
            caught.append(PEK.bwd_mismatch(jax_grad.to(torch.bfloat16), got[i])["n_over"])
        assert all(caught), (fault, caught)


class TestCpuTensorsLaunchNothing:
    def test_wrappers_take_plain_versions_on_cpu(self, rng):
        q, k, v, do, mask, pair = (torch.from_numpy(a) for a in _inputs(rng, N=40))
        PK.reset_launch_counts()
        o, lse = PEK.evoformer_fwd(q, k, v, mask, pair)
        ro, rlse = PEK.evoformer_fwd_plain(q, k, v, mask, pair)
        assert torch.equal(o, ro) and torch.equal(lse, rlse)
        delta = PEK._delta(o, do)
        args = (q, k, v, mask, pair, do, lse, delta)
        dq, dk, dv, db1, db2 = PEK.evoformer_bwd_plain(q, k, v, mask, pair, o, lse, do)
        assert torch.equal(PEK.evoformer_bwd_dq(*args), dq)
        gk, gv, dsum = PEK.evoformer_bwd_dkv(*args)
        assert torch.equal(gk, dk) and torch.equal(gv, dv)
        assert torch.equal(PEK._db1(dsum, mask), db1)
        assert torch.equal(PEK.evoformer_bwd_db2(*args), db2)
        leaves = [x.clone().requires_grad_() for x in (q, k, v, pair)]
        out = PE.ds4sci_evoformer_attention(leaves[0], leaves[1], leaves[2], [mask, leaves[3]])
        out.backward(do)
        assert all(x.grad is not None for x in leaves)
        assert PK.launch_counts() == {n: 0 for n in PK.WRAPPERS}

    def test_absent_or_frozen_bias_gets_no_gradient(self, rng):
        """The backward returns None (not zeros) for a bias that is absent
        or needs no gradient, as the reference's kernels compute none; the
        Function runs with a frozen mask and no pair bias."""
        q, k, v, do, mask, pair = (torch.from_numpy(a) for a in _inputs(rng, N=24))
        o, lse = PEK.evoformer_fwd(q, k, v, mask, pair)
        grads = PEK.evoformer_attention_bwd(q, k, v, mask, pair, o, lse, do,
                                            need_db1=False, need_db2=False)
        assert grads[3] is None and grads[4] is None
        o, lse = PEK.evoformer_fwd(q, k, v, mask)
        assert PEK.evoformer_attention_bwd(q, k, v, mask, None, o, lse, do)[4] is None
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        out = PEK.EvoformerAttention.apply(*leaves, mask, None)
        assert all(g.abs().max() > 0 for g in torch.autograd.grad(out, leaves, do))
        with pytest.raises(ValueError):
            PEK.evoformer_bwd_db2(q, k, v, mask, None, do, lse, None)

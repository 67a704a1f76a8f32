"""Mixtral-class MoE serving of the port held against the JAX package on the
CPU, from the same numpy-made inputs.

- the gating authority: `dropless_topk_gating` (indices equal, weights,
  l_aux and z-loss at 1e-6) at k = 1, 2, 3, with planted ties (lax.top_k
  takes the lowest index; so must the port), `expert_counts` and
  `sort_by_expert` (stable) equal;
- the grouped GEMM's plain version (`grouped_gemm_plain`, and `grouped_mm`
  "dense" and "ragged", which on CPU tensors is the plain version) against
  the JAX package's "dense" and "ragged" grouped_mm at 1e-5 in f32, with
  an empty segment, one segment holding every row and rows past the
  segments; a model of the kernel's walk of its grid (csrc/
  grouped_gemm.cu: every CTA's segment and row tile from the counts)
  covering every row of every segment once inside the grid's bound;
- `_mlp` on one MoE layer, scan and dropless, with full-precision and
  groupwise-int8 expert stacks, with and without PR-MoE's residual, in f32
  at 1e-5 against the JAX package's `_mlp`, and the scan path equal to the
  dropless one;
- `quantize_layer` on an MoE layer: the expert stacks' groupwise codes and
  scales, and the residual expert's per-channel ones, bit for bit against
  the jitted JAX function, from f32 and bf16 weights;
- nine tiny Mixtral-form engines (2 layers, d_model 64, 4 heads over 2 KV
  heads, 4 experts) against the JAX engine, top-1 and top-2, scan and
  dropless, gated and ungated with biases, with and without the residual,
  once with window 8 (on int8 weights), on f32 pools, on int8 pools and
  with per-channel int8 weights: a 21-token prompt then 6 greedy decode steps, logits within
  1e-4 (2e-3 on int8 pools), greedy tokens and `moe_expert_census()` equal;
- `generate()` tokens and census, and the scheduler's moe_* metrics, equal
  to the JAX package's; a JAX per-channel int8 tree (groupwise expert
  stacks) carried across leaf for leaf and served; the Mixtral-8x7B
  config of chip_smoke.py against the JAX package's config_from_hf of
  mistralai/Mixtral-8x7B-v0.1's config.json.

The JAX references are jitted once per module, and each engine pair is
built once (module fixtures). The kernel itself is held against its plain
version on the card in tests/test_torch_cuda.py -k GroupedGemm and by
chip_smoke.py.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import numpy_params, to_jax
from deepspeed_tpu.inference import ServingScheduler as JaxScheduler
from deepspeed_tpu.inference import ServingSchedulerConfig as JaxSchedulerConfig
from deepspeed_tpu.inference import init_inference as jax_init_inference
from deepspeed_tpu.inference import model as JM
from deepspeed_tpu.models import transformer as JT
from deepspeed_tpu.moe import dropless as JD
from deepspeed_tpu.utils.hf_checkpoint import config_from_hf
from deepspeed_tpu_torch.inference import ServingScheduler, ServingSchedulerConfig
from deepspeed_tpu_torch.inference import init_inference
from deepspeed_tpu_torch.inference import model as PM
from deepspeed_tpu_torch.inference.quantization import ChannelQuantWeight, QuantizedWeight
from deepspeed_tpu_torch.models import transformer as PT
from deepspeed_tpu_torch.moe import dropless as PD
from deepspeed_tpu_torch.ops.cuda import grouped_gemm as PG
from deepspeed_tpu_torch.utils.convert import params_from_numpy

TOL = {"auto": dict(rtol=1e-4, atol=1e-4), "int8": dict(rtol=2e-3, atol=2e-3)}
F32_TOL = dict(rtol=1e-5, atol=1e-5)
PER_CHANNEL = {"bits": 8, "per_channel": True}
# the tiny Mixtral form: 2 layers, d_model 64, 4 query heads over 2 KV heads
# of 16, 4 experts of d_ff 128, vocab 256
MIXTRAL_TINY = dict(vocab_size=256, n_layers=2, n_heads=4, n_kv_heads=2, d_model=64, d_ff=128,
                    max_seq=128, variant="llama", n_experts=4, moe_top_k=2)
UNGATED = dict(gated_mlp=False, mlp_bias=True, activation="gelu")
# form -> (config overrides, kv_cache_dtype, weight quantization): top-1 and
# top-2, scan and dropless, gated and ungated with biases, with and without
# the residual, once with window 8, on f32 and int8 pools, with full and
# per-channel int8 weights (the dimensions crossed, not multiplied: each
# JAX engine's compile costs seconds)
FORMS = {
    "top2_scan": ({}, "auto", None),
    "top2_dropless": (dict(moe_dropless=True), "auto", None),
    "ungated_bias_top1_scan": (dict(UNGATED, moe_top_k=1), "auto", None),
    "ungated_bias_dropless": (dict(UNGATED, moe_dropless=True), "auto", None),
    "residual_scan": (dict(moe_use_residual=True), "auto", None),
    "residual_top1_dropless": (dict(moe_use_residual=True, moe_top_k=1, moe_dropless=True),
                               "auto", None),
    "top2_scan_int8_pools": ({}, "int8", None),
    "window8_scan_int8_weights": (dict(sliding_window=8), "auto", PER_CHANNEL),
    "top2_dropless_int8_weights": (dict(moe_dropless=True), "auto", PER_CHANNEL),
}
SERVE = dict(max_seq_len=128, kv_block_size=16, num_kv_blocks=32, min_prefill_bucket=16,
             max_batch_size=8, moe_census=True)
STD = 0.3  # weights large enough that the greedy tokens and the routing move
# mistralai/Mixtral-8x7B-v0.1 config.json, the values config_from_hf reads
MIXTRAL_8X7B_HF = {"architectures": ["MixtralForCausalLM"], "vocab_size": 32000,
                   "hidden_size": 4096, "intermediate_size": 14336, "num_hidden_layers": 32,
                   "num_attention_heads": 32, "num_key_value_heads": 8,
                   "max_position_embeddings": 32768, "rope_theta": 1e6, "rms_norm_eps": 1e-5,
                   "hidden_act": "silu", "num_local_experts": 8, "num_experts_per_tok": 2,
                   "sliding_window": None, "tie_word_embeddings": False}

_jit_gating = jax.jit(JD.dropless_topk_gating, static_argnums=(1,))
_jit_grouped = jax.jit(JD.grouped_mm, static_argnames=("impl",))
_jit_mlp = jax.jit(JM._mlp, static_argnums=(2,))
_jit_quantize_layer = jax.jit(JM.quantize_layer, static_argnums=(1,))


def _t(a):
    return torch.from_numpy(np.array(a))


def _round_bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16().float().numpy()


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch single-threaded here: the tiny ops of these engines wait on each
    other across threads under the test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# gating, counts, the sort
# ---------------------------------------------------------------------------

def _tied_logits(rng, T, X):
    """Normal logits, with rows of planted ties: all equal, the top two
    equal, a tie between the second and third, an exact tie at the k-th
    place of every k."""
    x = rng.standard_normal((T, X)).astype(np.float32)
    x[0] = 0.5
    x[1, [1, 3]] = x[1].max() + 1.0
    x[2, [0, X - 1]] = x[2].max() + 1.0
    x[2, 2] = x[2].max() + 2.0
    x[3, :] = np.arange(X)[::-1] % 2  # pairs of equal values everywhere
    return x


@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("X", [4, 8])
def test_gating_matches_jax(rng, X, k):
    logits = _tied_logits(rng, 37, X)
    jidx, jw, jl, jz = (np.asarray(a) for a in _jit_gating(jnp.asarray(logits), k))
    pidx, pw, pl, pz = PD.dropless_topk_gating(_t(logits), k)
    np.testing.assert_array_equal(pidx.numpy(), jidx)
    np.testing.assert_allclose(pw.numpy(), jw, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(pl.item(), jl, rtol=1e-6)
    np.testing.assert_allclose(pz.item(), jz, rtol=1e-6)
    assert pidx[0].tolist() == list(range(k))  # a row of equal logits: the lowest indices
    # the counts and the stable sort of these decisions
    np.testing.assert_array_equal(PD.expert_counts(pidx, X).numpy(),
                                  np.asarray(JD.expert_counts(jnp.asarray(jidx), X)))
    for got, want in zip(PD.sort_by_expert(pidx), JD.sort_by_expert(jnp.asarray(jidx))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert PD.expert_counts(pidx, X).dtype == torch.int32


def test_gating_rejects_k_past_the_experts():
    with pytest.raises(ValueError, match="top_k"):
        PD.dropless_topk_gating(torch.zeros(3, 4), 5)


def test_router_z_loss_and_renormalize_match_jax(rng):
    logits = rng.standard_normal((9, 8)).astype(np.float32) * 3
    np.testing.assert_allclose(PD.router_z_loss(_t(logits)).item(),
                               float(JD.router_z_loss(jnp.asarray(logits))), rtol=1e-6)
    for renorm in (True, False):
        _, jw, _, _ = JD.dropless_topk_gating(jnp.asarray(logits), 2, renormalize=renorm)
        _, pw, _, _ = PD.dropless_topk_gating(_t(logits), 2, renormalize=renorm)
        np.testing.assert_allclose(pw.numpy(), np.asarray(jw), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# the grouped GEMM's plain version, and a model of the kernel's grid
# ---------------------------------------------------------------------------

GROUPED_COUNTS = {"mixed": [5, 0, 9, 6], "one_full": [0, 20, 0, 0], "first_full": [20, 0, 0, 0],
                  "rows_past_segments": [3, 4, 0, 2], "singletons": [1, 1, 1, 17]}


@pytest.mark.parametrize("case", sorted(GROUPED_COUNTS))
def test_grouped_mm_plain_matches_jax(rng, case):
    counts = np.array(GROUPED_COUNTS[case], np.int32)
    xs = rng.standard_normal((20, 16)).astype(np.float32)
    w = rng.standard_normal((4, 16, 24)).astype(np.float32)
    j = [jnp.asarray(a) for a in (xs, w, counts)]
    with jax.default_matmul_precision("highest"):
        want = {impl: np.asarray(_jit_grouped(*j, impl=impl)) for impl in ("dense", "ragged")}
    np.testing.assert_allclose(want["dense"], want["ragged"], **F32_TOL)
    args = [_t(a) for a in (xs, w, counts)]
    got = {"plain": PG.grouped_gemm_plain(*args), "wrapper": PG.grouped_gemm(*args),
           "dense": PD.grouped_mm(*args, impl="dense"),
           "ragged": PD.grouped_mm(*args, impl="ragged")}
    for g in got.values():
        for w_ in want.values():
            np.testing.assert_allclose(g.numpy(), w_, **F32_TOL)
    assert torch.equal(got["wrapper"], got["plain"])  # the CPU wrapper is the plain version
    n = int(counts.sum())
    assert not got["plain"][n:].any()  # rows past the segments: zero
    ref = np.concatenate([xs[o:o + c] @ w[e] for e, (o, c) in
                          enumerate(zip(np.cumsum(counts) - counts, counts))])
    np.testing.assert_allclose(got["plain"][:n].numpy(), ref, **F32_TOL)


def _kernel_tiles(counts, A, tn):
    """csrc/grouped_gemm.cu's find_tile for every row tile of the grid,
    ceil(A / tn) + min(X, A) - 1 of them: -> [(cta, expert, first row, end
    row)] of the CTAs that compute. Warp 0's form: a count cut at A is
    min(c, A - min(s, A)), s the raw counts before it (shuffle sums), held
    here against the walk that cuts each count at A less its offset."""
    c = np.maximum(np.asarray(counts, np.int64), 0)
    before = np.cumsum(c) - c
    cut = np.minimum(c, np.maximum(A - np.minimum(before, A), 0))
    seg = np.minimum(before, A)
    tiles = -(-cut // tn)
    first = np.cumsum(tiles) - tiles
    out, walk = [], []
    for t in range(-(-A // tn) + min(len(counts), A) - 1):
        hit = np.nonzero((t >= first) & (t < first + tiles))[0]
        if hit.size:
            e = int(hit[0])
            r0 = int(seg[e] + (t - first[e]) * tn)
            out.append((t, e, r0, min(r0 + tn, int(seg[e] + cut[e]))))
        before_t = off = 0
        for e, ce in enumerate(counts):
            ce = max(0, min(ce, A - off))
            n = -(-ce // tn)
            if t < before_t + n:
                r0 = off + (t - before_t) * tn
                walk.append((t, e, r0, min(r0 + tn, off + ce)))
                break
            before_t += n
            off += ce
    assert out == walk, (counts, A, tn)
    return out


# (K, N) of the grid model: Mixtral-8x7B's w_gate/w_in and w_out, a ragged one
GRID_SHAPES = [(4096, 14336), (14336, 4096), (1000, 136)]


def test_kernel_grid_covers_every_segment_row_once(rng):
    """The kernel's work plan (grouped_plan of either form: rows a tile,
    the grid's row tiles, column tiles and K splits) covers every (segment
    row, output column, k) once, in a tile of its own expert, inside the grid's bound,
    for the counts of GROUPED_COUNTS and skewed, empty and full counts at
    Mixtral's decode and prefill rows, on Mixtral's shapes and a ragged
    one; the CTAs past the segments compute nothing, and each K split
    holds at least one chunk."""
    cases = [(c, 20) for c in GROUPED_COUNTS.values()]
    cases += [(c, sum(c)) for c in ([0] * 7 + [300], [300] + [0] * 7, [1] * 8,
                                    [64, 0, 65, 1, 127, 0, 0, 43], [0, 0, 0, 0])]
    cases += [(list(rng.multinomial(A, rng.dirichlet(np.ones(8) * 0.3))), A)
              for A in (16, 64, 1024, 777) for _ in range(2)]
    cases += [([16, 0, 0, 0, 0, 0, 0, 0], 16), ([128] * 8, 1024), ([9, 0, 30, 4], 20),
              ([40] + [1] * 39, 79)]
    for counts, A in cases:
        offsets = np.cumsum(counts) - counts
        for (K, N), int8 in ((shape, int8) for shape in GRID_SHAPES for int8 in (False, True)):
            plan = PG.grouped_plan(A, K, N, len(counts), 132, int8)
            tiles = _kernel_tiles(counts, A, plan.tn)
            assert all(t < plan.row_tiles for t, *_ in tiles)
            cut = np.minimum(counts, np.maximum(A - np.minimum(offsets, A), 0))
            assert len(tiles) == sum(-(-cut // plan.tn))
            assert plan.col_tiles * PG.CH >= N > (plan.col_tiles - 1) * PG.CH
            assert plan.chunks * PG.BK >= K > (plan.chunks - 1) * PG.BK
            ranges = [plan.split_range(s) for s in range(plan.splits)]
            assert all(e > b for b, e in ranges), ranges
            # (row, column tile, k chunk) -> the CTAs that compute it
            seen = np.zeros((A, plan.col_tiles, plan.chunks), np.int32)
            for _, e, r0, r1 in tiles:
                assert offsets[e] <= r0 < r1 <= offsets[e] + counts[e]
                for b, e_ in ranges:
                    seen[r0:r1, :, b:e_] += 1
            n = min(A, int(sum(counts)))
            assert (seen[:n] == 1).all() and not seen[n:].any(), (counts, A, K, N)


# ---------------------------------------------------------------------------
# one MoE layer's FFN
# ---------------------------------------------------------------------------

def _layer_trees(over, int8, seed=3):
    """Layer 0 of a prepared MoE tree for both packages (weights rounded to
    bf16 values, computed in f32), its stacks groupwise int8 and the
    residual expert per-channel int8 by the JAX package's quantize_layer
    when int8."""
    jc = JT.TransformerConfig(**{**MIXTRAL_TINY, **over})
    pc = PT.TransformerConfig(**{**MIXTRAL_TINY, **over})
    tree = numpy_params(jc, seed=seed, std=STD)
    tree["layers"] = {k: _round_bf16(v) for k, v in tree["layers"].items()}
    prep = JM.prepare(to_jax(tree), jc)
    if int8:
        prep["layers"] = [_jit_quantize_layer(lp, jc) for lp in prep["layers"]]
    ported = params_from_numpy(jax.tree.map(np.asarray, prep), pc, device="cpu")
    return jc, pc, prep["layers"][0], ported["layers"][0]


@pytest.mark.parametrize("residual", [False, True], ids=["plain", "residual"])
@pytest.mark.parametrize("stacks", ["bf16_values", "int8"])
@pytest.mark.parametrize("path", ["scan", "dropless"])
def test_mlp_matches_jax(rng, path, stacks, residual):
    over = dict(moe_dropless=path == "dropless", moe_use_residual=residual)
    jc, pc, jlp, plp = _layer_trees(over, stacks == "int8")
    if stacks == "int8":
        assert isinstance(plp["w_in"], QuantizedWeight) and plp["w_in"].q.dtype == torch.int8
        assert plp["w_in"].scale.shape == (4, 64, 1)  # groups of 128 > d_ff: one a row
        assert (not residual) or isinstance(plp["wr_in"], ChannelQuantWeight)
    h = rng.standard_normal((11, 64)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(_jit_mlp(jnp.asarray(h), jlp, jc))
    census = torch.zeros(4, dtype=torch.int64)
    for use_kernel in (True, False):
        got = PM._mlp(_t(h), plp, pc, use_kernel, census)
        np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
    assert int(census.sum()) == 2 * 11 * 2  # two calls, 11 rows, top-2


def test_scan_and_dropless_paths_agree(rng):
    """One layer, the same weights: the scan over the experts and the
    dropless wire give the same FFN (f32, 1e-5), with and without biases."""
    h = _t(rng.standard_normal((13, 64)).astype(np.float32))
    for over in ({}, UNGATED):
        _, pc, _, plp = _layer_trees(over, False)
        scan = PM._mlp(h, plp, pc)
        drop = PM._mlp(h, plp, PT.TransformerConfig(**{**MIXTRAL_TINY, **over,
                                                        "moe_dropless": True}))
        np.testing.assert_allclose(drop.numpy(), scan.numpy(), **F32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_layer_is_the_jax_one(dtype):
    """The expert stacks groupwise (group 128 at d_ff 256), the residual
    expert and attention per channel: codes and scales bit for bit against
    the jitted JAX quantize_layer; router and coefficients untouched."""
    over = dict(moe_use_residual=True, d_ff=256)
    jc = JT.TransformerConfig(**{**MIXTRAL_TINY, **over})
    pc = PT.TransformerConfig(**{**MIXTRAL_TINY, **over})
    tree = numpy_params(jc, seed=5, std=STD)
    jlp = JM.prepare(to_jax(tree), jc)["layers"][0]
    plp = PM.prepare(params_from_numpy(tree, pc, device="cpu"), pc)["layers"][0]
    if dtype == "bfloat16":
        jlp = {k: v.astype(jnp.bfloat16) for k, v in jlp.items()}
        plp = {k: v.bfloat16() for k, v in plp.items()}
    jq, pq = _jit_quantize_layer(jlp, jc), PM.quantize_layer(plp, pc)
    assert sorted(jq) == sorted(pq)
    for name in ("w_gate", "w_in", "w_out"):
        assert isinstance(pq[name], QuantizedWeight) and pq[name].dtype_name == dtype
        np.testing.assert_array_equal(pq[name].q.numpy(), np.asarray(jq[name].q))
        np.testing.assert_array_equal(pq[name].scale.numpy(), np.asarray(jq[name].scale))
    assert pq["w_in"].scale.shape == (4, 64, 2)
    for name in ("w_qkv", "wo", "wr_in", "wr_gate", "wr_out"):
        assert isinstance(pq[name], ChannelQuantWeight), name
        np.testing.assert_array_equal(pq[name].codes().numpy(), np.asarray(jq[name].q))
        np.testing.assert_array_equal(pq[name].scales().numpy(), np.asarray(jq[name].scale))
    for name in ("w_router", "w_coef", "b_coef"):
        assert isinstance(pq[name], torch.Tensor) and pq[name] is plp[name]


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------

def _sync(peng, jeng):
    """Copy the JAX engine's pools into the port's (int8 pools: a code may
    flip at a .5 boundary between the two frameworks' f32 k/v)."""
    c, j = peng.cache, jeng.cache
    for dst, src in zip(c.k + c.v + list(c.k_scale or []) + list(c.v_scale or []),
                        j.k + j.v + list(j.k_scale or []) + list(j.v_scale or [])):
        dst.copy_(_t(np.asarray(src)))


def _engines(form, seed=1):
    over, kv, quant = FORMS[form]
    over = {**MIXTRAL_TINY, **over}
    jc, pc = JT.TransformerConfig(**over), PT.TransformerConfig(**over)
    tree = numpy_params(jc, seed=seed, std=STD)
    cfg = dict(SERVE, kv_cache_dtype=kv)
    jeng = jax_init_inference(to_jax(tree), jc, dict(cfg, decode_impl="xla"),
                              dtype=jnp.float32, quantization=quant)
    peng = init_inference(params_from_numpy(tree, pc, device="cpu"), pc, cfg,
                          dtype=torch.float32, device="cpu", quantization=quant)
    return jeng, peng


@pytest.fixture(scope="module", params=sorted(FORMS))
def scripted(request):
    """A 21-token prompt, then 6 greedy single-token decodes, on a JAX and a
    port engine of one form: each put's logits, and both censuses."""
    form = request.param
    jeng, peng = _engines(form)
    quant = FORMS[form][1] == "int8"
    prompt = np.random.default_rng(13).integers(0, 256, 21).astype(np.int32)
    steps, toks = [], []
    tok = prompt
    for _ in range(7):
        if quant:
            _sync(peng, jeng)
        lj = np.asarray(jeng.put([0], [tok.copy()]))
        lp = peng.put([0], [tok.copy()])
        steps.append((lj, lp))
        toks.append((int(lj[0].argmax()), int(lp[0].argmax())))
        tok = np.array([toks[-1][0]], np.int32)
    return dict(form=form, steps=steps, toks=toks, census=(jeng.moe_expert_census(),
                                                           peng.moe_expert_census()))


def test_engine_logits_match_jax_engine(scripted):
    tol = TOL[FORMS[scripted["form"]][1]]
    for lj, lp in scripted["steps"]:
        assert lp.shape == lj.shape == (1, 256)
        np.testing.assert_allclose(lp, lj, **tol)


def test_engine_greedy_tokens_identical(scripted):
    toks = scripted["toks"]
    assert [t for t, _ in toks] == [p for _, p in toks]
    assert len({t for t, _ in toks}) > 2  # the tokens actually move


def test_engine_census_identical(scripted):
    """moe_expert_census() equal to the JAX engine's, every routed row (pad
    rows included): layers x k x (the 32-row prefill bucket + 6 decode
    buckets of 8)."""
    jc, pc = scripted["census"]
    assert pc.dtype == np.int64 and pc.shape == (4,)
    np.testing.assert_array_equal(pc, jc)
    k = FORMS[scripted["form"]][0].get("moe_top_k", MIXTRAL_TINY["moe_top_k"])
    assert pc.sum() == 2 * k * (32 + 6 * 8)
    assert (pc > 0).sum() >= 2  # the routing moves


@pytest.mark.parametrize("form", sorted(f for f, (_, _, q) in FORMS.items() if q))
def test_int8_weight_lane_keeps_stacks_groupwise(form):
    """The per-channel lane's MoE layer: groupwise int8 expert stacks, the
    attention per channel, the router full precision; nothing dequantized
    at a program's entry (the stacks dequantize inside the MLP)."""
    over, kv, quant = FORMS[form]
    pc = PT.TransformerConfig(**{**MIXTRAL_TINY, **over})
    tree = numpy_params(JT.TransformerConfig(**{**MIXTRAL_TINY, **over}), seed=1, std=STD)
    peng = init_inference(params_from_numpy(tree, pc, device="cpu"), pc, dict(SERVE),
                          dtype=torch.float32, device="cpu", quantization=quant)
    for lp in peng.params["layers"]:
        assert all(isinstance(lp[n], QuantizedWeight) for n in ("w_gate", "w_in", "w_out"))
        assert isinstance(lp["w_qkv"], ChannelQuantWeight)
        assert isinstance(lp["w_router"], torch.Tensor)
    assert peng._dequant(peng.params) is peng.params


def test_generate_matches_jax():
    """generate() (the scheduler in wave mode, fused decode chunks) on the
    dropless top-1 form with the residual: the same tokens and the same
    census as the JAX engine's."""
    jeng, peng = _engines("residual_top1_dropless", seed=2)
    r = np.random.default_rng(4)
    prompts = [list(map(int, r.integers(0, 256, n))) for n in (9, 5, 14)]
    jo = jeng.generate(prompts, max_new_tokens=6)
    po = peng.generate(prompts, max_new_tokens=6)
    assert [list(map(int, o)) for o in po] == [list(map(int, o)) for o in jo]
    assert all(len(o) == 6 for o in po)
    np.testing.assert_array_equal(peng.moe_expert_census(), jeng.moe_expert_census())


def test_scheduler_census_metrics_match_jax():
    """The scheduler's moe_census_tokens, moe_expert_{i}_share and
    moe_imbalance equal the JAX scheduler's (the JAX package's
    test_dropless scheduler case, on both packages)."""
    jeng, peng = _engines("top2_dropless", seed=6)
    r = np.random.default_rng(0)
    prompts = [list(map(int, r.integers(0, 256, 9))) for _ in range(3)]
    cfg = dict(max_num_batched_tokens=32, prefill_chunk=8, warmup=False)
    out = []
    for sched in (JaxScheduler(jeng, JaxSchedulerConfig(**cfg), seed=0),
                  ServingScheduler(peng, ServingSchedulerConfig(**cfg), seed=0)):
        rids = [sched.submit(p, 4, stream=i) for i, p in enumerate(prompts)]
        sched.run()
        assert all(sched.finished[rid].output for rid in rids)
        m = sched.metrics()
        out.append({k: v for k, v in m.items() if k.startswith("moe_")})
    jm, pm = out
    assert sorted(pm) == sorted(jm) and len(pm) == 4 + 2
    for k in jm:
        np.testing.assert_allclose(pm[k], jm[k], rtol=1e-12, err_msg=k)
    assert pm["moe_census_tokens"] > 0 and pm["moe_imbalance"] >= 1.0
    np.testing.assert_allclose(sum(v for k, v in pm.items() if k.endswith("_share")), 1.0)


def test_carried_jax_int8_tree_serves_leaf_for_leaf():
    """A JAX per-channel int8 tree (groupwise expert stacks, [X, E, F] codes
    with f32 scales [X, E, F / 128], per-channel attention and head) carried by
    params_from_numpy: the same codes and scales in the port, and served
    by a port engine equal to the JAX engine serving it (1e-4)."""
    over = {**MIXTRAL_TINY, "d_ff": 256}
    jc, pc = JT.TransformerConfig(**over), PT.TransformerConfig(**over)
    tree = numpy_params(jc, seed=8, std=STD)
    jtree = jax.jit(lambda p: JM.quantize_prepared(p, jc))(JM.prepare(to_jax(tree), jc))
    carried = params_from_numpy(jax.tree.map(np.asarray, jtree), pc, device="cpu")
    for jl, pl in zip(jtree["layers"], carried["layers"]):
        for name, shape in (("w_gate", (4, 64, 256)), ("w_in", (4, 64, 256)),
                            ("w_out", (4, 256, 64))):
            assert isinstance(pl[name], QuantizedWeight)
            assert pl[name].q.shape == shape
            # groups of 128 along the last dim; one a row where 128 does not divide it
            assert pl[name].scale.shape == shape[:2] + (max(1, shape[2] // 128),)
            np.testing.assert_array_equal(pl[name].q.numpy(), np.asarray(jl[name].q))
            np.testing.assert_array_equal(pl[name].scale.numpy(), np.asarray(jl[name].scale))
    prompt = np.random.default_rng(0).integers(0, 256, 21).astype(np.int32)
    cfg = dict(SERVE)
    peng = init_inference(carried, pc, cfg, dtype=torch.float32, device="cpu",
                          quantization=PER_CHANNEL)
    # (the JAX engine takes a quantized tree as given, without the argument)
    jeng = jax_init_inference(jtree, jc, dict(cfg, decode_impl="xla"), dtype=jnp.float32)
    np.testing.assert_allclose(peng.put([0], [prompt]), np.asarray(jeng.put([0], [prompt])),
                               **TOL["auto"])
    # the per-channel lane dequantizes the stacks in the MLP, not at a
    # program's entry
    assert peng._dequant(peng.params) is peng.params


def test_mixtral_8x7b_config_matches_config_from_hf():
    """chip_smoke.py's MIXTRAL_8X7B against the JAX package's config_from_hf
    of mistralai/Mixtral-8x7B-v0.1's config.json: every field, and
    46,702,792,704 parameters in both packages."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    want = config_from_hf(dict(MIXTRAL_8X7B_HF))
    got = PT.TransformerConfig(**cs.MIXTRAL_8X7B)
    for field in ("vocab_size", "n_layers", "n_heads", "kv_heads", "d_model", "ff_dim",
                  "head_dim", "rope_theta", "norm_eps", "n_experts", "moe_top_k",
                  "sliding_window", "tie_embeddings", "is_gated", "act_name"):
        assert getattr(got, field) == getattr(want, field), field
    assert {k: tuple(v[0]) for k, v in PT._layer_shapes(got).items()} == {
        k: tuple(v[0]) for k, v in JT._layer_shapes(want).items()}
    assert PT.param_count(got) == 46_702_792_704

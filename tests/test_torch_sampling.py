"""The port's threefry streams and sampler held against the JAX package's,
on the CPU.

`deepspeed_tpu_torch/utils/prng.py` must give jax.random's threefry words,
fold_in keys, 32-bit random bits and f32 uniforms bit for bit.
`inference/sampling.py` must give the JAX package's tokens (its
sample_tokens run under jax.jit, as its engine runs it) and its filtered
logits (apply_penalty_and_filters) bit for bit, on logits rounded through
bf16 so that ties occur, the ties straddling the k-th place included;
host_oracle_token must equal sample_tokens row by row.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src import prng as jax_prng

from deepspeed_tpu.inference import sampling as JS
from deepspeed_tpu_torch.inference import sampling as PS
from deepspeed_tpu_torch.utils import prng

SEEDS = (0, 1, 2**31 - 1, 2**32 - 1)
DATA = (0, 1, 12345, 2**31, 2**32 - 1)
SHAPES = ((40,), (256,), (32000,))
# tests/test_sampling.py's configurations, and the bench's sampled lane
CONFIGS = [
    dict(do_sample=False),
    dict(do_sample=True, temperature=0.8),
    dict(do_sample=True, temperature=1.2, top_k=7),
    dict(do_sample=True, temperature=0.9, top_p=0.7),
    dict(do_sample=True, temperature=1.0, top_k=9, top_p=0.85, repetition_penalty=1.4),
    dict(do_sample=True, temperature=0.9, top_k=40, top_p=0.95),
]
V = 32000


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread a test: pytest-xdist workers share the CPU, and
    torch's own threads would oversubscribe it (restored after the test)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(words):
    return words.numpy().astype(np.uint32)


def _jax_keys(seed, n):
    return jax.vmap(jax.random.fold_in, in_axes=(None, 0))(
        jax.random.PRNGKey(seed), jnp.arange(n, dtype=jnp.uint32))


def _port_keys(seed, n):
    return prng.fold_in(prng.prng_key(seed), torch.arange(n))


# -- prng ---------------------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
def test_threefry2x32_words(seed):
    r = np.random.default_rng(seed % 1000)
    count = r.integers(0, 2**32, 64, dtype=np.uint64).astype(np.uint32)
    count[:4] = [0, 1, 2**32 - 1, 2**31]
    key = np.asarray(jax.random.PRNGKey(seed))
    want = np.asarray(jax_prng.threefry_2x32(jnp.asarray(key), jnp.asarray(count)))
    y1, y2 = prng.threefry2x32(int(key[0]), int(key[1]), prng.words(count[:32]),
                               prng.words(count[32:]))
    np.testing.assert_array_equal(np.concatenate([_np(y1), _np(y2)]), want)


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_and_fold_in(seed):
    np.testing.assert_array_equal(_np(prng.prng_key(seed)), np.asarray(jax.random.PRNGKey(seed)))
    for d in DATA:
        want = np.asarray(jax.random.fold_in(jax.random.PRNGKey(seed), d))
        np.testing.assert_array_equal(_np(prng.fold_in(prng.prng_key(seed), d)), want)
    # a batch of streams at once, as the engine folds its rows' stream ids
    np.testing.assert_array_equal(_np(_port_keys(seed, 37)), np.asarray(_jax_keys(seed, 37)))


def test_prng_key_range():
    for bad in (2**32, -2**31 - 1):
        with pytest.raises(ValueError):
            prng.prng_key(bad)
    np.testing.assert_array_equal(_np(prng.prng_key(-1)), np.asarray(jax.random.PRNGKey(-1)))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_random_bits_and_uniform(seed, shape):
    for d in (0, 2**32 - 1):
        jkey = jax.random.fold_in(jax.random.PRNGKey(seed), d)
        pkey = prng.fold_in(prng.prng_key(seed), d)
        bits = np.asarray(jax.random.bits(jkey, shape, dtype=jnp.uint32))
        np.testing.assert_array_equal(_np(prng.random_bits(pkey, shape)), bits)
        # the sampler's range, the default one, and one whose scaling rounds
        for lo, hi in ((1e-20, 1.0), (0.0, 1.0), (-2.0, 3.0)):
            want = np.asarray(jax.random.uniform(jkey, shape, minval=lo, maxval=hi))
            got = prng.uniform(pkey, shape, lo, hi).numpy()
            np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_uniform_batched_keys_match_vmap():
    """[S, 2] keys give [S, W] draws, row s that of keys[s], as the JAX
    sampler's vmap over rows draws them."""
    steps = jnp.arange(6, dtype=jnp.int32) * 7 + 3
    want = jax.vmap(lambda k, t: jax.random.uniform(
        jax.random.fold_in(k, t), (40,), minval=jnp.float32(1e-20), maxval=1.0))(
            _jax_keys(9, 6), steps)
    got = prng.uniform(prng.fold_in(_port_keys(9, 6), torch.from_numpy(np.array(steps))),
                       (40,), 1e-20, 1.0)
    np.testing.assert_array_equal(got.numpy().view(np.int32), np.asarray(want).view(np.int32))


# -- the sampler ----------------------------------------------------------------

def _case(S, seed, penalty):
    r = np.random.default_rng(seed)
    logits = torch.from_numpy((r.normal(size=(S, V)) * 3).astype(np.float32))
    logits = logits.bfloat16().float().numpy()  # bf16 values: many ties
    pres = r.integers(0, 2, (S, V)).astype(np.uint8)
    steps = r.integers(0, 5000, S).astype(np.int32)
    return logits, pres if penalty else None, steps


def _jax_run(cfg, logits, pres, steps, seed):
    keys = _jax_keys(seed, logits.shape[0])
    P = None if pres is None else jnp.asarray(pres)
    toks = jax.jit(lambda l, k, s, p: JS.sample_tokens(l, cfg, k, s, presence=p))(
        jnp.asarray(logits), keys, jnp.asarray(steps), P)
    filt = jax.jit(lambda l, p: JS.apply_penalty_and_filters(l, cfg, p))(jnp.asarray(logits), P)
    return np.asarray(toks), np.asarray(filt)


def _port_run(cfg, logits, pres, steps, seed):
    P = None if pres is None else torch.from_numpy(pres)
    toks = PS.sample_tokens(torch.from_numpy(logits), cfg, _port_keys(seed, logits.shape[0]),
                            torch.from_numpy(steps), presence=P)
    return toks.numpy(), PS.apply_penalty_and_filters(torch.from_numpy(logits), cfg, P).numpy()


def _configs(kw, penalty):
    kw = dict(kw, **({"repetition_penalty": 1.3} if penalty and "repetition_penalty" not in kw
                     else {}))
    return JS.SamplingConfig(**kw), PS.SamplingConfig(**kw)


@pytest.mark.parametrize("S", (8, 32))
@pytest.mark.parametrize("penalty", (False, True))
@pytest.mark.parametrize("kw", CONFIGS, ids=lambda kw: "-".join(f"{k}{v}" for k, v in kw.items()))
def test_sample_tokens_match_jax(kw, penalty, S):
    jcfg, pcfg = _configs(kw, penalty)
    logits, pres, steps = _case(S, S + 10 * penalty, penalty)
    jt, jf = _jax_run(jcfg, logits, pres, steps, seed=5)
    pt, pf = _port_run(pcfg, logits, pres, steps, seed=5)
    np.testing.assert_array_equal(pt, jt)
    np.testing.assert_array_equal(pf.view(np.int32), jf.view(np.int32))
    keys = _port_keys(5, S)
    for s in range(S):  # the host oracle replays each row's draw
        got = PS.host_oracle_token(logits[s], pcfg, keys[s].numpy(), int(steps[s]),
                                   presence_row=None if pres is None else pres[s])
        assert got == pt[s], f"row {s}"


def _planted_ties(S, k, seed):
    """bf16 logits whose k-th largest value of each row is shared by a run of
    entries on both sides of the k-th place, scattered over the vocabulary
    (lower and higher indices than the entries above them)."""
    r = np.random.default_rng(seed)
    logits = (r.normal(size=(S, V)) * 3).astype(np.float32)
    for s in range(S):
        order = np.argsort(-logits[s], kind="stable")
        tie = logits[s, order[k - 1]]
        logits[s, order[k - 6:k + 6]] = tie  # 12 entries straddle place k
        logits[s, r.choice(V, 5, replace=False)] = tie
    return torch.from_numpy(logits).bfloat16().float().numpy()


@pytest.mark.parametrize("k", (7, 40))
def test_planted_ties_at_kth_place(k):
    logits = _planted_ties(16, k, seed=k)
    jv, ji = jax.lax.top_k(jnp.asarray(logits), k)
    pv, pi = PS._top_k(torch.from_numpy(logits), k)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
    kw = dict(do_sample=True, temperature=0.9, top_k=k, top_p=0.95)
    jcfg, pcfg = JS.SamplingConfig(**kw), PS.SamplingConfig(**kw)
    steps = np.arange(16, dtype=np.int32) * 11
    jt, jf = _jax_run(jcfg, logits, None, steps, seed=2)
    pt, pf = _port_run(pcfg, logits, None, steps, seed=2)
    np.testing.assert_array_equal(pt, jt)
    np.testing.assert_array_equal(pf.view(np.int32), jf.view(np.int32))
    # the ties change which column gets which draw: a tie order by value
    # alone (the last index first) picks other tokens
    rev = torch.from_numpy(np.ascontiguousarray(logits[:, ::-1]))
    flipped = (V - 1) - PS.sample_tokens(rev, pcfg, _port_keys(2, 16),
                                         torch.from_numpy(steps)).numpy()
    assert (flipped != jt).any()


def test_top_k_order_of_signed_zeros_and_nan():
    x = np.array([[1.0, 3.0, 3.0, 2.0, 3.0, -0.0, 0.0, -0.0, 0.0, np.nan]], np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(x), 10)
    pv, pi = PS._top_k(torch.from_numpy(x), 10)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(pv.numpy().view(np.int32), np.asarray(jv).view(np.int32))


def test_greedy_takes_the_first_maximum():
    logits = np.zeros((3, 64), np.float32)
    logits[0, [5, 9]] = 2.0
    logits[1, [0, 63]] = 1.0
    logits[2] = -1.0
    logits[2, [40, 41, 42]] = -0.5
    cfg = JS.SamplingConfig()
    want = np.asarray(JS.sample_tokens(jnp.asarray(logits), cfg))
    got = PS.sample_tokens(torch.from_numpy(logits), PS.SamplingConfig()).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [5, 0, 40])


def test_presence_helpers_match_jax():
    r = np.random.default_rng(3)
    pres = r.integers(0, 2, (6, 100)).astype(np.uint8)
    toks = np.array([0, 99, 5, -1, 100, 5], np.int32)  # two outside [0, V)
    want = np.asarray(JS.update_presence(jnp.asarray(pres), jnp.asarray(toks)))
    got = PS.update_presence(torch.from_numpy(pres), torch.from_numpy(toks)).numpy()
    np.testing.assert_array_equal(got, want)
    prompts = [[1, 2, 2, 99], [], [150, -3, 7]]
    np.testing.assert_array_equal(PS.presence_from_prompts(prompts, 100, 4),
                                  JS.presence_from_prompts(prompts, 100, 4))


def test_config_surface():
    c = PS.SamplingConfig(do_sample=True, temperature=0.0)
    assert c.greedy and not c.needs_presence
    assert PS.SamplingConfig(repetition_penalty=1.2).needs_presence
    assert PS.SamplingConfig(top_k=3).key() == JS.SamplingConfig(top_k=3).key()
    with pytest.raises(dataclasses.FrozenInstanceError):
        c.top_k = 3


def test_oracle_margin_names_the_drawn_token():
    logits, _, steps = _case(4, 1, False)
    cfg = PS.SamplingConfig(**CONFIGS[-1])
    keys = _port_keys(0, 4)
    for s in range(4):
        m = PS.oracle_margin(logits[s], cfg, keys[s].numpy(), int(steps[s]))
        assert m["candidates"][0] == PS.host_oracle_token(logits[s], cfg, keys[s].numpy(),
                                                          int(steps[s]))
        assert m["gap"] >= 0

"""PyTorch port: JAX's random streams (prng.py, ops/threefry.py) against
jax.random on the CPU, on seeded keys and on batched keys (one per world,
as the port draws them where JAX vmaps).

Bars: key words, bits and integers equal; uniform floats equal bit for
bit, scaled ranges too (the port rounds the scale and shift once, as
XLA's fused multiply-add does); normal, truncated normal and Gumbel draws
within 1e-6 (log and log1p differ by an ulp between XLA and PyTorch);
flax's initial parameters within 1e-5 (the orthogonal initialiser's QR).
No JAX env is compiled here."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

import chip_smoke
from marl_hideandseek_tpu.models import rnn as jrnn
from marl_hideandseek_torch import prng
from marl_hideandseek_torch.models.layers import Dense, draw_params
from marl_hideandseek_torch.models.rnn import LSTM
from marl_hideandseek_torch.ops import threefry as tf

# Random123's known answers for threefry2x32-20 (kat_vectors), as JAX's
# own tests hold them (tests/random_test.py, testThreefry2x32).
KNOWN = [((0x00000000, 0x00000000), (0x00000000, 0x00000000),
          (0x6b200159, 0x99ba4efe)),
         ((0xffffffff, 0xffffffff), (0xffffffff, 0xffffffff),
          (0x1cb996fc, 0xbb002be7)),
         ((0x13198a2e, 0x03707344), (0x243f6a88, 0x85a308d3),
          (0xc4923a9c, 0x483df7a0))]
FLOAT_BAR = 1e-6
INIT_BAR = 1e-5


def u32(x: torch.Tensor) -> np.ndarray:
    if x.dtype == torch.uint32:
        return x.view(torch.int32).numpy().view(np.uint32)
    return x.numpy()


def keys(n, seed=3):
    """n JAX keys and the same words as a port key tensor."""
    ks = jax.random.split(jax.random.PRNGKey(seed), n)
    return ks, prng.as_key(np.asarray(ks))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("k,ctr,want", KNOWN)
def test_threefry_known_answers(k, ctr, want):
    out = tf.threefry(prng.as_key(np.array([k], np.uint32)),
                      prng.as_key(np.array([[ctr]], np.uint32)))
    assert tuple(int(v) for v in u32(out)[0, 0]) == want


@pytest.mark.parametrize("seed", [0, 1, 5, 42, 2 ** 31 + 3, -7])
def test_key_matches_jax(seed):
    np.testing.assert_array_equal(u32(prng.key(seed)),
                                  np.asarray(jax.random.PRNGKey(seed)))


def test_split_fold_in_and_bits_match_jax():
    k = jax.random.PRNGKey(11)
    tk = prng.key(11)
    np.testing.assert_array_equal(u32(prng.split(tk, 7)),
                                  np.asarray(jax.random.split(k, 7)))
    np.testing.assert_array_equal(u32(prng.fold_in(tk, 2000)),
                                  np.asarray(jax.random.fold_in(k, 2000)))
    jk, tks = keys(6)
    data = np.array([0, 1, 7, 1000, 2 ** 32 - 1, 123456], np.uint32)
    tdata = torch.from_numpy(data.astype(np.int64))
    np.testing.assert_array_equal(   # batched keys and data
        u32(prng.fold_in(tks, tdata)),
        np.asarray(jax.vmap(jax.random.fold_in)(jk, data)))
    np.testing.assert_array_equal(   # one key, many data
        u32(prng.fold_in(tk, tdata)),
        np.asarray(jax.vmap(lambda d: jax.random.fold_in(k, d))(data)))
    np.testing.assert_array_equal(   # batched keys, one datum
        u32(prng.fold_in(tks, 9)),
        np.asarray(jax.vmap(lambda kk: jax.random.fold_in(kk, 9))(jk)))
    np.testing.assert_array_equal(
        u32(prng.split(tks, 4)), np.asarray(jax.vmap(
            lambda kk: jax.random.split(kk, 4))(jk)))
    for shape in [(), (5,), (3, 7)]:
        np.testing.assert_array_equal(
            u32(prng.bits(tks, shape)), np.asarray(jax.vmap(
                lambda kk: jax.random.bits(kk, shape))(jk)))
    np.testing.assert_array_equal(u32(prng.bits(tk, (1000,))),
                                  np.asarray(jax.random.bits(k, (1000,))))


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-18.0, 18.0),
                                   (0.0, 3.14159), (0.1, 10.0),
                                   (-0.99999994, 1.0)])
def test_uniform_matches_jax_bit_for_bit(lo, hi):
    jk, tks = keys(16)
    got = prng.uniform(tks, (50, 3), lo, hi)
    want = jax.vmap(lambda kk: jax.random.uniform(
        kk, (50, 3), minval=lo, maxval=hi))(jk)
    np.testing.assert_array_equal(u32(got).view(np.uint32),
                                  np.asarray(want).view(np.uint32))


@pytest.mark.parametrize("lo,hi", [(0, 2), (3, 10), (0, 1), (5, 5), (9, 4),
                                   (-3, 100000), (0, 2 ** 31 - 1),
                                   (-2 ** 31, 2 ** 31 - 1)])
def test_randint_matches_jax(lo, hi):
    jk, tks = keys(8)
    got = prng.randint(tks, (40,), lo, hi)
    want = jax.vmap(lambda kk: jax.random.randint(kk, (40,), lo, hi))(jk)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_randint_per_world_bounds_match_jax():
    """Traced bounds, one per world's key (the level generator's wall
    picks): equal to JAX's vmapped randint."""
    jk, tks = keys(64, seed=4)
    rng = np.random.default_rng(0)
    lo = rng.integers(-5, 5, 64).astype(np.int32)
    hi = (lo + rng.integers(0, 40, 64)).astype(np.int32)
    got = prng.randint(tks, (), torch.from_numpy(lo), torch.from_numpy(hi))
    want = jax.vmap(lambda kk, a, b: jax.random.randint(kk, (), a, b))(
        jk, lo, hi)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_bernoulli_and_categorical_match_jax():
    jk, tks = keys(8)
    for p in (0.5, 0.3):
        np.testing.assert_array_equal(
            prng.bernoulli(tks, p, (100,)).numpy(), np.asarray(jax.vmap(
                lambda kk: jax.random.bernoulli(kk, p, (100,)))(jk)))
    rng = np.random.default_rng(1)
    logits = (2.0 * rng.standard_normal((64, 5, 19))).astype(np.float32)
    k = jax.random.PRNGKey(8)
    np.testing.assert_array_equal(
        prng.categorical(prng.key(8), torch.from_numpy(logits)).numpy(),
        np.asarray(jax.random.categorical(k, logits)))
    # One key per row (batched logits).
    np.testing.assert_array_equal(
        prng.categorical(tks, torch.from_numpy(logits[:8])).numpy(),
        np.asarray(jax.vmap(jax.random.categorical)(jk, logits[:8])))


@pytest.mark.parametrize("n", [1, 5, 100, 1625, 1626, 3000])
def test_permutation_matches_jax(n):
    """n on both sides of _shuffle's one-round threshold (1,625)."""
    k = jax.random.PRNGKey(n)
    np.testing.assert_array_equal(
        prng.permutation(prng.key(n), n).numpy(),
        np.asarray(jax.random.permutation(k, n)))


def test_normal_gumbel_and_truncated_normal_within_bar():
    jk, tks = keys(16, seed=6)
    pairs = [
        (prng.normal(tks, (4000,)),
         jax.vmap(lambda kk: jax.random.normal(kk, (4000,)))(jk)),
        (prng.gumbel(tks, (4000,)),
         jax.vmap(lambda kk: jax.random.gumbel(kk, (4000,)))(jk)),
        (prng.truncated_normal(tks, -2.0, 2.0, (4000,)),
         jax.vmap(lambda kk: jax.random.truncated_normal(
             kk, -2.0, 2.0, (4000,)))(jk)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=FLOAT_BAR)


@pytest.mark.parametrize("n,m", [(64, 256), (300, 64), (32, 32)])
def test_orthogonal_matches_jax(n, m):
    k = jax.random.PRNGKey(n + m)
    got = prng.orthogonal(prng.key(n + m), n, m)
    want = jax.random.orthogonal(k, n, (), jnp.float32, m)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=INIT_BAR)


def _assert_params_close(flat_flax, got):
    assert set(flat_flax) == set(got)
    for name, v in flat_flax.items():
        np.testing.assert_allclose(got[name][0].numpy(), np.asarray(v),
                                   rtol=0, atol=INIT_BAR, err_msg=name)


def test_flax_key_derivation_matches_flax():
    """flax's init of one Dense and one two-layer LSTM from a key: the
    port derives each parameter's key as flax does (a SHA-1 of the
    module path and the parameter's count folded into the key) and draws
    the same orthogonal kernels."""
    from marl_hideandseek_torch.bridge import flatten_tree

    k = jax.random.PRNGKey(17)
    tk = prng.key(17)[None]
    x = np.ones((3, 12), np.float32)
    dense = nn.Dense(24, kernel_init=jax.nn.initializers.orthogonal(2.0))
    want = flatten_tree(jax.tree.map(np.asarray,
                                     dense.init(k, x)["params"]))
    from marl_hideandseek_torch.models.layers import orthogonal
    got = draw_params(Dense(1, 12, 24, kernel_init=orthogonal(2.0)), tk)
    _assert_params_close(want, got)

    jl = jrnn.LSTM(num_hidden_channels=16, num_layers=2)
    st = tuple(np.zeros((2, 3, 16), np.float32) for _ in range(2))
    want = flatten_tree(jax.tree.map(np.asarray,
                                     jl.init(k, st, x)["params"]))
    got = draw_params(LSTM(1, 12, 16, num_layers=2), tk)
    _assert_params_close(want, got)


def _jax_table():
    """chip_smoke.THREEFRY_TABLE's entries, recomputed with jax.random."""
    def u(x):
        return np.asarray(x).astype(np.uint32).astype(np.int64).tolist()

    def i(x):
        return np.asarray(x).astype(np.int64).tolist()

    k = jax.random.PRNGKey(42)
    logits = ((np.arange(30).reshape(6, 5) * 3) % 7 / 4.0 - 0.75).astype(
        np.float32)
    perm = np.asarray(jax.random.permutation(k, 2000)).astype(np.int64)
    bits32 = lambda x: jax.lax.bitcast_convert_type(x, jnp.uint32)
    return {
        "key": u(k),
        "split": u(jax.random.split(k, 3)),
        "fold_in": u(jax.random.fold_in(k, 1000)),
        "episode_keys": u(jax.vmap(lambda w: jax.random.fold_in(
            jax.random.fold_in(jax.random.PRNGKey(5), w), 7))(
                jnp.arange(4, dtype=jnp.uint32))),
        "bits": u(jax.random.bits(k, (8,))),
        "uniform": u(bits32(jax.random.uniform(k, (8,)))),
        "uniform_scaled": u(bits32(jax.random.uniform(
            k, (8,), minval=-18.0, maxval=18.0))),
        "randint": i(jax.random.randint(k, (8,), 0, 10)),
        "randint_batched": i(jax.vmap(
            lambda kk, m: jax.random.randint(kk, (), 0, m))(
                jax.random.split(jax.random.PRNGKey(7), 4),
                jnp.array([3, 5, 7, 9]))),
        "categorical": i(jax.random.categorical(k, logits)),
        "permutation": i(jax.random.permutation(k, 12)),
        "permutation_2000": [int(np.sum(perm * np.arange(2000))),
                             *perm[:4].tolist()],
    }


def test_chip_smoke_table_matches_jax():
    """The table chip_smoke.py holds the card's draws to is JAX's, and
    the port draws it on the CPU."""
    want = _jax_table()
    assert json.dumps(chip_smoke.THREEFRY_TABLE, sort_keys=True) == \
        json.dumps(want, sort_keys=True)
    assert chip_smoke.threefry_table("cpu") == chip_smoke.THREEFRY_TABLE


"""The port's flip / permute / contrast augmentation against
``ops/augment.py`` of the JAX package.

``jax.random`` and ``torch.Generator`` give different numbers, so each
deterministic apply gets the parameters the JAX function draws from its key
(the same ``jax.random`` calls) and must reproduce that function's output;
the symmetries are also held to the numpy oracle ``permute_data_np``. The
port's own draws are checked by their statistics, and a seeded generator
must repeat its batch exactly.

Tolerance: flips and symmetries move values and must be exact; contrast
takes a population std in fp32 sums of another order: atol 1e-5.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from fetal_mri_segmentation_tpu.ops import augment as JA  # noqa: E402
from fetal_mri_segmentation_tpu_torch.ops import augment as TA  # noqa: E402

torch.set_num_threads(1)
CONTRAST_ATOL = 1e-5


def _example(seed, shape=(2, 5, 5, 5)):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    y = (rng.random((1,) + shape[1:]) > 0.5).astype(np.float32)
    return x, y


def test_symmetry_tables_match_jax():
    assert TA.PERMUTATION_KEYS == JA.PERMUTATION_KEYS
    assert len(TA.PERMUTATION_KEYS) == 48
    assert TA.INVERSE_KEY_INDEX == JA.INVERSE_KEY_INDEX


def test_every_symmetry_matches_jax_and_the_numpy_oracle():
    x, _ = _example(0)
    jperm = jax.jit(JA.permute_data)
    jrev = jax.jit(JA.reverse_permute_data)
    xt = torch.from_numpy(x)
    for i, key in enumerate(TA.PERMUTATION_KEYS):
        got = TA.permute_data(xt, i).numpy()
        np.testing.assert_array_equal(got, TA.permute_data_np(x, key))
        np.testing.assert_array_equal(got, JA.permute_data_np(x, key))
        np.testing.assert_array_equal(got, np.asarray(jperm(x, i)))
        back = TA.reverse_permute_data(torch.from_numpy(got), i).numpy()
        np.testing.assert_array_equal(back, np.asarray(jrev(got, i)))
        np.testing.assert_array_equal(back, x)


@pytest.mark.parametrize("i", range(48))
def test_static_symmetry_equals_permute_data(i):
    """``permute_volume`` (test-time augmentation's static permute and
    flips) is the same symmetry as ``permute_data`` for every key, with
    leading axes of any count, and ``reverse_permute_volume`` undoes it."""
    x, _ = _example(i, shape=(2, 4, 4, 4))
    xt = torch.from_numpy(x)
    want = TA.permute_data(xt, i).numpy()
    np.testing.assert_array_equal(want, JA.permute_data_np(
        x, JA.PERMUTATION_KEYS[i]))
    np.testing.assert_array_equal(TA.permute_volume(xt, i).numpy(), want)
    np.testing.assert_array_equal(
        TA.permute_volume(xt[None, None], i)[0, 0].numpy(), want)
    np.testing.assert_array_equal(
        TA.reverse_permute_volume(torch.from_numpy(want), i).numpy(), x)
    np.testing.assert_array_equal(
        TA.reverse_permute_volume(torch.from_numpy(want), i).numpy(),
        TA.reverse_permute_data(torch.from_numpy(want), i).numpy())


def test_batched_permutation_takes_one_symmetry_per_example():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(6, 1, 4, 4, 4)).astype(np.float32)
    index = np.array([0, 5, 17, 30, 41, 47])
    got = TA.permute_batch(torch.from_numpy(x), torch.from_numpy(index))
    for b, i in enumerate(index):
        np.testing.assert_array_equal(
            got[b].numpy(), TA.permute_data_np(x[b], TA.PERMUTATION_KEYS[i]))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_flip_apply_matches_jax_random_flip(seed):
    x, y = _example(seed, shape=(2, 3, 4, 5))   # flips take any shape
    key = jax.random.PRNGKey(seed)
    flips = np.array(jax.random.bernoulli(key, 0.5, (3,)))
    wx, wy = JA.random_flip(key, jnp.asarray(x), jnp.asarray(y))
    f = torch.from_numpy(flips)[None]
    np.testing.assert_array_equal(
        TA.apply_flip(torch.from_numpy(x)[None], f)[0].numpy(), wx)
    np.testing.assert_array_equal(
        TA.apply_flip(torch.from_numpy(y)[None], f)[0].numpy(), wy)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_permutation_apply_matches_jax_random_permutation(seed):
    x, y = _example(seed)
    key = jax.random.PRNGKey(seed)
    index = int(jax.random.randint(key, (), 0, 48))
    wx, wy = JA.random_permutation_x_y(key, jnp.asarray(x), jnp.asarray(y))
    i = torch.tensor([index])
    np.testing.assert_array_equal(
        TA.permute_batch(torch.from_numpy(x)[None], i)[0].numpy(), wx)
    np.testing.assert_array_equal(
        TA.permute_batch(torch.from_numpy(y)[None], i)[0].numpy(), wy)


def _jax_contrast_draw(key, factor):
    k_scale, k_shift = jax.random.split(key)
    return (float(jax.random.uniform(k_scale, (), minval=1 - factor,
                                     maxval=1 + factor)),
            float(jax.random.uniform(k_shift, (), minval=-factor,
                                     maxval=factor)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_contrast_apply_matches_jax_random_contrast(seed):
    x, _ = _example(seed)
    key = jax.random.PRNGKey(seed)
    scale, shift = _jax_contrast_draw(key, 0.1)
    want = JA.random_contrast(key, jnp.asarray(x), 0.1)
    got = TA.apply_contrast(torch.from_numpy(x)[None],
                            torch.tensor([scale]), torch.tensor([shift]))[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=CONTRAST_ATOL)


def test_contrast_uses_the_population_std():
    x = torch.tensor([[[[[1.0, 3.0]]]]])   # std 1 (population), not sqrt 2
    got = TA.apply_contrast(x, torch.tensor([1.0]), torch.tensor([1.0]))
    torch.testing.assert_close(got, x + 1.0)


@pytest.mark.parametrize("seed", [0, 7])
def test_augment_example_applies_match_jax_in_its_order(seed):
    """flip, then permute, then contrast, each with the draw the JAX
    ``augment_example`` makes from its split key."""
    x, y = _example(seed)
    key = jax.random.PRNGKey(seed)
    _, _, k_flip, k_perm, k_con = jax.random.split(key, 5)
    flips = torch.from_numpy(np.array(
        jax.random.bernoulli(k_flip, 0.5, (3,))))[None]
    index = torch.tensor([int(jax.random.randint(k_perm, (), 0, 48))])
    scale, shift = _jax_contrast_draw(k_con, 0.1)
    wx, wy = JA.augment_example(key, jnp.asarray(x), jnp.asarray(y),
                                flip=True, permute=True, contrast=0.1)
    gx = TA.permute_batch(TA.apply_flip(torch.from_numpy(x)[None], flips),
                          index)
    gy = TA.permute_batch(TA.apply_flip(torch.from_numpy(y)[None], flips),
                          index)
    gx = TA.apply_contrast(gx, torch.tensor([scale]), torch.tensor([shift]))
    np.testing.assert_array_equal(gy[0].numpy(), wy)
    np.testing.assert_allclose(gx[0].numpy(), np.asarray(wx),
                               atol=CONTRAST_ATOL)


def test_draw_statistics():
    g = torch.Generator().manual_seed(0)
    flips = TA.draw_flips(g, 20000).float()
    assert flips.shape == (20000, 3)
    assert torch.all((flips.mean(0) - 0.5).abs() < 0.015), flips.mean(0)
    index = TA.draw_permutations(g, 48 * 100)
    counts = torch.bincount(index, minlength=48)
    assert counts.numel() == 48 and int(counts.min()) > 0
    assert int(counts.max()) < 3 * 100
    scale, shift = TA.draw_contrast(g, 5000, 0.1)
    assert 0.9 <= float(scale.min()) and float(scale.max()) <= 1.1
    assert -0.1 <= float(shift.min()) and float(shift.max()) <= 0.1
    assert float(scale.max() - scale.min()) > 0.19
    assert float(shift.max() - shift.min()) > 0.19


def test_each_example_draws_its_own_symmetry():
    x = torch.arange(64, dtype=torch.float32).reshape(1, 1, 4, 4, 4)
    x = x.expand(6, 1, 4, 4, 4).contiguous()
    g = torch.Generator().manual_seed(3)
    out, _ = TA.augment_batch(g, x, x.clone(), flip=True, permute=True)
    distinct = {tuple(e.flatten().tolist()) for e in out}
    assert len(distinct) > 1


def test_seeded_generator_repeats_its_batch():
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(4, 1, 6, 6, 6)).astype(np.float32))
    y = torch.from_numpy((rng.random((4, 1, 6, 6, 6)) > 0.5).astype(
        np.uint8))
    runs = [TA.augment_batch(torch.Generator().manual_seed(s), x, y,
                             flip=True, permute=True, contrast=0.1)
            for s in (11, 11, 12)]
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1]) and runs[0][1].dtype == y.dtype
    assert not torch.equal(runs[0][0], runs[2][0])
    ex, ey = TA.augment_example(torch.Generator().manual_seed(11), x[0], y[0],
                                contrast=0.1)
    assert ex.shape == x[0].shape and ey.shape == y[0].shape


def test_permutation_needs_cubic_patches():
    x = torch.zeros(1, 1, 4, 4, 6)
    with pytest.raises(ValueError, match="cubic"):
        TA.random_permutation_x_y(torch.Generator(), x, x)
    with pytest.raises(ValueError, match="cubic"):
        JA.random_permutation_x_y(jax.random.PRNGKey(0), jnp.zeros((1, 4, 4, 6)),
                                  jnp.zeros((1, 4, 4, 6)))

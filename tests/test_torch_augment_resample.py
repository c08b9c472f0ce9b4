"""The port's scale and rotation augmentation against ``random_scale`` and
``random_rotation`` of the JAX package (``jax.scipy.ndimage.
map_coordinates``, order 1 for the data and order 0 for the truth).

``jax.random`` and ``torch.Generator`` give different numbers, so each
deterministic apply (``apply_scale``, ``apply_rotation``) gets the factors
or angles that the JAX function draws from its key (the same ``jax.random``
calls) and must reproduce that function's output. The port's own draws are
checked by their statistics.

Tolerance: the data within 1e-5 (fp32 trilinear sums; the port makes the
rotation matrix in float64 and rounds it once, JAX makes it in fp32, so the
source coordinates differ by an fp32 ulp); the truth EQUAL voxel for voxel,
ties at x.5 included (JAX rounds them away from zero, ``torch.round`` to
even).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from fetal_mri_segmentation_tpu.ops import augment as JA  # noqa: E402
from fetal_mri_segmentation_tpu_torch.config import Config  # noqa: E402
from fetal_mri_segmentation_tpu_torch.models import build_model  # noqa: E402
from fetal_mri_segmentation_tpu_torch.ops import augment as TA  # noqa: E402
from fetal_mri_segmentation_tpu_torch.training.state import (  # noqa: E402
    create_train_state)
from fetal_mri_segmentation_tpu_torch.training.train_step import (  # noqa: E402
    make_train_step)

torch.set_num_threads(1)
X_ATOL = 1e-5
SHAPES = [(16, 16, 16), (12, 16, 10), (15, 15, 15)]


def _example(seed, spatial, channels=2):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(channels,) + spatial).astype(np.float32)
    y = (rng.random((1,) + spatial) > 0.5).astype(np.float32)
    return x, y


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_factors(key, dev):
    return np.asarray(jnp.maximum(1.0 + dev * jax.random.normal(key, (3,)),
                                  0.1))


def _jax_angles(key, max_deg):
    return np.asarray(jax.random.uniform(
        key, (3,), minval=-max_deg, maxval=max_deg) * (jnp.pi / 180.0))


@pytest.mark.parametrize("spatial", SHAPES, ids=str)
@pytest.mark.parametrize("seed", range(4))
def test_apply_scale_matches_jax(spatial, seed):
    x, y = _example(seed, spatial)
    key = jax.random.PRNGKey(seed)
    want_x, want_y = JA.random_scale(key, jnp.asarray(x), jnp.asarray(y),
                                     0.25)
    got_x, got_y = TA.apply_scale(_t(x)[None], _t(y)[None],
                                  _t(_jax_factors(key, 0.25))[None])
    assert got_x.dtype == torch.float32 and got_x.shape[1:] == x.shape
    np.testing.assert_allclose(got_x[0].numpy(), np.asarray(want_x),
                               atol=X_ATOL, rtol=0)
    np.testing.assert_array_equal(got_y[0].numpy(), np.asarray(want_y))


@pytest.mark.parametrize("spatial", SHAPES, ids=str)
@pytest.mark.parametrize("seed", range(4))
def test_apply_rotation_matches_jax(spatial, seed):
    x, y = _example(seed + 10, spatial)
    key = jax.random.PRNGKey(seed)
    want_x, want_y = JA.random_rotation(key, jnp.asarray(x), jnp.asarray(y),
                                        15.0)
    got_x, got_y = TA.apply_rotation(_t(x)[None], _t(y)[None],
                                     _t(_jax_angles(key, 15.0))[None])
    assert got_x.dtype == torch.float32
    np.testing.assert_allclose(got_x[0].numpy(), np.asarray(want_x),
                               atol=X_ATOL, rtol=0)
    np.testing.assert_array_equal(got_y[0].numpy(), np.asarray(want_y))


def _scale_by(factors, x, y):
    """``random_scale``'s body with chosen factors (its own code from the
    clamp on), so ties can be placed."""
    spatial = x.shape[1:]
    centers = [(s - 1) / 2.0 for s in spatial]
    grids = jnp.meshgrid(*[jnp.arange(s, dtype=jnp.float32) for s in spatial],
                         indexing="ij")
    coords = [c + (g - c) / f for g, c, f in zip(grids, centers, factors)]
    fn = jax.scipy.ndimage.map_coordinates
    return (jax.vmap(lambda v: fn(v, coords, order=1, mode="constant",
                                  cval=0.0))(jnp.asarray(x)),
            jax.vmap(lambda v: fn(v, coords, order=0, mode="constant",
                                  cval=0.0))(jnp.asarray(y)))


@pytest.mark.parametrize("spatial,factors", [
    ((16, 16, 16), (0.5, 1.0, 0.5)),   # centre 7.5: c + 2 (g - c) is x.5
    ((15, 15, 15), (2.0, 2.0, 1.0)),   # centre 7: c + (g - c) / 2 is x.5
    ((8, 12, 6), (0.5, 2.0, 0.5)),
], ids=str)
def test_ties_round_away_from_zero_like_jax(spatial, factors):
    """Every output voxel's source coordinate is exactly x.5 along the
    scaled axes: the truth must pick the voxel ``lax.round`` picks (half
    away from zero), where ``torch.round`` would pick the even one."""
    x, y = _example(3, spatial)
    y = np.arange(np.prod(spatial), dtype=np.float32).reshape((1,) + spatial)
    want_x, want_y = _scale_by(factors, x, y)
    got_x, got_y = TA.apply_scale(_t(x)[None], _t(y)[None],
                                  torch.tensor([factors]))
    np.testing.assert_array_equal(got_y[0].numpy(), np.asarray(want_y))
    np.testing.assert_allclose(got_x[0].numpy(), np.asarray(want_x),
                               atol=X_ATOL, rtol=0)
    # the tie is real: rounding to even gives another truth
    f = torch.tensor(factors)
    c = (spatial[0] - 1) / 2.0
    coords = c + (torch.arange(spatial[0], dtype=torch.float32) - c) / f[0]
    assert bool(((coords - coords.floor()) == 0.5).any())
    assert not torch.equal(torch.round(coords).long(),
                           TA._round_half_away(coords))


def test_round_half_away_from_zero():
    v = torch.tensor([-2.5, -1.5, -0.5, -0.49999997, 0.0, 0.49999997, 0.5,
                      1.5, 2.5, 31.5, 8388607.5])
    want = np.asarray(jax.lax.round(jnp.asarray(v.numpy()))).astype(np.int64)
    np.testing.assert_array_equal(TA._round_half_away(v).numpy(), want)
    assert TA._round_half_away(torch.tensor([0.49999997])).item() == 0


@pytest.mark.parametrize("transform", ["scale", "rotation"])
def test_bf16_input_comes_back_fp32_like_jax(transform):
    """x staged as bf16 (the loop's staging for a bf16 model) is resampled
    in fp32 from the bf16-rounded values, as ``x.astype(jnp.float32)``."""
    x, y = _example(7, (12, 12, 12))
    xb = _t(x).to(torch.bfloat16)
    key = jax.random.PRNGKey(5)
    jx = jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16)
    if transform == "scale":
        want_x, want_y = JA.random_scale(key, jx, jnp.asarray(y), 0.25)
        got_x, got_y = TA.apply_scale(xb[None], _t(y)[None],
                                      _t(_jax_factors(key, 0.25))[None])
    else:
        want_x, want_y = JA.random_rotation(key, jx, jnp.asarray(y), 15.0)
        got_x, got_y = TA.apply_rotation(xb[None], _t(y)[None],
                                         _t(_jax_angles(key, 15.0))[None])
    assert want_x.dtype == jnp.float32 and got_x.dtype == torch.float32
    np.testing.assert_allclose(got_x[0].numpy(), np.asarray(want_x),
                               atol=X_ATOL, rtol=0)
    np.testing.assert_array_equal(got_y[0].numpy(), np.asarray(want_y))


def test_uint8_truth_keeps_its_dtype():
    x, y = _example(2, (10, 10, 10))
    yb = _t(y).to(torch.uint8)
    _, got = TA.apply_scale(_t(x)[None], yb[None],
                            torch.tensor([[0.8, 1.1, 1.3]]))
    _, want = TA.apply_scale(_t(x)[None], _t(y)[None],
                             torch.tensor([[0.8, 1.1, 1.3]]))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_each_example_takes_its_own_parameters():
    """A batch with per-example factors and angles equals the examples
    transformed one by one (and the identity leaves both unchanged)."""
    xs, ys = zip(*[_example(s, (10, 12, 8)) for s in range(3)])
    x, y = _t(np.stack(xs)), _t(np.stack(ys))
    factors = torch.tensor([[1.0, 1.0, 1.0], [0.7, 1.2, 0.9],
                            [1.4, 0.6, 1.1]])
    angles = torch.tensor([[0.0, 0.0, 0.0], [0.2, -0.1, 0.05],
                           [-0.25, 0.15, 0.1]])
    for fn, p in ((TA.apply_scale, factors), (TA.apply_rotation, angles)):
        bx, by = fn(x, y, p)
        for i in range(3):
            ox, oy = fn(x[i:i + 1], y[i:i + 1], p[i:i + 1])
            torch.testing.assert_close(bx[i:i + 1], ox, atol=0, rtol=0)
            torch.testing.assert_close(by[i:i + 1], oy, atol=0, rtol=0)
        torch.testing.assert_close(bx[0], x[0], atol=0, rtol=0)
        torch.testing.assert_close(by[0], y[0], atol=0, rtol=0)


def test_rotation_matrix_is_rz_ry_rx():
    a = np.array([0.3, -0.2, 0.5])
    ca, sa = np.cos(a), np.sin(a)
    rx = np.array([[1, 0, 0], [0, ca[0], -sa[0]], [0, sa[0], ca[0]]])
    ry = np.array([[ca[1], 0, sa[1]], [0, 1, 0], [-sa[1], 0, ca[1]]])
    rz = np.array([[ca[2], -sa[2], 0], [sa[2], ca[2], 0], [0, 0, 1]])
    got = TA.rotation_matrices(torch.tensor(a[None], dtype=torch.float32))
    np.testing.assert_allclose(got[0].numpy(), rz @ ry @ rx, atol=1e-7)


def test_draws_mean_spread_clamp_and_range():
    g = torch.Generator().manual_seed(0)
    f = TA.draw_scale_factors(g, 20000, 0.25)
    assert f.shape == (20000, 3) and f.dtype == torch.float32
    assert abs(f.mean().item() - 1.0) < 0.01
    assert abs(f.std().item() - 0.25) < 0.01
    assert f.min().item() >= 0.1
    # a deviation that sends many draws below the clamp
    f = TA.draw_scale_factors(g, 20000, 2.0)
    assert f.min().item() == pytest.approx(0.1) and (f == 0.1).any()
    a = TA.draw_rotation_angles(g, 20000, 15.0)
    lim = 15.0 * np.pi / 180.0
    assert a.shape == (20000, 3)
    assert a.min().item() >= -lim and a.max().item() <= lim
    assert abs(a.mean().item()) < 0.01
    assert abs(a.std().item() - 2 * lim / np.sqrt(12)) < 0.005
    # per example: the rows of one draw differ
    assert not torch.equal(a[0], a[1])


def test_seeded_generator_repeats_the_batch():
    xs, ys = zip(*[_example(s, (8, 8, 8)) for s in range(2)])
    x, y = _t(np.stack(xs)), _t(np.stack(ys))
    kw = dict(flip=True, permute=True, contrast=0.1, scale_deviation=0.25,
              rotate=15.0)
    a = TA.augment_batch(torch.Generator().manual_seed(4), x, y, **kw)
    b = TA.augment_batch(torch.Generator().manual_seed(4), x, y, **kw)
    c = TA.augment_batch(torch.Generator().manual_seed(5), x, y, **kw)
    torch.testing.assert_close(a[0], b[0], atol=0, rtol=0)
    torch.testing.assert_close(a[1], b[1], atol=0, rtol=0)
    assert not torch.equal(a[0], c[0])


def test_augment_batch_order_is_scale_rotate_flip_permute_contrast(
        monkeypatch):
    """The JAX package's order (``augment_example``): scale, rotate, flip,
    permute, contrast; a transform that is off is not called and draws
    nothing."""
    calls = []
    for name in ("random_scale", "random_rotation", "random_flip",
                 "random_permutation_x_y"):
        monkeypatch.setattr(TA, name, lambda g, x, y, *a, _n=name:
                            (calls.append(_n), (x, y))[1])
    monkeypatch.setattr(TA, "random_contrast", lambda g, x, f:
                        (calls.append("random_contrast"), x)[1])
    x, y = map(_t, _example(0, (4, 4, 4)))
    g = torch.Generator()
    TA.augment_batch(g, x[None], y[None], flip=True, permute=True,
                     contrast=0.1, scale_deviation=0.25, rotate=15.0)
    assert calls == ["random_scale", "random_rotation", "random_flip",
                     "random_permutation_x_y", "random_contrast"]
    calls.clear()
    TA.augment_batch(g, x[None], y[None], flip=True, permute=False,
                     scale_deviation=None, rotate=0)
    assert calls == ["random_flip"]
    import inspect
    src = inspect.getsource(JA.augment_example)
    order = [src.index(f"x, y = {n}(") for n in
             ("random_scale", "random_rotation", "random_flip",
              "random_permutation_x_y")]
    assert order == sorted(order) < [src.index("random_contrast(k_con")]


def test_augment_example_takes_the_new_keys():
    x, y = map(_t, _example(1, (8, 8, 8)))
    gx, gy = TA.augment_example(torch.Generator().manual_seed(1), x, y,
                                flip=False, permute=False,
                                scale_deviation=0.25, rotate=15.0)
    bx, by = TA.augment_batch(torch.Generator().manual_seed(1), x[None],
                              y[None], flip=False, permute=False,
                              scale_deviation=0.25, rotate=15.0)
    torch.testing.assert_close(gx, bx[0], atol=0, rtol=0)
    torch.testing.assert_close(gy, by[0], atol=0, rtol=0)


@pytest.mark.parametrize("kw", [{"distort": 0.25}, {"rotate": 15.0},
                                {"distort": 0.25, "rotate": 15.0}], ids=str)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_step_with_distort_and_rotate_runs(kw, dtype):
    """BASELINE config #2's full augmentation trains: the step no longer
    refuses ``distort`` and ``rotate``; a bf16-staged batch is resampled in
    fp32 and the loss is finite and moves the parameters."""
    cfg = Config(depth=2, n_base_filters=4, patch_shape=(8, 8, 8),
                 batch_size=2, compute_dtype=dtype, augment=True, flip=True,
                 permute=True, contrast=0.1, **kw)
    torch.manual_seed(0)
    model = build_model(cfg, "cpu")
    state = create_train_state(model, cfg)
    before = [p.detach().clone() for p in model.parameters()]
    rng = np.random.default_rng(0)
    y = np.zeros((2, 1, 8, 8, 8), np.float32)
    y[:, :, 2:6, 2:6, 2:6] = 1.0
    x = torch.from_numpy((y * 2 + rng.normal(0, 0.3, y.shape)).astype(
        np.float32))
    if dtype == "bfloat16":
        x = x.to(torch.bfloat16)
    step = make_train_step(model, cfg,
                           generator=torch.Generator().manual_seed(3))
    m = step(state, x, torch.from_numpy(y).to(torch.uint8))
    assert torch.isfinite(m["loss"]) and state.step == 1
    assert any(not torch.equal(a, b)
               for a, b in zip(before, model.parameters()))
    with pytest.raises(ValueError, match="torch.Generator"):
        make_train_step(model, cfg)

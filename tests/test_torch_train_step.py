"""The port's train step against the JAX ``make_train_step``.

Same params (``from_flax``), same batch, augmentation off, compute
float32, fold off: N = 3 steps of each package must land on the same
params and Adam moments, also with ``clip_norm`` and with ``remat``; an
optax Adam state carried over with ``load_optax_adam_state`` continues on
the same trajectory; ``KerasAdam`` alone matches ``make_optimizer``'s
update; a tiny model overfits one patch; and ``check_supported`` refuses
what the port does not train yet (a spatial mesh) and passes what it does
(the resampling augmentations, a data-parallel ``num_devices``).

Tolerance: params atol 1e-5 after 3 steps (the gradients differ between
the packages by fp32 sums of another order, about 1e-6 relative, and each
Adam step moves a param by about lr); moments rtol 1e-4 + atol 1e-8 (they
hold those gradients directly); KerasAdam alone on identical gradients
atol 1e-7.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
from flax.traverse_util import flatten_dict  # noqa: E402

from fetal_mri_segmentation_tpu.config import Config  # noqa: E402
from fetal_mri_segmentation_tpu.models import build_model as jax_build  # noqa: E402
from fetal_mri_segmentation_tpu.training import (  # noqa: E402
    create_train_state as jax_state, make_train_step as jax_step)
from fetal_mri_segmentation_tpu.training.state import (  # noqa: E402
    make_optimizer as jax_optimizer)
from fetal_mri_segmentation_tpu_torch.config import check_supported  # noqa: E402
from fetal_mri_segmentation_tpu_torch.models import build_model  # noqa: E402
from fetal_mri_segmentation_tpu_torch.training.state import (  # noqa: E402
    KerasAdam, create_train_state, make_optimizer)
from fetal_mri_segmentation_tpu_torch.training.train_step import (  # noqa: E402
    make_eval_step, make_train_step)
from fetal_mri_segmentation_tpu_torch.utils.params import (  # noqa: E402
    from_flax, init_flax_like, load_optax_adam_state)

torch.set_num_threads(1)
PARAM_ATOL = 1e-5
MOMENT_TOL = dict(rtol=1e-4, atol=1e-8)


def tiny_config(**kw):
    defaults = dict(depth=2, n_base_filters=8, patch_shape=(8, 8, 8),
                    batch_size=2, compute_dtype="float32", fold_level0="off",
                    augment=False, initial_learning_rate=1e-2,
                    use_pallas_conv=True, use_pallas_dec0=True)
    defaults.update(kw)
    return Config(**defaults)


def make_batch(cfg, b=2, seed=0):
    rng = np.random.default_rng(seed)
    shape = (b, 1) + cfg.patch_shape
    y = np.zeros(shape, np.float32)
    y[:, :, 2:6, 2:6, 2:6] = 1.0
    x = (y * 2 + rng.normal(0, 0.3, shape)).astype(np.float32)
    return x, y


def _adam(opt_state):
    """The ScaleByAdamState inside the injected-hyperparams chain."""
    return next(s for s in opt_state.inner_state
                if isinstance(s, optax.ScaleByAdamState))


def _pair(cfg, clip_norm=None):
    """A JAX state and a port state with the same params."""
    # the JAX Config has no Pallas switches that run on its CPU; the port's
    # kernel routes run their plain versions here
    jcfg = Config(**{**cfg.__dict__, "use_pallas_conv": False,
                     "use_pallas_dec0": False})
    jmodel = jax_build(jcfg)
    tx = jax_optimizer(cfg.initial_learning_rate, clip_norm)
    js = jax_state(jmodel, jcfg, jax.random.PRNGKey(0), tx=tx)
    model = build_model(cfg, "cpu")
    model.load_state_dict(from_flax(flatten_dict(js.params, sep="/")))
    return jmodel, jcfg, js, model, create_train_state(model, cfg, clip_norm)


def _compare(js, state):
    params = dict(state.model.named_parameters())
    want = from_flax(flatten_dict(js.params, sep="/"))
    for name, p in params.items():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   atol=PARAM_ATOL, rtol=0, err_msg=name)
    adam = _adam(js.opt_state)
    mu = from_flax(flatten_dict(adam.mu, sep="/"))
    nu = from_flax(flatten_dict(adam.nu, sep="/"))
    for name, p in params.items():
        st = state.optimizer.state[p]
        assert st["count"] == int(adam.count)
        np.testing.assert_allclose(st["mu"].numpy(), mu[name].numpy(),
                                   err_msg=name, **MOMENT_TOL)
        np.testing.assert_allclose(st["nu"].numpy(), nu[name].numpy(),
                                   err_msg=name, **MOMENT_TOL)


def _run_both(cfg, clip_norm=None, n=3):
    jmodel, jcfg, js, model, state = _pair(cfg, clip_norm)
    x, y = make_batch(cfg)
    jstep, step = jax_step(jmodel, jcfg), make_train_step(model, cfg)
    for i in range(n):
        js, jm = jstep(js, jnp.asarray(x), jnp.asarray(y),
                       jax.random.PRNGKey(i), None)
        m = step(state, torch.from_numpy(x), torch.from_numpy(y))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   atol=1e-5)
        np.testing.assert_allclose(float(m["dice"]), float(jm["dice"]),
                                   atol=1e-5)
    assert state.step == n
    return js, state


@pytest.mark.parametrize("remat", [False, True])
def test_three_steps_match_jax(remat):
    js, state = _run_both(tiny_config(remat=remat))
    _compare(js, state)


def test_three_steps_with_clip_norm_match_jax():
    cfg = tiny_config()
    # a norm small enough that the clip is active on every step
    js, state = _run_both(cfg, clip_norm=0.05)
    _compare(js, state)


def test_optax_state_carries_over():
    """Two JAX steps, the state carried over with from_flax and
    load_optax_adam_state, then one more step in each package."""
    cfg = tiny_config()
    jmodel, jcfg, js, model, state = _pair(cfg)
    x, y = make_batch(cfg, seed=1)
    jstep = jax_step(jmodel, jcfg)
    for i in range(2):
        js, _ = jstep(js, jnp.asarray(x), jnp.asarray(y),
                      jax.random.PRNGKey(i), None)
    model.load_state_dict(from_flax(flatten_dict(js.params, sep="/")))
    adam = _adam(js.opt_state)
    load_optax_adam_state(
        state.optimizer, model, int(adam.count),
        flatten_dict(adam.mu, sep="/"), flatten_dict(adam.nu, sep="/"),
        float(js.opt_state.hyperparams["learning_rate"]))
    js, _ = jstep(js, jnp.asarray(x), jnp.asarray(y), jax.random.PRNGKey(2),
                  None)
    make_train_step(model, cfg)(state, torch.from_numpy(x),
                                torch.from_numpy(y))
    _compare(js, state)


@pytest.mark.parametrize("clip_norm", [None, 0.5])
def test_keras_adam_matches_jax_make_optimizer(clip_norm):
    """Five updates of the same gradients: KerasAdam against optax's chain
    with ``scale_by_keras_adam`` (eps on the uncorrected sqrt(v))."""
    rng = np.random.default_rng(2)
    params = {"a": rng.normal(size=(3, 4)).astype(np.float32),
              "b": rng.normal(size=(5,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32) * 0.1
              for k, v in params.items()} for _ in range(5)]
    tx = jax_optimizer(1e-2, clip_norm)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    opt = make_optimizer(tp.values(), 1e-2, clip_norm)
    for g in grads:
        upd, opt_state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                   opt_state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
    for k in params:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   atol=1e-7, rtol=0)


def test_learning_rate_is_set_at_run_time():
    p = torch.nn.Parameter(torch.ones(3))
    opt = KerasAdam([p], lr=1e-3)
    assert opt.learning_rate == 1e-3
    opt.set_learning_rate(2.5e-4)
    assert opt.learning_rate == 2.5e-4
    p.grad = torch.ones(3)
    opt.step()
    # the first Keras-Adam step moves each param by lr (alpha(1) m / sqrt v
    # = 1 for a constant gradient, up to eps)
    torch.testing.assert_close(p.detach(), torch.full((3,), 1 - 2.5e-4),
                               atol=1e-7, rtol=0)


def test_overfit_one_patch_reaches_high_dice():
    """The port's counterpart of the JAX package's overfit smoke: loss
    (negative dice) below -0.9, kernel routes on."""
    cfg = tiny_config()
    model = build_model(cfg, "cpu")
    model.load_state_dict(from_flax(init_flax_like(cfg, seed=0)))
    state = create_train_state(model, cfg)
    step = make_train_step(model, cfg)
    x, y = map(torch.from_numpy, make_batch(cfg))
    for _ in range(150):
        m = step(state, x, y)
    assert float(m["loss"]) < -0.9, float(m["loss"])


def test_step_casts_bf16_x_and_uint8_y_on_entry():
    cfg = tiny_config()
    x, y = make_batch(cfg)
    xb = torch.from_numpy(x).bfloat16()
    runs = []
    for xs, ys in ((xb, torch.from_numpy(y).to(torch.uint8)),
                   (xb.float(), torch.from_numpy(y))):
        model = build_model(cfg, "cpu")
        model.load_state_dict(from_flax(init_flax_like(cfg, seed=1)))
        runs.append(make_train_step(model, cfg)(create_train_state(
            model, cfg), xs, ys))
    assert runs[0]["loss"].dtype == torch.float32
    torch.testing.assert_close(runs[0]["loss"], runs[1]["loss"], atol=0,
                               rtol=0)


def test_augmenting_step_needs_a_generator_and_repeats_with_its_seed():
    cfg = tiny_config(augment=True, flip=True, permute=True, contrast=0.1)
    with pytest.raises(ValueError, match="Generator"):
        make_train_step(build_model(cfg, "cpu"), cfg)
    x, y = map(torch.from_numpy, make_batch(cfg))
    losses = []
    for _ in range(2):
        model = build_model(cfg, "cpu")
        model.load_state_dict(from_flax(init_flax_like(cfg, seed=2)))
        step = make_train_step(model, cfg,
                               generator=torch.Generator().manual_seed(5))
        state = create_train_state(model, cfg)
        losses.append([float(step(state, x, y)["loss"]) for _ in range(3)])
    assert losses[0] == losses[1]


def test_eval_step_masks_the_padded_tail_and_reports_label_dice():
    cfg = tiny_config(n_labels=2, labels=(1, 2), activation_name="softmax",
                      include_label_wise_dice_coefficients=True)
    model = build_model(cfg, "cpu")
    model.load_state_dict(from_flax(init_flax_like(cfg, seed=3)))
    state = create_train_state(model, cfg)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.random((3, 1, 8, 8, 8)).astype(np.float32))
    y = torch.zeros(3, 2, 8, 8, 8)
    y[:, 0, :4] = 1.0
    y[:, 1, 4:] = 1.0
    ev = make_eval_step(model, cfg)
    ragged = ev(state, x[:2], y[:2])
    padded = ev(state, x, y, n_valid=2)
    assert set(padded) == {"loss", "dice", "label_0_dice_coef",
                           "label_1_dice_coef"}
    for k in padded:
        torch.testing.assert_close(padded[k], ragged[k], atol=1e-6, rtol=0)
    m = make_train_step(model, cfg)(state, x, y, n_valid=2)
    assert "label_1_dice_coef" in m and torch.isfinite(m["loss"])


@pytest.mark.parametrize("kw,item", [
    ({"distort": 0.25}, None), ({"rotate": 15.0}, None),
    ({"num_devices": 4}, "data-parallel"),
    ({"spatial_devices": 2}, "spatial sharding")])
def test_check_supported_refuses_what_is_not_ported(kw, item):
    """Every one of these is ported now and passes ``check_supported``
    (which ``build_model`` runs) and makes a train step: the resampling
    augmentations (the step needs a generator), data-parallel training
    (``num_devices`` above 1) and depth-axis spatial sharding
    (``spatial_devices`` above 1; the mesh comes from
    ``parallel/spatial.py``, and a single-device step on the same config
    trains the whole volume)."""
    cfg = Config(**kw)
    model = build_model(Config(depth=2, n_base_filters=8), "cpu")
    check_supported(cfg)
    make_train_step(model, cfg, generator=torch.Generator())
    if item is None:
        with pytest.raises(ValueError, match="torch.Generator"):
            make_train_step(model, Config(flip=False, permute=False, **kw))
    if item == "spatial sharding":
        build_model(Config(depth=2, n_base_filters=8, **kw), "cpu")


def test_augmentations_refused_for_training_only():
    """A serving config may carry training-only keys, and a train step with
    augmentation off ignores them (it needs no generator)."""
    check_supported(Config(distort=0.25, rotate=15.0))
    make_train_step(build_model(Config(depth=2, n_base_filters=8), "cpu"),
                    Config(distort=0.25, rotate=15.0, augment=False))

"""Training Isensee2017 and the U-Net's norm and deconvolution options in
the port against the JAX ``make_train_step``, on the CPU in fp32 with fold
off and augmentation off: 3 steps from the same variables and batch land on
the same params, Adam moments and BatchNorm running statistics (Isensee
with dropout off, the weighted dice, sigmoid and softmax heads; the U-Net
with BatchNorm, InstanceNorm and the transposed-conv decoder). Then the
port's own contracts: ``remat`` with dropout gives the gradients of no
remat from one generator seed (the masks are drawn before the checkpointed
forward), ``remat`` is off with BatchNorm (the running statistics move once
per step), the checkpoint carries the running statistics bit for bit, the
dropout step needs a generator, and ``train_model`` trains Isensee with
dropout and repeats itself from its seed.

Tolerance: as ``test_torch_train_step.py`` where the arithmetic allows it:
running statistics atol 1e-5, each step's loss and dice atol 1e-5, and
without a norm (the transposed-conv U-Net) params atol 1e-5 after 3 steps
and moments rtol 1e-4 + atol 1e-8. Behind a norm, gradients carry entries
near 0 (a conv bias before a norm has no effect on the output at all, so
its whole gradient is rounding), and Adam's update m / (sqrt(v) + eps)
turns the packages' fp32 reassociation there (about 1e-6 of a tensor's
largest gradient; 3e-4 for BatchNorm's scale, whose E[x^2] - E[x]^2
variance cancels) into steps that differ by up to the learning rate, which
then move the next steps' gradients. So with a norm the first step's
gradients (Adam's mu) are held at rtol 1e-4 + atol 1e-3 of their tensor's
largest entry (of the block's weight for a bias before a norm), and after
3 steps: moments at rtol 1e-4 + atol 1e-2 of that scale; a param entry
whose first gradient is under 1e-3 of that scale within 2 x lr per step of
JAX's, every other entry within 1e-4 (1/15 of the 3 steps' motion at the
configs' learning rate, 5e-4, at which the steps run).
"""

import csv
import os

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
from fetal_mri_segmentation_tpu_torch.data.memory import InMemoryDataFile  # noqa: E402
from fetal_mri_segmentation_tpu_torch.models import build_model  # noqa: E402
from fetal_mri_segmentation_tpu_torch.pipeline.generator import (  # noqa: E402
    get_training_and_validation_generators)
from fetal_mri_segmentation_tpu_torch.training.checkpoint import (  # noqa: E402
    CheckpointIO)
from fetal_mri_segmentation_tpu_torch.training.loop import train_model  # noqa: E402
from fetal_mri_segmentation_tpu_torch.training.state import (  # noqa: E402
    create_train_state)
from fetal_mri_segmentation_tpu_torch.training.train_step import (  # noqa: E402
    make_eval_step, make_train_step)
from fetal_mri_segmentation_tpu_torch.utils.params import (  # noqa: E402
    from_flax, init_flax_like)

torch.set_num_threads(1)
PARAM_ATOL, NORM_PARAM_ATOL = 1e-5, 1e-4
MOMENT_RTOL, MOMENT_ATOL = 1e-4, 1e-8
FIRST_SCALE_TOL, SCALE_TOL = 1e-3, 1e-2
STATS_ATOL = 1e-5


def tiny_config(**kw):
    defaults = dict(model_name="isensee", depth=3, n_base_filters=8,
                    n_segmentation_levels=2, dropout_rate=0.0,
                    patch_shape=(16, 16, 16), batch_size=2,
                    compute_dtype="float32", fold_level0="off",
                    augment=False, initial_learning_rate=5e-4,
                    use_pallas_conv=True, use_pallas_dec0=True)
    defaults.update(kw)
    return Config(**defaults)


def make_batch(cfg, b=2, seed=0):
    rng = np.random.default_rng(seed)
    shape = (b, cfg.n_labels) + cfg.patch_shape
    y = np.zeros(shape, np.float32)
    y[:, 0, 4:12, 3:11, 5:13] = 1.0
    if cfg.n_labels > 1:
        y[:, 1, 2:6, 2:6, 2:6] = 1.0
    x = (y[:, :1] * 2 + rng.normal(0, 0.3, (b, 1) + cfg.patch_shape))
    return x.astype(np.float32), y


def _flat_stats(batch_stats):
    return {f"batch_stats/{k}": v for k, v in
            flatten_dict(batch_stats, sep="/").items()}


def _pair(cfg):
    """A JAX state and a port state with the same variables."""
    jcfg = Config(**{**cfg.__dict__, "use_pallas_conv": False,
                     "use_pallas_dec0": False})
    jmodel = jax_build(jcfg)
    js = jax_state(jmodel, jcfg, jax.random.PRNGKey(0))
    model = build_model(cfg, "cpu")
    flat = flatten_dict(js.params, sep="/")
    flat.update(_flat_stats(js.batch_stats))
    model.load_state_dict(from_flax(flat))
    return jmodel, jcfg, js, model, create_train_state(model, cfg)


def _adam(js):
    adam = next(s for s in js.opt_state.inner_state
                if isinstance(s, optax.ScaleByAdamState))
    return (from_flax(flatten_dict(adam.mu, sep="/")),
            from_flax(flatten_dict(adam.nu, sep="/")), int(adam.count))


def _scales(model):
    """Per param, the tensor whose largest first-step gradient sets the
    scale of its rounding: its own, or for a conv
    bias before a norm its block's weight."""
    before_norm = {f"{n}.conv.bias" for n, m in model.named_modules()
                   if getattr(m, "norm_key", None)}
    return {n: n[:-len("bias")] + "weight" if n in before_norm else n
            for n, _ in model.named_parameters()}


def _compare_moments(js, state, has_norm, scale_tol):
    """Adam's count, mu and nu of the port's ``state`` against JAX's."""
    scale_of = _scales(state.model)
    mu, nu, count = _adam(js)
    for name, p in state.model.named_parameters():
        st = state.optimizer.state[p]
        assert st["count"] == count
        for got, ref in ((st["mu"], mu), (st["nu"], nu)):
            atol = (scale_tol * float(ref[scale_of[name]].abs().max())
                    if has_norm else MOMENT_ATOL)
            np.testing.assert_allclose(got.numpy(), ref[name].numpy(),
                                       rtol=MOMENT_RTOL, atol=atol,
                                       err_msg=name)


def _compare(js, state, g1, lr, steps, has_norm):
    """Params, moments and running statistics of the port's ``state``
    against JAX's ``js``; ``g1`` is JAX's first Adam mu (the gradient
    times 1 - b1)."""
    params = dict(state.model.named_parameters())
    want = from_flax(flatten_dict(js.params, sep="/"))
    assert set(want) == set(params)
    scale_of = _scales(state.model)
    for name, p in params.items():
        diff = (p.detach() - want[name]).abs()
        if not has_norm:
            assert bool((diff <= PARAM_ATOL).all()), name
            continue
        scale = g1[scale_of[name]].abs().max()
        flat = g1[name].abs() < FIRST_SCALE_TOL * scale
        assert bool((diff[flat] <= 2 * lr * steps).all()), name
        assert bool((diff[~flat] <= NORM_PARAM_ATOL).all()), (
            name, float(diff[~flat].max()))
    _compare_moments(js, state, has_norm, SCALE_TOL)
    stats = from_flax(_flat_stats(js.batch_stats))
    buffers = dict(state.model.named_buffers())
    assert set(stats) == set(buffers)
    for name, value in stats.items():
        np.testing.assert_allclose(buffers[name].numpy(), value.numpy(),
                                   atol=STATS_ATOL, rtol=0, err_msg=name)


STEP_CASES = {
    "isensee": dict(),
    "isensee-softmax": dict(n_labels=2, labels=(1, 2),
                            activation_name="softmax"),
    "unet-batchnorm": dict(model_name="unet", depth=2,
                           batch_normalization=True, remat=True),
    "unet-instancenorm": dict(model_name="unet", depth=2,
                              instance_normalization=True),
    "unet-deconvolution": dict(model_name="unet", depth=2,
                               deconvolution=True),
}


@pytest.mark.parametrize("case", STEP_CASES)
def test_three_steps_match_jax(case):
    """Isensee with the weighted dice (dropout off), and the U-Net with
    each norm and the transposed-conv decoder (BatchNorm with ``remat``
    asked for, which both packages turn off): params, Adam moments and the
    running statistics after 3 steps, and each step's loss and dice."""
    cfg = tiny_config(**STEP_CASES[case])
    has_norm = case != "unet-deconvolution"
    jmodel, jcfg, js, model, state = _pair(cfg)
    x, y = make_batch(cfg)
    jstep, step = jax_step(jmodel, jcfg), make_train_step(model, cfg)
    for i in range(3):
        js, jm = jstep(js, jnp.asarray(x), jnp.asarray(y),
                       jax.random.PRNGKey(i), None)
        m = step(state, torch.from_numpy(x), torch.from_numpy(y))
        for key in ("loss", "dice"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       atol=1e-5, err_msg=key)
        if i == 0:  # the JAX step donates its state: copy mu out now
            g1 = _adam(js)[0]
            _compare_moments(js, state, has_norm, FIRST_SCALE_TOL)
    assert state.step == 3
    _compare(js, state, g1, cfg.initial_learning_rate, 3, has_norm)


def test_remat_with_dropout_gives_the_gradients_of_no_remat():
    """The masks are drawn from the step's generator before the
    checkpointed forward, so the recompute drops the same channels."""
    cfg = tiny_config(dropout_rate=0.3, depth=3)
    x, y = map(torch.from_numpy, make_batch(cfg))
    grads = []
    for remat in (False, True):
        c = tiny_config(dropout_rate=0.3, depth=3, remat=remat)
        model = build_model(c, "cpu")
        model.load_state_dict(from_flax(init_flax_like(c, seed=1)))
        step = make_train_step(model, c,
                               generator=torch.Generator().manual_seed(2))
        step(create_train_state(model, c), x, y)
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()})
    for name, g in grads[0].items():
        assert g.abs().sum() > 0 or name.endswith("conv.bias"), name
        torch.testing.assert_close(grads[1][name], g, atol=1e-6, rtol=0,
                                   msg=name)


def test_remat_is_off_with_batchnorm():
    """The running statistics after one step with ``remat`` asked for equal
    those of a step without it: they moved once, not twice."""
    stats = []
    for remat in (False, True):
        cfg = tiny_config(model_name="unet", depth=2,
                          batch_normalization=True, remat=remat)
        model = build_model(cfg, "cpu")
        model.load_state_dict(from_flax(init_flax_like(cfg, seed=3)))
        x, y = map(torch.from_numpy, make_batch(cfg))
        make_train_step(model, cfg)(create_train_state(model, cfg), x, y)
        stats.append({n: b.clone() for n, b in model.named_buffers()})
    assert stats[0]
    for name, value in stats[0].items():
        assert not torch.equal(value, torch.zeros_like(value)) or name.endswith(
            "mean")
        torch.testing.assert_close(stats[1][name], value, atol=0, rtol=0,
                                   msg=name)


def test_dropout_step_needs_a_generator_and_eval_step_runs_eval_forms():
    cfg = tiny_config(dropout_rate=0.3)
    model = build_model(cfg, "cpu")
    with pytest.raises(ValueError, match="Generator"):
        make_train_step(model, cfg)
    model.load_state_dict(from_flax(init_flax_like(cfg, seed=4)))
    state = create_train_state(model, cfg)
    x, y = map(torch.from_numpy, make_batch(cfg))
    make_train_step(model, cfg, generator=torch.Generator().manual_seed(0))(
        state, x, y)
    assert model.training
    metrics = make_eval_step(model, cfg)(state, x, y)
    assert not model.training
    with torch.no_grad():
        pred = model(x.permute(0, 2, 3, 4, 1)).permute(0, 4, 1, 2, 3)
    again = make_eval_step(model, cfg)(state, x, y)
    torch.testing.assert_close(again["loss"], metrics["loss"], atol=0, rtol=0)
    assert torch.isfinite(pred).all()


def test_checkpoint_carries_the_running_statistics_bit_for_bit(tmp_path):
    """Two BatchNorm steps, saved and restored into a fresh model: the
    buffers equal bit for bit; the optimizer holds the parameters only."""
    cfg = tiny_config(model_name="unet", depth=2, batch_normalization=True)
    model = build_model(cfg, "cpu")
    model.load_state_dict(from_flax(init_flax_like(cfg, seed=5)))
    state = create_train_state(model, cfg)
    x, y = map(torch.from_numpy, make_batch(cfg))
    step = make_train_step(model, cfg)
    for _ in range(2):
        step(state, x, y)
    assert len(state.optimizer.state) == len(list(model.parameters()))
    io = CheckpointIO(str(tmp_path / "model.pt"))
    io.save(state, epoch=1, best_val=-0.5)
    fresh = build_model(cfg, "cpu")
    restored, epoch, _, _ = io.restore(create_train_state(fresh, cfg))
    assert epoch == 1 and restored.step == 2
    buffers = dict(fresh.named_buffers())
    assert buffers and set(buffers) == set(dict(model.named_buffers()))
    for name, value in model.named_buffers():
        assert not torch.equal(buffers[name], torch.zeros_like(value)) or \
            name.endswith("mean")
        assert torch.equal(buffers[name], value), name


def _isensee_loop(tmp_path, tag, seed):
    cfg = tiny_config(image_shape=(20, 20, 20), patch_shape=(16, 16, 16),
                      dropout_rate=0.3, augment=True, flip=True,
                      permute=True, contrast=0.1, n_epochs=2,
                      validation_batch_size=2,
                      model_file=str(tmp_path / f"{tag}.pt"),
                      training_file=str(tmp_path / f"{tag}_t.pkl"),
                      validation_file=str(tmp_path / f"{tag}_v.pkl"),
                      training_log=str(tmp_path / f"{tag}.log"))
    rng = np.random.default_rng(0)
    truth = np.zeros((4, 1, 20, 20, 20), np.uint8)
    truth[:, :, 5:15, 4:14, 6:16] = 1
    data = (truth * 2.0 + rng.normal(0, 0.3, truth.shape)).astype(np.float32)
    tg, n_t, vg, n_v = get_training_and_validation_generators(
        InMemoryDataFile(data, truth), batch_size=2, n_labels=1,
        training_keys_file=cfg.training_file,
        validation_keys_file=cfg.validation_file, data_split=0.5,
        patch_shape=cfg.patch_shape, training_patch_start_offset=(2, 2, 2),
        validation_batch_size=2, seed=0)
    model = build_model(cfg, "cpu")
    model.load_state_dict(from_flax(init_flax_like(cfg, seed=6)))
    state = train_model(model, create_train_state(model, cfg), cfg, tg, vg,
                        n_t, n_v, seed=seed, verbose=False)
    with open(cfg.training_log) as f:
        rows = list(csv.DictReader(f))
    return state, n_t, rows


def test_train_model_trains_isensee_with_dropout_from_its_seed(tmp_path):
    """Two epochs with augmentation and dropout (one generator, seeded per
    epoch from ``epoch_seed``): the same seed repeats the run exactly, and
    another seed draws other masks."""
    state, n_t, rows = _isensee_loop(tmp_path, "a", seed=0)
    assert state.step == 2 * n_t and len(rows) == 2
    assert all(np.isfinite(float(r["loss"])) for r in rows)
    assert os.path.exists(str(tmp_path / "a.pt"))
    again, _, _ = _isensee_loop(tmp_path, "b", seed=0)
    other, _, _ = _isensee_loop(tmp_path, "c", seed=1)
    params = dict(state.model.named_parameters())
    for name, p in again.model.named_parameters():
        assert torch.equal(p, params[name]), name
    assert any(not torch.equal(p, params[name])
               for name, p in other.model.named_parameters())

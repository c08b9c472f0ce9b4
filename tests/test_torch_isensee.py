"""The port's Isensee2017 (and the U-Net's norm and deconvolution options)
against the JAX models, on the CPU in fp32 with fold off: the eval forward
(the fused up-sampling module) and the training forward (upsample-then-conv,
dropout off; and with dropout, given the same masks) with a sigmoid head
and with a softmax head, on cubic and non-cubic inputs; the variables'
keys and shapes (``flax_param_shapes``, ``init_flax_like``, ``from_flax``)
against ``model.init`` for both families; the sliding-window and direct
predictors on an Isensee config against the JAX predictors; and the export
tool's ``batch_stats``.

Tolerance: atol 2e-4 on logits and probabilities (fp32 sums in another
order through every layer), as ``test_torch_unet3d.py``.
"""

from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax.traverse_util import flatten_dict  # noqa: E402

from fetal_mri_segmentation_tpu.config import Config  # noqa: E402
from fetal_mri_segmentation_tpu.inference.sliding_window import (  # noqa: E402
    SlidingWindowPredictor as JaxSliding)
from fetal_mri_segmentation_tpu.models import build_model as jax_build  # noqa: E402
from fetal_mri_segmentation_tpu.models import isensee2017 as JI  # noqa: E402
from fetal_mri_segmentation_tpu.parallel.spatial import (  # noqa: E402
    make_direct_predictor as jax_direct)
from fetal_mri_segmentation_tpu_torch.inference.predict import (  # noqa: E402
    build_serving_predictor, load_serving_model)
from fetal_mri_segmentation_tpu_torch.models import (  # noqa: E402
    Isensee2017, UNet3D, build_model)
from fetal_mri_segmentation_tpu_torch.utils.params import (  # noqa: E402
    flax_param_shapes, from_flax, init_flax_like)

torch.set_num_threads(1)
ATOL = 2e-4


def _config(**kw):
    base = dict(model_name="isensee", depth=3, n_base_filters=8,
                n_segmentation_levels=2, patch_shape=(16, 16, 16),
                compute_dtype="float32", fold_level0="off",
                use_pallas_conv=True, use_pallas_dec0=True)
    base.update(kw)
    return Config(**base)


def _flat(variables):
    """Flax variables flattened as ``tools/export_params_npz.py`` writes
    them: params bare, running statistics under ``batch_stats/``."""
    flat = flatten_dict(variables["params"], sep="/")
    flat.update({f"batch_stats/{k}": v for k, v in flatten_dict(
        variables.get("batch_stats", {}), sep="/").items()})
    return flat


def _pair(cfg, x, seed=0):
    """The JAX model with its variables and the port's model (on the CPU,
    kernel routes on) with the same weights."""
    jcfg = Config(**{**cfg.__dict__, "use_pallas_conv": False,
                     "use_pallas_dec0": False})
    jmodel = jax_build(jcfg)
    variables = jmodel.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    port = build_model(cfg, "cpu")
    port.load_state_dict(from_flax(_flat(variables)))
    return jmodel, variables, port


HEADS = [dict(), dict(n_labels=2, labels=(1, 2), activation_name="softmax",
                      depth=4, n_segmentation_levels=3)]


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("head,shape", zip(HEADS, [(2, 16, 24, 16, 1),
                                                   (1, 16, 16, 16, 1)]),
                         ids=["sigmoid", "softmax"])
def test_isensee_forward_matches_jax(head, shape, train):
    """Eval: the fused up-sampling module (no skip, parity form); train:
    upsample-then-conv, dropout off. Logits and probabilities."""
    cfg = _config(dropout_rate=0.0, **head)
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    jmodel, variables, port = _pair(cfg, x)
    assert isinstance(port, Isensee2017) and not port.training
    port.train(train)
    for logits in (False, True):
        want = jmodel.apply(variables, jnp.asarray(x), train=train,
                            logits=logits)
        got = port(torch.from_numpy(x), logits=logits)
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=ATOL)


@pytest.mark.parametrize("option", ["batch_normalization",
                                    "instance_normalization",
                                    "deconvolution"])
def test_unet_option_forward_matches_jax(option):
    """The U-Net with each option, eval forward (BatchNorm on its running
    statistics, moved off their initial values), non-cubic input."""
    cfg = _config(model_name="unet", depth=3, **{option: True})
    x = np.random.default_rng(9).normal(size=(2, 16, 24, 8, 1)).astype(
        np.float32)
    jmodel, variables, port = _pair(cfg, x)
    if "batch_stats" in variables:
        rng = np.random.default_rng(10)
        variables = {"params": variables["params"],
                     "batch_stats": jax.tree_util.tree_map(
                         lambda v: jnp.asarray(rng.uniform(0.5, 1.5, v.shape),
                                               jnp.float32),
                         variables["batch_stats"])}
        port.load_state_dict(from_flax(_flat(variables)))
    assert isinstance(port, UNet3D)
    want = jmodel.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_isensee_train_and_eval_forms_agree():
    """The contract of ``test_isensee_train_eval_decoder_dispatch_same_
    params``: one parameter tree, and with dropout off the training form
    (upsample-then-conv) gives the eval form's output."""
    cfg = _config(dropout_rate=0.0)
    port = build_model(cfg, "cpu")
    port.load_state_dict(from_flax(init_flax_like(cfg, seed=1)))
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(1, 16, 16, 16, 1)).astype(np.float32))
    with torch.no_grad():
        eval_out = port(x)
        port.train()
        train_out = port(x)
    torch.testing.assert_close(train_out, eval_out, atol=1e-5, rtol=0)


def test_isensee_dropout_forward_matches_jax_given_the_masks(monkeypatch):
    """With dropout on, the port's training forward given its masks equals
    the JAX training forward made to drop the same channels (its
    ``spatial_dropout_3d`` replaced by the same apply on those masks)."""
    cfg = _config(dropout_rate=0.3)
    x = np.random.default_rng(2).normal(size=(2, 16, 16, 16, 1)).astype(
        np.float32)
    jmodel, variables, port = _pair(cfg, x)
    port.train()
    masks = port.dropout_masks(2, torch.Generator().manual_seed(3))
    assert [m.shape for m in masks] == [(2, 8), (2, 16), (2, 32)]
    queue = [jnp.asarray(m.numpy()) for m in masks]

    def dropout(rng, h, rate, group=1):
        mask = queue.pop(0)[:, None, None, None, :]
        return jnp.where(mask, h / (1 - rate), 0.0).astype(h.dtype)

    monkeypatch.setattr(JI, "spatial_dropout_3d", dropout)
    want = jmodel.apply(variables, jnp.asarray(x), train=True,
                        rngs={"dropout": jax.random.PRNGKey(0)})
    assert not queue
    got = port(torch.from_numpy(x), dropout_masks=masks)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL)
    with torch.no_grad():
        plain = port.eval()(torch.from_numpy(x))
    assert np.abs(plain.numpy() - np.asarray(want)).max() > 10 * ATOL


def test_isensee_training_forward_needs_masks_or_a_generator():
    cfg = _config(dropout_rate=0.3)
    port = build_model(cfg, "cpu").train()
    x = torch.zeros(1, 16, 16, 16, 1)
    with pytest.raises(ValueError, match="generator"):
        port(x)
    a = port(x, generator=torch.Generator().manual_seed(4))
    b = port(x, dropout_masks=port.dropout_masks(
        1, torch.Generator().manual_seed(4)))
    torch.testing.assert_close(a, b, atol=0, rtol=0)
    port.eval()(x)  # eval draws nothing


def test_segmentation_levels_beyond_the_decoder_raise():
    cfg = _config(depth=3, n_segmentation_levels=3)
    with pytest.raises(ValueError, match="n_segmentation_levels"):
        build_model(cfg, "cpu")
    with pytest.raises(ValueError, match="n_segmentation_levels"):
        jax_build(cfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 16,
                                                               1)))


FAMILIES = {
    "isensee": dict(),
    "isensee-softmax": dict(n_labels=2, labels=(1, 2), depth=4,
                            n_segmentation_levels=3,
                            activation_name="softmax"),
    "unet": dict(model_name="unet"),
    "unet-batchnorm": dict(model_name="unet", batch_normalization=True),
    "unet-instancenorm": dict(model_name="unet",
                              instance_normalization=True),
    "unet-deconvolution": dict(model_name="unet", deconvolution=True,
                               all_modalities=("t1", "t2")),
}


@pytest.mark.parametrize("family", FAMILIES)
def test_variable_keys_and_shapes_match_model_init(family):
    """``flax_param_shapes`` and ``init_flax_like`` give ``model.init``'s
    variables (params and ``batch_stats``), and ``from_flax`` of them loads
    strictly into ``build_model``; norms start at scale 1, bias 0, running
    mean 0 and variance 1."""
    cfg = _config(**FAMILIES[family])
    x = jnp.zeros((1, 16, 16, 16, cfg.nb_channels))
    variables = jax.eval_shape(jax_build(cfg).init, jax.random.PRNGKey(0), x)
    want = {k: tuple(v.shape) for k, v in _flat(variables).items()}
    assert flax_param_shapes(cfg) == want
    ours = init_flax_like(cfg, seed=0)
    assert {k: v.shape for k, v in ours.items()} == want
    for key, value in ours.items():
        if key.endswith(("scale", "var")):
            assert (value == 1).all(), key
        elif not key.endswith("kernel"):
            assert (value == 0).all(), key
    model = build_model(cfg, "cpu")
    assert isinstance(model, Isensee2017 if cfg.model_name == "isensee"
                      else UNet3D)
    state = from_flax(ours)
    assert set(state) == set(model.state_dict())
    model.load_state_dict(state)


@pytest.fixture(scope="module")
def isensee_serving():
    cfg = _config(image_shape=(24, 24, 24), dropout_rate=0.3)
    jmodel = jax_build(cfg)
    variables = jmodel.init(jax.random.PRNGKey(5),
                            jnp.zeros((1, 16, 16, 16, 1)))
    port = build_model(cfg, "cpu")
    port.load_state_dict(from_flax(_flat(variables)))
    return cfg, jmodel, variables, port


@pytest.mark.parametrize("tta", [False, "flips"])
def test_sliding_window_on_isensee_matches_jax(isensee_serving, tta):
    cfg, jmodel, variables, port = isensee_serving
    x = np.random.default_rng(6).normal(size=(1, 24, 24, 24)).astype(
        np.float32)
    want = np.asarray(JaxSliding(jmodel, cfg, cfg.image_shape, overlap=8,
                                 patch_batch_size=3, tta_permute=tta)(
        variables, x))
    got = build_serving_predictor(port, cfg, overlap=8, patch_batch_size=3,
                                  tta=tta, device="cpu")(x)
    assert got.shape == want.shape == (1, 24, 24, 24)
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("tta", [False, "flips"])
def test_direct_predictor_on_isensee_matches_jax(isensee_serving, tta):
    cfg, jmodel, variables, port = isensee_serving
    x = np.random.default_rng(7).normal(size=(1, 24, 24, 24)).astype(
        np.float32)
    want = np.asarray(jax_direct(jmodel, cfg, tta=tta)(variables, x))
    pred = build_serving_predictor(port, cfg, direct=True, tta=tta,
                                   device="cpu")
    got = pred(x)
    np.testing.assert_allclose(got, want, atol=ATOL)
    far = np.abs(want[0] - 0.5) > ATOL
    np.testing.assert_array_equal(pred.predict_labels(x)[far],
                                  (want[0] > 0.5)[far])


def test_export_tool_writes_batch_stats(tmp_path):
    """A BatchNorm U-Net's checkpoint, its running statistics moved off
    their initial values, through ``tools/export_params_npz.py`` into the
    port's ``load_serving_model``: every parameter and buffer bit for
    bit, and the same eval forward as the JAX model."""
    import importlib.util

    from fetal_mri_segmentation_tpu.training import create_train_state
    from fetal_mri_segmentation_tpu.training.checkpoint import CheckpointIO

    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location(
        "export_params_npz", root / "tools" / "export_params_npz.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)

    cfg = _config(model_name="unet", depth=2, batch_normalization=True,
                  model_file=str(tmp_path / "ckpt"))
    jmodel = jax_build(cfg)
    state = create_train_state(jmodel, cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(8)
    stats = jax.tree_util.tree_map(
        lambda v: jnp.asarray(rng.uniform(0.5, 2.0, v.shape), jnp.float32),
        state.batch_stats)
    state = state.replace(batch_stats=stats)
    CheckpointIO(cfg.model_file).save(state, epoch=1, best_val=-0.5)
    out = str(tmp_path / "params.npz")
    variables = {"params": state.params, "batch_stats": stats}
    flat = _flat(variables)
    assert tool.export_params(cfg, out) == len(flat)
    model = load_serving_model(cfg, out, "cpu")
    want = from_flax(flat)
    assert any(k.endswith("bn.var") for k in want)
    for key, value in model.state_dict().items():
        torch.testing.assert_close(value, want[key], atol=0, rtol=0)
    x = rng.normal(size=(1, 16, 16, 16, 1)).astype(np.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jmodel.apply(
        variables, jnp.asarray(x))), atol=ATOL)

"""Weights cross from the flax tree to the port: ``from_flax`` maps a JAX
``UNet3D.init`` tree onto the port's ``state_dict`` (DHWIO -> OIDHW, exact),
and ``init_flax_like`` draws a tree with the same keys and shapes."""

from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from flax.traverse_util import flatten_dict  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from fetal_mri_segmentation_tpu.config import Config  # noqa: E402
from fetal_mri_segmentation_tpu.models import build_model as jax_build  # noqa: E402
from fetal_mri_segmentation_tpu_torch.models import build_model  # noqa: E402
from fetal_mri_segmentation_tpu_torch.utils.params import (  # noqa: E402
    from_flax, init_flax_like)

torch.set_num_threads(1)


def _config(**kw):
    base = dict(patch_shape=(16, 16, 16), depth=3, n_base_filters=8,
                compute_dtype="float32", fold_level0="off")
    base.update(kw)
    return Config(**base)


def _jax_flat(cfg, shapes_only=False):
    """The flattened flax params of ``UNet3D.init``; ``shapes_only`` traces
    the init for its shapes without running it."""
    x = jnp.zeros((1, 16, 16, 16, cfg.nb_channels))
    init = jax_build(cfg).init
    if shapes_only:
        variables = jax.tree_util.tree_map(
            lambda s: np.zeros(s.shape, s.dtype),
            jax.eval_shape(init, jax.random.PRNGKey(0), x))
    else:
        variables = jax.jit(init)(jax.random.PRNGKey(0), x)
    return flatten_dict(variables["params"], sep="/")


@pytest.mark.parametrize("kw", [
    {}, {"depth": 2, "all_modalities": ("t1", "t2"), "n_labels": 3,
         "labels": (1, 2, 4), "activation_name": "softmax"}])
def test_from_flax_gives_the_port_state_dict(kw):
    cfg = _config(**kw)
    flat = _jax_flat(cfg)
    state = from_flax(flat)
    model = build_model(cfg, "cpu")
    assert set(state) == set(model.state_dict())
    model.load_state_dict(state)  # strict: every key and shape
    k = np.asarray(flat["enc1_conv2/conv/kernel"])
    w = model.enc1_conv2.conv.weight.detach().numpy()
    np.testing.assert_array_equal(w, k.transpose(4, 3, 0, 1, 2))
    np.testing.assert_array_equal(
        model.head.weight.detach().numpy()[:, :, 0, 0, 0],
        np.asarray(flat["head/kernel"])[0, 0, 0].T)


@pytest.mark.parametrize("kw", [
    {}, {"depth": 4, "n_base_filters": 4, "n_labels": 2, "labels": (1, 2)}])
def test_init_flax_like_matches_jax_keys_and_shapes(kw):
    cfg = _config(**kw)
    jax_flat = _jax_flat(cfg, shapes_only=True)
    ours = init_flax_like(cfg, seed=0)
    assert set(ours) == set(jax_flat)
    for key, value in ours.items():
        assert value.shape == jax_flat[key].shape, key
        assert value.dtype == np.float32


def test_init_flax_like_is_lecun_normal_with_zero_bias():
    cfg = _config(depth=4, n_base_filters=16)
    flat = init_flax_like(cfg, seed=1)
    k = flat["dec0_conv1/conv/kernel"]
    std = np.sqrt(1.0 / (27 * k.shape[3]))
    # truncated at 2 sigma of the pre-truncation normal, variance restored
    assert np.abs(k).max() <= 2 * std / 0.87962566103423978 + 1e-7
    assert abs(k.std() / std - 1) < 0.05
    assert all(not v.any() for key, v in flat.items() if key.endswith("bias"))
    again = init_flax_like(cfg, seed=1)
    assert all(np.array_equal(again[key], v) for key, v in flat.items())


def test_from_flax_prefix_and_refusals():
    flat = {"params/enc0_conv1/conv/bias": np.ones(4, np.float32)}
    assert list(from_flax(flat)) == ["enc0_conv1.conv.bias"]
    stats = from_flax({"batch_stats/enc0_conv1/bn/mean": np.arange(4.0)})
    assert list(stats) == ["enc0_conv1.bn.mean"]
    torch.testing.assert_close(stats["enc0_conv1.bn.mean"],
                               torch.arange(4.0), atol=0, rtol=0)
    with pytest.raises(ValueError, match="5-D"):
        from_flax({"enc0_conv1/conv/kernel": np.zeros((3, 3, 4, 8))})
    with pytest.raises(ValueError, match="unknown parameter"):
        from_flax({"enc0_conv1/bn/momentum": np.zeros(4)})


def test_export_tool_round_trips_a_checkpoint(tmp_path):
    """tools/export_params_npz.py writes a checkpoint's params; the port's
    load_serving_model reads them back bit for bit."""
    import importlib.util

    from fetal_mri_segmentation_tpu.training import create_train_state
    from fetal_mri_segmentation_tpu.training.checkpoint import CheckpointIO
    from fetal_mri_segmentation_tpu_torch.inference.predict import (
        load_serving_model)

    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location(
        "export_params_npz", root / "tools" / "export_params_npz.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)

    cfg = _config(depth=2, model_file=str(tmp_path / "ckpt"))
    state = create_train_state(jax_build(cfg), cfg, jax.random.PRNGKey(0))
    CheckpointIO(cfg.model_file).save(state, epoch=1, best_val=-0.5)
    out = str(tmp_path / "params.npz")
    flat = flatten_dict(state.params, sep="/")
    assert tool.export_params(cfg, out) == len(flat)
    model = load_serving_model(cfg, out, "cpu")
    want = from_flax(flat)
    for key, value in model.state_dict().items():
        torch.testing.assert_close(value, want[key], atol=0, rtol=0)

"""The direct whole-volume predictor and test-time augmentation of the port
against the JAX package, on the CPU in fp32 with fold off: the direct
predictor (plain, flips, permute) against JAX ``make_direct_predictor``,
the sliding window's patch-level TTA against JAX ``tta_permute``, both at
atol 2e-4 (the model tolerance), identity-model cases at 1e-5 as the JAX
package's own tests take them, the async label surface, and the
probability transfers (fp16 within 4.9e-4; uint8 / uint16 the integers of
JAX ``quantize_prob``)."""

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
from fetal_mri_segmentation_tpu.parallel.spatial import (  # noqa: E402
    make_direct_predictor as jax_direct)
from fetal_mri_segmentation_tpu.utils.residency import (  # noqa: E402
    quantize_prob as jax_quantize)
from fetal_mri_segmentation_tpu_torch.inference.predict import (  # noqa: E402
    build_serving_predictor)
from fetal_mri_segmentation_tpu_torch.inference.sliding_window import (  # noqa: E402
    SlidingWindowPredictor)
from fetal_mri_segmentation_tpu_torch.models import build_model  # noqa: E402
from fetal_mri_segmentation_tpu_torch.parallel.spatial import (  # noqa: E402
    AsyncLabels, SpatialPredictor, make_direct_predictor)
from fetal_mri_segmentation_tpu_torch.utils import residency  # noqa: E402
from fetal_mri_segmentation_tpu_torch.utils.params import from_flax  # noqa: E402

torch.set_num_threads(1)
ATOL = 2e-4      # the port's model tolerance against UNet3D.apply (fp32)
ID_ATOL = 1e-5   # the JAX package's identity-model TTA tests


def _pair(depth, shape, patch=(8, 8, 8), seed=0):
    """A JAX model with params and the port's model with the same weights."""
    cfg = Config(image_shape=shape, patch_shape=patch, depth=depth,
                 n_base_filters=8, compute_dtype="float32",
                 fold_level0="off")
    model = jax_build(cfg)
    params = model.init(jax.random.PRNGKey(seed),
                        jnp.zeros((1,) + tuple(patch) + (1,)))["params"]
    port = build_model(cfg, "cpu")
    port.load_state_dict(from_flax(flatten_dict(params, sep="/")))
    return cfg, model, {"params": params}, port


@pytest.fixture(scope="module")
def direct3():
    return _pair(3, (16, 16, 16))


@pytest.fixture(scope="module")
def sliding2():
    return _pair(2, (12, 12, 12), seed=1)


def _volume(shape, seed):
    return np.random.default_rng(seed).normal(size=(1,) + shape).astype(
        np.float32)


@pytest.mark.parametrize("tta,chunk", [(False, None), ("flips", None),
                                       ("flips", 4), ("permute", None),
                                       ("permute", 12)])
def test_direct_matches_jax(direct3, tta, chunk):
    cfg, model, variables, port = direct3
    x = _volume(cfg.image_shape, 0)
    want = np.asarray(jax_direct(model, cfg, tta=tta, tta_chunk=chunk)(
        variables, x))
    pred = make_direct_predictor(port, cfg, tta=tta, tta_chunk=chunk,
                                 device="cpu")
    got = pred(x)
    assert got.shape == want.shape == (1,) + cfg.image_shape
    np.testing.assert_allclose(got, want, atol=ATOL)
    far = np.abs(want[0] - 0.5) > ATOL
    labels = pred.predict_labels(x)
    assert labels.dtype == np.uint8
    np.testing.assert_array_equal(labels[far], (want[0] > 0.5)[far])


@pytest.mark.parametrize("tta", ["flips", "permute"])
def test_sliding_window_tta_matches_jax(sliding2, tta):
    cfg, model, variables, port = sliding2
    x = _volume(cfg.image_shape, 1)
    want = np.asarray(JaxSliding(model, cfg, cfg.image_shape, overlap=4,
                                 patch_batch_size=3, tta_permute=tta)(
        variables, x))
    got = SlidingWindowPredictor(port, cfg, cfg.image_shape, overlap=4,
                                 patch_batch_size=3, tta=tta)(x)
    np.testing.assert_allclose(got, want, atol=ATOL)


class Identity(torch.nn.Module):
    """The identity model of the JAX package's TTA tests."""

    dtype = torch.float32

    def forward(self, x):
        return x


@pytest.mark.parametrize("tta", ["flips", "permute"])
def test_sliding_window_tta_of_identity_model_is_plain(tta):
    cfg = Config(patch_shape=(8, 8, 8), n_labels=1)
    vol = np.random.default_rng(3).random((1, 16, 16, 16)).astype(np.float32)
    pred = SlidingWindowPredictor(Identity(), cfg, (16, 16, 16), overlap=0,
                                  device="cpu", tta=tta)
    np.testing.assert_allclose(pred(vol), vol, atol=ID_ATOL)


@pytest.mark.parametrize("tta", [False, "flips", "permute"])
def test_direct_tta_of_identity_model_is_plain(tta):
    cfg = Config(image_shape=(8, 8, 8), n_labels=1, depth=2)
    vol = np.random.default_rng(4).random((1, 8, 8, 8)).astype(np.float32)
    pred = make_direct_predictor(Identity(), cfg, tta=tta, device="cpu")
    np.testing.assert_allclose(pred(vol), vol, atol=ID_ATOL)


def test_flips_tta_supports_non_cubic_patches():
    cfg = Config(patch_shape=(8, 8, 4), n_labels=1)
    vol = np.random.default_rng(6).random((1, 16, 16, 8)).astype(np.float32)
    pred = SlidingWindowPredictor(Identity(), cfg, (16, 16, 8), overlap=0,
                                  device="cpu", tta="flips")
    np.testing.assert_allclose(pred(vol), vol, atol=ID_ATOL)
    with pytest.raises(ValueError, match="cubic"):
        SlidingWindowPredictor(Identity(), cfg, (16, 16, 8), overlap=0,
                               device="cpu", tta=True)
    with pytest.raises(ValueError, match="TTA mode"):
        SlidingWindowPredictor(Identity(), cfg, (16, 16, 8), overlap=0,
                               device="cpu", tta="rotate")


def test_direct_async_surface_and_shape_checks(direct3):
    cfg, _, _, port = direct3
    pred = make_direct_predictor(port, cfg, device="cpu")
    x = _volume(cfg.image_shape, 2)
    out = pred.predict_labels_async(x, threshold=0.4)
    assert isinstance(out, AsyncLabels) and out.shape == cfg.image_shape
    np.testing.assert_array_equal(pred.unpack_labels(out),
                                  (pred(x)[0] > 0.4).astype(np.uint8))
    with pytest.raises(ValueError, match="divisible by 2"):
        pred(np.zeros((1, 16, 16, 18), np.float32))
    with pytest.raises(ValueError, match=r"\(C=1, D, H, W\)"):
        pred(np.zeros((16, 16, 16), np.float32))
    with pytest.raises(ValueError, match="CUBIC"):
        make_direct_predictor(port, cfg, tta="permute", device="cpu")(
            np.zeros((1, 16, 16, 8), np.float32))
    with pytest.raises(ValueError, match="must divide 48"):
        make_direct_predictor(port, cfg, tta="permute", tta_chunk=5,
                              device="cpu")
    for chunk in (3, 6, 16):
        with pytest.raises(ValueError, match="must divide 8"):
            SpatialPredictor(port, cfg, tta="flips", tta_chunk=chunk,
                             device="cpu")
    bad = Config(image_shape=(16, 16, 10), depth=3, n_base_filters=8)
    with pytest.raises(ValueError, match="divisible"):
        build_serving_predictor(port, bad, direct=True, device="cpu")


def test_direct_accepts_a_tensor_without_a_host_round_trip(direct3):
    cfg, _, _, port = direct3
    x = _volume(cfg.image_shape, 5)
    pred = make_direct_predictor(port, cfg, device="cpu")
    np.testing.assert_array_equal(
        pred.predict_probabilities(torch.from_numpy(x)).numpy(), pred(x))


@pytest.mark.parametrize("direct", [False, True])
@pytest.mark.parametrize("kind", ["float32", "float16", "uint8", "uint16"])
def test_prob_transfers(direct3, direct, kind):
    cfg, _, _, port = direct3
    pred = build_serving_predictor(port, cfg, direct=direct, overlap=4,
                                   device="cpu")
    x = _volume(cfg.image_shape, 6)
    prob = pred(x)
    out = pred.predict_prob_async(x, transfer_dtype=kind)
    assert isinstance(out, torch.Tensor)
    got = pred.unpack_prob(out)
    assert got.dtype == np.float32 and got.shape == prob.shape
    if kind in ("uint8", "uint16"):
        want = np.asarray(jax_quantize(jnp.asarray(prob), kind))
        np.testing.assert_array_equal(out.numpy(), want)
        np.testing.assert_allclose(got, prob, atol=0.5 / {
            "uint8": 255, "uint16": 65535}[kind] + 1e-7)
    elif kind == "float16":
        np.testing.assert_allclose(got, prob, atol=4.9e-4)
    else:
        np.testing.assert_array_equal(got, prob)


def test_quantize_rounds_half_to_even_like_jnp():
    p = np.array([0.5 / 255, 1.5 / 255, 2.5 / 255, 0.0, 1.0, 1.3, -0.2,
                  0.123456], np.float32)
    for kind in ("uint8", "uint16"):
        np.testing.assert_array_equal(
            residency.quantize_prob(torch.from_numpy(p), kind).numpy(),
            np.asarray(jax_quantize(jnp.asarray(p), kind)))


@pytest.mark.parametrize("spelling,kind", [
    ("fp32", "float32"), ("None", "float32"), ("half", "float16"),
    ("u8", "uint8"), ("u16", "uint16")])
def test_transfer_spellings(spelling, kind):
    from fetal_mri_segmentation_tpu.utils.residency import (
        resolve_prob_transfer)
    assert residency.resolve_prob_transfer(spelling) == kind
    assert resolve_prob_transfer(spelling) == kind


def test_multiclass_direct_label_map():
    cfg = Config(image_shape=(8, 8, 8), depth=2, n_base_filters=4,
                 n_labels=3, labels=(1, 2, 300), activation_name="softmax",
                 compute_dtype="float32")
    pred = make_direct_predictor(build_model(cfg, "cpu"), cfg, device="cpu")
    x = _volume(cfg.image_shape, 7)
    from fetal_mri_segmentation_tpu.inference.labelmaps import (
        get_prediction_labels)
    for threshold in (0.0, 0.4):
        got = pred.predict_labels(x, threshold)
        want = get_prediction_labels(pred(x), threshold, cfg.labels)
        assert got.dtype == want.dtype == np.uint16
        np.testing.assert_array_equal(got, want)

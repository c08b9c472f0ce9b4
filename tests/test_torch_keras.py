"""Keras interop of the port (``utils/keras_import.py``, ``keras_export.py``,
``keras_opt.py``, ``keras_migrate.py``) against Keras itself and against
the JAX package's modules, on the CPU in fp32 at small size (Keras 3 on its
CPU backend, h5py).

- The port's forward after import against the Keras model's, for the
  U-Net with and without the transposed-conv decoder and for Isensee2017,
  also into a config with a fold (the same parameter tree); the port's
  tree against the JAX importer's, through ``from_flax``.
- The ``.h5`` round trip in the legacy (whole-model) and the Keras 3
  (``.weights.h5``) layout; ``export_keras_*`` back into a Keras model.
- Adam slots: one continued step after ``load_old_model`` against Keras's
  own continued step and the JAX package's; the slots exported back.
- ``derive_config_from_keras_h5``'s fields against the JAX one's;
  ``train.main`` and ``predict.main`` with ``--from-keras`` on 16^3 cases.

Tolerances are the JAX package's Keras tests': forwards atol 2e-5 (5e-5
for Isensee, whose InstanceNorm divides by a small variance); a continued
Adam step atol 1e-6 in every weight; round trips bit for bit.
"""

import csv
import dataclasses
import os
import sys
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
keras = pytest.importorskip("keras")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax.traverse_util import flatten_dict  # noqa: E402

from fetal_mri_segmentation_tpu.config import Config as JaxConfig  # noqa: E402
from fetal_mri_segmentation_tpu.models import build_model as jax_build  # noqa: E402
from fetal_mri_segmentation_tpu.ops.dice import (  # noqa: E402
    dice_coefficient_loss as jax_dice_loss)
from fetal_mri_segmentation_tpu.utils import (  # noqa: E402
    keras_import as JI, keras_migrate as JM)
from fetal_mri_segmentation_tpu_torch import predict as predict_entry  # noqa: E402
from fetal_mri_segmentation_tpu_torch import train as train_entry  # noqa: E402
from fetal_mri_segmentation_tpu_torch.config import (  # noqa: E402
    PORT_ONLY, Config)
from fetal_mri_segmentation_tpu_torch.models import build_model  # noqa: E402
from fetal_mri_segmentation_tpu_torch.ops.dice import (  # noqa: E402
    dice_coefficient_loss)
from fetal_mri_segmentation_tpu_torch.utils import (  # noqa: E402
    keras_export as KE, keras_import as KI, keras_migrate as KM,
    keras_opt as KO)
from fetal_mri_segmentation_tpu_torch.utils.nifti import load_nifti  # noqa: E402
from fetal_mri_segmentation_tpu_torch.utils.params import (  # noqa: E402
    flatten, from_flax, init_flax_like)
from tests.synthetic import write_synthetic_dataset  # noqa: E402
from tests.test_keras_opt import LR, SHAPE, _batch, _build_keras_unet  # noqa: E402

torch.set_num_threads(1)
ATOL, ISENSEE_ATOL, STEP_ATOL = 2e-5, 5e-5, 1e-6
# model name -> port Config keys of the Keras twins below
ARCHS = {
    "unet_deconv": dict(model_name="unet", depth=2, n_base_filters=2,
                        deconvolution=True),
    "unet_upsampling": dict(model_name="unet", depth=2, n_base_filters=2),
    "isensee": dict(model_name="isensee", depth=3, n_base_filters=2,
                    n_segmentation_levels=2),
}


def _keras_unet(deconvolution: bool):
    """The reference U-Net at depth 2, 2 base filters (the JAX tests')."""
    from keras import layers

    inp = keras.Input(shape=SHAPE + (1,))
    x, skips = inp, []
    for level in range(2):
        f = 2 * 2 ** level
        x = layers.Conv3D(f, 3, padding="same", activation="relu")(x)
        x = layers.Conv3D(f * 2, 3, padding="same", activation="relu")(x)
        if level < 1:
            skips.append(x)
            x = layers.MaxPooling3D(2)(x)
    x = (layers.Conv3DTranspose(x.shape[-1], 2, strides=2)(x)
         if deconvolution else layers.UpSampling3D(2)(x))
    x = layers.Concatenate()([x, skips[0]])
    f = skips[0].shape[-1]
    x = layers.Conv3D(f, 3, padding="same", activation="relu")(x)
    x = layers.Conv3D(f, 3, padding="same", activation="relu")(x)
    out = layers.Conv3D(1, 1, activation="sigmoid")(x)
    return keras.Model(inp, out)


def _keras_isensee():
    """The reference Isensee2017 at depth 3, 2 base filters, 2 heads
    (GroupNormalization(groups=-1) for keras-contrib's InstanceNorm)."""
    from keras import layers

    depth, nbf, n_seg = 3, 2, 2

    def conv_block(x, f, strides=1, kernel=3):
        x = layers.Conv3D(f, kernel, strides=strides, padding="same")(x)
        x = layers.GroupNormalization(groups=-1, epsilon=1e-3)(x)
        return layers.LeakyReLU(negative_slope=0.3)(x)

    inp = keras.Input(shape=SHAPE + (1,))
    x, level_outputs, filters = inp, [], []
    for level in range(depth):
        f = nbf * 2 ** level
        filters.append(f)
        in_conv = conv_block(x, f, strides=1 if level == 0 else 2)
        h = conv_block(conv_block(in_conv, f), f)
        x = layers.Add()([in_conv, h])
        level_outputs.append(x)
    seg = []
    for level in range(depth - 2, -1, -1):
        x = conv_block(layers.UpSampling3D(2)(x), filters[level])
        x = layers.Concatenate()([level_outputs[level], x])
        x = conv_block(conv_block(x, filters[level]), filters[level],
                       kernel=1)
        if level < n_seg:
            seg.insert(0, layers.Conv3D(1, 1)(x))
    out = None
    for level in reversed(range(n_seg)):
        out = seg[level] if out is None else layers.Add()([out, seg[level]])
        if level > 0:
            out = layers.UpSampling3D(2)(out)
    return keras.Model(inp, layers.Activation("sigmoid")(out))


def _keras_model(name):
    return _keras_isensee() if name == "isensee" else _keras_unet(
        name == "unet_deconv")


def _config(name, **kw):
    return Config(**ARCHS[name], patch_shape=SHAPE, compute_dtype="float32",
                  **kw)


def _port(cfg, state_dict):
    model = build_model(cfg, "cpu")
    model.load_state_dict(state_dict)
    return model


def _forward(model, x):
    with torch.no_grad():
        return model.eval()(torch.from_numpy(x)).numpy()


@pytest.fixture(scope="module", params=sorted(ARCHS))
def twin(request):
    """A Keras model with its random initial weights, the port's config."""
    keras.utils.set_random_seed(sorted(ARCHS).index(request.param))
    return request.param, _keras_model(request.param), _config(request.param)


def test_forward_after_import_equals_keras(twin):
    name, kmodel, cfg = twin
    model = _port(cfg, KI.keras_state_dict(
        cfg, KI.keras_weight_list_from_model(kmodel)))
    x = np.random.default_rng(0).normal(0, 1, (2,) + SHAPE + (1,)).astype(
        np.float32)
    np.testing.assert_allclose(
        _forward(model, x), np.asarray(kmodel(x)),
        atol=ISENSEE_ATOL if name == "isensee" else ATOL, rtol=0)


def test_import_into_a_fold_config_equals_keras(twin):
    """The parameter tree does not change with the fold: the Keras weights
    import into a config with ``fold_level0`` (1, 1, 2), whose folded
    forward equals the Keras model's; the transposed-conv U-Net, which the
    JAX model refuses to fold, is refused with its message."""
    name, kmodel, cfg = twin
    fold_cfg = dataclasses.replace(cfg, fold_level0=(1, 1, 2))
    weights = KI.keras_weight_list_from_model(kmodel)
    if name == "unet_deconv":
        with pytest.raises(ValueError, match="requires the fused decoder"):
            _port(fold_cfg, KI.keras_state_dict(fold_cfg, weights))
        return
    model = _port(fold_cfg, KI.keras_state_dict(fold_cfg, weights))
    assert model.fold_level0 == (1, 1, 2)
    x = np.random.default_rng(0).normal(0, 1, (1,) + SHAPE + (1,)).astype(
        np.float32)
    np.testing.assert_allclose(
        _forward(model, x), np.asarray(kmodel(x)),
        atol=ISENSEE_ATOL if name == "isensee" else ATOL, rtol=0)


def test_tree_equals_the_jax_importer(twin):
    """The port's flax-layout tree equals the JAX importer's on the JAX
    model's own params tree, and so do the state dicts through
    ``from_flax``."""
    name, kmodel, cfg = twin
    weights = KI.keras_weight_list_from_model(kmodel)
    jcfg = JaxConfig(**{k: v for k, v in dataclasses.asdict(cfg).items()
                        if k not in PORT_ONLY})
    jmodel = jax_build(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0),
                         jnp.zeros((1,) + SHAPE + (1,)))["params"]
    importer = (JI.import_keras_isensee_weights if name == "isensee"
                else JI.import_keras_unet_weights)
    want = flatten_dict(importer(params, weights), sep="/")
    got = flatten(KI.keras_params(cfg, weights))
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)
    for k, v in from_flax(want).items():
        assert torch.equal(KI.keras_state_dict(cfg, weights)[k], v), k


@pytest.mark.parametrize("layout", ["legacy", "keras3"])
def test_h5_round_trip(twin, tmp_path, layout):
    """Importing from a saved ``.h5`` equals importing from the live model:
    the legacy whole-model file (build order) and the Keras 3
    ``.weights.h5`` (type-grouped, alphabetical)."""
    name, kmodel, cfg = twin
    path = str(tmp_path / ("m.h5" if layout == "legacy" else "m.weights.h5"))
    kmodel.save(path) if layout == "legacy" else kmodel.save_weights(path)
    got = KI.keras_state_dict(cfg, KI.keras_weight_list_from_h5(path))
    want = KI.keras_state_dict(cfg, KI.keras_weight_list_from_model(kmodel))
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_export_into_keras_equals_the_port(twin):
    """Random port weights pushed onto the twin Keras model give the
    port's probabilities, and import back bit for bit."""
    name, _, cfg = twin
    kmodel = _keras_model(name)
    model = _port(cfg, from_flax(init_flax_like(cfg, seed=7)))
    exporter = (KE.export_keras_isensee_weights if name == "isensee"
                else KE.export_keras_unet_weights)
    exporter(model, kmodel)
    x = np.random.default_rng(1).normal(0, 1, (2,) + SHAPE + (1,)).astype(
        np.float32)
    np.testing.assert_allclose(np.asarray(kmodel(x)), _forward(model, x),
                               atol=ATOL, rtol=0)
    back = KI.keras_state_dict(cfg, KI.keras_weight_list_from_model(kmodel))
    for k, v in model.state_dict().items():
        assert torch.equal(back[k], v), k


def test_importers_refuse_the_wrong_architecture():
    cfg = _config("unet_deconv")
    isensee = KI.keras_weight_list_from_model(_keras_isensee())
    with pytest.raises(ValueError, match="normalization layers"):
        KI.keras_state_dict(cfg, isensee)
    with pytest.raises(ValueError, match="weight count mismatch"):
        KI.keras_state_dict(dataclasses.replace(cfg, depth=3), KI.
                            keras_weight_list_from_model(_keras_unet(True)))
    with pytest.raises(ValueError, match="keras model contains "
                       "normalization layers"):
        KE.export_keras_unet_weights(
            _port(cfg, from_flax(init_flax_like(cfg))), _keras_isensee())


# --- Adam slots and the one-call migration --------------------------------


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A compiled Keras U-Net trained 3 steps and saved whole (the
    reference's ModelCheckpoint file), the weight list after ONE further
    step of the same live model (the continuation), and its forward on a
    probe before that step."""
    keras.utils.set_random_seed(0)
    kmodel = _build_keras_unet()
    for s in range(3):
        kmodel.train_on_batch(*_batch(s))
    path = str(tmp_path_factory.mktemp("keras") / "model.h5")
    kmodel.save(path)
    probe = np.random.default_rng(7).normal(0, 1, (2,) + SHAPE + (1,))
    probe = probe.astype(np.float32)
    y_probe = np.asarray(kmodel(probe))
    kmodel.train_on_batch(*_batch(99))
    return path, KI.keras_weight_list_from_model(kmodel), probe, y_probe


def _port_step(model, state, x, y):
    model.train()
    state.optimizer.zero_grad()
    dice_coefficient_loss(torch.from_numpy(y),
                          model(torch.from_numpy(x))).backward()
    state.optimizer.step()


def test_continued_step_equals_keras_and_jax(trained):
    """``load_old_model`` on the file, one further step, and every weight
    lands where Keras's own continuation and the JAX package's land."""
    path, continued, probe, y_probe = trained
    model, state, cfg = KM.load_old_model(path, verbose=False, device="cpu")
    assert state.step == 3 and abs(state.learning_rate - LR) < 1e-9
    np.testing.assert_allclose(_forward(model, probe), y_probe, atol=ATOL,
                               rtol=0)
    _port_step(model, state, *_batch(99))
    want = KI.keras_state_dict(cfg, continued)
    jmodel, jstate, _ = JM.load_old_model(path, verbose=False)

    @jax.jit
    def step(s, x, y):
        grads = jax.grad(lambda p: jax_dice_loss(
            y, jmodel.apply({"params": p}, x)))(s.params)
        return s.apply_gradients(grads)

    jstate = step(jstate, *map(jnp.asarray, _batch(99)))
    jax_sd = from_flax(flatten_dict(jax.device_get(jstate.params), sep="/"))
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(),
                                   atol=STEP_ATOL, rtol=0, err_msg=k)
        np.testing.assert_allclose(v.numpy(), jax_sd[k].numpy(),
                                   atol=STEP_ATOL, rtol=0, err_msg=k)


def test_continued_step_without_slots_differs(trained):
    """Control: the same step from fresh Adam moments lands measurably
    elsewhere, so the test above is not vacuous."""
    path, continued, _, _ = trained
    model, state, cfg = KM.load_old_model(path, with_optimizer=False,
                                          verbose=False, device="cpu")
    assert state.step == 0
    _port_step(model, state, *_batch(99))
    want = KI.keras_state_dict(cfg, continued)
    assert max(float((v - want[k]).abs().max())
               for k, v in model.state_dict().items()) > 1e-5


def test_adam_state_exports_back_into_keras(trained):
    """The slots written onto a fresh compiled Keras twin equal the file's,
    with its iteration count and learning rate."""
    path = trained[0]
    model, state, _ = KM.load_old_model(path, verbose=False, device="cpu")
    kmodel = _build_keras_unet()
    KE.export_keras_unet_weights(model, kmodel)
    KO.export_keras_adam_state(state, kmodel, KE.export_keras_unet_weights)
    got = KO.keras_adam_slots_from_model(kmodel)
    want = KO.keras_adam_slots_from_h5(path)
    assert got.iterations == want.iterations == 3
    assert abs(got.learning_rate - want.learning_rate) < 1e-9
    for a, b in zip(got.momentum + got.velocity,
                    want.momentum + want.velocity):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def isensee_h5(tmp_path_factory):
    keras.utils.set_random_seed(1)
    kmodel = _keras_isensee()
    kmodel.compile(optimizer=keras.optimizers.Adam(5e-4), loss="mse")
    path = str(tmp_path_factory.mktemp("keras_i") / "isensee.h5")
    kmodel.save(path)
    probe = np.random.default_rng(3).normal(0, 1, (1,) + SHAPE + (1,))
    probe = probe.astype(np.float32)
    return path, probe, np.asarray(kmodel(probe))


@pytest.mark.parametrize("which", ["unet", "isensee", "weights_only"])
def test_derive_config_equals_jax(trained, isensee_h5, tmp_path, which):
    """Every field of the derived config equals the JAX package's; the
    Isensee file also loads and predicts as Keras does."""
    if which == "weights_only":
        path = str(tmp_path / "w.weights.h5")
        _build_keras_unet().save_weights(path)
    else:
        path = trained[0] if which == "unet" else isensee_h5[0]
    base = dict(patch_shape=(16, 16, 16), image_shape=(16, 16, 16))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = KM.derive_config_from_keras_h5(path, base=Config(**base),
                                             verbose=False)
        want = JM.derive_config_from_keras_h5(path, base=JaxConfig(**base),
                                              verbose=False)
    # the port's own Config fields aside, which the JAX Config does not have
    assert {k: v for k, v in dataclasses.asdict(got).items()
            if k not in PORT_ONLY} == dataclasses.asdict(want)
    if which == "isensee":
        _, probe, y_probe = isensee_h5
        model, state, cfg = KM.load_old_model(path, verbose=False,
                                              device="cpu")
        assert cfg.model_name == "isensee" and state.step == 0
        np.testing.assert_allclose(_forward(model, probe), y_probe,
                                   atol=ISENSEE_ATOL, rtol=0)


def test_without_h5py_the_error_names_it(trained, monkeypatch):
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="needs h5py"):
        KM.load_old_model(trained[0], device="cpu")


def test_train_main_from_keras(trained, tmp_path):
    """``train.main --from-keras`` on 16^3 cases: the architecture and the
    Adam state from the file, an epoch trained and checkpointed, the same
    per-epoch loss as the root ``train.py --from-keras``; a second run over
    the fresh checkpoint without ``--overwrite`` is refused."""
    import train as jax_train

    path = trained[0]
    cases = str(tmp_path / "cases")
    write_synthetic_dataset(cases, n_cases=4, shape=(16, 16, 16))
    kw = dict(image_shape=SHAPE, validation_patch_overlap=2,
              training_patch_start_offset=(2, 2, 2), batch_size=2,
              n_epochs=1, num_devices=1, augment=False)
    logs = {}
    for tag, cls, main in (("port", Config, train_entry.main),
                           ("jax", JaxConfig, jax_train.main)):
        d = tmp_path / tag
        cfg = cls(**kw, data_file=str(d / "data"),
                  model_file=str(d / "model.ckpt"),
                  training_file=str(d / "training_ids.pkl"),
                  validation_file=str(d / "validation_ids.pkl"),
                  training_log=str(d / "training.log"))
        if tag == "jax":
            cfg.data_file += ".h5"
        os.makedirs(d)
        extra = {"device": "cpu"} if tag == "port" else {}
        main(cfg, cases, verbose=False, from_keras=path, **extra)
        assert os.path.exists(cfg.model_file)
        with open(cfg.training_log) as f:
            logs[tag] = list(csv.DictReader(f))
    for key in ("loss", "val_loss"):
        np.testing.assert_allclose(
            [float(r[key]) for r in logs["port"]],
            [float(r[key]) for r in logs["jax"]], atol=1e-4, err_msg=key)
    port_cfg = Config(**kw, data_file=str(tmp_path / "port" / "data"),
                      model_file=str(tmp_path / "port" / "model.ckpt"),
                      training_file=str(tmp_path / "port" / "t.pkl"),
                      validation_file=str(tmp_path / "port" / "v.pkl"),
                      training_log=str(tmp_path / "port" / "again.log"))
    with pytest.raises(SystemExit, match="from-keras"):
        train_entry.main(port_cfg, cases, verbose=False, from_keras=path,
                         device="cpu")


def test_predict_main_from_keras(trained, tmp_path):
    """``predict.main --from-keras --input`` on a 16^3 case: the
    probability map equals the root ``predict.py --from-keras``'s within
    the forward's tolerance, and the label map is written."""
    import predict as jax_predict

    path = trained[0]
    cases = str(tmp_path / "cases")
    write_synthetic_dataset(cases, n_cases=1, shape=(16, 16, 16))
    case = os.path.join(cases, "case_0")
    kw = dict(image_shape=SHAPE, validation_patch_overlap=2)
    predict_entry.main(Config(**kw), inputs=[case], output_dir=str(
        tmp_path / "port"), overlap=2, prob_map=True, from_keras=path,
        device="cpu", verbose=False)
    jax_predict.main(JaxConfig(**kw), output_dir=str(tmp_path / "jax"),
                     overlap=2, inputs=[case], prob_map=True,
                     from_keras=path)
    got, want = (load_nifti(str(tmp_path / t / "case_0" /
                                "prediction.nii.gz")).get_fdata()
                 for t in ("port", "jax"))
    assert got.shape == SHAPE
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    predict_entry.main(Config(**kw), inputs=[case], output_dir=str(
        tmp_path / "labels"), overlap=2, from_keras=path, device="cpu",
        verbose=False)
    labels = load_nifti(str(tmp_path / "labels" / "case_0" /
                            "prediction.nii.gz")).get_fdata()
    assert labels.shape == SHAPE and set(np.unique(labels)) <= {0, 1}

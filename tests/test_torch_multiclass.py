"""The port's multi-class training against the JAX package's
``tests/test_multiclass.py::test_multiclass_end_to_end``.

The same fixture: three 20^3 cases with nested labels (5 = outer shell,
2 = core), written into a 16^3 dataset by each package's writer; depth 2,
4 base filters, sigmoid over two label channels, batch 2, fp32, lr 5e-3,
augmentation off, fold off. Each package's generator yields the same
one-hot batch; the port starts from the JAX model's parameters
(``from_flax``) and the kernel switches are on (their plain versions run
on the CPU). Each of the first 10 steps' loss and per-label dice within
rtol 1e-4 of the JAX step's on that batch: both run fp32, and their sums
differ by reassociation alone (about 1e-6 relative per step), which 10
Adam steps at lr 5e-3 grow by well under 1e-4. After 150 steps the JAX
test's own assertions hold for the port: the last loss below the first,
both ``label_*_dice_coef`` metrics present, the predicted label map in
{0, 2, 5}, core dice above 0.5 and shell dice above 0.3. The pieces of the
path are held to their JAX counterparts too: the weighted dice and its
gradient, the label-wise metric closures, the label map of a probability
volume, the dice-collapse detector, and a ``train_model`` log's label
columns.
"""

import csv

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax.traverse_util import flatten_dict  # noqa: E402

from fetal_mri_segmentation_tpu.config import Config as JaxConfig  # noqa: E402
from fetal_mri_segmentation_tpu.data import (  # noqa: E402
    open_data_file as jax_open, write_data_to_file as jax_write)
from fetal_mri_segmentation_tpu.inference.labelmaps import (  # noqa: E402
    get_prediction_labels as jax_labels)
from fetal_mri_segmentation_tpu.models import build_model as jax_build  # noqa: E402
from fetal_mri_segmentation_tpu.ops import dice as jax_dice  # noqa: E402
from fetal_mri_segmentation_tpu.pipeline import (  # noqa: E402
    data_generator as jax_generator)
from fetal_mri_segmentation_tpu.training.loop import (  # noqa: E402
    detect_dice_collapse as jax_collapse)
from fetal_mri_segmentation_tpu.training import (  # noqa: E402
    create_train_state as jax_state, make_train_step as jax_step)
from fetal_mri_segmentation_tpu.utils.nifti import save_nifti  # noqa: E402
from fetal_mri_segmentation_tpu_torch.config import Config  # noqa: E402
from fetal_mri_segmentation_tpu_torch.data.build import (  # noqa: E402
    open_data_file, write_data_to_file)
from fetal_mri_segmentation_tpu_torch.data.memory import (  # noqa: E402
    InMemoryDataFile)
from fetal_mri_segmentation_tpu_torch.inference.labelmaps import (  # noqa: E402
    get_prediction_labels)
from fetal_mri_segmentation_tpu_torch.inference.sliding_window import (  # noqa: E402
    SlidingWindowPredictor)
from fetal_mri_segmentation_tpu_torch.models import build_model  # noqa: E402
from fetal_mri_segmentation_tpu_torch.ops import dice as port_dice  # noqa: E402
from fetal_mri_segmentation_tpu_torch.pipeline.generator import (  # noqa: E402
    data_generator, get_training_and_validation_generators)
from fetal_mri_segmentation_tpu_torch.training.loop import (  # noqa: E402
    detect_dice_collapse, train_model)
from fetal_mri_segmentation_tpu_torch.training.state import (  # noqa: E402
    create_train_state)
from fetal_mri_segmentation_tpu_torch.training.train_step import (  # noqa: E402
    make_train_step)
from fetal_mri_segmentation_tpu_torch.utils.params import from_flax  # noqa: E402

torch.set_num_threads(1)
LOSS_RTOL = 1e-4
N_MATCHED, N_STEPS = 10, 150
SETTINGS = dict(model_name="unet", depth=2, n_base_filters=4,
                patch_shape=(16, 16, 16), image_shape=(16, 16, 16),
                n_labels=2, labels=(2, 5), activation_name="sigmoid",
                batch_size=2, compute_dtype="float32", augment=False,
                include_label_wise_dice_coefficients=True,
                initial_learning_rate=5e-3, fold_level0="off")


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """The JAX test's cases, built by each package (HDF5 and the port's
    directory layout); the arrays must be equal."""
    d = tmp_path_factory.mktemp("mc")
    files = []
    for i in range(3):
        rng = np.random.default_rng(i)
        zz, yy, xx = np.mgrid[:20, :20, :20]
        r2 = (zz - 10) ** 2 + (yy - 10) ** 2 + (xx - 10) ** 2
        truth = np.zeros((20, 20, 20), np.uint8)
        truth[r2 < 64] = 5
        truth[r2 < 16] = 2
        vol = (truth == 5) * 1.0 + (truth == 2) * 3.0 + rng.normal(
            0, 0.2, truth.shape)
        case = d / f"case_{i}"
        case.mkdir()
        save_nifti(vol.astype(np.float32), str(case / "volume.nii.gz"))
        save_nifti(truth, str(case / "truth.nii.gz"))
        files.append([str(case / "volume.nii.gz"), str(case / "truth.nii.gz")])
    jax_path, port_path = str(d / "mc.h5"), str(d / "mc_port")
    jax_write(files, jax_path, image_shape=(16, 16, 16),
              normalize="per_volume", crop=False)
    write_data_to_file(files, port_path, image_shape=(16, 16, 16),
                       normalize="per_volume", crop=False)
    jf, pf = jax_open(jax_path), open_data_file(port_path)
    for name in ("data", "truth", "affine"):
        np.testing.assert_array_equal(np.asarray(getattr(pf.root, name)[:]),
                                      np.asarray(getattr(jf.root, name)[:]))
    yield jf, pf
    jf.close()
    pf.close()


def _batch(jf, pf):
    """The JAX test's first batch from each generator: equal."""
    kw = dict(batch_size=2, n_labels=2, labels=(2, 5), patch_shape=None,
              skip_blank=True, seed=0)
    jx, jy = next(jax_generator(jf, [0, 1, 2], **kw))
    x, y = next(data_generator(pf, [0, 1, 2], **kw))
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)
    assert y.shape[1] == 2 and set(np.unique(y)) <= {0.0, 1.0}
    assert (y[:, 0] * y[:, 1]).sum() == 0  # nested labels: one channel each
    return x, y


def test_multiclass_end_to_end_matches_jax(datasets):
    jf, pf = datasets
    x, y = _batch(jf, pf)
    jcfg = JaxConfig(**SETTINGS)
    jmodel = jax_build(jcfg)
    js = jax_state(jmodel, jcfg, jax.random.PRNGKey(0))
    jstep = jax_step(jmodel, jcfg)
    cfg = Config(**SETTINGS, use_pallas_conv=True, use_pallas_dec0=True)
    model = build_model(cfg, "cpu")
    model.load_state_dict(from_flax(flatten_dict(js.params, sep="/")))
    state = create_train_state(model, cfg)
    step = make_train_step(model, cfg,
                           generator=torch.Generator().manual_seed(0))
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)

    rng = jax.random.PRNGKey(0)
    losses = []
    for i in range(N_STEPS):
        m = step(state, xt, yt)
        losses.append(float(m["loss"]))
        if i < N_MATCHED:
            rng, k = jax.random.split(rng)
            js, jm = jstep(js, jnp.asarray(x), jnp.asarray(y), k, None)
            assert sorted(m) == sorted(jm)
            for key in jm:
                np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                           rtol=LOSS_RTOL, err_msg=(i, key))
    # the JAX test's assertions, on the port
    assert losses[-1] < losses[0]
    assert "label_0_dice_coef" in m and "label_1_dice_coef" in m
    pred = SlidingWindowPredictor(model, cfg, image_shape=(16, 16, 16),
                                  overlap=0, patch_batch_size=1)
    data = np.asarray(pf.root.data[0], np.float32)
    labels = pred.predict_labels(data)
    assert labels.dtype == np.uint8
    assert set(np.unique(labels)) <= {0, 2, 5}
    truth = np.asarray(pf.root.truth[0][0])
    d2 = port_dice.hard_dice(truth == 2, labels == 2)
    d5 = port_dice.hard_dice(truth == 5, labels == 5)
    assert d2 > 0.5 and d5 > 0.3, (d2, d5)


@pytest.mark.parametrize("with_mask", [False, True])
def test_weighted_dice_and_label_metrics_match_jax(with_mask):
    rng = np.random.default_rng(3)
    y = (rng.uniform(size=(3, 3, 6, 5, 4)) > 0.6).astype(np.float32)
    p = rng.uniform(size=y.shape).astype(np.float32)
    mask = np.array([1.0, 1.0, 0.0], np.float32) if with_mask else None
    yt = torch.from_numpy(y)
    pt = torch.from_numpy(p).requires_grad_()
    loss = port_dice.weighted_dice_coefficient_loss(
        yt, pt, sample_mask=None if mask is None else torch.from_numpy(mask))
    loss.backward()

    def jloss(pp):
        return jax_dice.weighted_dice_coefficient_loss(
            jnp.asarray(y), pp,
            sample_mask=None if mask is None else jnp.asarray(mask))

    want, grad = jax.value_and_grad(jloss)(jnp.asarray(p))
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(pt.grad.numpy(), np.asarray(grad), rtol=1e-5,
                               atol=1e-9)
    for i in range(3):
        f = port_dice.get_label_dice_coefficient_function(i)
        g = jax_dice.get_label_dice_coefficient_function(i)
        assert f.__name__ == g.__name__ == f"label_{i}_dice_coef"
        np.testing.assert_allclose(
            float(f(yt, pt.detach())),
            float(g(jnp.asarray(y), jnp.asarray(p))), rtol=1e-6)
        np.testing.assert_allclose(
            float(port_dice.label_wise_dice_coefficient(yt, pt.detach(), i)),
            float(jax_dice.label_wise_dice_coefficient(
                jnp.asarray(y), jnp.asarray(p), i)), rtol=1e-6)


@pytest.mark.parametrize("labels", [(1, 2, 4), (2, 5), None])
def test_prediction_labels_match_jax(labels):
    rng = np.random.default_rng(4)
    n = 3 if labels is None else len(labels)
    prob = rng.uniform(size=(n, 5, 6, 7)).astype(np.float32)
    got = get_prediction_labels(prob, labels=labels)
    want = jax_labels(prob, labels=labels)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("history", [
    [], [0.0, 0.0], [0.5, 0.005, 0.002, 0.009], [0.0, 0.0, 0.02],
    [0.9, 0.0, 0.0, 0.0], [0.01, 0.01, 0.01]])
def test_dice_collapse_detector_matches_jax(history):
    assert detect_dice_collapse(history) == jax_collapse(history)
    assert (detect_dice_collapse(history, patience=2, threshold=0.02)
            == jax_collapse(history, patience=2, threshold=0.02))


def test_train_model_logs_label_columns(tmp_path):
    """``train_model`` on the multi-class recipe's problem at 16^3 (three
    disjoint structures labelled 1, 2, 4; depth 3, 8 filters, whole-volume
    patches shifted by up to the start offset, batch 3, lr 5e-4, fp32,
    augmentation off) against the JAX ``train_model`` from the same
    parameters on the same cases: every epoch's loss, dice and per-label
    columns within rtol 1e-4 (the loop adds no arithmetic to the matched
    steps). The log carries the per-label columns under the JAX names
    (``label_{i}`` by channel index, as the reference's metric closures
    name them), and the loss falls."""
    from fetal_mri_segmentation_tpu.pipeline import (
        get_training_and_validation_generators as jax_generators)
    from fetal_mri_segmentation_tpu.training import train_model as jax_train
    from tests.synthetic import make_multiclass_case
    cases = [make_multiclass_case((16, 16, 16), seed=i) for i in range(8)]
    data = np.stack([c[0] for c in cases])[:, None]
    data = (data - data.mean(axis=(2, 3, 4), keepdims=True)) / data.std(
        axis=(2, 3, 4), keepdims=True)
    truth = np.stack([c[1] for c in cases])
    settings = dict(
        model_name="unet", depth=3, n_base_filters=8,
        image_shape=(16, 16, 16), patch_shape=(16, 16, 16), n_labels=3,
        labels=(1, 2, 4), batch_size=3, validation_batch_size=3, n_epochs=4,
        early_stop=0, patience=4, augment=False,
        include_label_wise_dice_coefficients=True,
        initial_learning_rate=5e-4, compute_dtype="float32",
        fold_level0="off", skip_blank=False, validation_split=0.75,
        validation_patch_overlap=0, training_patch_start_offset=(6, 6, 6))
    logs = {}
    for side in ("jax", "port"):
        paths = {k: str(tmp_path / f"{side}_{k}") for k in (
            "model_file", "training_file", "validation_file", "training_log")}
        gens = (jax_generators if side == "jax"
                else get_training_and_validation_generators)(
            InMemoryDataFile(data, truth), batch_size=3, n_labels=3,
            labels=(1, 2, 4), training_keys_file=paths["training_file"],
            validation_keys_file=paths["validation_file"], data_split=0.75,
            patch_shape=(16, 16, 16), validation_batch_size=3,
            training_patch_start_offset=(6, 6, 6), skip_blank=False, seed=0)
        if side == "jax":
            jcfg = JaxConfig(**settings, **paths)
            jmodel = jax_build(jcfg)
            js = jax_state(jmodel, jcfg, jax.random.PRNGKey(0))
            # the JAX step donates the state's buffers: copy them first
            init = from_flax(flatten_dict(js.params, sep="/"))
            jax_train(jmodel, js, jcfg, gens[0], gens[2], gens[1], gens[3],
                      verbose=False)
        else:
            cfg = Config(**settings, **paths, use_pallas_conv=True,
                         use_pallas_dec0=True)
            model = build_model(cfg, "cpu")
            model.load_state_dict(init)
            train_model(model, create_train_state(model, cfg), cfg, gens[0],
                        gens[2], gens[1], gens[3], verbose=False)
        with open(paths["training_log"]) as f:
            logs[side] = list(csv.DictReader(f))
    rows = logs["port"]
    assert len(rows) == len(logs["jax"]) == 4
    columns = ["loss", "val_loss", "dice_coefficient",
               "val_dice_coefficient"] + [
        f"{p}label_{i}_dice_coef" for i in range(3) for p in ("", "val_")]
    assert set(columns) <= set(rows[0])
    for got, want in zip(rows, logs["jax"]):
        for c in columns:
            np.testing.assert_allclose(float(got[c]), float(want[c]),
                                       rtol=1e-4, err_msg=(got["epoch"], c))
    assert float(rows[-1]["loss"]) < float(rows[0]["loss"])

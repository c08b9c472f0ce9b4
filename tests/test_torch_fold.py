"""Space-to-depth folding in the port (``ops/fold.py``, the folded level 0
of ``UNet3D`` and ``Isensee2017``) against the JAX package, case by case as
``tests/test_fold.py`` holds the JAX fold to the plain convs.

Seeded numpy inputs and random per-channel parameters (biases, norm scales
and offsets drawn at random, so a wrong channel permute cannot hide behind
equal channels) go through the JAX function and the port's, in fp32 on the
CPU: every folded op per factor set and formulation, the folded norm, both
model families folded against JAX folded and against the port unfolded (in
eval and in training, full (2,2,2) factors, a non-cubic patch, depth 4),
the gates and the auto resolution with the JAX messages, a fold config's
train step against JAX's, the spatial predictor with a fold on 2 and 4
thread-ranks against one device, and the portable program of a fold
config against the unfolded one. Tolerance rtol 2e-4, atol 2e-5 (the JAX
package's own fold tolerance; the layout ops are exact). The
data-parallel step with a fold runs in ``tests/test_torch_parallel.py``'s
rank launch ("with_fold"), a Keras import into a fold config in
``tests/test_torch_keras.py``.
"""

import copy
import functools
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from fetal_mri_segmentation_tpu.config import Config as JaxConfig  # noqa: E402
from fetal_mri_segmentation_tpu.models import isensee2017 as JI  # noqa: E402
from fetal_mri_segmentation_tpu.models import layers as JL  # noqa: E402
from fetal_mri_segmentation_tpu.models.isensee2017 import (  # noqa: E402
    Isensee2017 as JaxIsensee)
from fetal_mri_segmentation_tpu.models.unet3d import UNet3D as JaxUNet3D  # noqa: E402
from fetal_mri_segmentation_tpu.ops import fold as JF  # noqa: E402
from fetal_mri_segmentation_tpu_torch.config import (  # noqa: E402
    Config, check_supported)
from fetal_mri_segmentation_tpu_torch.models import build_model  # noqa: E402
from fetal_mri_segmentation_tpu_torch.models import layers as PL  # noqa: E402
from fetal_mri_segmentation_tpu_torch.models.isensee2017 import (  # noqa: E402
    Isensee2017)
from fetal_mri_segmentation_tpu_torch.models.unet3d import UNet3D  # noqa: E402
from fetal_mri_segmentation_tpu_torch.ops import fold as PF  # noqa: E402
from fetal_mri_segmentation_tpu_torch.parallel import (  # noqa: E402
    collectives, spatial)
from fetal_mri_segmentation_tpu_torch.training.train_step import (  # noqa: E402
    make_train_step)
from fetal_mri_segmentation_tpu_torch.utils import export  # noqa: E402
from fetal_mri_segmentation_tpu_torch.utils.params import flax_params  # noqa: E402

from tests.test_torch_unet3d import _ThreadRanks, _thread_dist  # noqa: E402
from tests import test_torch_train_step as TS  # noqa: E402

torch.set_num_threads(1)
RTOL, ATOL = 2e-4, 2e-5
FACTOR_SETS = [(2, 2, 2), (1, 2, 2), (2, 1, 1), (1, 1, 2)]
FORMS = ["parity", "parity_batched", "dense"]


def _np(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(got, want, rtol=RTOL, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def _randomized(model, seed=0):
    """``model`` with every bias drawn at random and every norm scale 1 +
    a random offset, so each channel carries its own values; returns its
    parameters as a flax tree for the JAX model (made from the port's
    model, since a flax ``init`` of a folded model costs many seconds)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(("bias", "scale")):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.3
                        + name.endswith("scale"))
    return {"params": flax_params(model)}


def _jax_apply(jmodel, variables, x, **kw):
    return jax.jit(functools.partial(jmodel.apply, **kw))(
        variables, jnp.asarray(x))


# ---------------------------------------------------------------- layout ops


@pytest.mark.parametrize("factors", FACTOR_SETS)
def test_fold_round_trip_equals_jax(factors):
    x = _np(np.random.default_rng(0), 2, 8, 6, 4, 3)
    got = PF.fold(_t(x), factors)
    want = JF.fold(jnp.asarray(x), factors)
    n = factors[0] * factors[1] * factors[2]
    assert tuple(got.shape) == (2, 8 // factors[0], 6 // factors[1],
                                4 // factors[2], 3 * n)
    assert got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(PF.unfold(got, factors).numpy(), x)
    np.testing.assert_array_equal(
        PF.unfold(got, factors).numpy(),
        np.asarray(JF.unfold(want, factors)))


def test_fold_order_is_subvoxel_major():
    """Folded channel ((b1*f2 + b2)*f3 + b3)*C + c, as in the JAX fold."""
    x = _np(np.random.default_rng(1), 1, 4, 4, 4, 2)
    xf = PF.fold(_t(x), (2, 2, 2)).numpy()
    for b1 in range(2):
        for b2 in range(2):
            for b3 in range(2):
                s = (b1 * 2 + b2) * 2 + b3
                np.testing.assert_array_equal(xf[0, 1, 0, 1, 2 * s:2 * s + 2],
                                              x[0, 2 + b1, b2, 2 + b3])


OPS = ["conv3_parity", "conv3_parity_batched", "conv3_dense",
       "conv3_stride2", "pool", "up_conv3", "upsample", "concat", "conv1"]


@pytest.mark.parametrize("factors", FACTOR_SETS + [(1, 1, 1)])
@pytest.mark.parametrize("op", OPS)
def test_folded_op_matches_jax(op, factors):
    """Each op of the fold algebra on the same folded inputs, kernel and
    bias as the JAX function, and (the conv forms) as the plain conv."""
    rng = np.random.default_rng(OPS.index(op))
    cin, cout = 3, 5
    k = _np(rng, 3, 3, 3, cin, cout, scale=0.2)
    b = _np(rng, cout)
    if op.startswith("conv3") or op in ("pool", "conv1", "concat"):
        shape = (2, 8, 8, 8, cin) if op == "conv3_stride2" else (
            2, 8, 6, 4, cin)
        x = _np(rng, *shape)
        xf = np.asarray(JF.fold(jnp.asarray(x), factors))
    if op.startswith("conv3_") and op != "conv3_stride2":
        form = op[len("conv3_"):]
        got = PF.conv3_folded(_t(xf), _t(k), _t(b), factors, form)
        want = JF.conv3_folded(jnp.asarray(xf), jnp.asarray(k),
                               jnp.asarray(b), factors, formulation=form)
        plain = PL.conv3d_ndhwc(_t(x), _t(k).permute(4, 3, 0, 1, 2),
                                _t(b), padding=1)
        _close(PF.unfold(got, factors), plain.numpy())
    elif op == "conv3_stride2":
        got = PF.conv3_folded_stride2(_t(xf), _t(k), _t(b), factors)
        want = JF.conv3_folded_stride2(jnp.asarray(xf), jnp.asarray(k),
                                       jnp.asarray(b), factors)
    elif op == "pool":
        got = PF.pool_folded(_t(xf), factors)
        want = JF.pool_folded(jnp.asarray(xf), factors)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    elif op in ("up_conv3", "upsample"):
        xd = _np(rng, 2, 4, 3, 5, cin)
        if op == "up_conv3":
            got = PF.up_conv3_folded(_t(xd), _t(k), factors)
            want = JF.up_conv3_folded(jnp.asarray(xd), jnp.asarray(k),
                                      factors)
        else:
            got = PF.upsample_nearest_folded(_t(xd), factors)
            want = JF.upsample_nearest_folded(jnp.asarray(xd), factors)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    elif op == "concat":
        other = _np(rng, *xf.shape[:4], 2 * xf.shape[4] // cin)
        got = PF.concat_folded(_t(xf), _t(other), factors)
        want = JF.concat_folded(jnp.asarray(xf), jnp.asarray(other), factors)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        k1 = _np(rng, 1, 1, 1, cin, cout)
        got = PF.conv1_folded(_t(xf), _t(k1), _t(b), factors)
        want = JF.conv1_folded(jnp.asarray(xf), jnp.asarray(k1),
                               jnp.asarray(b), factors)
    assert tuple(got.shape) == tuple(want.shape)
    _close(got, want)


def test_refusals_carry_the_jax_messages():
    """Bad factors, a non-divisible volume, an unknown formulation and the
    stride-2 conv over an odd unfolded axis (SAME stride 2 pads it (1, 1),
    not the (0, 1) the routing encodes)."""
    rng = np.random.default_rng(2)
    x = _np(rng, 1, 7, 8, 8, 2)
    k = _np(rng, 3, 3, 3, 2, 3)
    cases = [
        (lambda m, a: m.fold(a(x), (2, 3, 1)), "fold factors must be"),
        (lambda m, a: m.fold(a(x), (2, 2, 2)), "not divisible by factors"),
        (lambda m, a: m.conv3_folded(a(x[:, :6]), a(k), None, (2, 2, 2),
                                     "nope"), "unknown formulation"),
        (lambda m, a: m.conv3_folded_stride2(m.fold(a(x), (1, 1, 2)), a(k),
                                             None, (1, 1, 2)),
         "even spatial dims"),
    ]
    for run, match in cases:
        messages = []
        for mod, arr in ((JF, jnp.asarray), (PF, _t)):
            with pytest.raises(ValueError, match=match) as err:
                run(mod, arr)
            messages.append(str(err.value))
        assert messages[0] == messages[1]


@pytest.mark.parametrize("factors", FACTOR_SETS)
def test_folded_instance_norm_matches_jax(factors):
    rng = np.random.default_rng(3)
    c = 3
    x = _np(rng, 2, 4, 6, 8, c)
    n = factors[0] * factors[1] * factors[2]
    xf = np.asarray(JF.fold(jnp.asarray(x), factors))
    scale, bias = 1 + _np(rng, c, scale=0.3), _np(rng, c)
    jnorm = JL.FoldedInstanceNorm(n)
    want = jnorm.apply({"params": {"scale": scale, "bias": bias}},
                       jnp.asarray(xf))
    norm = PL.FoldedInstanceNorm(c, n, dtype=torch.float32)
    plain = PL.InstanceNorm(c, dtype=torch.float32)
    with torch.no_grad():
        for m in (norm, plain):
            m.scale.copy_(_t(scale))
            m.bias.copy_(_t(bias))
        got = norm(_t(xf))
        _close(got, want)
        _close(PF.unfold(got, factors), plain(_t(x)).numpy())


# -------------------------------------------------------------------- models


UNET_CASES = {
    "full-parity": dict(factors=(2, 2, 2), form="parity", depth=3),
    "full-parity_batched": dict(factors=(2, 2, 2), form="parity_batched",
                                depth=3),
    "partial-dense": dict(factors=(1, 2, 2), form="dense", depth=3),
    "non-cubic": dict(factors=(1, 1, 2), form="dense", depth=2,
                      shape=(1, 8, 12, 6, 1)),
    "depth4": dict(factors=(1, 1, 2), form="dense", depth=4, filters=2,
                   shape=(1, 16, 16, 16, 1)),
    "instancenorm": dict(factors=(1, 1, 2), form="dense", depth=2,
                         instance_normalization=True),
    "batch2": dict(factors=(2, 1, 1), form="parity", depth=2,
                   shape=(2, 8, 8, 8, 1)),
}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("case", UNET_CASES)
def test_unet_fold_matches_jax_and_plain(case, train):
    """The folded U-Net equals the JAX folded U-Net and the port's unfolded
    one from the same parameters (probabilities and logits)."""
    kw = dict(UNET_CASES[case])
    factors, form = kw.pop("factors"), kw.pop("form")
    shape, depth = kw.pop("shape", (1, 8, 8, 8, 1)), kw.pop("depth")
    filters = kw.pop("filters", 4)
    x = _np(np.random.default_rng(4), *shape)
    models = {fold: UNet3D(n_labels=2, depth=depth, n_base_filters=filters,
                           dtype=torch.float32, fold_level0=fold,
                           fold_formulation=form, **kw).train(train)
              for fold in (factors, "off")}
    variables = _randomized(models[factors])
    models["off"].load_state_dict(models[factors].state_dict())
    jmodel = JaxUNet3D(n_labels=2, depth=depth, n_base_filters=filters,
                       dtype=jnp.float32, fold_level0=factors,
                       fold_formulation=form, **kw)
    for logits in (False, True):
        want = _jax_apply(jmodel, variables, x, train=train, logits=logits)
        with torch.no_grad():
            got = models[factors](_t(x), logits=logits)
            plain = models["off"](_t(x), logits=logits)
        _close(got, want)
        _close(got, plain.numpy())


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("factors,form", [((1, 1, 2), "dense"),
                                          ((2, 2, 2), "parity")])
def test_isensee_fold_matches_jax_and_plain(monkeypatch, factors, form,
                                            train):
    """Isensee2017 folded: InstanceNorm over spatial x sub-voxel, the
    stride-2 entry consuming the folded level, the folded up-sampling
    module (fused in eval, upsample-then-conv in training), concat and 1^3
    tails and heads per sub-voxel; in training with dropout, given the same
    masks (each original channel's mask tiled over the sub-voxels)."""
    x = _np(np.random.default_rng(5), 1, 8, 8, 8, 1)
    kw = dict(n_labels=2, depth=3, n_base_filters=4, n_segmentation_levels=2)
    models = {fold: Isensee2017(dtype=torch.float32, fold_level0=fold,
                                fold_formulation=form, **kw).train(train)
              for fold in (factors, "off")}
    variables = _randomized(models[factors], seed=1)
    models["off"].load_state_dict(models[factors].state_dict())
    jmodel = JaxIsensee(dtype=jnp.float32, fold_level0=factors,
                        fold_formulation=form, **kw)
    masks = (models["off"].dropout_masks(1, torch.Generator().manual_seed(3))
             if train else None)
    queue = [jnp.asarray(m.numpy()) for m in masks or []]

    def dropout(rng, h, rate, group=1):
        mask = jnp.tile(queue.pop(0), (1, group))[:, None, None, None, :]
        return jnp.where(mask, h / (1 - rate), 0.0).astype(h.dtype)

    monkeypatch.setattr(JI, "spatial_dropout_3d", dropout)
    want = _jax_apply(jmodel, variables, x, train=train,
                      rngs={"dropout": jax.random.PRNGKey(0)})
    assert not queue
    with torch.no_grad():
        got = models[factors](_t(x), dropout_masks=masks)
        plain = models["off"](_t(x), dropout_masks=masks)
    _close(got, want)
    _close(got, plain.numpy())


# --------------------------------------------------- gates and auto folding


@pytest.mark.parametrize("kw", [dict(depth=2, deconvolution=True),
                                dict(depth=1),
                                dict(depth=2, batch_normalization=True)],
                         ids=["deconvolution", "depth1", "batchnorm"])
def test_gates_refuse_with_the_jax_messages(kw):
    """An explicit fold that the JAX U-Net refuses is refused by the port's
    model, ``build_model`` and ``check_supported`` with the same message."""
    x = jnp.zeros((1, 8, 8, 8, 1), jnp.float32)
    with pytest.raises(ValueError) as err:
        JaxUNet3D(fold_level0=(2, 2, 2), **kw).init(jax.random.PRNGKey(0), x)
    message = str(err.value)
    for make in (lambda: UNet3D(fold_level0=(2, 2, 2), **kw),
                 lambda: build_model(Config(fold_level0=(2, 2, 2), **kw),
                                     "cpu"),
                 lambda: check_supported(Config(fold_level0=(2, 2, 2),
                                                **kw))):
        with pytest.raises(ValueError) as got:
            make()
        assert str(got.value) == message


def test_auto_resolution_and_override(monkeypatch):
    """"auto" does not fold on the port's backends, as on the JAX package's
    CPU; with ``_fold_backend_ok`` opened in both packages it folds batch-1
    norm-free inputs with ``FOLD_AUTO`` and equals JAX;
    ``fold_override("off")`` pins it off; a norm or a batch of 2 falls back
    to the plain path."""
    assert PL.FOLD_AUTO == JL.FOLD_AUTO
    calls = []
    real = PL.conv3_folded
    monkeypatch.setattr(PL, "conv3_folded",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    x = _np(np.random.default_rng(6), 2, 8, 12, 6, 1)
    jmodel = JaxUNet3D(n_labels=1, depth=2, n_base_filters=4,
                       dtype=jnp.float32)
    model = UNet3D(depth=2, n_base_filters=4, dtype=torch.float32)
    assert model.fold_level0 == "auto"
    variables = _randomized(model)

    def run(batch=1):
        calls.clear()
        with torch.no_grad():
            return model(_t(x[:batch])), bool(calls)

    y_plain, folded = run()
    assert not folded
    monkeypatch.setattr(PL, "_fold_backend_ok", lambda: True)
    monkeypatch.setattr(JL, "_fold_backend_ok", lambda: True)
    y_fold, folded = run()
    assert folded
    _close(y_fold, _jax_apply(jmodel, variables, x[:1]))
    _close(y_fold, y_plain.numpy())
    with PL.fold_override("off"):
        y_off, folded = run()
    assert not folded
    np.testing.assert_array_equal(y_off.numpy(), y_plain.numpy())
    _, folded = run(batch=2)
    assert not folded, "auto must not fold a batch"
    norm = UNet3D(depth=2, n_base_filters=4, dtype=torch.float32,
                  instance_normalization=True)
    calls.clear()
    with torch.no_grad():
        norm(_t(x[:1]))
    assert not calls
    for bad, cls in (("on", PL.fold_override),
                     ("nope", PL.decoder_form_override)):
        with pytest.raises(ValueError, match="unknown"):
            cls(bad)


def test_config_fold_wiring():
    """The config's fold reaches the model; every tuple and formulation the
    JAX ``Config`` accepts builds and makes a train step."""
    for form in FORMS:
        for factors in FACTOR_SETS:
            cfg = Config(depth=2, n_base_filters=4, fold_level0=list(factors),
                         fold_formulation=form, compute_dtype="float32")
            JaxConfig(depth=2, fold_level0=list(factors),
                      fold_formulation=form)
            check_supported(cfg)
            model = build_model(cfg, "cpu")
            assert model.fold_level0 == factors
            assert model.fold_formulation == form
            make_train_step(model, cfg, generator=torch.Generator())
    isensee = build_model(Config(model_name="isensee", depth=3,
                                 n_base_filters=4, n_segmentation_levels=2,
                                 fold_level0=(1, 1, 2)), "cpu")
    assert isensee.fold_level0 == (1, 1, 2)


# ------------------------------------------------------------ training step


def test_fold_train_step_matches_jax():
    """Three steps of a fold config against the JAX ``make_train_step`` on
    the same config: params and Adam moments (the tolerances of
    ``tests/test_torch_train_step.py``)."""
    cfg = TS.tiny_config(fold_level0=(2, 2, 2),
                         fold_formulation="parity_batched")
    js, state = TS._run_both(cfg)
    TS._compare(js, state)


# ------------------------------------------------------------- on depth slabs


SLAB_CASES = {
    "w-fold-2-ranks": (dict(fold_level0=(1, 1, 2)), 2, 16),
    "full-fold-2-ranks": (dict(fold_level0=(2, 2, 2),
                               fold_formulation="parity"), 2, 16),
    "w-fold-odd-slab": (dict(fold_level0=(1, 1, 2)), 4, 12),
    "full-fold-odd-slab": (dict(fold_level0=(2, 2, 2),
                                fold_formulation="parity_batched"), 4, 12),
    "instancenorm": (dict(fold_level0=(2, 1, 1), instance_normalization=True),
                     2, 16),
    "isensee": (dict(model_name="isensee", n_segmentation_levels=2,
                     fold_level0=(2, 2, 2), fold_formulation="parity"),
                2, 16),
}


@pytest.mark.parametrize("case", SLAB_CASES)
def test_spatial_predictor_with_fold_equals_one_device(monkeypatch, case):
    """The spatial predictor on N thread-ranks (the port's collectives over
    ``_thread_dist``) with a fold equals the one-device direct predictor:
    the halo of one folded row (two rows where D folds), the folded
    InstanceNorm's moments summed over the ranks, and a slab too odd to
    fold on D (12 rows on 4 ranks), which is gathered whole first."""
    kw, n, rows = SLAB_CASES[case]
    cfg = Config(**{**dict(depth=3, n_base_filters=4,
                           compute_dtype="float32", image_shape=(rows,) * 3,
                           patch_shape=(rows,) * 3), **kw})
    model = build_model(cfg, "cpu")
    torch.manual_seed(0)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(("bias", "scale")):
                p.copy_(torch.randn_like(p) * 0.3 + name.endswith("scale"))
    vol = _np(np.random.default_rng(7), 1, rows, rows, rows)
    want = spatial.make_direct_predictor(model, cfg, device="cpu"
                                         ).predict_probabilities(vol)
    monkeypatch.setattr(collectives, "dist", _thread_dist())
    monkeypatch.setattr(spatial, "dist", _thread_dist())
    ranks, got, errors = _ThreadRanks(n), [None] * n, []

    def run(rank):
        try:
            group = (ranks, rank)
            mesh = spatial.HybridMesh(group, None, group, rank, 1, n,
                                      torch.device("cpu"))
            predictor = spatial.SpatialPredictor(copy.deepcopy(model), cfg,
                                                 mesh)
            got[rank] = predictor.predict_probabilities(vol)
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)
            ranks.barrier.abort()

    threads = [threading.Thread(target=run, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not errors and not any(t.is_alive() for t in threads), errors
    for rank in range(n):
        _close(got[rank], want.numpy(), atol=1e-5)


# --------------------------------------------------------------- the export


def test_export_of_a_fold_config_is_the_unfolded_program(monkeypatch,
                                                         tmp_path):
    """Every artifact pins no fold and the parity decoder: a fold config's
    program is the unfolded program, node for node, and predicts the same
    labels; after the export the model's own forward folds again."""
    from fetal_mri_segmentation_tpu_torch.models import unet3d

    kw = dict(image_shape=(12, 12, 12), patch_shape=(8, 8, 8), depth=2,
              n_base_filters=4, compute_dtype="float32")
    vol = _np(np.random.default_rng(8), 1, 12, 12, 12)
    torch.manual_seed(1)
    weights = build_model(Config(**kw), "cpu").state_dict()
    models, programs, labels = {}, [], []
    for fold in ((1, 1, 2), "off"):
        cfg = Config(fold_level0=fold, **kw)
        models[fold] = build_model(cfg, "cpu")
        models[fold].load_state_dict(weights)
        path = str(tmp_path / f"{fold}.fetal")
        export.export_predictor(models[fold], cfg, cfg.image_shape, path,
                                overlap=4)
        predict = export.load_predictor(path, device="cpu")
        programs.append(predict.program.code)
        labels.append(predict(vol))
    assert programs[0] == programs[1]
    np.testing.assert_array_equal(labels[0], labels[1])
    calls = []
    monkeypatch.setattr(unet3d, "fold",
                        lambda *a: calls.append(1) or PF.fold(*a))
    with torch.no_grad():
        models[(1, 1, 2)](_t(vol.transpose(1, 2, 3, 0)[None]))
    assert calls

"""MedNeXt on the port (``models/mednext.py``) held to the plain float32
reference ``reference/mednext.py`` on the CPU, at 32^3 patches with 8 base
channels: the S and L tables at kernels 3 and 5, the L model's first-step
gradients and three train steps through ``make_train_step``, the
resampling blocks' shapes, the norm against ``nn.GroupNorm``, the
published parameter counts, the refusals, the entry points and the spans.

Tolerances, each with its reason:

- ``FP32``: the port's fp32 forward against the reference, atol 1e-4 +
  rtol 1e-4 of max |logit|. The same fp32 formulas in another order
  (channels-last 1^3 convs as GEMMs, the norm's sums): measured 7e-6 to
  1.1e-5 on logits of max 9-35. A bf16 forward misses it by orders
  (``test_bf16_forward`` asserts that it fails).
- ``BF16``: the bf16 forward, 0.05 of max |logit|: every depthwise, 1^3
  conv and GELU operand and every activation between blocks rounded to 8
  bits of mantissa through 62 blocks.
- ``GRAD``: one train step's gradients against autograd over the
  reference, each leaf's L2 gap within 1e-4 of the larger of its own and
  the median leaf's norm (the depthwise biases feed a norm, which removes
  them: their gradients are rounding alone); the loss within 1e-5.
- ``STEPS``: three steps of Keras Adam, each moving leaf's change within
  1e-3 of the larger of its own and the median change. Leaves whose
  reference gradient is under 1e-3 of the median (the depthwise biases)
  are left out: Adam's sign-like first steps turn their rounding-sized
  gradients into learning-rate-sized steps on either side.
"""

import dataclasses
import math
import os
import statistics
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch import nn  # noqa: E402

from fetal_mri_segmentation_tpu_torch import predict as predict_entry  # noqa: E402
from fetal_mri_segmentation_tpu_torch import serve as serve_entry  # noqa: E402
from fetal_mri_segmentation_tpu_torch import train as train_entry  # noqa: E402
from fetal_mri_segmentation_tpu_torch.config import (  # noqa: E402
    Config, check_interop, check_supported)
from fetal_mri_segmentation_tpu_torch.inference.predict import (  # noqa: E402
    build_serving_predictor)
from fetal_mri_segmentation_tpu_torch.models import (  # noqa: E402
    MedNeXt, build_model, layers, mednext)
from fetal_mri_segmentation_tpu_torch.training.state import (  # noqa: E402
    create_train_state)
from fetal_mri_segmentation_tpu_torch.training.train_step import (  # noqa: E402
    make_train_step)
from fetal_mri_segmentation_tpu_torch.utils import (  # noqa: E402
    export, params as port_params)
from perfbench import inputs  # noqa: E402
from perfbench.families import family  # noqa: E402
from perfbench.reference import train as ref_train  # noqa: E402
from perfbench.reference import window as ref_window  # noqa: E402
from reference import mednext as R  # noqa: E402
from tests.synthetic import write_synthetic_dataset  # noqa: E402

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
FS = 8
FP32 = dict(atol=1e-4, rel=1e-4)
BF16 = 0.05
GRAD = 1e-4
STEPS = 1e-3


def _cfg(size="L", kernel=5, dtype="float32", **kw):
    kw.setdefault("image_shape", (40, 40, 40))
    return Config(model_name="mednext", n_base_filters=FS,
                  mednext_size=size, mednext_kernel=kernel,
                  patch_shape=(32, 32, 32), compute_dtype=dtype, **kw)


def _ref_cfg(size="L", kernel=5):
    return {"n_base_filters": FS, "n_labels": 1, "mednext_size": size,
            "mednext_kernel": kernel}


def _weights(size="L", kernel=5, seed=0):
    """The benchmark's seeded weights (``perfbench/inputs.py::
    make_weights``), at which every part shows in the output: He-normal
    conv weights over their fan-in, the head a tenth of that, biases
    N(0, 0.05^2), norm scales 1 + N(0, 0.1^2) and biases N(0, 0.1^2)."""
    return inputs.make_weights({**_ref_cfg(size, kernel),
                                "model_name": "mednext"}, seed, "cpu")


def _model(cfg, weights):
    model = build_model(cfg, "cpu")
    model.load_state_dict(weights, strict=True)
    return model


def _forward(model, x):
    """The port on NCDHW, logits NCDHW."""
    with torch.no_grad():
        return model(x.permute(0, 2, 3, 4, 1), logits=True).permute(
            0, 4, 1, 2, 3).float()


def _input(seed=1, batch=2):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((batch, 1, 32, 32, 32), generator=g)


@pytest.fixture(scope="module")
def weights():
    return _weights()


@pytest.mark.parametrize("size,kernel", [("S", 3), ("S", 5), ("L", 3),
                                         ("L", 5)])
def test_fp32_forward_matches_reference(size, kernel):
    w = _weights(size, kernel)
    x = _input()
    got = _forward(_model(_cfg(size, kernel), w), x)
    with torch.no_grad():
        want = R.forward(w, x, _ref_cfg(size, kernel))
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= FP32["atol"] + FP32["rel"] * scale


def test_bf16_forward(weights):
    """bf16 within ``BF16`` of max |logit|, and outside ``FP32``: the
    comparison tells the two precisions apart."""
    x = _input()
    got = _forward(_model(_cfg(dtype="bfloat16"), weights), x)
    with torch.no_grad():
        want = R.forward(weights, x, _ref_cfg())
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= BF16 * scale
    assert err > FP32["atol"] + FP32["rel"] * scale


def test_state_dict_is_the_family_param_spec():
    model = build_model(_cfg(), "cpu")
    got = [(k, tuple(v.shape)) for k, v in model.state_dict().items()]
    spec = {**_ref_cfg(), "model_name": "mednext"}
    assert got == [(k, tuple(s)) for k, s in family(spec).param_spec(spec)]
    assert got == [(k, tuple(s)) for k, s in R.param_spec(spec)]
    assert [k for k, _ in model.named_parameters()] == [k for k, _ in got]


@pytest.mark.parametrize("size,kernel,count", [
    ("S", 3, 5_550_881), ("B", 3, 10_526_273), ("M", 3, 17_548_929),
    ("L", 3, 61_779_233), ("L", 5, 62_992_865)])
def test_published_parameter_counts(size, kernel, count):
    """At 32 base channels, one input channel and one label, from the
    reference's parameters and from the port's ``state_dict`` alike (the
    public model's ``dummy_tensor`` left out): L with kernel 3 rounds to
    the paper's 61.8 M; S, B and M lie within 1 % of its 5.6, 10.5 and
    17.6 M, which it counted with its datasets' channels and classes."""
    cfg = {"n_base_filters": 32, "n_labels": 1, "mednext_size": size,
           "mednext_kernel": kernel}
    assert sum(math.prod(s) for _, s in R.param_spec(cfg)) == count
    with torch.device("meta"):
        model = MedNeXt(n_base_filters=32, size=size, kernel=kernel)
    assert sum(p.numel() for p in model.state_dict().values()) == count
    paper = {"S": 5.6, "B": 10.5, "M": 17.6, "L": 61.8}[size]
    if kernel == 3:
        assert abs(count / 1e6 - paper) <= 0.01 * paper
    if (size, kernel) == ("L", 3):
        assert round(count / 1e6, 1) == paper


def _blocks(kind, cin, cout, n, seed=4):
    """A port block and ``torch.nn``'s own layers with its weights."""
    torch.manual_seed(seed)
    block = mednext.MedNeXtBlock(cin, cout, 2, 3, kind, torch.float32)
    x = torch.randn(1, n, n, n, cin)
    return block, x


def test_up_block_pads_its_odd_extent():
    """The up block: a transposed depthwise conv to 2n - 1, one zero voxel
    padded at the front of each axis; its residual, the 1^3 stride-2
    transposed conv (``nn.ConvTranspose3d``), lands on the odd voxels
    after the padding, its bias on the other voxels past the first."""
    block, x = _blocks("up", 16, 8, 4)
    with torch.no_grad():
        conv1 = nn.ConvTranspose3d(16, 16, 3, stride=2, padding=1, groups=16)
        conv1.weight.copy_(block.conv1.weight)
        conv1.bias.copy_(block.conv1.bias)
        assert tuple(conv1(x.permute(0, 4, 1, 2, 3)).shape[2:]) == (7, 7, 7)
        out = block(x)
        assert tuple(out.shape) == (1, 8, 8, 8, 8)
        for axis in (1, 2, 3):
            assert float(out.narrow(axis, 0, 1).abs().max()) == 0.0
        block.mlp.conv3.weight.zero_()
        block.mlp.conv3.bias.zero_()
        res = nn.ConvTranspose3d(16, 8, 1, stride=2)
        res.weight.copy_(block.res_conv.weight)
        res.bias.copy_(block.res_conv.bias)
        want = nn.functional.pad(res(x.permute(0, 4, 1, 2, 3)),
                                 R.UP_PAD).permute(0, 2, 3, 4, 1)
        out = block(x)
    torch.testing.assert_close(out, want, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(out[:, 1::2, 1::2, 1::2],
                               x @ block.res_conv.weight.flatten(1)
                               + block.res_conv.bias, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(out[:, 2::2, 2::2, 2::2],
                               block.res_conv.bias.expand(1, 3, 3, 3, 8))


def test_down_block_strides():
    """The down block halves each axis with its stride-2 depthwise conv
    (``nn.Conv3d(groups=C)``) and adds the 1^3 stride-2 conv of x."""
    block, x = _blocks("down", 8, 16, 8)
    with torch.no_grad():
        conv1 = nn.Conv3d(8, 8, 3, stride=2, padding=1, groups=8)
        conv1.weight.copy_(block.conv1.weight)
        conv1.bias.copy_(block.conv1.bias)
        torch.testing.assert_close(
            block.conv1(x), conv1(x.permute(0, 4, 1, 2, 3)).permute(
                0, 2, 3, 4, 1), atol=1e-6, rtol=1e-6)
        block.mlp.conv3.weight.zero_()
        block.mlp.conv3.bias.zero_()
        res = nn.Conv3d(8, 16, 1, stride=2)
        res.weight.copy_(block.res_conv.weight)
        res.bias.copy_(block.res_conv.bias)
        out = block(x)
        want = res(x.permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)
    assert tuple(out.shape) == (1, 4, 4, 4, 16)
    torch.testing.assert_close(out, want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("route", ["composite", "norm_function"])
def test_norm_equals_group_norm(monkeypatch, route):
    """``layers.InstanceNorm(affine, eps 1e-5)`` is ``nn.GroupNorm(C, C)``:
    on the composite and routed as on the card (the fused norm's training
    Function, whose CPU twin runs here), values and gradients of x, scale
    and bias."""
    monkeypatch.setattr(layers, "_kernel_device",
                        lambda t: route == "norm_function")
    g = torch.Generator().manual_seed(5)
    norm = layers.InstanceNorm(16, dtype=torch.float32, eps=mednext.GN_EPS)
    gn = nn.GroupNorm(16, 16)
    with torch.no_grad():
        norm.scale.copy_(1 + 0.3 * torch.randn(16, generator=g))
        norm.bias.copy_(0.3 * torch.randn(16, generator=g))
        gn.weight.copy_(norm.scale)
        gn.bias.copy_(norm.bias)
    x = (3 * torch.randn(2, 6, 5, 7, 16, generator=g) + 1).requires_grad_()
    x2 = x.detach().clone().requires_grad_()
    dy = torch.randn(2, 6, 5, 7, 16, generator=g)
    got = norm(x)
    want = gn(x2.permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)
    torch.testing.assert_close(got, want, atol=2e-6, rtol=1e-5)
    gx, gs, gb = torch.autograd.grad(got, [x, norm.scale, norm.bias], dy)
    wx, ws, wb = torch.autograd.grad(want, [x2, gn.weight, gn.bias], dy)
    for a, b in ((gx, wx), (gs, ws), (gb, wb)):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


def _batch(seed=6):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(2, 1, 32, 32, 32, generator=g)
    y = (torch.rand(2, 1, 32, 32, 32, generator=g) > 0.6).float()
    return x, y


def test_train_step_matches_reference_autograd(weights):
    """One step of ``make_train_step`` (no augmentation): its loss, and
    the gradients it leaves on the parameters, against autograd over the
    reference."""
    cfg = _cfg(augment=False, batch_size=2)
    model = _model(cfg, weights)
    state = create_train_state(model, cfg)
    x, y = _batch()
    loss = float(make_train_step(model, cfg)(state, x, y)["loss"].detach())
    p = {k: v.clone().requires_grad_(True) for k, v in weights.items()}
    want = ref_train.dice_loss(y, torch.sigmoid(R.forward(p, x, _ref_cfg())))
    want.backward()
    assert loss == pytest.approx(float(want.detach()), abs=1e-5)
    got = dict(model.named_parameters())
    median = float(np.median([float(p[k].grad.norm()) for k in p]))
    assert median > 0
    for k, ref in p.items():
        gap = float((got[k].grad - ref.grad).norm())
        assert gap <= GRAD * max(float(ref.grad.norm()), median), k


def test_three_train_steps_match_the_reference(weights):
    """Three steps of ``make_train_step`` with the configuration's
    augmentation (flips, symmetries, contrast) and Keras Adam, against
    ``perfbench/reference/train.py::run_steps`` over the reference's
    forward (its augmentation redrawn from a generator seeded alike): the
    losses within 1e-5 and each moving leaf's change within ``STEPS``."""
    cfg = _cfg(batch_size=2, initial_learning_rate=1e-3)
    model = _model(cfg, weights)
    state = create_train_state(model, cfg)
    step = make_train_step(model, cfg,
                           generator=torch.Generator().manual_seed(8))
    batches = [_batch(seed) for seed in (6, 7, 9)]
    losses = [float(step(state, x, y)["loss"]) for x, y in batches]
    fcfg = {**_ref_cfg(), "model_name": "mednext", "flip": True,
            "permute": True, "contrast": 0.1, "augment": True,
            "initial_learning_rate": 1e-3}
    ref = ref_train.run_steps(weights, batches, fcfg,
                              torch.Generator().manual_seed(8))
    assert losses == pytest.approx(ref["losses"], abs=1e-5)
    gr = {k: float(g.norm()) for k, g in ref["first_grad"].items()}
    med = statistics.median(gr.values())
    moving = [k for k in gr if gr[k] >= 1e-3 * med]
    # the depthwise biases, which feed a norm, are the leaves left out
    assert set(gr) - set(moving) == {k for k in gr if k.endswith(
        "conv1.bias")}
    got = dict(model.named_parameters())
    changes = {k: float((ref["params"][k] - weights[k]).norm())
               for k in moving}
    med_change = statistics.median(changes.values())
    for k in moving:
        gap = float((got[k].detach() - ref["params"][k]).norm())
        assert gap <= STEPS * max(changes[k], med_change), k


def test_train_step_takes_the_norm_function(monkeypatch, weights):
    """Routed as on the card, one train step sends the 62 norms through
    the fused norm's training Function with activation "none" and eps
    1e-5: 62 forward and 62 backward calls, each asking for the
    parameters' gradient, and the loss and gradients of the step with
    every norm on the composite."""
    from fetal_mri_segmentation_tpu_torch.ops import instance_norm as norm_ops

    forward, backward = [], []
    train = layers.instance_norm_act_train
    bwd = norm_ops.instance_norm_act_backward

    def counting_train(*args, **kw):
        forward.append((args[3], args[5]))
        return train(*args, **kw)

    def counting_backward(*args, params=True):
        backward.append(params)
        return bwd(*args, params=params)

    monkeypatch.setattr(layers, "instance_norm_act_train", counting_train)
    monkeypatch.setattr(norm_ops, "instance_norm_act_backward",
                        counting_backward)
    cfg = _cfg(augment=False, batch_size=2)
    x, y = _batch()
    runs = []
    for on_card in (True, False):
        monkeypatch.setattr(layers, "_kernel_device", lambda t: on_card)
        model = _model(cfg, weights)
        loss = float(make_train_step(model, cfg)(
            create_train_state(model, cfg), x, y)["loss"].detach())
        runs.append((loss, {k: v.grad for k, v in model.named_parameters()}))
    assert len(forward) == len(backward) == 62
    assert set(forward) == {("none", mednext.GN_EPS)} and all(backward)
    (loss, got), (want_loss, want) = runs
    assert loss == pytest.approx(want_loss, abs=1e-6)
    median = float(np.median([float(g.norm()) for g in want.values()]))
    for k, ref in want.items():
        gap = float((got[k] - ref).norm())
        assert gap <= GRAD * max(float(ref.norm()), median), k


def _volume(shape=(32, 32, 48), seed=9):
    return torch.randn((1,) + shape,
                       generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("mode", ["window", "window_flips", "direct",
                                  "direct_flips"])
def test_serving_predictors_match_the_reference(weights, mode):
    """``build_serving_predictor`` (the ``predict`` CLI's) on a 32 x 32 x
    48 volume: the sliding window in two overlapping 32^3 patches (overlap
    16) and the direct whole-volume forward, each plain and with the 8
    flips averaged, against the reference's sliding window of the
    reference's forward (and its whole-volume forward). The L tables at
    kernel 5; the sliding window's flips on the S tables at kernel 3 (16
    forwards a side)."""
    direct, flips = mode.startswith("direct"), mode.endswith("flips")
    size, kernel = ("S", 3) if mode == "window_flips" else ("L", 5)
    if (size, kernel) != ("L", 5):
        weights = _weights(size, kernel)
    cfg = dataclasses.replace(_cfg(size, kernel), image_shape=(32, 32, 48))
    pred = build_serving_predictor(_model(cfg, weights), cfg, overlap=16,
                                   patch_batch_size=2, direct=direct,
                                   tta="flips" if flips else False)
    vol = _volume()
    got = pred.predict_probabilities(vol.numpy()).double()

    def probs(v):
        with torch.no_grad():
            if direct:
                return torch.sigmoid(R.forward(
                    weights, v[None], _ref_cfg(size, kernel)))[0].double()
            return ref_window.probabilities(
                v, lambda t: R.forward(weights, t, _ref_cfg(size, kernel)),
                (32,) * 3, 16)

    if flips:
        want = 0
        for fx in (0, 1):
            for fy in (0, 1):
                for fz in (0, 1):
                    dims = [d + 1 for d, f in enumerate((fx, fy, fz)) if f]
                    flip = (lambda t: t.flip(dims)) if dims else (lambda t: t)
                    want = want + flip(probs(flip(vol)))
        want = want / 8
    else:
        want = probs(vol)
    assert float((got.reshape(want.shape) - want).abs().max()) <= 1e-5


@pytest.mark.parametrize("kw,match", [
    (dict(use_pallas_conv=True), "use_pallas_conv"),
    (dict(use_pallas_dec0=True), "use_pallas_dec0"),
    (dict(fold_level0=(1, 1, 2)), "fold_level0"),
    (dict(spatial_devices=2), "spatial_devices=2"),
    (dict(mednext_size="XL"), "mednext_size='XL'"),
    (dict(mednext_kernel=7), "mednext_kernel=7"),
    (dict(patch_shape=(40, 40, 40)), "divisible by 16"),
], ids=["pallas_conv", "pallas_dec0", "fold", "spatial", "size", "kernel",
        "patch"])
def test_check_supported_refuses(kw, match):
    cfg = dataclasses.replace(_cfg(), **kw)
    with pytest.raises(ValueError, match=match):
        check_supported(cfg)
    with pytest.raises(ValueError, match=match):
        build_model(cfg, "cpu")


def test_interop_export_and_card_refusals(weights, tmp_path):
    cfg = _cfg()
    check_supported(cfg)
    model = _model(cfg, weights)
    with pytest.raises(ValueError, match="no flax or Keras counterpart"):
        check_interop(cfg.model_name)
    with pytest.raises(ValueError, match="no flax or Keras counterpart"):
        port_params.flax_param_shapes(cfg)
    with pytest.raises(ValueError, match="no flax or Keras counterpart"):
        port_params.flax_params(model)
    with pytest.raises(ValueError, match="predict --export"):
        export.export_predictor(model, cfg, (32, 32, 32),
                                str(tmp_path / "m.fetal"))
    # on the card the fused norm takes channel counts in multiples of 8
    with pytest.raises(ValueError, match="multiple of 8"):
        build_model(dataclasses.replace(cfg, n_base_filters=12), "cuda")
    with pytest.raises(ValueError, match="multiples of 16"):
        model(torch.zeros(1, 32, 32, 40, 1))


def test_repo_config_builds_the_published_model():
    """The port's own preset (beside the port: the JAX package's
    ``configs/`` holds the presets both packages load) loads without a
    warning, every key but its comment a ``Config`` field, and builds
    MedNeXt-L with kernel 5 at the paper's batch 2 of 128^3 patches;
    the benchmark's configuration file holds the same keys."""
    import json
    import warnings

    path = ROOT / "fetal_mri_segmentation_tpu_torch" / "configs" / (
        "fetal_mednext.json")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        cfg = Config.load(str(path))
    fields = {f.name for f in dataclasses.fields(Config)}
    keys = json.loads(path.read_text())
    assert set(keys) - fields == {"_comment"}
    assert (cfg.model_name, cfg.n_base_filters, cfg.mednext_size,
            cfg.mednext_kernel) == ("mednext", 32, "L", 5)
    assert cfg.patch_shape == (128, 128, 128) and cfg.batch_size == 2
    assert cfg.initial_learning_rate == 1e-3
    check_supported(cfg)
    bench = json.loads((ROOT / "perfbench" / "configs"
                        / "mednext-l-fetal.json").read_text())
    assert {k: v for k, v in bench.items() if not k.startswith("_")} == {
        k: v for k, v in keys.items() if not k.startswith("_")}
    with torch.device("meta"):
        model = MedNeXt(n_base_filters=cfg.n_base_filters,
                        size=cfg.mednext_size, kernel=cfg.mednext_kernel)
    assert sum(p.numel() for p in model.parameters()) == 62_992_865


@pytest.mark.parametrize("model_name", ["mednext", "unet", "isensee"])
def test_saved_config_carries_the_port_fields_for_mednext_only(
        model_name, tmp_path):
    """``Config.save`` writes ``mednext_size`` and ``mednext_kernel`` for
    MedNeXt alone; every config reloads equal in the port."""
    import json

    from fetal_mri_segmentation_tpu_torch.config import PORT_ONLY

    cfg = Config(model_name=model_name, mednext_size="S", mednext_kernel=3)
    if model_name != "mednext":
        cfg = Config(model_name=model_name)
    path = tmp_path / "c.json"
    cfg.save(str(path))
    saved = set(json.loads(path.read_text()))
    assert (set(PORT_ONLY) <= saved) == (model_name == "mednext")
    assert not (set(PORT_ONLY) & saved) or model_name == "mednext"
    assert Config.load(str(path)) == cfg
    assert Config().mednext_kernel == 5


def test_chip_smoke_holds_every_norm_shape_and_leaf_of_the_preset():
    """``chip_smoke.py``'s MedNeXt norm shapes (``MEDNEXT_NORM_SHAPES``,
    with the number of norms a forward of each) are those of one forward
    of the mednext preset at its train batch, and its A1 leaf count
    (``ADAM_MODELS``) is the preset's (on meta tensors: shapes only)."""
    import collections
    import sys

    sys.path.insert(0, str(ROOT))
    import chip_smoke

    from fetal_mri_segmentation_tpu_torch.models.layers import InstanceNorm

    cfg = Config.load(str(ROOT / chip_smoke.MEDNEXT_CONFIG))
    with torch.device("meta"):
        model = MedNeXt(n_base_filters=cfg.n_base_filters,
                        size=cfg.mednext_size, kernel=cfg.mednext_kernel)
    seen = collections.Counter()
    for mod in model.modules():
        if isinstance(mod, InstanceNorm):
            assert mod.epsilon == chip_smoke.MEDNEXT_NORM_EPS
            mod.register_forward_hook(
                lambda m, a, out: seen.update([tuple(a[0].shape)]))
    with torch.no_grad():
        model(torch.empty(cfg.batch_size, *cfg.patch_shape, 1,
                          device="meta"))
    assert seen == {shape + (c,): count for _, shape, c, count
                    in chip_smoke.MEDNEXT_NORM_SHAPES}
    assert sum(seen.values()) * 2 == chip_smoke.MEDNEXT_NORM_LAUNCHES
    (leaves, launches), = [m[2:] for m in chip_smoke.ADAM_MODELS
                           if m[0] == "mednext"]
    assert leaves == len(list(model.parameters()))
    assert launches == -(-leaves // 80)


@pytest.fixture(scope="module")
def entry_run(tmp_path_factory):
    """The port's train, predict and serve entry points on a tiny MedNeXt
    config (L tables, kernel 5) and four synthetic cases, on the CPU."""
    d = tmp_path_factory.mktemp("mednext_entry")
    write_synthetic_dataset(str(d / "cases"), n_cases=4, shape=(20, 22, 18))
    cfg = Config(model_name="mednext", n_base_filters=FS, mednext_size="L",
                 mednext_kernel=5, image_shape=(32, 32, 32),
                 patch_shape=(32, 32, 32), validation_patch_overlap=0,
                 batch_size=2, n_epochs=1, compute_dtype="float32",
                 dropout_rate=0.0, augment=True, validation_split=0.75,
                 num_devices=1, data_file=str(d / "data"),
                 model_file=str(d / "model.ckpt"),
                 training_file=str(d / "training_ids.pkl"),
                 validation_file=str(d / "validation_ids.pkl"),
                 training_log=str(d / "training.log"))
    state = train_entry.main(cfg, str(d / "cases"), verbose=False, seed=1,
                             device="cpu")
    return d, cfg, state


def test_entry_points_run_mednext(entry_run):
    d, cfg, state = entry_run
    assert isinstance(state.model, MedNeXt) and state.step > 0
    assert os.path.exists(cfg.model_file)
    n = predict_entry.main(cfg, inputs=[str(d / "cases" / "case_0")],
                           output_dir=str(d / "pred"), device="cpu",
                           verbose=False)
    assert n == 1 and (d / "pred" / "case_0" / "prediction.nii.gz").exists()
    watch = d / "watch"
    watch.mkdir()
    os.symlink(d / "cases" / "case_1", watch / "case_1")
    served = serve_entry.main(cfg, None, str(watch), str(d / "served"),
                              once=True, device="cpu", verbose=False)
    assert served == 1


def test_spans_of_one_train_step(weights):
    """One train step under a profiler: the two MedNeXt spans once each,
    nested in the step's ``train.forward``, under the step's one
    request."""
    from fetal_mri_segmentation_tpu_torch.utils import profiling

    cfg = _cfg(augment=False, batch_size=2)
    model = _model(cfg, weights)
    step = make_train_step(model, cfg)
    state = create_train_state(model, cfg)
    x, y = _batch()
    profiling.reset_spans()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        step(state, x, y)
    records = profiling.span_records()
    assert len({r["request"] for r in records}) == 1
    forward = [r for r in records if r["name"] == "train.forward"]
    assert len(forward) == 1
    for name in ("mednext.encoder", "mednext.decoder"):
        mine = [r for r in records if r["name"] == name]
        assert len(mine) == 1
        assert mine[0]["parent"] == forward[0]["span"]


def test_seeded_init_is_reproducible():
    """``train`` starts a MedNeXt from ``init_parameters(model, seed)``
    (it has no flax initializer): the same seed gives the same
    parameters, another seed others; PyTorch's default bounds, norm scales
    1 and biases 0."""
    cfg = _cfg()
    a, b, c = (build_model(cfg, "cpu") for _ in range(3))
    mednext.init_parameters(a, 5)
    mednext.init_parameters(b, 5)
    mednext.init_parameters(c, 6)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["stem.weight"], sc["stem.weight"])
    w = sa["enc_block_0.0.conv1.weight"]
    assert float(w.abs().max()) <= 5 ** -1.5 and float(w.std()) > 0.01
    assert float(sa["enc_block_0.0.mlp.conv3.weight"].abs().max()) <= (
        3 * FS) ** -0.5
    assert torch.equal(sa["enc_block_0.0.norm.scale"], torch.ones(FS))
    assert torch.equal(sa["enc_block_0.0.norm.bias"], torch.zeros(FS))

"""Swin UNETR on the port (``models/swin_unetr.py``,
``ops/window_attention.py``) held to the plain float32 reference
``reference/swin_unetr.py`` on the CPU, at 32^3 and 64^3 patches with a
feature size of 12: at 32^3 stage 1 (16^3) pads to 21^3, stage 2 (8^3)
pads to 14^3 and shifts with a mask, and stages 3 and 4 (4^3, 2^3) clip
their windows; at 64^3 stage 3 (8^3) shifts too and stage 4 clips.

Tolerances, each with its reason:

- ``FP32``: the port's fp32 forward against the reference, atol 1e-4 +
  rtol 1e-4 of max |logit|. The same fp32 formulas in another order
  (channels-last convs, the window attention's reshapes, the norms' sums):
  measured 5e-6 to 8e-6 on logits of max 9-10. A bf16 forward misses it
  by three orders (``test_bf16_forward`` asserts that it fails).
- ``BF16``: the bf16 forward, 0.05 of max |logit| (measured 0.013): every
  conv, linear and attention operand and every activation between blocks
  rounded to 8 bits of mantissa, through 8 Swin blocks and 13 residual
  blocks.
- ``ATTN``: the two attention routes in fp32, 1e-5 (one softmax in
  another order).
- ``GRAD``: one train step's gradients against autograd over the
  reference, each leaf's L2 gap within 1e-4 of the larger of its own and
  the median leaf's norm (some leaves' gradients are rounding alone: the
  key bias's, which the softmax cancels); the loss within 1e-5.
"""

import dataclasses
import math
import os
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from fetal_mri_segmentation_tpu_torch import predict as predict_entry  # noqa: E402
from fetal_mri_segmentation_tpu_torch import serve as serve_entry  # noqa: E402
from fetal_mri_segmentation_tpu_torch import train as train_entry  # noqa: E402
from fetal_mri_segmentation_tpu_torch.config import (  # noqa: E402
    Config, check_interop, check_supported)
from fetal_mri_segmentation_tpu_torch.inference.predict import (  # noqa: E402
    build_serving_predictor)
from fetal_mri_segmentation_tpu_torch.models import (  # noqa: E402
    SwinUNETR, build_model, layers)
from fetal_mri_segmentation_tpu_torch.ops import (  # noqa: E402
    window_attention as wa)
from fetal_mri_segmentation_tpu_torch.training.state import (  # noqa: E402
    create_train_state)
from fetal_mri_segmentation_tpu_torch.training.train_step import (  # noqa: E402
    make_train_step)
from fetal_mri_segmentation_tpu_torch.utils import (  # noqa: E402
    keras_export, params as port_params)
from perfbench.families import family  # noqa: E402
from perfbench.reference import window as ref_window  # noqa: E402
from reference import swin_unetr as R  # noqa: E402
from tests.synthetic import write_synthetic_dataset  # noqa: E402

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
FS = 12
FP32 = dict(atol=1e-4, rel=1e-4)
BF16 = 0.05
ATTN = dict(atol=1e-5, rtol=1e-5)
GRAD = 1e-4


def _cfg(patch=32, dtype="float32", **kw):
    return Config(model_name="swin_unetr", n_base_filters=FS, depth=4,
                  image_shape=(48, 48, 48), patch_shape=(patch,) * 3,
                  compute_dtype=dtype, **kw)


def _ref_cfg():
    return {"n_base_filters": FS, "n_labels": 1}


def _weights(seed=0):
    """Seeded weights large enough that every part shows in the output:
    He-normal weights, a relative-position table of std 0.5, LayerNorm
    scales 1 + N(0, 0.1^2)."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for name, shape in R.param_spec(_ref_cfg()):
        z = torch.randn(shape, generator=g)
        if name.endswith("relative_position_bias_table"):
            out[name] = 0.5 * z
        elif len(shape) == 1:
            norm = ".norm" in name and name.endswith("weight")
            out[name] = 1 + 0.1 * z if norm else 0.05 * z
        else:
            fan = shape[0] if "transp_conv" in name else math.prod(shape[1:])
            out[name] = z * math.sqrt(2.0 / fan)
    return out


def _model(cfg, weights):
    model = build_model(cfg, "cpu")
    model.load_state_dict(weights, strict=True)
    return model


def _forward(model, x):
    """The port on NCDHW, logits NCDHW."""
    with torch.no_grad():
        return model(x.permute(0, 2, 3, 4, 1), logits=True).permute(
            0, 4, 1, 2, 3).float()


def _input(patch, seed=1, batch=2):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((batch, 1) + (patch,) * 3, generator=g)


@pytest.fixture(scope="module")
def weights():
    return _weights()


@pytest.mark.parametrize("patch", [32, 64])
def test_fp32_forward_matches_reference(weights, patch):
    cfg = _cfg(patch)
    x = _input(patch, batch=2 if patch == 32 else 1)
    got = _forward(_model(cfg, weights), x)
    with torch.no_grad():
        want = R.forward(weights, x, _ref_cfg())
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= FP32["atol"] + FP32["rel"] * scale


def test_bf16_forward(weights):
    x = _input(32)
    with torch.no_grad():
        want = R.forward(weights, x, _ref_cfg())
    got = _forward(_model(_cfg(32, "bfloat16"), weights), x)
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= BF16 * scale
    # the fp32 tolerance tells the two apart
    assert err > FP32["atol"] + FP32["rel"] * scale


def _qkv(seed, b=2, nw=3, h=2, n=27, d=8):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(b, nw, h, n, d, generator=g) for _ in range(3)]


@pytest.mark.parametrize("masked", [False, True], ids=["bias", "bias+mask"])
def test_attention_routes_agree(masked):
    """The composite against the SDPA route on the bias alone (one bias
    broadcast over every window) and on the bias with a shift mask (one
    per window), in fp32; both against the reference's attention."""
    window, dims = (3, 3, 3), (3, 3, 9)
    q, k, v = _qkv(3)
    g = torch.Generator().manual_seed(4)
    table = torch.randn(5 ** 3, 2, generator=g)
    index = wa.relative_position_index(window)
    mask = wa.shift_mask(dims, window, (0, 0, 1)) if masked else None
    bias = wa.attention_bias(table, index, 27, mask, torch.float32)
    assert bias.shape == ((3 if masked else 1), 2, 27, 27)
    before = dict(wa.window_attention.calls)
    composite = wa.window_attention(q, k, v, bias)
    sdpa = wa.attention_sdpa(q, k, v, bias)
    # a CPU tensor takes the composite, and the call is counted there
    assert wa.window_attention.calls == {
        "composite": before["composite"] + 1, "sdpa": before["sdpa"]}
    torch.testing.assert_close(composite, wa.attention_composite(
        q, k, v, bias), rtol=0, atol=0)
    torch.testing.assert_close(sdpa, composite, **ATTN)
    want_bias = table[index.reshape(-1)].reshape(27, 27, 2).permute(2, 0, 1)
    if masked:
        want_bias = want_bias + mask[:, None]
    torch.testing.assert_close(
        composite, R.attention(q, k, v, want_bias, R._same), **ATTN)
    # the bias rows start at multiples of 16 elements, which the card's
    # SDPA kernel reads faster (ops/window_attention.py)
    assert bias.stride(-2) % 16 == 0 and bias.stride(-1) == 1


@pytest.mark.parametrize("key", [
    ((21, 21, 21), (7, 7, 7), (3, 3, 3)), ((14, 14, 14), (7, 7, 7), (3, 3, 3)),
    ((14, 21, 7), (7, 7, 7), (3, 3, 3))], ids=["21", "14", "14x21x7"])
def test_index_and_mask_equal_the_reference(key):
    dims, window, shift = key
    assert torch.equal(wa.relative_position_index(),
                       R.relative_position_index())
    assert torch.equal(wa.relative_position_index((3, 4, 5)),
                       R.relative_position_index((3, 4, 5)))
    got = wa.shift_mask(dims, window, shift)
    assert torch.equal(got, R.shift_mask(dims, window, shift))
    assert got.shape == (math.prod(dims) // 343, 343, 343)
    assert set(got.unique().tolist()) == {-100.0, 0.0}
    x = torch.randn((2,) + dims + (3,))
    parts = wa.window_partition(x, window)
    assert torch.equal(parts, R.window_partition(x, window))
    assert torch.equal(wa.window_reverse(parts, window, dims), x)


def test_model_buffers_are_the_reference_index_and_masks(weights):
    model = _model(_cfg(32), weights)
    buffers = dict(model.named_buffers())
    masks = {k: v for k, v in buffers.items() if "shift_mask" in k}
    # stage 1 (16^3 -> 21^3) and stage 2 (8^3 -> 14^3) shift
    assert sorted(masks) == ["swinViT.shift_mask_14_14_14_7_7_7_3_3_3",
                             "swinViT.shift_mask_21_21_21_7_7_7_3_3_3"]
    for name, mask in masks.items():
        d = int(name.split("_")[2])
        assert torch.equal(mask, R.shift_mask((d,) * 3, (7,) * 3, (3,) * 3))
    index = [v for k, v in buffers.items() if "relative_position_index" in k]
    assert len(index) == 8
    assert all(torch.equal(i, R.relative_position_index()) for i in index)
    # none of them is saved
    assert not any("shift_mask" in k or "relative_position_index" in k
                   for k in model.state_dict())


def test_state_dict_is_the_family_param_spec():
    cfg = _cfg(32)
    model = build_model(cfg, "cpu")
    got = [(k, tuple(v.shape)) for k, v in model.state_dict().items()]
    fam = family({"model_name": "swin_unetr"})
    spec = {"n_base_filters": FS, "n_labels": 1}
    assert got == [(k, tuple(s)) for k, s in fam.param_spec(spec)]
    assert got == [(k, tuple(s)) for k, s in R.param_spec(spec)]
    assert [k for k, _ in model.named_parameters()] == [k for k, _ in got]
    # MONAI's size at its defaults (feature 48, BTCV's 14 labels): 62.19 M
    full = R.param_spec({"n_base_filters": 48, "n_labels": 14})
    assert sum(math.prod(s) for _, s in full) == 62_187_296


def _dice_loss(y, pred):
    t, p = y.reshape(-1), pred.reshape(-1)
    return -(2 * (t * p).sum() + 1) / (t.sum() + p.sum() + 1)


def test_train_step_matches_reference_autograd(weights):
    """One step of ``make_train_step`` (no augmentation): its loss, and
    the gradients it leaves on the parameters, against autograd over the
    reference."""
    cfg = _cfg(32, augment=False, batch_size=2)
    model = _model(cfg, weights)
    state = create_train_state(model, cfg)
    g = torch.Generator().manual_seed(6)
    x = torch.randn(2, 1, 32, 32, 32, generator=g)
    y = (torch.rand(2, 1, 32, 32, 32, generator=g) > 0.6).float()
    loss = float(make_train_step(model, cfg)(state, x, y)["loss"].detach())
    p = {k: v.clone().requires_grad_(True) for k, v in weights.items()}
    want = _dice_loss(y, torch.sigmoid(R.forward(p, x, _ref_cfg())))
    want.backward()
    assert loss == pytest.approx(float(want.detach()), abs=1e-5)
    got = dict(model.named_parameters())
    norms = [float(p[k].grad.norm()) for k in p]
    median = float(np.median(norms))
    assert median > 0
    for k, ref in p.items():
        gap = float((got[k].grad - ref.grad).norm())
        assert gap <= GRAD * max(float(ref.grad.norm()), median), k


def test_train_step_takes_the_norm_function(monkeypatch, weights):
    """Routed as on the card, one train step sends the 26 residual-block
    norms through the fused norm's training Function: 26 forward and 26
    backward calls, none asking for a parameter gradient (the ones and
    zeros are buffers), and the loss and gradients of the step with every
    norm on the composite."""
    from fetal_mri_segmentation_tpu_torch.ops import instance_norm as norm_ops

    forward, backward = [], []
    train = layers.instance_norm_act_train
    bwd = norm_ops.instance_norm_act_backward

    def counting_train(*args, **kw):
        forward.append(args[3])
        return train(*args, **kw)

    def counting_backward(*args, params=True):
        backward.append(params)
        return bwd(*args, params=params)

    monkeypatch.setattr(layers, "instance_norm_act_train", counting_train)
    monkeypatch.setattr(norm_ops, "instance_norm_act_backward",
                        counting_backward)
    cfg = _cfg(32, augment=False, batch_size=2)
    g = torch.Generator().manual_seed(6)
    x = torch.randn(2, 1, 32, 32, 32, generator=g)
    y = (torch.rand(2, 1, 32, 32, 32, generator=g) > 0.6).float()
    runs = []
    for on_card in (True, False):
        monkeypatch.setattr(layers, "_kernel_device", lambda t: on_card)
        model = _model(cfg, weights)
        loss = float(make_train_step(model, cfg)(
            create_train_state(model, cfg), x, y)["loss"].detach())
        runs.append((loss, {k: v.grad for k, v in model.named_parameters()}))
    assert len(forward) == len(backward) == 26
    assert sorted(set(forward)) == ["leaky_relu", "none"]
    assert not any(backward)
    (loss, got), (want_loss, want) = runs
    assert loss == pytest.approx(want_loss, abs=1e-6)
    median = float(np.median([float(g.norm()) for g in want.values()]))
    for k, ref in want.items():
        gap = float((got[k] - ref).norm())
        assert gap <= GRAD * max(float(ref.norm()), median), k


def test_serving_predictor_matches_the_reference_window(weights):
    """``build_serving_predictor`` (the ``predict`` CLI's) on a 32 x 32 x
    40 volume in two overlapping 32^3 patches (overlap 8), against the
    reference's sliding window of the reference's forward."""
    cfg = dataclasses.replace(_cfg(32), image_shape=(32, 32, 40))
    pred = build_serving_predictor(_model(cfg, weights), cfg, overlap=8,
                                   patch_batch_size=2)
    vol = torch.randn((1, 32, 32, 40),
                      generator=torch.Generator().manual_seed(9))
    got = pred.predict_probabilities(vol.numpy()).double()
    with torch.no_grad():
        want = ref_window.probabilities(
            vol, lambda v: R.forward(weights, v, _ref_cfg()), (32,) * 3, 8)
    assert float((got - want).abs().max()) <= 1e-5


@pytest.mark.parametrize("kw,match", [
    (dict(use_pallas_conv=True), "use_pallas_conv"),
    (dict(use_pallas_dec0=True), "use_pallas_dec0"),
    (dict(fold_level0=(1, 1, 2)), "fold_level0"),
    (dict(spatial_devices=2), "spatial_devices=2"),
    (dict(depth=3), "depth=3"),
    (dict(n_base_filters=16), "n_base_filters=16"),
    (dict(patch_shape=(48, 48, 48)), "divisible by 32"),
], ids=["pallas_conv", "pallas_dec0", "fold", "spatial", "depth", "filters",
        "patch"])
def test_check_supported_refuses(kw, match):
    cfg = dataclasses.replace(_cfg(32), **kw)
    with pytest.raises(ValueError, match=match):
        check_supported(cfg)
    with pytest.raises(ValueError, match=match):
        build_model(cfg, "cpu")


def test_interop_and_card_refusals(weights):
    cfg = _cfg(32)
    check_supported(cfg)
    with pytest.raises(ValueError, match="no flax or Keras counterpart"):
        check_interop(cfg.model_name)
    with pytest.raises(ValueError, match="no flax or Keras counterpart"):
        port_params.flax_param_shapes(cfg)
    with pytest.raises(ValueError, match="no flax or Keras counterpart"):
        keras_export.export_keras_unet_weights(_model(cfg, weights), None)
    # on the card the fused norm takes channel counts in multiples of 8
    with pytest.raises(ValueError, match="multiple of 24"):
        build_model(cfg, "cuda")
    with pytest.raises(ValueError, match="multiples of 32"):
        _model(cfg, weights)(torch.zeros(1, 32, 32, 48 + 8, 1))


def test_repo_config_builds_the_published_model():
    """The port's own preset (beside the port: the JAX package's
    ``configs/`` holds the presets both packages load) loads without a
    warning, every key but its comment a ``Config`` field, and builds
    MONAI's 62M-parameter model."""
    import json
    import warnings

    path = ROOT / "fetal_mri_segmentation_tpu_torch" / "configs" / (
        "fetal_swin_unetr.json")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        cfg = Config.load(str(path))
    fields = {f.name for f in dataclasses.fields(Config)}
    assert set(json.loads(path.read_text())) - fields == {"_comment"}
    assert (cfg.model_name, cfg.n_base_filters, cfg.depth) == (
        "swin_unetr", 48, 4)
    assert cfg.patch_shape == (96, 96, 96) and cfg.batch_size == 4
    assert cfg.validation_patch_overlap == 48 and cfg.dropout_rate == 0.0
    check_supported(cfg)
    with torch.device("meta"):
        model = SwinUNETR(feature_size=48, n_labels=14, dtype=torch.bfloat16)
    assert sum(p.numel() for p in model.parameters()) == 62_187_296


def _composite_before(norm, x, activation, slope):
    """``InstanceNorm._composite`` as it was before the norm took ``eps``
    and ``affine``: the JAX package's formula at eps 1e-3 with the learned
    scale and bias."""
    xf = x.float()
    dims = tuple(range(1, xf.dim() - 1))
    mean = xf.mean(dim=dims, keepdim=True)
    var = xf.var(dim=dims, correction=0, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + 1e-3)
    y = (y * norm.scale + norm.bias).reshape(x.shape).to(norm.dtype)
    return layers.apply_activation(y, activation, slope)


def test_isensee_norms_unchanged_beside_swin(monkeypatch, weights):
    """Isensee2017's 27 norms still reach the fused norm with eps 1e-3,
    their learned scale and bias and LeakyReLU 0.3, and the composite is
    bit-equal to the formula before; Swin UNETR's residual blocks reach it
    with eps 1e-5, ones and zeros that are buffers (no parameter), and
    LeakyReLU 0.01 after each block's first norm only."""
    from fetal_mri_segmentation_tpu_torch.models.isensee2017 import (
        Isensee2017)

    calls = []

    def counting(x, scale, bias, activation, slope, eps, dtype):
        calls.append((scale, bias, activation, slope, eps))
        return original(x, scale, bias, activation, slope, eps, dtype)

    original = layers.instance_norm_act
    monkeypatch.setattr(layers, "_kernel_device", lambda x: True)
    monkeypatch.setattr(layers, "instance_norm_act", counting)
    torch.manual_seed(0)
    model = Isensee2017(depth=5, n_base_filters=8,
                        dtype=torch.float32).eval()
    for m in model.modules():
        if isinstance(m, layers.InstanceNorm):
            with torch.no_grad():
                m.scale.normal_(1, 0.2)
                m.bias.normal_(0, 0.2)
    x = torch.randn(2, 16, 16, 16, 1,
                    generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        model(x)
    params = {id(p) for p in model.parameters()}
    assert len(calls) == 27
    for scale, bias, activation, slope, eps in calls:
        assert (activation, slope, eps) == ("leaky_relu", 0.3, 1e-3)
        assert id(scale) in params and id(bias) in params
    norm = model.enc0_ctx1._modules["in"]
    y = torch.randn(2, 16, 16, 16, 8) * 3 + 1
    monkeypatch.setattr(layers, "_kernel_device", lambda x: False)
    assert torch.equal(norm(y, activation="leaky_relu", negative_slope=0.3),
                       _composite_before(norm, y, "leaky_relu", 0.3))

    calls.clear()
    monkeypatch.setattr(layers, "_kernel_device", lambda x: True)
    swin = _model(_cfg(32), weights)
    _forward(swin, _input(32, batch=1))
    swin_params = {id(p) for p in swin.parameters()}
    blocks = [m for m in swin.modules()
              if type(m).__name__ == "UnetResBlock"]
    convs = [m for b in blocks for m in (b.conv1, b.conv2, b.conv3)
             if m is not None]
    assert len(calls) == len(convs) == 26
    assert sum(c[2] == "leaky_relu" for c in calls) == len(blocks) == 10
    for scale, bias, activation, slope, eps in calls:
        assert eps == 1e-5 and activation in ("leaky_relu", "none")
        assert slope == 0.01
        assert id(scale) not in swin_params and id(bias) not in swin_params
        assert torch.equal(scale, torch.ones_like(scale))
        assert torch.equal(bias, torch.zeros_like(bias))


@pytest.fixture(scope="module")
def entry_run(tmp_path_factory, weights):
    """The port's train, predict and serve entry points on the tiny
    Swin UNETR config and four synthetic cases, on the CPU."""
    d = tmp_path_factory.mktemp("swin_entry")
    write_synthetic_dataset(str(d / "cases"), n_cases=4, shape=(20, 22, 18))
    cfg = Config(model_name="swin_unetr", n_base_filters=FS, depth=4,
                 image_shape=(32, 32, 32), patch_shape=(32, 32, 32),
                 validation_patch_overlap=0, batch_size=2, n_epochs=1,
                 compute_dtype="float32", dropout_rate=0.0, augment=True,
                 validation_split=0.75, num_devices=1,
                 data_file=str(d / "data"), model_file=str(d / "model.ckpt"),
                 training_file=str(d / "training_ids.pkl"),
                 validation_file=str(d / "validation_ids.pkl"),
                 training_log=str(d / "training.log"))
    state = train_entry.main(cfg, str(d / "cases"), verbose=False, seed=1,
                             device="cpu")
    return d, cfg, state


def test_entry_points_run_swin(entry_run):
    d, cfg, state = entry_run
    assert isinstance(state.model, SwinUNETR) and state.step > 0
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


def test_spans_and_route_counter_of_one_case(weights):
    """One case through the sliding window under a profiler: the two
    Swin spans once per patch batch, nested in that batch's
    ``window.model``, under the case's one request; the attention's call
    counter names the route of each of the forward's 8 blocks."""
    from fetal_mri_segmentation_tpu_torch.utils import profiling

    cfg = dataclasses.replace(_cfg(32), image_shape=(32, 32, 32))
    pred = build_serving_predictor(_model(cfg, weights), cfg, overlap=0)
    vol = np.random.default_rng(3).normal(size=(1, 32, 32, 32)).astype(
        np.float32)
    profiling.reset_spans()
    before = dict(wa.window_attention.calls)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        pred.unpack_labels(pred.predict_labels_async(vol))
    records = profiling.span_records()
    assert wa.window_attention.calls == {
        "composite": before["composite"] + 8, "sdpa": before["sdpa"]}
    assert len({r["request"] for r in records}) == 1
    model_span = [r for r in records if r["name"] == "window.model"]
    for name in ("swin.encoder", "swin.decoder"):
        mine = [r for r in records if r["name"] == name]
        assert len(mine) == len(model_span) == 1
        assert mine[0]["parent"] == model_span[0]["span"]


def test_seeded_init_is_reproducible():
    """``train`` starts a Swin UNETR from ``init_parameters(model, seed)``
    (it has no flax initializer): the same seed gives the same
    parameters, another seed others; PyTorch's default bounds and MONAI's
    table scale."""
    from fetal_mri_segmentation_tpu_torch.models.swin_unetr import (
        init_parameters)

    cfg = _cfg(32)
    a, b, c = (build_model(cfg, "cpu") for _ in range(3))
    init_parameters(a, 5)
    init_parameters(b, 5)
    init_parameters(c, 6)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["encoder1.layer.conv1.conv.weight"],
                           sc["encoder1.layer.conv1.conv.weight"])
    w = sa["swinViT.layers1.0.blocks.0.attn.qkv.weight"]
    assert float(w.abs().max()) <= FS ** -0.5
    table = sa["swinViT.layers1.0.blocks.0.attn.relative_position_bias_table"]
    assert float(table.abs().max()) <= 0.04 and float(table.std()) > 0.01
    assert torch.equal(sa["swinViT.layers1.0.blocks.0.norm1.weight"],
                       torch.ones(FS))

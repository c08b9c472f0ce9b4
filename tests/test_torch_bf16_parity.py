"""The port's bf16 training held to the JAX package's bf16 training, on the
CPU (bf16 is the compute dtype of every production config and of every
quality recipe).

- **Max pooling at ties.** ``models/layers.py::max_pool_3d`` and
  ``ops/fold.py::pool_folded`` (unfolded; folds (2, 2, 2), (1, 2, 2) and
  (1, 1, 2)) against the JAX functions on inputs with planted ties, in fp32
  and bf16: the gradient equal bit for bit (flax's ``reduce_window`` sends
  a window's gradient to its first maximum in row-major (d, h, w) order;
  ``jnp.max`` over a fold cell splits it evenly among the cell's tied
  sub-voxels), the forward equal bit for bit to JAX's and to the port's
  earlier reshape-and-``amax`` pool.
- **One bf16 step of the multi-class recipe's U-Net** (depth 3, 8 filters,
  sigmoid over labels 1, 2, 4, weighted dice, fused decoder; level 0
  unfolded and folded (2, 2, 2)) and **of Isensee2017** (softmax,
  InstanceNorm, dropout off, whose masks neither side can draw like the
  other's): the probabilities, the loss and every parameter's gradient.
- **20 bf16 steps of the multi-class recipe** (Keras Adam at lr 5e-4, one
  init, one batch sequence, augmentation off): each step's loss.

Both sides get the same inputs, made with numpy from a seed, and the same
parameters (``utils/params.py::from_flax``); the kernel switches are on in
the port (their plain versions run on the CPU), fold off unless a case says
otherwise.

Tolerances.

- *The ratio rule* (ROADMAP, queue 3 rules), for every tensor of every case:
  relL2(port bf16, JAX fp32) <= max(2 x relL2(JAX bf16, JAX fp32), 1e-2).
  The port's bf16 may be no further from the fp32 answer than twice as far
  as JAX's own bf16 is. A gradient that is 0 in exact arithmetic (a conv's
  bias before InstanceNorm: the norm removes it) is pure rounding on every
  side, so its distances are taken relative to its block's weight
  gradient. The Isensee step stacks each parameter's gradient over four
  batches into one tensor (see its test).
- *Directly against JAX's bf16* (the U-Net step, where no norm stands
  between the two bf16 paths): the probabilities within relL2 1e-3, half a
  bf16 unit roundoff (2^-9), the loss within rtol 1e-4, and each weight's
  gradient and the fp32 head's within relL2 1e-2, five unit roundoffs
  (measured: 2.5e-5, 7e-7 and 3.4e-3 at most, against a bf16-to-fp32
  distance of 4.4e-4 for the probabilities and 5e-3 to 1e-1 for the
  weights). The bias gradients of the bf16 convs are held by the ratio
  rule alone: each is a sum over every voxel of a bf16 cotangent, which
  XLA:CPU accumulates in bf16 (``test_xla_cpu_sums_a_bf16_broadcast_in_bf16``
  shows it), so JAX's bf16 bias gradients here are 0.02 to 2.3 away from
  fp32 while the port's, summed in fp32 and rounded once, are 0.01 to 0.05
  away.
- *The 20 steps*: step i's loss within 2 x band_i + 1e-4 |fp32 loss| of
  JAX's bf16 loss, where band_i is the largest distance JAX's bf16 loss
  has had from its fp32 loss up to step i: bf16 rounding moves the two
  bf16 trajectories apart as it moves each from fp32, so the band it has
  opened bounds them. The curve of 20 losses is one tensor for the ratio
  rule.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax.traverse_util import flatten_dict  # noqa: E402

from fetal_mri_segmentation_tpu.config import Config as JaxConfig  # noqa: E402
from fetal_mri_segmentation_tpu.models import build_model as jax_build  # noqa: E402
from fetal_mri_segmentation_tpu.models.layers import (  # noqa: E402
    max_pool_3d as jax_max_pool)
from fetal_mri_segmentation_tpu.ops.fold import (  # noqa: E402
    fold as jax_fold, pool_folded as jax_pool_folded)
from fetal_mri_segmentation_tpu.training import (  # noqa: E402
    create_train_state as jax_state, make_train_step as jax_step)
from fetal_mri_segmentation_tpu.training.train_step import (  # noqa: E402
    _forward as jax_forward, get_loss_fn as jax_loss_fn)
from fetal_mri_segmentation_tpu_torch.config import Config  # noqa: E402
from fetal_mri_segmentation_tpu_torch.data.synthetic import (  # noqa: E402
    make_multiclass_case)
from fetal_mri_segmentation_tpu_torch.models import build_model  # noqa: E402
from fetal_mri_segmentation_tpu_torch.models.layers import max_pool_3d  # noqa: E402
from fetal_mri_segmentation_tpu_torch.ops.fold import (  # noqa: E402
    fold, pool_folded, unfold)
from fetal_mri_segmentation_tpu_torch.training.state import (  # noqa: E402
    create_train_state)
from fetal_mri_segmentation_tpu_torch.training.train_step import (  # noqa: E402
    _forward, get_loss_fn, make_train_step)
from fetal_mri_segmentation_tpu_torch.utils.params import from_flax  # noqa: E402

torch.set_num_threads(1)

PROB_RELL2, LOSS_RTOL, WEIGHT_GRAD_RELL2 = 1e-3, 1e-4, 1e-2
RATIO, RATIO_FLOOR = 2.0, 1e-2
STEP_LOSS_RTOL = 1e-4
LABELS = (1, 2, 4)
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
POOLS = {"unfolded": None, "fold222": (2, 2, 2), "fold122": (1, 2, 2),
         "fold112": (1, 1, 2)}


def _rel(a, b, scale=None) -> float:
    """relL2(a, b): ||a - b|| / ||b||, or / ||scale||."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    den = np.linalg.norm(b if scale is None else np.asarray(scale))
    return float(np.linalg.norm(a - b) / max(den, 1e-30))


def _ratio_rule(port16, jax16, jax32, scale=None, what=""):
    got = _rel(port16, jax32, scale)
    bound = max(RATIO * _rel(jax16, jax32, scale), RATIO_FLOOR)
    assert got <= bound, (what, got, bound)


# -- max pooling at ties ------------------------------------------------------


def _tied_input(shape, seed=0):
    """Values from {0, 0.5, 1, 1.5} (exact in bf16), so most windows hold a
    tied maximum somewhere; the first window of every channel is planted
    with its maximum at window positions 3 and 5 alone (row-major (d, h, w)
    order in a 2^3 window), the second with all eight equal."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 4, size=shape).astype(np.float32) / 2
    first = np.zeros((2, 2, 2), np.float32)
    first.reshape(-1)[[3, 5]] = 2.0
    x[:, 0:2, 0:2, 0:2] = first[None, ..., None]
    x[:, 0:2, 0:2, 2:4] = 1.0
    return x


def _amax_pool_before(x, window=(2, 2, 2)):
    """The port's pool before the tie repair: reshape, then ``amax``."""
    B, D, H, W, C = x.shape
    (wd, wh, ww), (d, h, w) = window, (D // window[0], H // window[1],
                                        W // window[2])
    x = x[:, :d * wd, :h * wh, :w * ww]
    return x.reshape(B, d, wd, h, wh, w, ww, C).amax(dim=(2, 4, 6))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("pattern", POOLS)
def test_max_pool_gradient_at_ties_is_jax(pattern, dtype):
    tdt, jdt = DTYPES[dtype]
    ff = POOLS[pattern]
    # odd trailing sizes: the VALID remainder is dropped (unfolded only;
    # a fold needs even sizes on its folded axes)
    shape = (2, 9, 8, 7, 3) if ff is None else (2, 8, 8, 8, 3)
    x = _tied_input(shape)
    out_shape = tuple(s // 2 for s in shape[1:4])
    cot = np.random.default_rng(1).standard_normal(
        (shape[0],) + out_shape + (shape[4],)).astype(np.float32)
    xt = torch.tensor(x).to(tdt)
    xj = jnp.asarray(x, jdt)
    if ff is None:
        port_fn, jax_fn = max_pool_3d, jax_max_pool
    else:
        xt, xj = fold(xt, ff), jax_fold(xj, ff)
        port_fn = functools.partial(pool_folded, factors=ff)
        jax_fn = functools.partial(jax_pool_folded, factors=ff)

    leaf = xt.clone().requires_grad_()
    out = port_fn(leaf)
    (out.float() * torch.from_numpy(cot)).sum().backward()
    want_out, vjp = jax.vjp(jax_fn, xj)
    (want_grad,) = vjp(jnp.asarray(cot, jdt))

    assert out.dtype == tdt and out.is_contiguous()
    np.testing.assert_array_equal(out.detach().float().numpy(),
                                  np.asarray(want_out, np.float32))
    np.testing.assert_array_equal(leaf.grad.float().numpy(),
                                  np.asarray(want_grad, np.float32))
    # the forward is the earlier pool's, bit for bit
    before = _amax_pool_before(torch.tensor(x).to(tdt))
    np.testing.assert_array_equal(out.detach().float().numpy(),
                                  before.float().numpy())
    # the planted window (maxima at positions 3 and 5): the first maximum
    # alone takes the gradient, but where one fold cell holds both, which
    # splits it evenly
    g = leaf.grad.float() if ff is None else unfold(leaf.grad.float(), ff)
    planted = g[0, 0:2, 0:2, 0:2, 0].reshape(-1).numpy()
    want = np.isin(np.arange(8), [3, 5] if ff == (2, 2, 2) else [3])
    np.testing.assert_array_equal(planted != 0, want)


def test_xla_cpu_sums_a_bf16_broadcast_in_bf16():
    """The bias gradient of a bf16 conv in JAX is the transpose of a
    broadcast, a bf16 sum over every voxel, and XLA:CPU accumulates it in
    bf16: 27648 increments of ~2^-12 stall near 1 instead of reaching ~6.
    The port's bias gradients sum in fp32, so the direct bf16 comparison
    leaves the bf16 convs' biases to the ratio rule."""
    cot = np.full((2, 24, 24, 24, 4), 2.0 ** -12, np.float32)

    def f(b):
        y = jnp.zeros(cot.shape, jnp.bfloat16) + b.astype(jnp.bfloat16)
        return (y.astype(jnp.float32) * cot).sum()

    got = np.asarray(jax.grad(f)(jnp.zeros(4, jnp.float32)))
    exact = cot[..., 0].size * 2.0 ** -12
    assert np.all(np.abs(got - exact) > 0.5 * exact), (got, exact)
    t = torch.zeros(4, requires_grad=True)
    y = torch.zeros(cot.shape, dtype=torch.bfloat16) + t.to(torch.bfloat16)
    (y.float() * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), exact, rtol=2.0 ** -8)


# -- one bf16 step --------------------------------------------------------------


def _multiclass_batch(size, n=2, seed=0):
    """``n`` multi-class cases of ``size``^3 (labels 1, 2, 4 as channels),
    each volume normalized to zero mean and unit variance; channels-first."""
    xs, ys = [], []
    for i in range(n):
        v, t = make_multiclass_case(shape=(size,) * 3, seed=seed + i)
        xs.append(((v - v.mean()) / v.std())[None])
        ys.append(np.stack([t == lab for lab in LABELS]))
    return np.stack(xs).astype(np.float32), np.stack(ys).astype(np.float32)


def _recipe(size, **kw):
    """The multi-class recipe's model at ``size``^3."""
    return {**dict(model_name="unet", depth=3, n_base_filters=8,
                   patch_shape=(size,) * 3, image_shape=(size,) * 3,
                   n_labels=3, labels=LABELS, activation_name="sigmoid",
                   batch_size=2, augment=False,
                   include_label_wise_dice_coefficients=True,
                   initial_learning_rate=5e-4, fold_level0="off"), **kw}


def _isensee(size):
    return dict(model_name="isensee", depth=3, n_base_filters=8,
                n_segmentation_levels=2, dropout_rate=0.0,
                patch_shape=(size,) * 3, image_shape=(size,) * 3,
                n_labels=3, labels=LABELS, activation_name="softmax",
                batch_size=2, augment=False, initial_learning_rate=5e-4,
                fold_level0="off")


def _jax_steps(settings, dtype, batches, params=None):
    """(params, [(loss, probabilities, gradients under the port's names)]):
    one JAX training forward and backward on each batch, from ``params``
    (the model's seed-0 initialization where None)."""
    cfg = JaxConfig(**settings, compute_dtype=dtype)
    model = jax_build(cfg)
    if params is None:
        params = jax_state(model, cfg, jax.random.PRNGKey(0)).params
    loss_fn = jax_loss_fn(cfg)

    @jax.jit
    def value_and_grad(p, x, y):
        def loss_of(p):
            pred, _ = jax_forward(model, p, {}, x, train=True)
            return loss_fn(y, pred), pred
        return jax.value_and_grad(loss_of, has_aux=True)(p)

    out = []
    for x, y in batches:
        (loss, pred), grads = value_and_grad(params, jnp.asarray(x),
                                             jnp.asarray(y))
        out.append((float(loss), np.asarray(pred, np.float32),
                    {k: v.numpy() for k, v in
                     from_flax(flatten_dict(grads, sep="/")).items()}))
    return params, out


def _port_steps(settings, params, batches):
    """(model, [(loss, probabilities, gradients)]): the port's bf16
    training forward and backward on each batch, from ``params``."""
    cfg = Config(**settings, compute_dtype="bfloat16", use_pallas_conv=True,
                 use_pallas_dec0=True)
    model = build_model(cfg, "cpu")
    model.load_state_dict(from_flax(flatten_dict(params, sep="/")))
    model.train()
    out = []
    for x, y in batches:
        model.zero_grad(set_to_none=True)
        pred = _forward(model, torch.from_numpy(x))
        loss = get_loss_fn(cfg)(torch.from_numpy(y), pred)
        loss.backward()
        out.append((loss.item(), pred.detach().float().numpy(),
                    {n: p.grad.numpy().copy()
                     for n, p in model.named_parameters()}))
    return model, out


def _stacked(runs):
    """Losses, probabilities and each gradient, stacked over the batches."""
    return (np.asarray([r[0] for r in runs]), np.stack([r[1] for r in runs]),
            {n: np.stack([r[2][n] for r in runs]) for n in runs[0][2]})


def _bf16_conv_biases(model):
    """The biases added in bf16 (every conv block's; the head is fp32)."""
    return {f"{n}.bias" for n, m in model.named_modules()
            if isinstance(m, torch.nn.Conv3d) and n != "head"}


def _scales(model):
    """Per parameter, the gradient that sets its scale: its own, or for a
    conv bias before a norm (whose exact gradient is 0) its weight's."""
    before_norm = {f"{n}.conv.bias" for n, m in model.named_modules()
                   if getattr(m, "norm_key", None)}
    return {n: n[:-len("bias")] + "weight" if n in before_norm else n
            for n, _ in model.named_parameters()}


@pytest.mark.parametrize("fold_level0", ["off", (2, 2, 2)],
                         ids=["fused", "fold222"])
def test_unet_bf16_step_matches_jax_bf16(fold_level0):
    settings = _recipe(24, fold_level0=fold_level0)
    batches = [_multiclass_batch(24)]
    params, run32 = _jax_steps(settings, "float32", batches)
    _, run16 = _jax_steps(settings, "bfloat16", batches, params)
    model, port = _port_steps(settings, params, batches)
    (l32, p32, g32), (l16, p16, g16), (loss, prob, grads) = (
        _stacked(run32), _stacked(run16), _stacked(port))
    assert set(grads) == set(g16)

    assert _rel(prob, p16) <= PROB_RELL2, _rel(prob, p16)
    np.testing.assert_allclose(loss, l16, rtol=LOSS_RTOL)
    biases = _bf16_conv_biases(model)
    for name, g in grads.items():
        if name not in biases:
            assert _rel(g, g16[name]) <= WEIGHT_GRAD_RELL2, (
                name, _rel(g, g16[name]))
        _ratio_rule(g, g16[name], g32[name], what=name)
    _ratio_rule(prob, p16, p32, what="probabilities")
    _ratio_rule(loss, l16, l32, what="loss")


def test_isensee_bf16_step_by_the_ratio_rule():
    """Each tensor is a parameter's gradient on each of four batches,
    stacked: on one batch of two, the distance of an 8-entry norm
    gradient from fp32 is one noisy draw (JAX's own bf16 distance for
    ``dec0_loc1.in.bias`` spans 0.021-0.092 over 12 batches, the port's
    0.026-0.073, their means 0.038 and 0.041)."""
    settings = _isensee(16)
    batches = [_multiclass_batch(16, seed=2 * i) for i in range(4)]
    params, run32 = _jax_steps(settings, "float32", batches)
    _, run16 = _jax_steps(settings, "bfloat16", batches, params)
    model, port = _port_steps(settings, params, batches)
    (l32, p32, g32), (l16, p16, g16), (loss, prob, grads) = (
        _stacked(run32), _stacked(run16), _stacked(port))
    assert set(grads) == set(g16)
    scale_of = _scales(model)
    for name, g in grads.items():
        _ratio_rule(g, g16[name], g32[name], scale=g32[scale_of[name]],
                    what=name)
    _ratio_rule(prob, p16, p32, what="probabilities")
    _ratio_rule(loss, l16, l32, what="loss")


# -- 20 bf16 steps -----------------------------------------------------------------


N_STEPS = 20


def _jax_losses(settings, dtype, batches):
    cfg = JaxConfig(**settings, compute_dtype=dtype)
    model = jax_build(cfg)
    state = jax_state(model, cfg, jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(np.array, state.params)  # not donated
    step = jax_step(model, cfg)
    losses = []
    for i, (x, y) in enumerate(batches):
        state, m = step(state, jnp.asarray(x), jnp.asarray(y),
                        jax.random.PRNGKey(i), None)
        losses.append(float(m["loss"]))
    return params, np.asarray(losses)


def test_multiclass_recipe_20_bf16_steps_follow_jax():
    settings = _recipe(16, batch_size=3)
    x, y = _multiclass_batch(16, n=6)
    order = np.random.default_rng(0)
    batches = [(x[i], y[i]) for i in
               (order.choice(6, 3, replace=False) for _ in range(N_STEPS))]
    params, j32 = _jax_losses(settings, "float32", batches)
    _, j16 = _jax_losses(settings, "bfloat16", batches)

    cfg = Config(**settings, compute_dtype="bfloat16", use_pallas_conv=True,
                 use_pallas_dec0=True)
    model = build_model(cfg, "cpu")
    model.load_state_dict(from_flax(flatten_dict(params, sep="/")))
    state = create_train_state(model, cfg)
    step = make_train_step(model, cfg)
    p16 = np.asarray([float(step(state, torch.from_numpy(bx),
                                 torch.from_numpy(by))["loss"])
                      for bx, by in batches])

    band = np.maximum.accumulate(np.abs(j16 - j32))
    bound = 2 * band + STEP_LOSS_RTOL * np.abs(j32)
    assert np.all(np.abs(p16 - j16) <= bound), np.stack(
        [p16, j16, j32, np.abs(p16 - j16), bound])
    _ratio_rule(p16, j16, j32, what="loss curve")
    assert p16[-1] < p16[0]  # it trains

"""The port's conv-block pieces against the JAX package's, on the CPU in
fp32: ``InstanceNorm``, BatchNorm (flax ``nn.BatchNorm``: the training
output, the eval output and the running statistics after 3 updates),
``UpConv`` with the transposed conv (and flax's kernel convention it rests
on), the stride-2 and 1^3 blocks with each activation, the kernel routes
with activation "none" followed by InstanceNorm (K1 at C = 128, K2 at
C = 16, K3) against JAX ``ConvBlock(instance_normalization=True,
use_pallas=True)`` in interpret mode, forward and ``jax.vjp``, and spatial
dropout: the apply given one mask against the JAX op, and the masks'
statistics.

Tolerance: atol 1e-5 on single norms and blocks (fp32 sums in another
order); 1e-4 + rtol 1e-4 on the kernel routes' values and VJPs (as
``test_torch_kernel_grad.py``); the dropout apply exact in fp32.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax import linen as fnn  # noqa: E402
from flax.traverse_util import flatten_dict  # noqa: E402

from fetal_mri_segmentation_tpu.models import layers as JL  # noqa: E402
from fetal_mri_segmentation_tpu.ops import pallas_conv as PC  # noqa: E402
from fetal_mri_segmentation_tpu.ops import pallas_conv_flat as PCF  # noqa: E402
from fetal_mri_segmentation_tpu.ops import pallas_dec0 as PD  # noqa: E402
from fetal_mri_segmentation_tpu_torch.models import layers  # noqa: E402
from fetal_mri_segmentation_tpu_torch.models.layers import (  # noqa: E402
    BatchNorm, ConvBlock, InstanceNorm, UpConv, draw_dropout_masks,
    same_padding, spatial_dropout_3d)
from fetal_mri_segmentation_tpu_torch.utils.params import from_flax  # noqa: E402

torch.set_num_threads(1)
ATOL = 1e-5
ROUTE_TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture
def interpret(monkeypatch):
    """Route the JAX Pallas forwards through interpret mode on the CPU."""
    monkeypatch.setenv("FETAL_TPU_PALLAS_INTERPRET", "1")
    for mod, name in ((PC, "_conv3x3_fwd"), (PCF, "_conv3x3_flat_fwd"),
                      (PD, "_dec0_fwd")):
        orig = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _f=orig, **kw: _f(
            *a, **{**kw, "interpret": True}))


def _normal(rng, shape, std=1.0, mean=0.0):
    return rng.normal(mean, std, shape).astype(np.float32)


def _load(module, variables, prefix=""):
    """The flax variables of one module into the port's module."""
    flat = flatten_dict(variables["params"], sep="/")
    flat.update({f"batch_stats/{k}": v for k, v in flatten_dict(
        variables.get("batch_stats", {}), sep="/").items()})
    state = from_flax(flat)
    module.load_state_dict({k[len(prefix):]: v for k, v in state.items()})


def test_instance_norm_matches_jax():
    rng = np.random.default_rng(0)
    x = _normal(rng, (2, 6, 5, 7, 4), std=3.0, mean=1.5)
    jmod = JL.InstanceNorm(dtype=jnp.float32)
    params = {"params": {"scale": _normal(rng, (4,)) + 1,
                         "bias": _normal(rng, (4,))}}
    want = jmod.apply(params, jnp.asarray(x))
    port = InstanceNorm(4, dtype=torch.float32)
    _load(port, params)
    got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL)


def test_batch_norm_matches_flax_over_three_updates():
    """Three training updates (outputs and running statistics against the
    mutated ``batch_stats``), then the eval output on the running
    statistics. The variance is flax's biased one: ``nn.BatchNorm3d``'s
    unbiased running variance would miss by a factor n / (n - 1)."""
    rng = np.random.default_rng(1)
    jmod = fnn.BatchNorm(axis=-1, momentum=0.99, epsilon=1e-3,
                         dtype=jnp.float32)
    x0 = _normal(rng, (2, 3, 4, 2, 5), std=2.0, mean=0.5)
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x0),
                          use_running_average=True)
    variables = {"params": {"scale": _normal(rng, (5,)) + 1,
                            "bias": _normal(rng, (5,))},
                 "batch_stats": variables["batch_stats"]}
    port = BatchNorm(5, dtype=torch.float32)
    _load(port, variables)
    port.train()
    for step in range(3):
        x = _normal(rng, (2, 3, 4, 2, 5), std=2.0 + step, mean=step)
        want, mutated = jmod.apply(variables, jnp.asarray(x),
                                   use_running_average=False,
                                   mutable=["batch_stats"])
        variables = {"params": variables["params"], **mutated}
        got = port(torch.from_numpy(x))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=ATOL)
    stats = variables["batch_stats"]
    np.testing.assert_allclose(port.mean.numpy(), np.asarray(stats["mean"]),
                               atol=1e-6)
    np.testing.assert_allclose(port.var.numpy(), np.asarray(stats["var"]),
                               atol=1e-6)
    port.eval()
    x = _normal(rng, (1, 2, 3, 4, 5))
    want = jmod.apply(variables, jnp.asarray(x), use_running_average=True)
    got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL)
    torch.testing.assert_close(port.var, torch.from_numpy(
        np.array(stats["var"])), atol=1e-6, rtol=0)


def test_flax_conv_transpose_flips_the_kernel():
    """The convention ``from_flax`` rests on: flax's 2^3 stride-2
    ``ConvTranspose`` applied to one voxel returns its kernel flipped on
    all three spatial axes (``transpose_kernel=False``), where
    ``conv_transpose3d`` returns the kernel as it is."""
    rng = np.random.default_rng(2)
    k = _normal(rng, (2, 2, 2, 1, 1))
    mod = fnn.ConvTranspose(1, (2, 2, 2), strides=(2, 2, 2), padding="VALID",
                            use_bias=False, dtype=jnp.float32)
    out = mod.apply({"params": {"kernel": jnp.asarray(k)}},
                    jnp.ones((1, 1, 1, 1, 1)))
    np.testing.assert_allclose(np.asarray(out)[0, ..., 0],
                               k[::-1, ::-1, ::-1, 0, 0], atol=0)
    torch_out = torch.nn.functional.conv_transpose3d(
        torch.ones(1, 1, 1, 1, 1), torch.from_numpy(
            k[..., 0, 0].copy())[None, None], stride=2)
    np.testing.assert_allclose(torch_out[0, 0].numpy(), k[..., 0, 0], atol=0)


@pytest.mark.parametrize("shape", [(2, 3, 4, 2, 6), (1, 2, 2, 3, 8)])
def test_upconv_deconvolution_matches_flax(shape):
    rng = np.random.default_rng(3)
    x = _normal(rng, shape)
    c = shape[-1]
    jmod = JL.UpConv(5, deconvolution=True, dtype=jnp.float32)
    params = jmod.init(jax.random.PRNGKey(1), jnp.asarray(x))
    params = {"params": {"deconv": {
        "kernel": _normal(rng, (2, 2, 2, c, 5)),
        "bias": _normal(rng, (5,))}}}
    want = jmod.apply(params, jnp.asarray(x))
    port = UpConv(c, 5, deconvolution=True, dtype=torch.float32)
    _load(port, params)
    got = port(torch.from_numpy(x))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL)
    nearest = UpConv(c, c, dtype=torch.float32)
    assert not list(nearest.parameters())
    np.testing.assert_array_equal(
        nearest(torch.from_numpy(x)).numpy(),
        np.asarray(JL.UpConv(c).apply({}, jnp.asarray(x))))


@pytest.mark.parametrize("size,stride,pads", [
    (8, 2, (0, 1)), (7, 2, (1, 1)), (6, 1, (1, 1)), (5, 2, (1, 1))])
def test_same_padding_follows_xla(size, stride, pads):
    assert same_padding(size, 3, stride) == pads
    assert same_padding(size, 1, 1) == (0, 0)


BLOCK_CASES = [
    # (kernel, stride, norm, activation, input shape)
    (3, 2, "instance", "leaky_relu", (2, 8, 6, 4, 4)),
    (3, 2, "instance", "leaky_relu", (1, 7, 5, 6, 4)),
    (3, 2, None, "relu", (1, 6, 7, 8, 4)),
    (1, 1, "instance", "leaky_relu", (2, 4, 5, 3, 8)),
    (1, 1, None, "none", (1, 4, 4, 4, 8)),
    (3, 1, "batch", "leaky_relu", (2, 4, 6, 5, 4)),
    (3, 1, "instance", "none", (1, 5, 4, 6, 4)),
]


@pytest.mark.parametrize("kernel,stride,norm,activation,shape", BLOCK_CASES)
def test_conv_block_matches_jax(kernel, stride, norm, activation, shape):
    """Strided (XLA's uneven SAME padding), 1^3 and normed blocks with
    each activation (LeakyReLU with Keras's slope 0.3), plain route; a
    BatchNorm block in training (the batch's statistics)."""
    rng = np.random.default_rng(4)
    x = _normal(rng, shape)
    kw = dict(batch_normalization=norm == "batch",
              instance_normalization=norm == "instance",
              activation=activation)
    jblock = JL.ConvBlock(6, kernel_size=(kernel,) * 3, strides=(stride,) * 3,
                          dtype=jnp.float32, **kw)
    train = norm == "batch"
    variables = jblock.init(jax.random.PRNGKey(2), jnp.asarray(x))
    if train:
        want, _ = jblock.apply(variables, jnp.asarray(x), train=True,
                               mutable=["batch_stats"])
    else:
        want = jblock.apply(variables, jnp.asarray(x))
    block = ConvBlock(shape[-1], 6, kernel_size=kernel, stride=stride,
                      dtype=torch.float32, **kw)
    assert block.negative_slope == 0.3
    _load(block, variables)
    block.train(train)
    got = block(torch.from_numpy(x))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL)


def _spy(monkeypatch, name):
    """Record the activation each call of ``layers.<name>`` is given."""
    calls = []
    orig = getattr(layers, name)

    def spy(*args):
        calls.append(args[-2])
        return orig(*args)

    monkeypatch.setattr(layers, name, spy)
    return calls


ROUTES = [("conv3x3", (1, 4, 4, 4), 128, 128),
          ("conv3x3_flat", (2, 6, 8, 8), 16, 16)]


@pytest.mark.parametrize("route,shape,ci,co", ROUTES,
                         ids=[r[0] for r in ROUTES])
def test_kernel_route_before_instance_norm_matches_jax(
        interpret, monkeypatch, route, shape, ci, co):
    """K1 (C = 128) and K2 (C = 16) with activation "none", then the fp32
    InstanceNorm and LeakyReLU: forward and the VJP in x and every
    parameter, against the JAX block on its Pallas path."""
    rng = np.random.default_rng(5)
    x = _normal(rng, shape + (ci,))
    g = _normal(rng, shape + (co,))
    jblock = JL.ConvBlock(co, instance_normalization=True,
                          activation="leaky_relu", dtype=jnp.float32,
                          use_pallas=True)
    assert jblock.bind({})._pallas_op(jnp.asarray(x)) is not None
    variables = jblock.init(jax.random.PRNGKey(3), jnp.asarray(x))
    variables = jax.tree_util.tree_map(
        lambda v: jnp.asarray(_normal(rng, v.shape, 0.1) + (
            1 if v.ndim == 1 else 0)), variables)
    want, vjp = jax.vjp(lambda v, xx: jblock.apply(v, xx), variables,
                        jnp.asarray(x))
    d_vars, dx = vjp(jnp.asarray(g))
    calls = _spy(monkeypatch, route)
    block = ConvBlock(ci, co, instance_normalization=True,
                      activation="leaky_relu", dtype=torch.float32,
                      use_kernel_conv=True)
    _load(block, variables)
    xt = torch.from_numpy(x).requires_grad_()
    got = block(xt)
    got.backward(torch.from_numpy(g))
    assert calls == ["none"]
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **ROUTE_TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx), **ROUTE_TOL)
    want_grads = from_flax(flatten_dict(d_vars["params"], sep="/"))
    for name, p in block.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[name].numpy(),
                                   err_msg=name, **ROUTE_TOL)


def test_fused_decoder_route_before_instance_norm_matches_jax(
        interpret, monkeypatch):
    """K3 with activation "none", then the InstanceNorm and the relu."""
    rng = np.random.default_rng(6)
    xd = _normal(rng, (1, 2, 2, 2, 16))
    skip = _normal(rng, (1, 4, 4, 4, 8))
    g = _normal(rng, (1, 4, 4, 4, 8))
    jblock = JL.ConvBlock(8, instance_normalization=True, dtype=jnp.float32,
                          use_pallas_dec0=True)
    variables = jblock.init(jax.random.PRNGKey(4), (jnp.asarray(xd),
                                                    jnp.asarray(skip)))
    want, vjp = jax.vjp(lambda v, a, b: jblock.apply(v, (a, b)), variables,
                        jnp.asarray(xd), jnp.asarray(skip))
    d_vars, dxd, dskip = vjp(jnp.asarray(g))
    calls = _spy(monkeypatch, "up_concat_conv3x3_kernel")
    block = ConvBlock(24, 8, instance_normalization=True,
                      dtype=torch.float32, use_kernel_dec0=True)
    _load(block, variables)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (xd, skip)]
    got = block(tuple(leaves))
    got.backward(torch.from_numpy(g))
    assert calls == ["none"]
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **ROUTE_TOL)
    for t, w in zip(leaves, (dxd, dskip)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   **ROUTE_TOL)
    want_grads = from_flax(flatten_dict(d_vars["params"], sep="/"))
    for name, p in block.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[name].numpy(),
                                   err_msg=name, **ROUTE_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_spatial_dropout_apply_matches_jax_given_one_mask(dtype):
    """The JAX op draws its mask as ``bernoulli(rng, keep, (B,1,1,1,C))``;
    the port's apply given that mask returns the same values."""
    rng = np.random.default_rng(7)
    x = _normal(rng, (3, 4, 2, 5, 6))
    key = jax.random.PRNGKey(8)
    rate = 0.3
    xj = jnp.asarray(x, dtype)
    want = JL.spatial_dropout_3d(key, xj, rate)
    mask = np.array(jax.random.bernoulli(key, 1 - rate, (3, 1, 1, 1, 6)))
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    got = spatial_dropout_3d(xt, torch.from_numpy(mask.reshape(3, 6)), rate)
    assert got.dtype == xt.dtype
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


def test_spatial_dropout_masks_keep_whole_channels_at_the_rate():
    """Over many draws each (sample, channel) is kept with probability
    1 - rate (within 4 standard deviations), a kept channel is scaled by
    1 / keep at every voxel and a dropped one is 0 at every voxel, the
    channels vary independently, and one generator seed repeats."""
    rate, batch, channels = 0.3, 8, (16, 32)
    gen = torch.Generator().manual_seed(0)
    draws = [draw_dropout_masks(gen, batch, channels, rate)
             for _ in range(200)]
    kept = torch.cat([m.flatten() for d in draws for m in d]).float()
    sigma = (rate * (1 - rate) / kept.numel()) ** 0.5
    assert abs(kept.mean().item() - (1 - rate)) < 4 * sigma
    assert all(m.shape == (batch, c) and m.dtype == torch.bool
               for d in draws for m, c in zip(d, channels))
    mask = draws[0][0]
    y = spatial_dropout_3d(torch.ones(batch, 3, 2, 4, 16), mask, rate)
    per_channel = y.reshape(batch, -1, 16)
    assert bool((per_channel == per_channel[:, :1]).all())
    torch.testing.assert_close(per_channel[:, 0],
                               mask.float() / (1 - rate), atol=1e-6, rtol=0)
    again = draw_dropout_masks(torch.Generator().manual_seed(0), batch,
                               channels, rate)
    assert all(torch.equal(a, b) for a, b in zip(again, draws[0]))
    assert not torch.equal(draws[0][0], draws[1][0])

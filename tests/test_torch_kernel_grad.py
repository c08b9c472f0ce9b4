"""Gradients of the port's kernel routes against the JAX custom VJPs.

``conv3x3`` (K1), ``conv3x3_flat`` (K2) and ``up_concat_conv3x3_kernel``
(K3) against ``jax.vjp`` of ``pallas_conv.conv3x3``,
``pallas_conv_flat.conv3x3_flat`` and ``pallas_dec0.
up_concat_conv3x3_pallas``, whose forwards run in interpret mode here (as
``tests/test_pallas_conv.py`` runs them); the port's routes run their plain
versions inside the same ``autograd.Function`` that wraps the kernel on the
card. Then the whole ``UNet3D`` with both switches on against
``jax.grad`` of the JAX model with its Pallas switches on, the routes under
``torch.utils.checkpoint`` and the prepared-weight caches across an
optimizer step.

Tolerance: fp32 throughout; atol 1e-4 + rtol 1e-4 on the VJPs (fp32 conv
sums taken in another order by XLA and by PyTorch), 2e-4 on the model's
gradients (the same through every layer).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax.traverse_util import flatten_dict  # noqa: E402

from fetal_mri_segmentation_tpu.models.unet3d import UNet3D as JaxUNet3D  # noqa: E402
from fetal_mri_segmentation_tpu.ops import pallas_conv as PC  # noqa: E402
from fetal_mri_segmentation_tpu.ops import pallas_conv_flat as PCF  # noqa: E402
from fetal_mri_segmentation_tpu.ops import pallas_dec0 as PD  # noqa: E402
from fetal_mri_segmentation_tpu_torch.models.layers import ConvBlock  # noqa: E402
from fetal_mri_segmentation_tpu_torch.models.unet3d import UNet3D  # noqa: E402
from fetal_mri_segmentation_tpu_torch.ops import conv3x3 as C  # noqa: E402
from fetal_mri_segmentation_tpu_torch.ops import dec0 as D  # noqa: E402
from fetal_mri_segmentation_tpu_torch.ops.cuda_lib import cached  # noqa: E402
from fetal_mri_segmentation_tpu_torch.training.state import KerasAdam  # noqa: E402
from fetal_mri_segmentation_tpu_torch.utils.params import from_flax  # noqa: E402

torch.set_num_threads(1)
ATOL = RTOL = 1e-4
MODEL_ATOL = 2e-4


@pytest.fixture
def interpret(monkeypatch):
    """Route the JAX Pallas forwards through interpret mode on the CPU."""
    monkeypatch.setenv("FETAL_TPU_PALLAS_INTERPRET", "1")
    for mod, name in ((PC, "_conv3x3_fwd"), (PCF, "_conv3x3_flat_fwd"),
                      (PD, "_dec0_fwd")):
        orig = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _f=orig, **kw: _f(
            *a, **{**kw, "interpret": True}))


def _normal(rng, shape, std=1.0):
    return (rng.normal(0, std, shape)).astype(np.float32)


def _torch_vjp(fn, inputs, cotangent):
    leaves = [torch.from_numpy(a).requires_grad_() for a in inputs]
    y = fn(*leaves)
    y.backward(torch.from_numpy(cotangent))
    return y.detach().numpy(), [t.grad.numpy() for t in leaves]


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=RTOL)


CONV_CASES = [("conv3x3", PC.conv3x3, (1, 8, 8, 8, 8, 16)),
              ("conv3x3_flat", PCF.conv3x3_flat, (2, 4, 8, 8, 16, 8))]


@pytest.mark.parametrize("activation", ["relu", "leaky_relu", "none"])
@pytest.mark.parametrize("entry,jax_fn,shape", CONV_CASES,
                         ids=[c[0] for c in CONV_CASES])
def test_conv_route_vjp_matches_jax_custom_vjp(interpret, entry, jax_fn,
                                               shape, activation):
    b, d, h, w, ci, co = shape
    rng = np.random.default_rng(0)
    x = _normal(rng, (b, d, h, w, ci))
    k = _normal(rng, (3, 3, 3, ci, co), 0.1)
    bias = _normal(rng, (co,), 0.1)
    g = _normal(rng, (b, d, h, w, co))
    slope = 0.3
    want_y, vjp = jax.vjp(lambda *a: jax_fn(*a, activation, slope),
                          jnp.asarray(x), jnp.asarray(k), jnp.asarray(bias))
    want = vjp(jnp.asarray(g))
    port = getattr(C, entry)
    got_y, got = _torch_vjp(lambda *a: port(*a, activation, slope),
                            (x, k, bias), g)
    _close(got_y, want_y)
    for a, bb in zip(got, want):
        _close(a, bb)


def test_conv_route_vjp_dtypes_and_skipped_grads():
    """dx, dw come back in their inputs' dtypes, db in the bias's; a
    gradient nobody asked for is not computed."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(_normal(rng, (1, 4, 4, 4, 8))).bfloat16()
    k = torch.from_numpy(_normal(rng, (3, 3, 3, 8, 8), 0.1)).bfloat16()
    bias = torch.from_numpy(_normal(rng, (8,), 0.1))
    g = torch.ones(1, 4, 4, 4, 8, dtype=torch.bfloat16)
    dx, dw, db = C.conv3x3_vjp(x, k, bias, g, "relu", 0.3)
    assert (dx.dtype, dw.dtype, db.dtype) == (torch.bfloat16, torch.bfloat16,
                                             torch.float32)
    none = C.conv3x3_vjp(x, k, bias, g, "relu", 0.3,
                         needs=(False, True, False))
    assert none[0] is None and none[2] is None
    torch.testing.assert_close(none[1], dw)


def test_dec0_route_vjp_matches_jax_custom_vjp(interpret):
    rng = np.random.default_rng(2)
    b, d, cu, cs, co = 2, 4, 16, 8, 8
    xd = _normal(rng, (b, d, d, d, cu))
    skip = _normal(rng, (b, 2 * d, 2 * d, 2 * d, cs))
    k = _normal(rng, (3, 3, 3, cu + cs, co), 0.1)
    bias = _normal(rng, (co,), 0.1)
    g = _normal(rng, (b, 2 * d, 2 * d, 2 * d, co))
    want_y, vjp = jax.vjp(
        lambda *a: PD.up_concat_conv3x3_pallas(*a, "relu", 0.3),
        *map(jnp.asarray, (xd, skip, k, bias)))
    want = vjp(jnp.asarray(g))
    got_y, got = _torch_vjp(
        lambda *a: D.up_concat_conv3x3_kernel(*a, "relu", 0.3),
        (xd, skip, k, bias), g)
    _close(got_y, want_y)
    for a, bb in zip(got, want):
        _close(a, bb)


def _grads_of(params, loss_fn):
    return flatten_dict(jax.grad(loss_fn)(params), sep="/")


@pytest.mark.parametrize("fuse", [True, False])
def test_unet_gradients_with_both_switches_match_jax(interpret, fuse):
    """Every parameter gets a non-zero gradient through the kernel routes,
    equal to ``jax.grad`` of the JAX model with its Pallas switches on."""
    rng = np.random.default_rng(3)
    x = _normal(rng, (2, 8, 8, 8, 1))
    t = (rng.random((2, 8, 8, 8, 1)) > 0.5).astype(np.float32)
    jmodel = JaxUNet3D(n_labels=1, depth=3, n_base_filters=8,
                       dtype=jnp.float32, fold_level0="off", use_pallas=True,
                       use_pallas_dec0=True, fuse_decoder=fuse)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]

    def jloss(p):
        return jnp.sum(jmodel.apply({"params": p}, jnp.asarray(x))
                       * jnp.asarray(t))

    want = from_flax(_grads_of(params, jloss))
    model = UNet3D(depth=3, n_base_filters=8, dtype=torch.float32,
                   use_kernel_conv=True, use_kernel_dec0=True,
                   fuse_decoder=fuse)
    model.load_state_dict(from_flax(flatten_dict(params, sep="/")))
    (model(torch.from_numpy(x)) * torch.from_numpy(t)).sum().backward()
    for name, p in model.named_parameters():
        assert p.grad is not None and p.grad.abs().sum() > 0, name
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   atol=MODEL_ATOL, err_msg=name)


@pytest.mark.parametrize("entry", ["conv3x3", "conv3x3_flat", "dec0"])
def test_route_output_carries_its_backward_when_a_gradient_is_wanted(entry):
    """The routes' outputs carry their Function's backward node when an
    input wants a gradient (on the card the kernel's output had no
    ``grad_fn``, the fault this guards) and none otherwise."""
    rng = np.random.default_rng(4)
    if entry == "dec0":
        args = [_normal(rng, (1, 2, 2, 2, 8)), _normal(rng, (1, 4, 4, 4, 8)),
                _normal(rng, (3, 3, 3, 16, 8), 0.1), _normal(rng, (8,))]
        fn, node = D.up_concat_conv3x3_kernel, "_FusedDecoderBackward"
    else:
        args = [_normal(rng, (1, 4, 4, 4, 8)),
                _normal(rng, (3, 3, 3, 8, 8), 0.1), _normal(rng, (8,))]
        fn, node = getattr(C, entry), "_FusedConvBackward"
    leaves = [torch.from_numpy(a) for a in args]
    assert fn(*leaves).grad_fn is None
    leaves[-1].requires_grad_()
    assert type(fn(*leaves).grad_fn).__name__ == node
    with torch.no_grad():
        assert fn(*leaves).grad_fn is None


def test_routes_under_checkpoint_give_the_same_gradients():
    """``torch.utils.checkpoint(use_reentrant=False)`` (the port of
    ``config.remat``) recomputes the routes' forwards and reaches the same
    gradients."""
    torch.manual_seed(0)
    model = UNet3D(depth=2, n_base_filters=8, dtype=torch.float32,
                   use_kernel_conv=True, use_kernel_dec0=True)
    x = torch.randn(1, 8, 8, 8, 1)
    model(x).sum().backward()
    plain = {n: p.grad.clone() for n, p in model.named_parameters()}
    model.zero_grad()
    torch.utils.checkpoint.checkpoint(model, x, use_reentrant=False).sum(
        ).backward()
    for name, p in model.named_parameters():
        torch.testing.assert_close(p.grad, plain[name], atol=1e-6, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_weight_view_carries_the_gradient(dtype):
    """``ConvBlock._kernel_dhwio`` while autograd records: the kernel route's
    weight gradient reaches ``conv.weight`` as the plain route's does."""
    torch.manual_seed(1)
    x = torch.randn(1, 4, 4, 4, 8)
    grads = []
    for use in (True, False):
        block = ConvBlock(8, 16, dtype=dtype, use_kernel_conv=use)
        block.load_state_dict(ConvBlock(8, 16).state_dict() if not grads
                              else state)
        state = block.state_dict()
        block(x).float().sum().backward()
        grads.append(block.conv.weight.grad)
    tol = 1e-5 if dtype == torch.float32 else 0.05
    torch.testing.assert_close(grads[0], grads[1], atol=tol, rtol=tol)


def test_prepared_weights_follow_optimizer_steps():
    """No prepared kernel operand outlives an optimizer step: the fused
    decoder's pre-summed weights (``cuda_lib.cached`` on the DHWIO tensor,
    as its launch does) and the conv kernel's K-major weight are made again
    from the stepped parameter; while autograd records, the DHWIO tensor is
    new on every call."""
    torch.manual_seed(2)
    up, sk, co = 16, 8, 8
    block = ConvBlock(up + sk, co, dtype=torch.bfloat16, use_kernel_dec0=True,
                      use_kernel_conv=True)
    opt = KerasAdam(block.parameters(), lr=0.1)

    def prepared():
        k = block._kernel_dhwio()
        return k, cached(k, ("dec0", up), lambda t: D.kernel_weights(t, up))

    with torch.no_grad():
        k0, w0 = prepared()
        assert block._kernel_dhwio() is k0          # same version: kept
    xd, skip = torch.randn(1, 2, 2, 2, up), torch.randn(1, 4, 4, 4, sk)
    block((xd, skip)).float().sum().backward()
    opt.step()
    with torch.no_grad():
        k1, w1 = prepared()
        assert k1 is not k0
        fresh = block.conv.weight.to(torch.bfloat16).permute(2, 3, 4, 1, 0)
        torch.testing.assert_close(k1, fresh, atol=0, rtol=0)
        for a, b, old in zip(w1, D.kernel_weights(fresh, up), w0):
            torch.testing.assert_close(a, b, atol=0, rtol=0)
            assert not torch.equal(a, old)
        kmajor = C.kmajor_weight(k1)
        assert kmajor.is_contiguous() and kmajor.data_ptr() == k1.data_ptr()
    assert block._kernel_dhwio() is not block._kernel_dhwio()

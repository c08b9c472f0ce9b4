"""The fused-decoder port (ops/dec0.py) against the JAX package: the Pallas
kernel ``pallas_dec0._dec0_fwd`` in interpret mode and the parity form
``models/layers.py::up_concat_conv3x3``. fp32 on the CPU, where the entry
point runs its plain version; tolerance atol 1e-4 (fp32 sums in another
order)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from fetal_mri_segmentation_tpu.models import layers as jax_layers  # noqa: E402
from fetal_mri_segmentation_tpu.ops import pallas_dec0  # noqa: E402
from fetal_mri_segmentation_tpu_torch.ops import conv3x3 as conv_ops  # noqa: E402
from fetal_mri_segmentation_tpu_torch.ops import dec0  # noqa: E402

torch.set_num_threads(1)
ATOL = 1e-4

# (B, coarse d, h, w, C_up, C_skip, C_out): the shared decoder-level case
# of tests/synthetic.py and the anisotropic (3, 4, 5) case of
# tests/test_pallas_dec0.py
SHAPES = [(2, 4, 4, 4, 16, 8, 8), (1, 3, 4, 5, 8, 8, 8)]


def _case(B, d, h, w, cu, cs, co, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, d, h, w, cu)).astype(np.float32)
    s = rng.normal(size=(B, 2 * d, 2 * h, 2 * w, cs)).astype(np.float32)
    k = (rng.normal(size=(3, 3, 3, cu + cs, co)) * 0.1).astype(np.float32)
    b = rng.normal(size=(co,)).astype(np.float32)
    return x, s, k, b


def _act(y, activation, slope):
    if activation == "relu":
        return jnp.maximum(y, 0.0)
    if activation == "leaky_relu":
        return jnp.where(y > 0, y, y * slope)
    return y


def _port(x, s, k, b, activation):
    tx = [torch.from_numpy(a) for a in (x, s, k, b)]
    return dec0.up_concat_conv3x3_kernel(*tx, activation, 0.3).numpy()


# each interpret-mode Pallas call compiles for seconds: one activation per
# shape here, every activation against the parity form below
@pytest.mark.parametrize("shape,activation", zip(SHAPES, ["relu",
                                                          "leaky_relu"]))
def test_matches_pallas_dec0_kernel(shape, activation):
    x, s, k, b = _case(*shape)
    want = pallas_dec0._dec0_fwd(
        *(jnp.asarray(a) for a in (x, s, k, b)), activation=activation,
        negative_slope=0.3, interpret=True)
    np.testing.assert_allclose(_port(x, s, k, b, activation),
                               np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("activation", ["none", "relu", "leaky_relu"])
def test_matches_jax_parity_form_with_activation(shape, activation):
    x, s, k, b = _case(*shape, seed=1)
    want = _act(jax_layers.up_concat_conv3x3(
        *(jnp.asarray(a) for a in (x, s, k, b))), activation, 0.3)
    np.testing.assert_allclose(_port(x, s, k, b, activation),
                               np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("with_skip", [True, False])
def test_parity_form_matches_jax(with_skip):
    x, s, k, b = _case(*SHAPES[1], seed=4)
    if not with_skip:
        s, k = None, k[:, :, :, :x.shape[-1]]
    want = jax_layers.up_concat_conv3x3(
        jnp.asarray(x), None if s is None else jnp.asarray(s),
        jnp.asarray(k), jnp.asarray(b))
    got = dec0.up_concat_conv3x3(
        torch.from_numpy(x), None if s is None else torch.from_numpy(s),
        torch.from_numpy(k), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_parity_form_equals_upsample_concat_conv():
    x, s, k, b = (torch.from_numpy(a) for a in _case(*SHAPES[0], seed=5))
    up = x.repeat_interleave(2, 1).repeat_interleave(2, 2).repeat_interleave(
        2, 3)
    want = conv_ops.conv3x3_reference(torch.cat([up, s], -1), k, b, "none")
    torch.testing.assert_close(dec0.up_concat_conv3x3(x, s, k, b), want,
                               atol=ATOL, rtol=0)


def test_build_weights_are_the_pallas_weights_in_gemm_layout():
    x, s, k, b = _case(*SHAPES[0], seed=6)
    cu, cs, co = x.shape[-1], s.shape[-1], k.shape[-1]
    jup, jskip = pallas_dec0._build_weights(jnp.asarray(k), cu, jnp.float32)
    up, skip = dec0.build_dec0_weights(torch.from_numpy(k), cu,
                                       torch.float32)
    np.testing.assert_allclose(
        up.numpy(), np.asarray(jup).transpose(0, 2, 1), atol=1e-6)
    np.testing.assert_array_equal(
        skip.numpy(),
        np.asarray(jskip).transpose(0, 2, 1).reshape(27 * cs, co))


@pytest.mark.parametrize("x_shape,skip_shape,channels,ok", [
    ((1, 8, 8, 8, 512), (1, 16, 16, 16, 256), (512, 256, 256), True),
    ((1, 3, 4, 5, 8), (1, 6, 8, 10, 8), (8, 8, 8), True),
    ((1, 4, 4, 4, 12), (1, 8, 8, 8, 8), (12, 8, 8), False),
    ((1, 4, 4, 4, 8), (1, 9, 8, 8, 8), (8, 8, 8), False),
])
def test_gate(x_shape, skip_shape, channels, ok):
    assert dec0.dec0_available(x_shape, skip_shape, *channels) is ok


def test_cpu_path_launches_nothing_and_meta_tensors_raise():
    x, s, k, b = (torch.from_numpy(a) for a in _case(*SHAPES[1]))
    before = dec0.up_concat_conv3x3_kernel.launches
    dec0.up_concat_conv3x3_kernel(x, s, k, b)
    assert dec0.up_concat_conv3x3_kernel.launches == before
    with pytest.raises(ValueError, match="not a CUDA device"):
        dec0.up_concat_conv3x3_kernel(x.to("meta"), s.to("meta"),
                                      k.to("meta"), b.to("meta"))

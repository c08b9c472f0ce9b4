"""The fused decoder's input-dilated form in the port
(``ops/dec0.py::up_concat_conv3x3_dilated``, a transposed conv with the
flipped 4^3 kernel) against the JAX ``models/layers.py::
up_concat_conv3x3_dilated`` (an lhs-dilated conv with padding 2), the
port's parity form and the materialized upsample + concat + conv, case by
case as ``tests/test_dilated_decoder.py``; and ``ConvBlock``'s choice
between the two forms under the heuristic's gate (monkeypatched open in
both packages, as the JAX test does off-TPU) and under both overrides.

fp32 on the CPU, the same seeded inputs on both sides; tolerance rtol
2e-4, atol 2e-5 (sums of another order; the JAX test's own tolerances are
1e-5 to 2e-4).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from fetal_mri_segmentation_tpu.models import layers as JL  # noqa: E402
from fetal_mri_segmentation_tpu.models.unet3d import UNet3D as JaxUNet3D  # noqa: E402
from fetal_mri_segmentation_tpu_torch.models import layers as PL  # noqa: E402
from fetal_mri_segmentation_tpu_torch.models.unet3d import UNet3D  # noqa: E402
from fetal_mri_segmentation_tpu_torch.ops import dec0  # noqa: E402
from fetal_mri_segmentation_tpu_torch.ops.conv3x3 import conv3d_ndhwc  # noqa: E402
from fetal_mri_segmentation_tpu_torch.utils.params import flax_params  # noqa: E402

from tests.synthetic import decoder_level_case as _case  # noqa: E402

torch.set_num_threads(1)
RTOL, ATOL = 2e-4, 2e-5


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def test_matches_parity_form_and_jax():
    x, s, k, b = _case()
    got = dec0.up_concat_conv3x3_dilated(_t(x), _t(s), _t(k), _t(b))
    _close(got, JL.up_concat_conv3x3_dilated(x, s, k, b))
    _close(got, dec0.up_concat_conv3x3(_t(x), _t(s), _t(k), _t(b)).numpy())


def test_matches_materialized_upsample():
    x, s, k, b = _case(seed=1)
    up = PL.upsample_nearest(_t(x), (2, 2, 2))
    cat = torch.cat([up, _t(s)], -1)
    want = conv3d_ndhwc(cat, _t(k).permute(4, 3, 0, 1, 2), _t(b), padding=1)
    got = dec0.up_concat_conv3x3_dilated(_t(x), _t(s), _t(k), _t(b))
    _close(got, want.numpy())


def test_anisotropic_shapes():
    rng = np.random.default_rng(2)
    B, dd, hh, ww, CU, CS, CO = 1, 3, 4, 5, 8, 8, 8
    x = rng.normal(size=(B, dd, hh, ww, CU)).astype(np.float32)
    s = rng.normal(size=(B, 2 * dd, 2 * hh, 2 * ww, CS)).astype(np.float32)
    k = (rng.normal(size=(3, 3, 3, CU + CS, CO)) * 0.1).astype(np.float32)
    b = rng.normal(size=(CO,)).astype(np.float32)
    got = dec0.up_concat_conv3x3_dilated(_t(x), _t(s), _t(k), _t(b))
    assert tuple(got.shape) == (B, 2 * dd, 2 * hh, 2 * ww, CO)
    _close(got, JL.up_concat_conv3x3_dilated(jnp.asarray(x), jnp.asarray(s),
                                             jnp.asarray(k), jnp.asarray(b)))
    _close(got, dec0.up_concat_conv3x3(_t(x), _t(s), _t(k), _t(b)).numpy())


def test_no_skip_branch():
    """Isensee's up-sampling module: no skip, the kernel covers only the
    upsampled channels."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(1, 4, 4, 4, 8)).astype(np.float32)
    k = (rng.normal(size=(3, 3, 3, 8, 8)) * 0.1).astype(np.float32)
    b = rng.normal(size=(8,)).astype(np.float32)
    got = dec0.up_concat_conv3x3_dilated(_t(x), None, _t(k), _t(b))
    _close(got, JL.up_concat_conv3x3_dilated(jnp.asarray(x), None,
                                             jnp.asarray(k), jnp.asarray(b)))
    _close(got, dec0.up_concat_conv3x3(_t(x), None, _t(k), _t(b)).numpy())


def test_gradients_match_jax():
    """d sum(y^2) / d(x_deep, skip, kernel) of the port's dilated form
    against ``jax.grad`` of the JAX dilated form."""
    x, s, k, b = _case(B=1, seed=4)

    def loss(x, s, k):
        return jnp.sum(JL.up_concat_conv3x3_dilated(x, s, k, b) ** 2)

    want = jax.grad(loss, argnums=(0, 1, 2))(x, s, k)
    inputs = [_t(a).requires_grad_() for a in (x, s, k)]
    (dec0.up_concat_conv3x3_dilated(*inputs, _t(b)) ** 2).sum().backward()
    for got, ref in zip(inputs, want):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(ref),
                                   rtol=RTOL, atol=2e-4)


def _pair(batch, seed):
    """A JAX U-Net and the port's on the same random parameters (biases
    drawn per channel), and an input of ``batch`` samples."""
    model = UNet3D(depth=3, n_base_filters=8, dtype=torch.float32)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.3)
    jmodel = JaxUNet3D(n_labels=1, depth=3, n_base_filters=8,
                       dtype=jnp.float32, fold_level0="off")
    x = np.random.default_rng(seed).normal(
        size=(batch, 8, 8, 8, 1)).astype(np.float32)
    return model, jmodel, {"params": flax_params(model)}, x


def _count_forms(monkeypatch):
    """Record which plain form each fused decoder block takes."""
    taken = []
    for name in ("up_concat_conv3x3", "up_concat_conv3x3_dilated"):
        real = getattr(PL, name)
        monkeypatch.setattr(PL, name, lambda *a, _n=name, _f=real: (
            taken.append(_n), _f(*a))[1])
    return taken


def test_convblock_dispatch_train_eval_agree(monkeypatch):
    """With the gate open in both packages, training takes the dilated
    form and eval at batch 1 the parity form, as JAX dispatches; both equal
    JAX and each other."""
    monkeypatch.setattr(PL, "_dilated_backend_ok", lambda: True)
    monkeypatch.setattr(JL, "_dilated_backend_ok", lambda: True)
    model, jmodel, variables, x = _pair(1, 5)
    taken = _count_forms(monkeypatch)
    with torch.no_grad():
        y_eval = model.eval()(_t(x))
        forms_eval, taken[:] = list(taken), []
        y_train = model.train()(_t(x))
    assert set(forms_eval) == {"up_concat_conv3x3"}
    assert set(taken) == {"up_concat_conv3x3_dilated"} and len(taken) == 2
    _close(y_train, y_eval.numpy())
    _close(y_train, jmodel.apply(variables, jnp.asarray(x), train=True))
    _close(y_eval, jmodel.apply(variables, jnp.asarray(x)))


def test_convblock_batched_dispatch(monkeypatch):
    """A batch of 3 in eval takes the dilated form (gate open) and equals
    the per-sample batch-1 parity forms and JAX."""
    monkeypatch.setattr(PL, "_dilated_backend_ok", lambda: True)
    monkeypatch.setattr(JL, "_dilated_backend_ok", lambda: True)
    model, jmodel, variables, x = _pair(3, 6)
    taken = _count_forms(monkeypatch)
    with torch.no_grad():
        y_b = model(_t(x))
        assert set(taken) == {"up_concat_conv3x3_dilated"}
        y_1 = torch.cat([model(_t(x[i:i + 1])) for i in range(3)])
    _close(y_b, y_1.numpy())
    _close(y_b, jmodel.apply(variables, jnp.asarray(x)))


@pytest.mark.parametrize("form", ["parity", "dilated"])
def test_overrides_pin_the_form(monkeypatch, form):
    """``decoder_form_override`` picks the form whatever the gate and the
    batch say, in both packages, and leaves the heuristic on exit."""
    model, jmodel, variables, x = _pair(2, 7)
    taken = _count_forms(monkeypatch)
    name = {"parity": "up_concat_conv3x3",
            "dilated": "up_concat_conv3x3_dilated"}[form]
    with PL.decoder_form_override(form), JL.decoder_form_override(form), \
            torch.no_grad():
        got = model(_t(x))
        want = jmodel.apply(variables, jnp.asarray(x))
    assert set(taken) == {name} and len(taken) == 2
    _close(got, want)
    taken.clear()
    with torch.no_grad():
        model(_t(x))
    assert set(taken) == {"up_concat_conv3x3"}  # the gate is shut here

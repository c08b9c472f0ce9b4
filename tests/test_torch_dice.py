"""The port's dice losses and metrics against ``ops/dice.py`` of the JAX
package, on the same numpy inputs, including the masked ragged batch of
``tests/test_training.py::test_partial_batch_masking_exact``.

Tolerance: fp32 sums in another order; rtol 1e-6, atol 1e-6. The ragged
batch against its padded twin: atol 1e-6 (the contract of the JAX test).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from fetal_mri_segmentation_tpu.config import Config  # noqa: E402
from fetal_mri_segmentation_tpu.ops import dice as JD  # noqa: E402
from fetal_mri_segmentation_tpu.training.train_step import (  # noqa: E402
    get_loss_fn as jax_loss_fn)
from fetal_mri_segmentation_tpu_torch.ops import dice as TD  # noqa: E402
from fetal_mri_segmentation_tpu_torch.training.train_step import (  # noqa: E402
    _masked_dice, get_loss_fn, pad_batch)

torch.set_num_threads(1)
TOL = dict(rtol=1e-6, atol=1e-6)


def _pair(seed, shape=(3, 2, 6, 5, 4)):
    rng = np.random.default_rng(seed)
    t = (rng.random(shape) > 0.6).astype(np.float32)
    p = rng.random(shape).astype(np.float32)
    return t, p


def _both(fn_j, fn_t, *arrays, **kw):
    want = fn_j(*map(jnp.asarray, arrays),
                **{k: jnp.asarray(v) for k, v in kw.items()})
    got = fn_t(*map(torch.from_numpy, arrays),
               **{k: torch.from_numpy(v) for k, v in kw.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    return got


@pytest.mark.parametrize("name", ["dice_coefficient", "dice_coefficient_loss",
                                  "weighted_dice_coefficient",
                                  "weighted_dice_coefficient_loss"])
@pytest.mark.parametrize("seed", [0, 1])
def test_dice_functions_match_jax(name, seed):
    t, p = _pair(seed)
    _both(getattr(JD, name), getattr(TD, name), t, p)


def test_dice_of_bf16_prediction_sums_in_fp32():
    t, p = _pair(2)
    got = TD.dice_coefficient(torch.from_numpy(t),
                              torch.from_numpy(p).bfloat16())
    want = JD.dice_coefficient(jnp.asarray(t), jnp.asarray(p, jnp.bfloat16))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("n_valid", [1, 2, 3])
def test_weighted_dice_sample_mask_matches_jax(n_valid):
    t, p = _pair(3)
    mask = (np.arange(3) < n_valid).astype(np.float32)
    _both(JD.weighted_dice_coefficient, TD.weighted_dice_coefficient, t, p,
          sample_mask=mask)


@pytest.mark.parametrize("label", [0, 1])
def test_label_wise_dice_matches_jax(label):
    t, p = _pair(4)
    _both(lambda a, b: JD.label_wise_dice_coefficient(a, b, label),
          lambda a, b: TD.label_wise_dice_coefficient(a, b, label), t, p)
    f = TD.get_label_dice_coefficient_function(label)
    assert f.__name__ == JD.get_label_dice_coefficient_function(
        label).__name__ == f"label_{label}_dice_coef"
    _both(JD.get_label_dice_coefficient_function(label), f, t, p)


@pytest.mark.parametrize("case", ["overlap", "empty", "disjoint"])
def test_hard_dice_matches_jax(case):
    t, p = _pair(5)
    p = p > 0.5
    if case == "empty":
        t, p = np.zeros_like(t), np.zeros_like(p)
    elif case == "disjoint":
        p = ~t.astype(bool)
    assert TD.hard_dice(t, p) == JD.hard_dice(t, p)


def test_collective_dice_is_not_ported_yet():
    t, p = map(torch.from_numpy, _pair(6))
    with pytest.raises(NotImplementedError, match="DDP"):
        TD.dice_coefficient(t, p, axis_name="data")


@pytest.mark.parametrize("n_labels", [1, 2])
def test_masked_ragged_batch_equals_padded_batch_and_jax(n_labels):
    """Padding a ragged batch of 3 to 4 with ``n_valid=3`` gives the ragged
    batch's loss and dice exactly, as in the JAX package."""
    rng = np.random.default_rng(7)
    t3 = (rng.random((3, n_labels, 4, 4, 4)) > 0.5).astype(np.float32)
    p3 = rng.random((3, n_labels, 4, 4, 4)).astype(np.float32)
    tp, pp, n_valid = pad_batch(t3, p3, 4)
    assert n_valid == 3 and tp.shape[0] == 4
    mask = (np.arange(4) < n_valid).astype(np.float32)
    cfg = Config(n_labels=n_labels, labels=tuple(range(1, n_labels + 1)))
    loss, jloss = get_loss_fn(cfg), jax_loss_fn(cfg)
    ragged = loss(torch.from_numpy(t3), torch.from_numpy(p3))
    padded = loss(torch.from_numpy(tp), torch.from_numpy(pp),
                  torch.from_numpy(mask))
    want = jloss(jnp.asarray(tp), jnp.asarray(pp), None, jnp.asarray(mask))
    np.testing.assert_allclose(padded.numpy(), ragged.numpy(), atol=1e-6)
    np.testing.assert_allclose(padded.numpy(), np.asarray(want), **TOL)
    d_ragged = _masked_dice(torch.from_numpy(t3), torch.from_numpy(p3), None)
    d_padded = _masked_dice(torch.from_numpy(tp), torch.from_numpy(pp),
                            torch.from_numpy(mask))
    np.testing.assert_allclose(d_padded.numpy(), d_ragged.numpy(), atol=1e-6)

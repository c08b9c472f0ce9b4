"""The port's UNet3D against the JAX ``UNet3D.apply`` on the same params
(``from_flax``): compute float32, fold off, fused and unfused decoder, and
with both kernel switches on (on the CPU the port's kernel routes run their
plain versions; the JAX side runs its Pallas kernels in interpret mode).
Tolerance atol 2e-4 on probabilities and logits (fp32 sums in another
order through every layer)."""

import copy
import threading
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from flax.traverse_util import flatten_dict  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from fetal_mri_segmentation_tpu.config import Config  # noqa: E402
from fetal_mri_segmentation_tpu.models.unet3d import UNet3D as JaxUNet3D  # noqa: E402
from fetal_mri_segmentation_tpu_torch.models import build_model  # noqa: E402
from fetal_mri_segmentation_tpu_torch.models import layers  # noqa: E402
from fetal_mri_segmentation_tpu_torch.parallel import collectives  # noqa: E402
from fetal_mri_segmentation_tpu_torch.models.layers import (  # noqa: E402
    max_pool_3d, set_spatial_group)
from fetal_mri_segmentation_tpu_torch.models.unet3d import UNet3D  # noqa: E402
from fetal_mri_segmentation_tpu_torch.utils.params import from_flax  # noqa: E402

torch.set_num_threads(1)
ATOL = 2e-4


def _jax_model(depth, n_labels=1, activation="sigmoid", **kw):
    return JaxUNet3D(n_labels=n_labels, depth=depth, n_base_filters=8,
                     activation_name=activation, dtype=jnp.float32,
                     fold_level0="off", **kw)


def _compare(jmodel, tmodel, x, params, logits=False):
    want = jmodel.apply({"params": params}, jnp.asarray(x), logits=logits)
    with torch.inference_mode():
        got = tmodel(torch.from_numpy(x), logits=logits)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("fuse", [True, False])
def test_unet3d_matches_jax(fuse):
    x = np.random.default_rng(0).normal(size=(2, 16, 24, 16, 1))
    x = x.astype(np.float32)
    jmodel = _jax_model(3, fuse_decoder=fuse)
    params = jmodel.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    tmodel = UNet3D(depth=3, n_base_filters=8, dtype=torch.float32,
                    fuse_decoder=fuse)
    tmodel.load_state_dict(from_flax(flatten_dict(params, sep="/")))
    _compare(jmodel, tmodel, x, params)
    _compare(jmodel, tmodel, x, params, logits=True)


def test_multiclass_softmax_head_matches_jax():
    x = np.random.default_rng(2).normal(size=(1, 8, 8, 12, 2))
    x = x.astype(np.float32)
    jmodel = _jax_model(2, n_labels=3, activation="softmax")
    params = jmodel.init(jax.random.PRNGKey(3), jnp.asarray(x))["params"]
    tmodel = UNet3D(in_channels=2, n_labels=3, depth=2, n_base_filters=8,
                    activation_name="softmax", dtype=torch.float32)
    tmodel.load_state_dict(from_flax(flatten_dict(params, sep="/")))
    _compare(jmodel, tmodel, x, params)


def test_kernel_routes_match_jax_pallas_model(monkeypatch):
    """Both switches on: every conv with C_in >= 8 and the fused decoder go
    through the port's kernel entry points (plain versions on the CPU)."""
    monkeypatch.setenv("FETAL_TPU_PALLAS_INTERPRET", "1")
    x = np.random.default_rng(4).normal(size=(1, 8, 8, 16, 1))
    x = x.astype(np.float32)
    jmodel = _jax_model(2, use_pallas=True, use_pallas_dec0=True)
    params = jmodel.init(jax.random.PRNGKey(5), jnp.asarray(x))["params"]
    cfg = Config(patch_shape=(8, 8, 16), depth=2, n_base_filters=8,
                 compute_dtype="float32", use_pallas_conv=True,
                 use_pallas_dec0=True)
    tmodel = build_model(cfg, "cpu")
    tmodel.load_state_dict(from_flax(flatten_dict(params, sep="/")))
    assert tmodel.enc0_conv2.use_kernel_conv
    assert tmodel.dec0_conv1.use_kernel_dec0
    _compare(jmodel, tmodel, x, params)


def test_max_pool_drops_the_remainder_like_valid_pooling():
    x = torch.arange(2 * 5 * 4 * 3 * 2, dtype=torch.float32).reshape(
        2, 5, 4, 3, 2)
    want = jax.lax.reduce_window(
        jnp.asarray(x.numpy()), -jnp.inf, jax.lax.max, (1, 2, 2, 2, 1),
        (1, 2, 2, 2, 1), "VALID")
    got = max_pool_3d(x)
    assert got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


class _ThreadRanks:
    """N ranks as N threads of this process, for ``parallel/collectives.py``
    in place of ``torch.distributed`` (:func:`_thread_dist`): each rank's
    group is ``(this, rank)``; a gather meets at a barrier."""

    def __init__(self, n):
        self.n = n
        self.slots = [None] * n
        self.barrier = threading.Barrier(n, timeout=120)

    def all_gather(self, rank, t):
        self.slots[rank] = t.clone()
        self.barrier.wait()
        out = list(self.slots)
        self.barrier.wait()
        return out


def _thread_dist():
    def all_gather(parts, t, group):
        for p, q in zip(parts, group[0].all_gather(group[1], t)):
            p.copy_(q)

    def all_reduce(t, op=None, group=None):
        t.copy_(sum(group[0].all_gather(group[1], t)))

    return types.SimpleNamespace(
        get_rank=lambda group: group[1],
        get_world_size=lambda group: group[0].n, all_gather=all_gather,
        all_reduce=all_reduce, ReduceOp=torch.distributed.ReduceOp)


@pytest.mark.parametrize("kw,rows,error,match", [
    ({"spatial_devices": 4, "n_base_filters": 8,
      "compute_dtype": "float32"}, 4, None, 2),
    ({"spatial_devices": 2, "depth": 3, "n_base_filters": 8,
      "compute_dtype": "float32"}, 6, None, 1),
    ({"fold_level0": (1, 1, 2), "batch_normalization": True}, None,
     ValueError, r"fold_factors requires norm-free conv blocks "
     r"\(InstanceNorm is supported; BatchNorm is not\)"),
])
def test_build_model_refuses_what_is_not_ported(monkeypatch, kw, rows,
                                                error, match):
    """A fold tuple with BatchNorm, which the JAX model refuses too, is
    refused at build time with its message. A spatial mesh is ported and
    builds, and a depth slab that goes odd before the last halving is run
    as XLA reshards it: the level ``match``, where the slab is odd, is
    gathered whole. Here N ranks run as threads of this process through the
    port's own collectives (:func:`_thread_dist`); each rank's rows equal
    its rows of the whole volume's forward within ``ATOL``."""
    if error is not None:
        with pytest.raises(error, match=match):
            build_model(Config(**kw), "cpu")
        return
    n = kw["spatial_devices"]
    model = build_model(Config(**kw), "cpu")
    assert isinstance(model, UNet3D)
    assert layers.gather_level(rows, model.depth - 1) == match
    monkeypatch.setattr(collectives, "dist", _thread_dist())
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(1, n * rows, 16, 16, 1)).astype(np.float32))
    with torch.inference_mode():
        want = model(x)
    ranks, got, errors = _ThreadRanks(n), [None] * n, []

    def run(rank):
        try:
            replica = copy.deepcopy(model)
            set_spatial_group(replica, (ranks, rank))
            with torch.inference_mode():
                got[rank] = replica(x[:, rank * rows:(rank + 1) * rows])
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)
            ranks.barrier.abort()

    threads = [threading.Thread(target=run, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not errors and not any(t.is_alive() for t in threads), errors
    np.testing.assert_allclose(torch.cat(got, 1).numpy(), want.numpy(),
                               atol=ATOL)
    # a data-parallel device count is ported and builds
    build_model(Config(num_devices=4, depth=2, n_base_filters=8), "cpu")


@pytest.mark.parametrize("fold", ["auto", "off", None])
def test_fold_settings_that_mean_no_fold_build(fold):
    cfg = Config(depth=2, n_base_filters=4, fold_level0=fold)
    assert isinstance(build_model(cfg, "cpu"), UNet3D)


@pytest.mark.parametrize("key", ["use_pallas_conv", "use_pallas_dec0"])
def test_float32_with_a_kernel_switch_on_the_card_raises(key):
    cfg = Config(depth=2, n_base_filters=4, compute_dtype="float32",
                 **{key: True})
    with pytest.raises(ValueError, match=key):
        build_model(cfg, "cuda")

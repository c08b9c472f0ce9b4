"""The Hopper kernels' tile plans replayed on the CPU.

``conv3x3_kernel`` and ``dec0_kernel`` (``fetal_mri_segmentation_tpu_torch/
csrc``) load every operand with TMA: box loads through tensor maps, zero
fill out of bounds, at coordinates that each kernel computes per K step.
Those maps, boxes, grids and coordinates come from Python
(``ops/tiling.py``, ``ops/conv3x3.py::tile_plan`` / ``load_coords``,
``ops/dec0.py::tile_plan`` / ``load_coords``). Here the loads are emulated
in torch from the same integers -- the per-tap boxes, the 8 strided
sub-parity views of the skip, the K-major weights, the masked row scatter
of the epilogue -- and the result is held against ``conv3x3_reference`` /
``up_concat_conv3x3_reference`` on a window around each tile. Every shape
that ``chip_smoke.py`` checks on the card is covered (the Isensee2017
shapes too: 16 channels in a 64-wide N tile and a 32-channel K step, 4^3
tiles with a ragged depth), with the plan of its full batch. Inputs are small integers and weights multiples of 1/4, so
every sum is exact in fp32 whatever its order: atol 1e-5.
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from fetal_mri_segmentation_tpu_torch.models.layers import ConvBlock  # noqa: E402
from fetal_mri_segmentation_tpu_torch.ops import conv3x3 as conv_ops  # noqa: E402
from fetal_mri_segmentation_tpu_torch.ops import cuda_lib, tiling  # noqa: E402
from fetal_mri_segmentation_tpu_torch.ops import dec0 as dec_ops  # noqa: E402

torch.set_num_threads(1)
ATOL = 1e-5
MAX_TEST_VOXELS = 1 << 22  # activation elements kept per case (bf16)
SAMPLED_TILES = 6          # M tiles replayed when a case has many
ALL_TILES_STEPS = 4000     # K steps up to which every M tile is replayed


def _ints(rng, shape, lo=-2, hi=2, scale=1.0):
    return torch.from_numpy(
        rng.integers(lo, hi + 1, size=shape).astype(np.float32) * scale)


def _window(t, starts, sizes):
    """t[starts : starts + sizes] on the leading axes, zero outside t."""
    out = t.new_zeros(tuple(sizes) + tuple(t.shape[len(sizes):]))
    src, dst = [], []
    for s, n, size in zip(starts, t.shape, sizes):
        lo, hi = max(s, 0), min(s + size, n)
        if hi <= lo:
            return out
        src.append(slice(lo, hi))
        dst.append(slice(lo - s, hi - s))
    out[tuple(dst)] = t[tuple(src)]
    return out


def box_load(t, tmap, coords):
    """One TMA box load: the map's strided view of ``t`` (its outermost
    extent cut to what ``t`` holds: the test keeps fewer batches than the
    plan's), the box at ``coords`` (innermost first), zeros outside."""
    dims = list(tmap.dims)
    dims[-1] = min(dims[-1], t.shape[0])
    strides = [s // tiling.ELEM for s in tmap.strides]
    view = t.as_strided(dims[::-1], strides[::-1],
                        t.storage_offset() + tmap.offset // tiling.ELEM)
    return _window(view, coords[::-1], tmap.box[::-1])


def _epilogue(acc, bias, n0, bn, activation):
    b = torch.zeros(bn)
    co = min(bn, bias.shape[0] - n0)
    b[:co] = bias[n0:n0 + co]
    return conv_ops.apply_activation(acc + b, activation, 0.3)[:, :co]


def _tiles(plan, batches, rng, steps_per_tile):
    """The M tiles replayed: all of them when the case is small, else the
    first and last of the kept batches and a few drawn between."""
    n = plan.m_tiles // plan.shape[0] * batches
    if n * steps_per_tile <= ALL_TILES_STEPS:
        return list(range(n))
    return sorted({0, n - 1, *rng.choice(n, SAMPLED_TILES - 2).tolist()})


def _batches(B, *elements_per_batch):
    return max(1, min(B, MAX_TEST_VOXELS // max(elements_per_batch)))


def _rows(plan, origin, valid_extent):
    """(row index, (d, h, w)) of the tile rows inside the output."""
    _, d0, h0, w0 = origin
    for r in range(plan.bm):
        td, th, tw = tiling.row_voxel(r, plan.box)
        v = (d0 + td, h0 + th, w0 + tw)
        if all(c < e for c, e in zip(v, valid_extent)):
            yield r, v


def _replayed(fine_extent):
    """Replayed with tensors: outputs up to 64^3 per example. The whole
    128^3 volumes of the direct predictor get the plan-only checks."""
    return int(np.prod(fine_extent)) <= 64 ** 3


ALL_CONV_SHAPES = chip_smoke.CONV_SHAPES + chip_smoke.ISENSEE_SHAPES
CONV_CASES = [pytest.param(s, id=f"{s[0]}-{s[1]}")
              for s in ALL_CONV_SHAPES if _replayed(s[3:6])]
DEC_CASES = [pytest.param(s, id=s[0]) for s in chip_smoke.DEC_SHAPES
             if _replayed([2 * v for v in s[2:5]])]
CONV_PLAN_CASES = [pytest.param(s, id=f"{s[0]}-{s[1]}")
                   for s in ALL_CONV_SHAPES if not _replayed(s[3:6])]
DEC_PLAN_CASES = [pytest.param(s, id=s[0]) for s in chip_smoke.DEC_SHAPES
                  if not _replayed([2 * v for v in s[2:5]])]


@pytest.mark.parametrize("case", CONV_CASES)
def test_conv_tile_plan_replays_to_the_reference(case):
    entry, layer, B, D, H, W, ci, co = case
    activation = chip_smoke.ACTIVATION.get(layer, "relu")
    rng = np.random.default_rng(B * D * H * W + ci + co)
    plan = conv_ops.tile_plan(B, D, H, W, ci, co)
    assert plan.m_tiles == B * np.prod(plan.tiles)
    assert plan.n_tiles * plan.bn >= co > (plan.n_tiles - 1) * plan.bn
    assert all(t * b >= e for t, b, e in zip(plan.tiles, plan.box,
                                             (D, H, W)))
    kb = _batches(B, D * H * W * ci)
    x = _ints(rng, (kb, D, H, W, ci)).to(torch.bfloat16)
    w = _ints(rng, (3, 3, 3, ci, co), scale=0.25)
    bias = _ints(rng, (co,), scale=0.25)
    wk = conv_ops.kmajor_weight(w.to(torch.bfloat16))
    assert wk.shape == (co, 3, 3, 3, ci) and wk.is_contiguous()
    tiles = _tiles(plan, kb, rng, plan.n_tiles * 27 * plan.chunks)
    written = torch.zeros((kb, D, H, W, co), dtype=torch.int32)
    for bx in tiles:
        b, d0, h0, w0 = origin = tiling.tile_origin(bx, plan.box, plan.tiles)
        # the reference on the tile's box plus its halo
        lo = (d0 - 1, h0 - 1, w0 - 1)
        size = tuple(s + 2 for s in plan.box)
        ref = conv_ops.conv3x3_reference(
            _window(x[b].float(), lo, size)[None], w, bias, activation,
            0.3)[0, 1:-1, 1:-1, 1:-1]
        for by in range(plan.n_tiles):
            n0 = by * plan.bn
            acc = torch.zeros(plan.bm, plan.bn)
            for it in range(27 * plan.chunks):
                xc, wc = conv_ops.load_coords(plan, it, b, d0, h0, w0, n0)
                a = box_load(x, plan.maps[0], xc).reshape(plan.bm, -1)
                bt = box_load(wk, plan.maps[1], wc).reshape(plan.bn, -1)
                acc += a.float() @ bt.float().T
            y = _epilogue(acc, bias, n0, plan.bn, activation)
            for r, (d, h, ww) in _rows(plan, origin, (D, H, W)):
                want = ref[d - d0, h - h0, ww - w0, n0:n0 + y.shape[1]]
                torch.testing.assert_close(y[r], want, atol=ATOL, rtol=0)
                written[b, d, h, ww, n0:n0 + y.shape[1]] += 1
    if len(tiles) == plan.m_tiles // B * kb:
        assert bool((written == 1).all()), "an output written twice or never"


@pytest.mark.parametrize("case", DEC_CASES)
def test_dec0_tile_plan_replays_to_the_reference(case):
    layer, B, dc, hc, wc, cu, cs, co = case
    activation = chip_smoke.ACTIVATION.get(layer, "relu")
    rng = np.random.default_rng(B * dc * hc * wc + cu + cs + co)
    plan = dec_ops.tile_plan(B, dc, hc, wc, cu, cs, co)
    assert plan.m_tiles == B * np.prod(plan.tiles)
    kb = _batches(B, dc * hc * wc * cu, 8 * dc * hc * wc * cs)
    xd = _ints(rng, (kb, dc, hc, wc, cu)).to(torch.bfloat16)
    skip = _ints(rng, (kb, 2 * dc, 2 * hc, 2 * wc, cs)).to(torch.bfloat16)
    k = _ints(rng, (3, 3, 3, cu + cs, co), scale=0.25)
    bias = _ints(rng, (co,), scale=0.25)
    w_up, w_skip = dec_ops.kernel_weights(k, cu)
    operands = {"xd": xd, "skip": skip, "w_up": w_up, "w_skip": w_skip}
    tiles = _tiles(plan, kb, rng, 8 * plan.n_tiles * plan.n_iters)
    written = torch.zeros((kb, 2 * dc, 2 * hc, 2 * wc, co), dtype=torch.int32)
    for bx in tiles:
        b, d0, h0, w0 = origin = tiling.tile_origin(bx, plan.box, plan.tiles)
        # the reference on the tile's coarse box plus one coarse voxel
        size = tuple(s + 2 for s in plan.box)
        ref = dec_ops.up_concat_conv3x3_reference(
            _window(xd[b].float(), (d0 - 1, h0 - 1, w0 - 1), size)[None],
            _window(skip[b].float(), (2 * d0 - 2, 2 * h0 - 2, 2 * w0 - 2),
                    tuple(2 * s for s in size))[None],
            k, bias, activation, 0.3)[0, 2:-2, 2:-2, 2:-2]
        for parity in range(8):
            r1, r2, r3 = parity >> 2 & 1, parity >> 1 & 1, parity & 1
            for by in range(plan.n_tiles):
                n0 = by * plan.bn
                acc = torch.zeros(plan.bm, plan.bn)
                for it in range(plan.n_iters):
                    (ia, ca), (ib, cb) = dec_ops.load_coords(
                        plan, it, parity, b, d0, h0, w0, n0)
                    ma, mb = plan.maps[ia], plan.maps[ib]
                    a = box_load(operands[ma.operand], ma, ca)
                    bt = box_load(operands[mb.operand], mb, cb)
                    acc += (a.reshape(plan.bm, -1).float()
                            @ bt.reshape(plan.bn, -1).float().T)
                y = _epilogue(acc, bias, n0, plan.bn, activation)
                for r, (a_, bb, c) in _rows(plan, origin, (dc, hc, wc)):
                    f = (2 * a_ + r1, 2 * bb + r2, 2 * c + r3)
                    want = ref[f[0] - 2 * d0, f[1] - 2 * h0, f[2] - 2 * w0,
                               n0:n0 + y.shape[1]]
                    torch.testing.assert_close(y[r], want, atol=ATOL, rtol=0)
                    written[(b,) + f + (slice(n0, n0 + y.shape[1]),)] += 1
    if len(tiles) == plan.m_tiles // B * kb:
        assert bool((written == 1).all()), "an output written twice or never"


def _map_end(tmap):
    """One past the last byte a tensor map addresses, from its origin."""
    return tmap.offset + sum((d - 1) * st for d, st in zip(
        tmap.dims, tmap.strides)) + tiling.ELEM


def _plan_integers_fit(plan, sizes, n_iters, coords):
    """The plan's integers fit the kernel's types: the ConvGeom / Dec0Geom
    fields and every tile index are C ints, each tensor map addresses
    exactly its operand's bytes, and the last tile's first and last K steps
    load inside the operand (one voxel of TMA zero fill at most)."""
    assert all(type(v) is int and 0 <= v < 2 ** 31 for v in plan.geom)
    assert plan.total_tiles < 2 ** 31
    for operand, size in sizes.items():
        ends = [_map_end(m) for m in plan.maps if m.operand == operand]
        assert max(ends) == size and all(e <= size for e in ends), operand
    for it in (0, n_iters - 1):
        for index, c in coords(it):
            tmap = plan.maps[index]
            assert all(-1 <= v <= d for v, d in zip(c, tmap.dims)), (
                tmap.operand, c, tmap.dims)


@pytest.mark.parametrize("case", CONV_PLAN_CASES)
def test_conv_plan_of_a_whole_volume_fits_its_integers(case):
    """The direct predictor's 128^3 layers at batch 1 and the TTA chunks
    of 2 and 8: 8 x 128^3 x 64 bf16 is 2^31 bytes (the epilogue's output
    offsets, ``csrc/conv3x3.cu::row_offset``, are 64-bit), while every
    other integer of the plan stays a C int."""
    _, layer, B, D, H, W, ci, co = case
    plan = conv_ops.tile_plan(B, D, H, W, ci, co)
    last = tiling.tile_origin(plan.m_tiles - 1, plan.box, plan.tiles)
    assert last[0] == B - 1
    n0 = (plan.n_tiles - 1) * plan.bn

    def coords(it):
        xc, wc = conv_ops.load_coords(plan, it, *last, n0)
        return ((0, xc), (1, wc))

    _plan_integers_fit(plan, {"x": B * D * H * W * ci * tiling.ELEM,
                              "w": co * 27 * ci * tiling.ELEM},
                       27 * plan.chunks, coords)
    # the last output row's offset in elements, as the kernel computes it
    b, d0, h0, w0 = last
    td, th, tw = tiling.row_voxel(plan.bm - 1, plan.box)
    top = (((b * D + d0 + td) * H + h0 + th) * W + w0 + tw) * co
    assert top + co == B * D * H * W * co
    # the TTA chunk of 8 spans 2^31 bytes: past a signed 32-bit byte count
    assert (B * D * H * W * co * tiling.ELEM >= 2 ** 31) == (B == 8)


@pytest.mark.parametrize("case", DEC_PLAN_CASES)
def test_dec0_plan_of_a_whole_volume_fits_its_integers(case):
    """The fused decoder level at a coarse 64^3 (a fine 128^3 output) at
    batches 1, 2 and 8: the same integer limits, with the fine output's
    offsets (``csrc/dec0.cu::row_offset``) in 64 bits."""
    _, B, dc, hc, wc, cu, cs, co = case
    plan = dec_ops.tile_plan(B, dc, hc, wc, cu, cs, co)
    last = tiling.tile_origin(plan.m_tiles - 1, plan.box, plan.tiles)
    assert last[0] == B - 1
    n0 = (plan.n_tiles - 1) * plan.bn

    def coords(it):
        return dec_ops.load_coords(plan, it, 7, *last, n0)

    e = tiling.ELEM
    _plan_integers_fit(plan, {"xd": B * dc * hc * wc * cu * e,
                              "w_up": 8 * co * 8 * cu * e,
                              "w_skip": co * 27 * cs * e,
                              "skip": B * 8 * dc * hc * wc * cs * e},
                       plan.n_iters, coords)
    fine = B * 8 * dc * hc * wc * co
    assert (fine * e >= 2 ** 31) == (B == 8)


@pytest.mark.parametrize("extent,voxels,box", [
    ((64, 64, 64), 128, (1, 2, 64)), ((32, 32, 32), 128, (1, 4, 32)),
    ((16, 16, 16), 128, (1, 8, 16)), ((8, 8, 8), 128, (2, 8, 8)),
    ((12, 20, 28), 128, (1, 4, 32)), ((3, 5, 4), 128, (4, 8, 4)),
    ((64, 64, 64), 256, (1, 4, 64)), ((32, 32, 32), 256, (1, 8, 32))])
def test_tile_box_covers_small_axes(extent, voxels, box):
    assert tiling.tile_box(*extent, voxels) == box
    assert np.prod(box) == voxels


@pytest.mark.parametrize("layer,bn", [
    ("enc0_conv2", 64), ("enc2_conv1", 128), ("enc3_conv1", 128),
    ("enc3_conv2", 128), ("dec0_conv2", 64), ("ragged-K", 64)])
def test_n_tile_follows_c_out(layer, bn):
    shape = next(s for s in chip_smoke.CONV_SHAPES if s[1] == layer)
    plan = conv_ops.tile_plan(*shape[2:])
    assert (plan.bn, plan.bm) == (bn, 256 if bn == 64 else 128)


@pytest.mark.parametrize("layer,kb,chunks", [
    ("enc0_conv2", 32, 1), ("ragged", 32, 1), ("ragged-K", 64, 1),
    ("enc1_conv1", 64, 1), ("enc3_conv2", 64, 4)])
def test_k_step_follows_c_in(layer, kb, chunks):
    shape = next(s for s in chip_smoke.CONV_SHAPES if s[1] == layer)
    plan = conv_ops.tile_plan(*shape[2:])
    assert (plan.kb, plan.chunks) == (kb, chunks)
    assert plan.maps[0].box[0] == plan.maps[1].box[0] == kb
    assert plan.maps[0].spec(0)[-1] == 2 * kb  # swizzle bytes


@pytest.mark.parametrize("layer,bn,kb,box,tiles", [
    ("serve isensee enc0_ctx", 64, 32, (1, 4, 64), (64, 16, 1)),
    ("direct isensee enc0_ctx", 64, 32, (1, 2, 128), (128, 64, 1)),
    ("serve isensee dec0_loc1", 64, 32, (1, 4, 64), (64, 16, 1)),
    ("serve isensee enc4_ctx", 128, 64, (8, 4, 4), (1, 1, 1)),
    ("direct isensee enc4_ctx", 128, 64, (2, 8, 8), (4, 1, 1))])
def test_isensee_narrow_and_deep_plans(layer, bn, kb, box, tiles):
    """The Isensee shapes the U-Net never gave the kernel: 16 output
    channels in a 64-wide N tile and 16 input channels in a 32-channel K
    step (TMA's zero fill pads both), and the 4^3 level at batch 8, one
    (8, 4, 4) box per sample over a depth of 4 (the rows past the depth
    masked)."""
    entry, _, B, D, H, W, ci, co = next(
        s for s in chip_smoke.ISENSEE_SHAPES if s[1] == layer)
    assert chip_smoke.ACTIVATION[layer] == "none"
    plan = conv_ops.tile_plan(B, D, H, W, ci, co)
    assert (plan.bn, plan.kb, plan.box, plan.tiles) == (bn, kb, box, tiles)
    assert plan.m_tiles == B * np.prod(tiles) and plan.n_tiles == 1 + (
        co > bn)
    w_map = plan.maps[1]
    assert w_map.dims == (ci, 27, co) and w_map.box == (kb, 1, bn)


def test_skip_sub_parity_maps_address_the_fine_voxels():
    B, dc, hc, wc, cs = 2, 3, 4, 5, 8
    plan = dec_ops.tile_plan(B, dc, hc, wc, 8, cs, 8)
    skip = torch.arange(B * 8 * dc * hc * wc * cs, dtype=torch.float32)
    skip = skip.reshape(B, 2 * dc, 2 * hc, 2 * wc, cs)
    for p in range(8):
        tmap = plan.maps[3 + p]
        p1, p2, p3 = p >> 2 & 1, p >> 1 & 1, p & 1
        view = skip.as_strided(
            tmap.dims[::-1], [s // tiling.ELEM for s in tmap.strides][::-1],
            tmap.offset // tiling.ELEM)
        torch.testing.assert_close(view, skip[:, p1::2, p2::2, p3::2])


@pytest.mark.parametrize("kwargs,match", [
    (dict(strides=(2, 40, 400)), "multiples of 16"),
    (dict(box=(64, 1, 512)), r"\[1, 256\]"),
    (dict(box=(16, 1, 64)), "128 or 64 bytes"),
    (dict(offset=8), "16-byte"),
    (dict(dims=(64,) * 6, strides=(2,) + (128,) * 5, box=(64,) + (1,) * 5),
     "1 to 5 dims")])
def test_tensor_map_rules_raise(kwargs, match):
    base = dict(operand="w", dims=(64, 27, 64), strides=(2, 128, 3456),
                box=(64, 1, 64))
    tiling.TensorMap(**base)
    with pytest.raises(ValueError, match=match):
        tiling.TensorMap(**{**base, **kwargs})


def test_map_spec_rejects_a_misaligned_base():
    tmap = tiling.weight_map("w", (8, 27, 8), 64)
    assert tmap.spec(1024)[:2] == [1024, 3]
    assert len(tmap.spec(1024)) == tiling.SPEC_LEN
    with pytest.raises(ValueError, match="16-byte"):
        tmap.spec(1032)


def test_cached_operand_follows_in_place_changes():
    t = torch.ones(4)
    calls = []

    def make(x):
        calls.append(1)
        return x * 2

    first = cuda_lib.cached(t, "k", make)
    assert cuda_lib.cached(t, "k", make) is first and len(calls) == 1
    t.add_(1)
    torch.testing.assert_close(cuda_lib.cached(t, "k", make),
                               torch.full((4,), 4.0))
    assert len(calls) == 2


def test_conv_block_prepares_the_weight_once_per_version():
    block = ConvBlock(8, 16, dtype=torch.float32, use_kernel_conv=True)
    x = torch.randn(1, 4, 4, 4, 8)
    with torch.no_grad():
        w1 = block._kernel_dhwio()
        assert block._kernel_dhwio() is w1
        assert w1.permute(4, 0, 1, 2, 3).is_contiguous()
        assert conv_ops.kmajor_weight(w1).data_ptr() == w1.data_ptr()
        y1 = block(x)
        block.conv.weight.mul_(-1)  # an optimizer step or load_state_dict
        w2 = block._kernel_dhwio()
        y2 = block(x)
    assert w2 is not w1
    torch.testing.assert_close(w2, -w1)
    want = conv_ops.conv3x3_reference(
        x, block.conv.weight.detach().permute(2, 3, 4, 1, 0),
        block.conv.bias.detach(), "relu")
    torch.testing.assert_close(y2, want)
    assert not torch.allclose(y1, y2)


def test_conv_block_keeps_autograd_while_it_records():
    block = ConvBlock(8, 8, dtype=torch.float32, use_kernel_conv=True)
    block(torch.randn(1, 3, 3, 3, 8)).sum().backward()
    assert block.conv.weight.grad is not None


def test_dec0_kernel_weights_follow_the_kernel_tensor():
    rng = np.random.default_rng(0)
    k = _ints(rng, (3, 3, 3, 16, 8), scale=0.25)
    key = ("dec0", 8)
    up, sk = cuda_lib.cached(k, key, lambda t: dec_ops.kernel_weights(t, 8))
    assert cuda_lib.cached(k, key, None)[0] is up
    ref_up, ref_sk = dec_ops.build_dec0_weights(k, 8, torch.bfloat16)
    torch.testing.assert_close(up, ref_up.reshape(8, 8, 8, 8).permute(
        0, 3, 1, 2))
    torch.testing.assert_close(sk, ref_sk.reshape(27, 8, 8).permute(2, 0, 1))
    k[..., 0] += 1
    up2, _ = cuda_lib.cached(k, key, lambda t: dec_ops.kernel_weights(t, 8))
    assert not torch.equal(up2, up)


def test_plans_are_plain_integers():
    plan = conv_ops.tile_plan(8, 16, 16, 16, 128, 256)
    assert all(type(v) is int for v in plan.geom)
    assert len(plan.geom) == 14  # csrc/conv3x3.cu::ConvGeom
    dplan = dec_ops.tile_plan(8, 8, 8, 8, 512, 256, 256)
    assert all(type(v) is int for v in dplan.geom)
    assert len(dplan.geom) == 15  # csrc/dec0.cu::Dec0Geom
    assert len(dplan.maps) == 11
    assert dataclasses.replace(plan) == plan

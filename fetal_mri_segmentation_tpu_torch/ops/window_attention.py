"""Shifted-window 3D attention (Swin UNETR's, ``models/swin_unetr.py``):
the window geometry and one attention op with two routes.

No TPU kernel is ported here: the JAX package has no attention. Geometry,
as MONAI's ``monai/networks/nets/swin_unetr.py`` builds it:

- :func:`window_and_shift`: per axis the window (``WINDOW``, or the axis's
  length where it is at most ``WINDOW``) and the shift (0 there);
- :func:`window_partition` / :func:`window_reverse`: (B, D, H, W, C) <->
  (B, windows, tokens, C), windows in (d, h, w) order;
- :func:`relative_position_index`: the (n, n) index of a 7^3 window's
  token pairs into the (2w - 1)^3 bias table;
- :func:`shift_mask`: the shifted block's (windows, n, n) mask on the
  padded grid, 0 within a region and -100 across regions.

:func:`window_attention` computes ``softmax(q k^T / sqrt(d) + bias) v``
over q, k, v (B, windows, heads, n, d), ``bias`` (1 or windows, heads, n,
n) the relative-position bias with the shift mask folded in
(:func:`attention_bias`). Two routes give the same result:

- ``"composite"`` (:func:`attention_composite`): the plain ops, scores in
  q's dtype, the bias added and the softmax taken in fp32, the
  probabilities rounded to v's dtype before the second matmul (MONAI's
  under autocast). The CPU runs it.
- ``"sdpa"`` (:func:`attention_sdpa`):
  ``torch.nn.functional.scaled_dot_product_attention`` with the bias as
  its additive mask, in q's dtype. A per-window bias is passed with the
  windows folded into the heads, (B, windows x heads, n, n), so that the
  mask broadcasts over the batch by a stride of 0 and is never copied per
  sample; :func:`attention_bias` lays the bias out with its rows padded to
  16 elements. On the H100 SDPA runs cuDNN's flash kernel, which reads the
  mask in place either way, but with aligned rows takes 0.84 against 1.53
  ms for a shifted stage-1 block at batch 4, and a whole batch-4 forward
  35.0 against 36.7 ms (``PERF.md``).

On a CUDA tensor the route is SDPA (measured on the H100: 37.2 against
57.9 ms a batch-4 96^3 forward; ``PERF.md``), on any other the composite.
The function counts its calls per route in its ``calls`` attribute.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

WINDOW = 7
# the bias rows start at multiples of 16 elements: cuDNN's flash attention
# reads such a mask 1.8x faster on the H100 (the module docstring)
_ALIGN = 16


def window_and_shift(size: Sequence[int],
                     shift: int) -> Tuple[tuple, tuple]:
    """MONAI's ``get_window_size`` for a grid of ``size``."""
    return (tuple(min(s, WINDOW) for s in size),
            tuple(0 if s <= WINDOW else shift for s in size))


def relative_position_index(window: Sequence[int] = (WINDOW,) * 3
                            ) -> torch.Tensor:
    """(n, n) int64 index into the (2 w - 1)^3 table of each pair of a
    window's tokens (MONAI's ``WindowAttention``)."""
    coords = torch.stack(torch.meshgrid(
        *[torch.arange(w) for w in window], indexing="ij")).flatten(1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0)
    rel = rel + torch.tensor([w - 1 for w in window])
    _, wh, ww = window
    rel = rel * torch.tensor([(2 * wh - 1) * (2 * ww - 1), 2 * ww - 1, 1])
    return rel.sum(-1)


def window_partition(x: torch.Tensor, window: Sequence[int]) -> torch.Tensor:
    """(B, D, H, W, C) -> (B, windows, tokens, C); D, H, W multiples of the
    window."""
    b, d, h, w, c = x.shape
    wd, wh, ww = window
    x = x.reshape(b, d // wd, wd, h // wh, wh, w // ww, ww, c)
    return x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(b, -1, wd * wh * ww, c)


def window_reverse(x: torch.Tensor, window: Sequence[int],
                   dims: Sequence[int]) -> torch.Tensor:
    """The inverse of :func:`window_partition` onto the grid ``dims``."""
    b, c = x.shape[0], x.shape[-1]
    d, h, w = dims
    wd, wh, ww = window
    x = x.reshape(b, d // wd, h // wh, w // ww, wd, wh, ww, c)
    return x.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(b, d, h, w, c)


def shift_mask(dims: Sequence[int], window: Sequence[int],
               shift: Sequence[int], device=None) -> torch.Tensor:
    """(windows, n, n) fp32 mask of the shifted block on the padded grid
    ``dims`` (MONAI's ``compute_mask``)."""
    img = torch.zeros(tuple(dims), device=device)
    axes = [(slice(-w), slice(-w, -s), slice(-s, None))
            for w, s in zip(window, shift)]
    region = 0
    for a in axes[0]:
        for b in axes[1]:
            for c in axes[2]:
                img[a, b, c] = region
                region += 1
    ids = window_partition(img[None, ..., None], window)[0, :, :, 0]
    return torch.where(ids[:, None, :] != ids[:, :, None], -100.0, 0.0)


def attention_bias(table: torch.Tensor, index: torch.Tensor, n: int,
                   mask: Optional[torch.Tensor],
                   dtype: torch.dtype) -> torch.Tensor:
    """The additive bias of one block's attention in ``dtype``: the table
    (T, heads) gathered at ``index[:n, :n]`` (MONAI's slice), plus the shift
    mask (windows, n, n) where there is one: (1 or windows, heads, n, n),
    each row starting at a multiple of 16 elements. Differentiable in
    ``table``."""
    heads = table.shape[1]
    bias = table[index[:n, :n].reshape(-1)].reshape(n, n, heads)
    bias = bias.permute(2, 0, 1)[None]
    if mask is not None:
        bias = bias + mask[:, None]
    return _aligned(bias, dtype)


def _aligned(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` in ``dtype``, each row of its last axis starting at a multiple
    of ``_ALIGN`` elements."""
    n = t.shape[-1]
    row = -(-n // _ALIGN) * _ALIGN
    out = t.new_empty(t.shape[:-1] + (row,), dtype=dtype)[..., :n]
    return out.copy_(t)


def attention_composite(q, k, v, bias):
    """The composite route (the module docstring)."""
    scores = (q * q.shape[-1] ** -0.5) @ k.transpose(-1, -2)
    prob = torch.softmax(scores.float() + bias.float(), dim=-1)
    return prob.to(v.dtype) @ v


def attention_sdpa(q, k, v, bias):
    """The SDPA route (the module docstring)."""
    b, nw, h, n, d = q.shape
    if bias.dtype != q.dtype:
        bias = _aligned(bias, q.dtype)
    if bias.shape[0] == 1:
        shape = (b * nw, h, n, d)
        mask = bias.expand(b * nw, h, n, n)
    else:
        # the windows folded into the heads: the mask is then one tensor
        # broadcast over the batch
        shape = (b, nw * h, n, d)
        mask = bias.view(1, nw * h, n, n).expand(b, nw * h, n, n)
    out = F.scaled_dot_product_attention(
        q.reshape(shape), k.reshape(shape), v.reshape(shape),
        attn_mask=mask)
    return out.view(b, nw, h, n, d)


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     bias: torch.Tensor) -> torch.Tensor:
    """``softmax(q k^T / sqrt(d) + bias) v`` in every window: q, k, v (B,
    windows, heads, n, d), ``bias`` (1 or windows, heads, n, n); the result
    (B, windows, heads, n, d) in q's dtype. SDPA on a CUDA tensor, else
    the composite; each call counted under its route in
    ``window_attention.calls``."""
    sdpa = q.is_cuda
    window_attention.calls["sdpa" if sdpa else "composite"] += 1
    return (attention_sdpa if sdpa else attention_composite)(q, k, v, bias)


window_attention.calls = {"composite": 0, "sdpa": 0}

"""The model families, one file each, found by a configuration's
``model_name``: ``families/<model_name>.py``. Like ``reference/``, a family
file imports nothing of the port or of JAX. Each offers:

- ``param_spec(cfg)``: (name, shape) of every parameter, in order, under
  the names the program's ``state_dict`` gives them;
- ``init(name, shape, z)``: one parameter from ``z``, a standard normal
  draw of its shape (``inputs.make_weights``);
- ``forward(p, x, cfg, quant=None, dropout_masks=None)``: the plain
  float32 logits of x (B, C, D, H, W); ``quant`` rounds each conv's
  operands (the control), ``dropout_masks`` are a training forward's;
- ``head_key(cfg)``: the bias of the finest head, which
  ``inputs.center_head`` shifts;
- ``ops(cfg, patch, in_channels=1)``: every operation of one forward of
  one patch as ``flops.Op`` (FLOPs, bytes and a ``group``: ``"conv"`` for
  the convs inside the program's conv blocks, ``None`` for heads; a later
  family may add groups such as ``"attn"``);
- ``ranges()``: module class name -> ``pb.*`` range name, for the traced
  run;
- ``dropout_masks(generator, batch, cfg)``: a train step's keep-masks,
  drawn from ``generator`` in the program's documented order, or None;
- ``loss(y, pred, cfg)``: the training loss of probabilities ``pred``
  against truth ``y``, as the program trains the family.
"""

from __future__ import annotations

import functools
import importlib.util
import os

DIR = os.path.dirname(os.path.abspath(__file__))


@functools.lru_cache(maxsize=None)
def _load(path: str):
    spec = importlib.util.spec_from_file_location(
        "pb_family_" + os.path.basename(path)[:-3], path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def family(cfg: dict):
    """The family module of ``cfg["model_name"]``; raises naming the file
    it looked for where there is none."""
    path = os.path.join(DIR, str(cfg["model_name"]) + ".py")
    if not os.path.isfile(path):
        raise LookupError(f"model_name {cfg['model_name']!r}: no family "
                          f"file {path}")
    return _load(path)

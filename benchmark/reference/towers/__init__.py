"""The reference's towers, each found by its name: the tower ``<name>`` is
the file ``towers/<name>.py``, where ``<name>`` is the system's
``--vid_base_arch`` or ``--aud_base_arch`` value. Adding the reference of
an architecture is adding its file; no other file is edited.

A tower file defines ``build(channels)``, which returns an ``nn.Module``
with:

* ``feature_dim``: the width D of its features, at which the network
  sizes the modality's head stack;
* ``forward(x) -> [B, D]`` in float32. A video tower takes RGB clips
  ``[B, T, H, W, channels]`` (``channels`` 3), an audio tower log-mel
  spectrograms ``[B, nfilt, frames, channels]``;
* ``draw_std(name, shape)``: its seed-draw rule. For its parameter
  ``name`` (relative to the tower) the standard deviation of the leaf's
  slice of the benchmark's one normal draw (``weights.make_state``), or
  0.0 for a leaf that keeps a constant initial value, such as
  BatchNorm's scale 1 and shift 0. A leaf whose own initialiser is random
  has to be drawn, or the state would not follow from the seed.

Its parameters carry the names and shapes of the system's tower of that
name, so that one state dict loads into both.

Its forward FLOPs (``benchmark/flops.py::count``) are those of the
submodules that compute its products: each ``model.Conv``, and each
module with a method ``flops(args, out) -> int`` that gives 2 x the
multiply-adds of one call from the shapes of its arguments and output,
batch included (a dense layer; an attention's two products). Nothing else
is counted. The first of them to finish a call is the tower's stem: it
reads the tower's input, so a training step computes no input gradient of
it (``train = 3 x forward - stems``).

Its products go through the ``Precision`` helpers of ``model``: operands
through ``q``, outputs through ``qg``, under ``autocast``, and its blocks
through ``_run``, so that the float8 control, the bf16 look and
checkpointing hold for every tower.
"""

from __future__ import annotations

import importlib
from pathlib import Path

HERE = Path(__file__).resolve().parent


def names():
    """The towers there are files for."""
    return sorted(p.stem for p in HERE.glob("*.py")
                  if not p.stem.startswith("_"))


def build(name, channels):
    """The tower ``name``, built by its file for input of ``channels``."""
    path = HERE / f"{name}.py"
    if not name.isidentifier() or name.startswith("_") or not path.is_file():
        raise KeyError(f"no reference tower {name!r}: looked for {path}; "
                       f"the tower files are {names()}")
    return importlib.import_module(f"{__name__}.{name}").build(channels)

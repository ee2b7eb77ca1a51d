"""Named spans at the program's layer boundaries, for ``torch.profiler``.

``span(name)`` is a ``torch.profiler.record_function`` range while a
profiler is recording, and a shared no-op context otherwise: a bare
``record_function`` costs tens of microseconds a use even with no profiler
running, the check below under one. The ranges sit on the profiler's own
clock, the clock of the device activity in the same trace, so a reader of
the trace can put each kernel down to the span whose host interval holds
the runtime call that launched it (by correlation id, on any thread: on
CUDA ``loss.backward()`` launches from autograd's device thread while the
calling thread waits inside its span).

The spans (names are fixed: ``tools/profile_step.py`` and the benchmark's
per-layer metrics read them by name):

* ``train/state.py::train_step``: ``dgtd.train.step`` (its ``args`` the
  step index and ``graph`` or ``eager``) and inside it
  ``dgtd.train.normalize``, ``dgtd.train.forward`` (``model.loss``, the
  losses included), ``dgtd.train.backward``, ``dgtd.train.all_reduce``
  (only under data parallelism) and ``dgtd.train.optimizer``. A replayed
  step launches each phase's CUDA graph inside that phase's span (the
  copy into the graph's inputs in ``dgtd.train.normalize``), so its device
  work is put down to the same spans by the graph launch's correlation id;
  it opens none of the spans inside the forward (their Python does not run);
* ``models/cod.py::SegModel``: ``dgtd.predict`` around ``predict`` and
  ``dgtd.loss`` around the loss terms of ``loss``;
* the networks' forwards (``models/hitnet.py``, ``models/dqnet.py``):
  ``dgtd.prompt_encoder``, ``dgtd.prompt_decoders`` (HitNet's 28 decoders,
  DQnet's depth prompts), ``dgtd.backbone`` and ``dgtd.decode``;
* the offline depther: ``dgtd.depther`` around
  ``tools/depth_gen.py::Dinov2Depther.batch`` (the copy to the card, the
  normalization, the model), inside it ``dgtd.depther.backbone``
  (``models/dpt.py::DinoDPTDepther.features``), ``dgtd.depther.head`` (the
  DPT head, the expectation over the bins, the resize) and, in each
  DINOv2 block, ``dgtd.depther.attention`` around the SDPA call alone.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
from torch.profiler import record_function

_OFF = contextlib.nullcontext()


def span(name: str, args: Optional[str] = None):
    """A ``record_function(name, args)`` range while a profiler records,
    else the shared no-op context."""
    if torch._C._autograd._profiler_enabled():
        return record_function(name, args)
    return _OFF

"""adrates_torch — the PyTorch/CUDA port of adrates_tpu.

The same fixed-income pricing and AD-risk semantics as ``adrates_tpu``
(which stays the reference every part of this package is tested
against), written for one NVIDIA H100:

 - trade *compilation* (dates/calendars/day counts/schedules) happens once
   on the host in Python/numpy and produces static padded cashflow tables;
 - *pricing and risk* are plain torch functions on float64 tensors,
   differentiated with ``torch.func``; the hot device computations off the
   autodiff path are hand-written CUDA kernels (``adrates_torch/csrc``),
   each with a plain torch twin in ``adrates_torch/ops/kernels.py``.

Numerical policy: every tensor is created with an explicit
``dtype=torch.float64`` (int32/int64 for indices); the package never
changes torch's global default dtype, and no function picks a device by
itself — callers pass ``device=``.
"""

from . import utils
from .utils import *  # noqa: F401,F403 — conventions are the base namespace

__version__ = "0.1.0"

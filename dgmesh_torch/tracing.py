"""Spans and counters of the program, on the profiler's clock.

While a ``torch.profiler`` session records, ``span(name)`` is a
``record_function`` range: it lands in the same trace as the CUDA runtime
calls and the device's kernels, with the same timestamps, so that each
kernel, copy, synchronisation and idle stretch of the device can be put down
to the stage of the program that issued it.  ``count(name, value)`` adds to
a running total that ``counts()`` reads.  When no profiler records, a span is
a shared null context and a count does nothing: no tensor is made and no
value computed.  Nothing switches them but the profiler itself
(``cli/train.py --profile_iters N`` writes such a trace).

Spans (a root holds every span of its iteration or view):

- roots: ``trainer.iteration`` (``Trainer.run_iteration``), ``trainer.log``
  (the host's reads of the metrics in ``Trainer.train``: the tripwires' and
  the log line's), ``render.frame`` (``eval/testing.py::render_frame_with_aux``);
- the step's stages: ``step.anchor``, ``anchor.knn``, ``step.normal_init``,
  ``step.forward``, ``step.backward``, ``step.sanitize``, ``step.optimizer``,
  ``step.densify``;
- layers: ``nets.<field>`` (each net call, by its ``NetParams`` field),
  ``splat.preprocess``, ``splat.binning``, ``splat.composite``, ``dpsr``,
  ``mesh.marching_tets``, ``raster.rasterize``, ``raster.shade``, and the
  kernels' backward on the autograd engine's thread:
  ``splat.composite_bwd``, ``raster.shade_bwd``, ``nets.trunk_bwd``.

Counters: ``nets.rows.<field>``, the rows each net call runs, and
``nets.live_rows.<field>``, the live Gaussians or valid vertices among them;
``knn.pairs``, the (query, valid ref) pairs each ``ops/knn.py::knn`` call
searches.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, List, Union

import torch
from torch.autograd import profiler as _profiler
from torch.autograd.profiler import record_function

_host: Dict[str, int] = {}
_device: Dict[str, List[torch.Tensor]] = {}


def active() -> bool:
    """Whether a torch.profiler session records now."""
    return _profiler._is_profiler_enabled


class _Off:
    """A span while no profiler records: a null context, one per name, and
    the decorator of that name (which looks at the profiler at each call)."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __call__(self, fn: Callable) -> Callable:
        name = self.name

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return spanned


class _On(record_function):
    """A span while a profiler records; as a decorator, the same as _Off's."""

    def __call__(self, fn: Callable) -> Callable:
        return _off(self.name)(fn)


_OFF: Dict[str, _Off] = {}


def _off(name: str) -> _Off:
    off = _OFF.get(name)
    if off is None:
        off = _OFF[name] = _Off(name)
    return off


def span(name: str):
    """The program's range ``name``: ``with span(name): ...`` or
    ``@span(name)`` on a function."""
    if _profiler._is_profiler_enabled:
        return _On(name)
    return _off(name)


def count(name: str, value: Union[int, torch.Tensor, Callable[[], Union[int, torch.Tensor]]]):
    """Add ``value`` (a host int, a 0-d tensor kept on its device until
    ``counts``, or a callable giving one, called only here) to the total
    ``name``, while a profiler records."""
    if not _profiler._is_profiler_enabled:
        return
    if callable(value):
        value = value()
    if isinstance(value, torch.Tensor):
        _device.setdefault(name, []).append(value.detach())
    else:
        _host[name] = _host.get(name, 0) + int(value)


def counts() -> Dict[str, int]:
    """The totals as host numbers (one synchronisation per device total)."""
    out = dict(_host)
    for k, v in _device.items():
        out[k] = out.get(k, 0) + int(torch.stack(v).sum().item())
    return out


def reset() -> None:
    _host.clear()
    _device.clear()

"""The port's tracer: named host spans and counters at its layer boundaries.

It is off unless whoever owns a profiling session turns it on
(``enable()``), reads what it recorded (``spans()``, ``counters()``) and
turns it off (``disable()``); no environment variable or config key does.
Off, ``span(name)`` returns one shared no-op context manager (no
allocation, no clock read, no torch call, never a synchronisation) and
``count`` is one flag test; a counter whose value costs work to compute
is guarded by ``is_on()``.

On, each span records a ``Span``: its name, ``time.perf_counter_ns()`` at
its entry and exit, the ``threading.get_ident()`` of the thread it ran on,
and ``parent``, the name of the innermost span open on that thread when it
began (None at the top). A span is recorded only if it began and ended
within one ``enable()`` ... ``disable()``. Each span is also a range of
any running ``torch.profiler`` profile, so that it shows the spans over the
kernels they launched, on the profiler's own clock (a profile records the
ranges of a thread other than its own, the loader's producer, only with
``profile_all_threads``). The range is torch's ``_RecordFunctionFast``,
which with no profile running costs a small fraction of what
``torch.profiler.record_function`` does.

The spans and counters, by the module that records them and the thread
that runs it:

========================  ========  ==================================================
``train.forward``         caller    ``train_lib.forward_backward``: the inputs, the
                                    model and the total loss
``train.backward``        caller    the placement's ``before_backward`` and
                                    ``total.backward()``
``train.optimizer``       caller    ``train_lib.apply_gradients``, the whole of it
``optimizer.clip``        caller    its child: the gradients' reduce, the global norm
                                    and the rescales (and the accumulation window)
``optimizer.adam``        caller    its child: the learning rate and the Adam step
``train.graph_replay``    caller    ``train_lib.train_step`` on a captured step: the
                                    batch copied into the graph's inputs, the replay
                                    and the metrics' clone (the three ``train.*``
                                    phases above then run only when a step is eager
                                    or captured)
``model.unit``            caller    ``models/dualvgr.py::DualVGRUnitStack``: one unit
                                    cycle of a forward, QueryAttn through the
                                    residual add (in a train step's forward: eager
                                    or captured steps only)
``loader.gather``         producer  ``data/loader.py``: one batch made, both feature
                                    gathers
``loader.put``            producer  one batch handed to the queue, blocked while full
``loader.get``            consumer  one blocking get from the queue
``prefetch.copy``         caller    ``parallel/mesh.py::prefetch_to_device``: one
                                    item's pinning, copies issued and event recorded
``validate.fetch``        caller    ``validate_lib.validate``: one batch's predictions
                                    brought to the host (the wait for the card)
``validate.tally``        caller    everything after a pass's loop: concatenations,
                                    buckets, strings
``extract.upload``        caller    ``predict.py::video_features``: one video's decoded
                                    frames put on the device (pageable, whole)
``extract.clips``         caller    its clip sampling and both resizes on the device
``extract.appearance``    caller    ``preprocess/features.py``: one call of the
                                    appearance extractor (normalise, ResNet-101)
``extract.motion``        caller    one call of the motion extractor (ResNeXt-101 3D)
``predict.encode``        caller    ``predict.py::predict_frames``: the questions
                                    tokenized and encoded
``predict.forward``       caller    its DualVGR forward (the logits left on the device)
========================  ========  ==================================================

Counters: ``loader.batches``, ``loader.rows`` (rows gathered, padding rows
included) and ``loader.bytes`` (the batches' feature bytes) on the
producer; ``prefetch.bytes`` (bytes issued host to device) and
``prefetch.pinned`` (pageable tensors pinned on the way);
``train.graph_captures``, ``train.graph_replays`` and ``train.eager_steps``
(``train_lib.train_step``: steps captured, replayed, taken eagerly; a
captured step is replayed too, so replays over all steps is the share the
graph took); ``model.unit_cycles`` (the unit cycles the model's forwards
ran; a replayed step runs them without the host, so counts none);
``lstm.gate_acts_bytes`` (``ops/lstm_train_kernel.py::bilstm_train_fwd``:
the bytes of gate activations kernel 3 keeps for kernel 4, a launch on the
card; eager and captured steps only, as ``model.unit_cycles``);
``proj.tc_f32_rows`` (``ops/proj_kernel.py::input_proj_f32``: the rows R*T
that kernel 7 projects on the tensor cores, a launch on the card; eager
and captured steps and every eval forward); ``proj.tc_f32_wgrad_rows``
(``ops/proj_kernel.py::input_proj_f32_wgrad``: the rows R*T whose
``dW_ih`` kernel 8 sums on the tensor cores, a launch on the card; eager
and captured steps, so a fp32 train step reads the rows of
``proj.tc_f32_rows`` in it too); ``lstm.tc_f32_whh_rows``
(``ops/whh_grad_kernel.py::whh_grad_f32``: the rows R*T whose ``dW_hh``
kernel 9 sums on the tensor cores, a launch on the card: the appearance
BiLSTM's and both question BiLSTMs' in a train step; eager and captured
steps); ``extract.videos`` (videos
with frames handed to ``predict.py::video_features``),
``extract.upload_bytes`` (their decoded frames' bytes put on the device),
``extract.frames`` and ``extract.clips`` (``preprocess/features.py``: the
frames through ResNet-101 and the clips through ResNeXt-101 3D, counted
where each extractor is called, the feature CLI's batches too) and
``predict.questions`` (the questions ``predict_frames`` answered). The
extraction spans are the host's: the backbones' kernels run on after
their span ends, until something waits for the features.
"""

from __future__ import annotations

import threading
import time
from typing import NamedTuple

from torch._C._profiler import _RecordFunctionFast


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    thread: int
    parent: str | None


class _Off:
    """The span of a tracer that is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()

_on = False
_session = 0  # counts the enable() calls: a span records only in its own
_lock = threading.Lock()
_spans: list[Span] = []
_counters: dict[str, int] = {}
_open = threading.local()  # .names: the spans open on this thread, innermost last


class _Span:
    __slots__ = ("name", "session", "parent", "range", "start")

    def __init__(self, name: str):
        self.name, self.session = name, _session

    def __enter__(self):
        names = getattr(_open, "names", None)
        if names is None:
            names = _open.names = []
        self.parent = names[-1] if names else None
        names.append(self.name)
        self.range = _RecordFunctionFast(self.name)
        self.range.__enter__()
        self.start = time.perf_counter_ns()
        return None

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        self.range.__exit__(*exc)
        _open.names.pop()
        if _on and self.session == _session:
            with _lock:
                _spans.append(Span(self.name, self.start, end, threading.get_ident(), self.parent))
        return False


def span(name: str):
    """A context manager that records the time its body takes as ``name``."""
    if not _on:
        return _OFF
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Adds ``n`` to the counter ``name``."""
    if _on:
        with _lock:
            _counters[name] = _counters.get(name, 0) + n


def is_on() -> bool:
    """Whether the tracer is on."""
    return _on


def enable() -> None:
    """Turns the tracer on."""
    global _on, _session
    _session += 1
    _on = True


def disable() -> None:
    """Turns the tracer off; what it recorded stays until read."""
    global _on
    _on = False


def spans() -> list[Span]:
    """The spans recorded since the last call, in the order they ended."""
    with _lock:
        out = list(_spans)
        _spans.clear()
    return out


def counters() -> dict[str, int]:
    """The counters' totals since the last call."""
    with _lock:
        out = dict(_counters)
        _counters.clear()
    return out

"""A kernel's share of its roofline over the traced window: the least time
the chip could take for the algorithm's work in the window's steps, over
the time the kernel's launches took."""

from __future__ import annotations

from perfbench.lib.peaks import bound_s


def share(trace, kernel) -> float | None:
    """``kernel`` is a module of ``perfbench/roofline/``: ``PATTERN``, the
    kernel's name in the trace, and ``launches(step, model)``, the
    (flops, bytes) of the work it does for one step. None where no launch
    of it ran."""
    took = sum(d for name, _, d in trace.kernels if kernel.PATTERN.search(name))
    if took <= 0:
        return None
    model = trace.config["model"]
    least = sum(bound_s(f, b) for step in trace.steps for f, b in kernel.launches(step, model))
    return 100.0 * least / took

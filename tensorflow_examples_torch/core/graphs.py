"""CUDA graph capture that keeps the kernels' launch counts honest.

A kernel wrapper counts its launches in Python, which a graph replay
does not run. :func:`capture` runs ``fn`` under a capture context, takes
the counts the capture moved back out (a capture launches nothing) and
returns them as the graph's tally; :func:`add_tally` adds a tally once a
replay. The serving engine's decode rungs (``serving/engine.py``) and
the trainer's k-step graphs (``train/graphs.py``) both capture through
here.
"""

from __future__ import annotations

from typing import Callable


def launch_counts(kernels) -> dict:
    """Every ``*launches`` counter of ``kernels``, keyed (wrapper, name)."""
    return {(fn, name): value for fn in kernels for name, value in vars(fn).items()
            if name.endswith("launches")}


def capture(capture_ctx, fn: Callable, kernels):
    """``fn()``'s result under ``capture_ctx`` and the launches it recorded,
    ``{(wrapper, counter): n}``; the counters are restored either way."""
    before = launch_counts(kernels)
    try:
        with capture_ctx:
            out = fn()
        after = launch_counts(kernels)
    finally:
        for (wrapper, name), value in before.items():
            setattr(wrapper, name, value)
    return out, {key: after[key] - before[key] for key in after if after[key] != before[key]}


def add_tally(tally: dict, times: int = 1) -> None:
    """Count ``times`` replays of a graph that recorded ``tally``."""
    for (wrapper, name), n in tally.items():
        setattr(wrapper, name, getattr(wrapper, name) + n * times)

"""The JSONL line schema of the trainer's telemetry: the port's copy of
the parts of ``tensorflow_examples_tpu/telemetry/schema.py`` that cover
the kinds the port's trainer writes (``window``, ``eval``, ``final``,
``memory``, ``compile_warning``), and the serving line's optional key
groups. The trainer's lines are schema version 5 lines of the reference
and the serving line (``serving/batcher.py``) is stamped
``SERVING_SCHEMA_VERSION``, so the reference's ``validate_line`` accepts
both.

Line shape::

    {"schema_version": 5, "kind": "window" | "eval" | "final" | "memory"
                                 | "compile_warning",
     "host": 0, "step": <int >= 0>, "time_unix": <float>,
     "session_start_unix": <float>,          # constant per fit
     "metrics": {"train/loss": ...},          # numeric or null
     "counters": {"train/steps_total": ...},  # non-negative ints (fit deltas)
     "gauges": {...}, "derived": {...},       # numeric or null
     "exit_reason": "complete" | "preempt" | "error:<Type>",  # final only
     "memory": {"params_bytes": ..., ...},    # required on memory lines
     "compile": {"fn": ..., "delta": ..., "count": ..., "wall_secs": ...},
                                              # compile_warning lines only
     "profile": {"dir": ..., "start_step": ..., "num_steps": ...,
                 "wall_secs": ...}}           # final lines only, optional
"""

from __future__ import annotations

import numbers
from typing import Any

SCHEMA_VERSION = 5
# The serving line's version: the reference's SERVING_SCHEMA_VERSION. Its
# validator requires only the v4 ``SERVING_KEYS`` of a serving object and
# refuses keys newer than the stamp, so the keys the port does not write
# yet do not block it.
SERVING_SCHEMA_VERSION = 14

# The serving line's optional keys, the reference's
# (``telemetry/schema.py``): the speculation measurement (stamped when
# ``spec_decode_k`` > 0), the paged pool's prefix-cache summary, the
# overload story (the SLO-class split, brownout state and the digest's
# truncation flag; every replica line) and the precision registry's facts
# (stamped when the weights are quantized). The router-only keys of v12
# to v14 stay off a replica's line, as in the reference.
SERVING_KEYS_V8 = ("accepted_per_step", "draft_hit_rate", "spec_k")
SERVING_KEYS_V9 = ("prefix_blocks", "prefix_chains")
SERVING_KEYS_V10 = (
    "queue_wait_p95_interactive", "queue_wait_p95_batch",
    "ttft_p95_interactive", "ttft_p95_batch",
    "tpot_p95_interactive", "tpot_p95_batch",
    "shed_interactive", "shed_batch", "preempted_batch",
    "brownout_level", "brownout_transitions", "digest_truncated",
)
SERVING_KEYS_V11 = ("weight_bits", "param_bytes", "param_bytes_f32", "quantized_params")
KINDS = ("window", "eval", "final", "memory", "compile_warning")
_REQUIRED = ("schema_version", "kind", "host", "step", "time_unix", "session_start_unix",
             "metrics", "counters", "gauges", "derived")


def _is_number(v: Any) -> bool:
    return isinstance(v, numbers.Real) and not isinstance(v, bool)


def _is_count(v: Any) -> bool:
    return isinstance(v, int) and not isinstance(v, bool) and v >= 0


def _check_numeric_map(obj: dict, section: str, problems: list[str]) -> None:
    sec = obj.get(section)
    if not isinstance(sec, dict):
        problems.append(f"{section} is not an object")
        return
    for k, v in sec.items():
        if not isinstance(k, str):
            problems.append(f"{section} key {k!r} is not a string")
        if v is not None and not _is_number(v):
            problems.append(f"{section}[{k!r}] = {v!r} is not numeric")


def validate_line(obj: Any) -> list[str]:
    """The schema violations of one line (empty: valid)."""
    if not isinstance(obj, dict):
        return [f"line is {type(obj).__name__}, not an object"]
    problems = [f"missing required field {k!r}" for k in _REQUIRED if k not in obj]
    if problems:
        return problems
    if obj["schema_version"] != SCHEMA_VERSION:
        problems.append(f"schema_version {obj['schema_version']!r} != {SCHEMA_VERSION}")
    if obj["kind"] not in KINDS:
        problems.append(f"kind {obj['kind']!r} not in {KINDS}")
    for key in ("host", "step"):
        if not _is_count(obj[key]):
            problems.append(f"{key} {obj[key]!r} is not a non-negative int")
    for key in ("time_unix", "session_start_unix"):
        if not _is_number(obj[key]):
            problems.append(f"{key} {obj[key]!r} is not a number")
    for section in ("metrics", "gauges", "derived"):
        _check_numeric_map(obj, section, problems)
    if not isinstance(obj["counters"], dict):
        problems.append("counters is not an object")
    else:
        problems += [f"counters[{k!r}] = {v!r} is not a non-negative int"
                     for k, v in obj["counters"].items() if not _is_count(v)]
    if obj["kind"] == "final" and not isinstance(obj.get("exit_reason"), str):
        problems.append("final line is missing a string exit_reason")
    if obj["kind"] != "final" and "exit_reason" in obj:
        problems.append("exit_reason on a non-final line")
    if "memory" in obj:
        _check_numeric_map(obj, "memory", problems)
    elif obj["kind"] == "memory":
        problems.append("memory line is missing the memory object")
    if obj["kind"] == "compile_warning":
        comp = obj.get("compile")
        if not isinstance(comp, dict):
            problems.append("compile_warning line is missing the compile object")
        else:
            problems += [f"compile[{k!r}] = {comp.get(k)!r} is not a string"
                         for k in ("fn", "delta") if not isinstance(comp.get(k), str)]
            if "count" in comp and not _is_count(comp["count"]):
                problems.append(f"compile['count'] = {comp['count']!r} is not a non-negative int")
            if "wall_secs" in comp and not _is_number(comp["wall_secs"]):
                problems.append(f"compile['wall_secs'] = {comp['wall_secs']!r} is not a number")
    elif "compile" in obj:
        problems.append("compile object on a non-compile_warning line")
    if "profile" in obj:
        prof = obj["profile"]
        if obj["kind"] != "final":
            problems.append("profile object on a non-final line")
        elif not isinstance(prof, dict):
            problems.append("profile is not an object")
        else:
            if not isinstance(prof.get("dir"), str):
                problems.append("profile['dir'] is not a string")
            problems += [f"profile[{k!r}] = {prof.get(k)!r} is not a non-negative int"
                         for k in ("start_step", "num_steps") if not _is_count(prof.get(k))]
    return problems


"""The port's brownout controller and serve fault plan against the JAX
package's (PyTorch/CUDA port): both are host code, so the same inputs
must give the same outputs exactly.

* One seeded sequence of ``update``/``note_ttft`` calls under one fake
  clock gives the same levels, transition events (reasons included),
  ``transitions()``, TTFT p95s, enforcement answers and registry counters
  in both controllers.
* ``parse_serve_spec`` of the reference test's spec strings gives the
  same plans and the same errors; a ``ServeEngine`` armed with one plan
  fires the same faults in the same order.
"""

import numpy as np
import pytest

from tensorflow_examples_tpu.serving import overload as jax_overload
from tensorflow_examples_tpu.telemetry.registry import MetricsRegistry as JaxRegistry
from tensorflow_examples_tpu.utils import faults as jax_faults
from tensorflow_examples_torch.serving import overload
from tensorflow_examples_torch.serving.paged_kv import BlockExhausted
from tensorflow_examples_torch.telemetry.registry import MetricsRegistry
from tensorflow_examples_torch.utils import faults


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def _trace(module, registry, seed, **kw):
    """Drive one controller through a seeded load pattern: bursts that
    fill the queue and KV, TTFT samples, quiet stretches."""
    clock = _Clock()
    ctl = module.OverloadController(registry=registry, clock=clock, **kw)
    rng = np.random.default_rng(seed)
    out = []
    for step in range(400):
        clock.t += float(rng.uniform(0.01, 0.4))
        phase = (step // 60) % 3  # hot, warm, cold
        queue = int(rng.integers(0, 30)) if phase == 0 else int(rng.integers(0, 6)) * (phase == 1)
        kv = float(rng.uniform(0.0, 1.0)) if phase == 0 else float(rng.uniform(0.0, 0.3))
        for _ in range(int(rng.integers(0, 3))):
            ctl.note_ttft(float(rng.exponential(0.4 if phase == 0 else 0.05)))
        level = ctl.update(queue_depth=queue, kv_occupancy=kv)
        out.append((level, ctl.ttft_p95(), ctl.sheds("batch"), ctl.sheds("interactive"),
                    ctl.max_new_cap(), ctl.spec_disabled()))
    return ctl, out


@pytest.mark.parametrize("kw", [
    dict(queue_hi=8, kv_hi=0.9, hold_s=0.5),
    dict(queue_hi=4, kv_hi=0.8, ttft_hi_s=0.3, clear_frac=0.4, hold_s=1.0, max_new_tokens_cap=3),
    dict(queue_hi=16, enabled=False),
])
def test_controller_matches_the_reference_step_for_step(kw):
    ours_reg, theirs_reg = MetricsRegistry(), JaxRegistry()
    ours, a = _trace(overload, ours_reg, 3, **kw)
    theirs, b = _trace(jax_overload, theirs_reg, 3, **kw)
    assert a == b
    assert [e[1:] for e in ours.events] == [e[1:] for e in theirs.events]
    assert ours.transitions() == theirs.transitions()
    if kw.get("enabled", True):
        assert ours.transitions() > 4 and max(r[0] for r in a) >= 2
    assert ours_reg.counter_values() == theirs_reg.counter_values()
    assert ours_reg.gauge_values() == theirs_reg.gauge_values()
    assert (overload.LADDER, overload.MAX_LEVEL) == (jax_overload.LADDER, jax_overload.MAX_LEVEL)


SPECS = ["crash@1:4,slowrep@0:0.25,transport@2:3,kvexhaust@0:7,badhealth@1:2",
         "transport@0:2,badhealth@1:1", "killrouter@3,crash@0:0", "", " crash@2:1 , "]
BAD_SPECS = ["explode@0:1", "crash@3", "crash@a:b", "killrouter@x", "slowrep@0:fast"]


def _error(fn, spec):
    with pytest.raises(ValueError) as e:
        fn(spec)
    return str(e.value)


def test_parse_serve_spec_matches_the_reference():
    for spec in SPECS:
        ours, theirs = faults.parse_serve_spec(spec), jax_faults.parse_serve_spec(spec)
        assert vars(ours) == vars(theirs), spec
    for spec in BAD_SPECS:
        assert _error(faults.parse_serve_spec, spec) == _error(jax_faults.parse_serve_spec, spec)
    assert faults.SERVE_ENV_VAR == jax_faults.SERVE_ENV_VAR
    assert faults.SERVE_KINDS == jax_faults.SERVE_KINDS


def test_serve_engine_fires_what_the_reference_fires():
    spec = "crash@1:2,kvexhaust@0:1,transport@0:2,badhealth@1:1"
    ours, theirs = (faults.ServeEngine(faults.parse_serve_spec(spec)),
                    jax_faults.ServeEngine(jax_faults.parse_serve_spec(spec)))
    killed = []
    faults.register_serve_crash(1, lambda: killed.append("port"))
    jax_faults.register_serve_crash(1, lambda: killed.append("jax"))
    try:
        log = {}
        for name, eng in (("port", ours), ("jax", theirs)):
            seen = []
            for _ in range(3):
                seen += [eng.transport_fault(0), eng.transport_fault(1),
                         eng.health_fault(1), eng.health_fault(0)]
            for replica in (0, 1, 0, 1, 1):
                try:
                    eng.decode_step(replica, [replica, 3])
                    seen.append("ok")
                except Exception as e:  # noqa: BLE001 — the fault is the point
                    seen.append((type(e).__name__, str(e), getattr(e, "slots", None)))
            log[name] = seen
        assert log["port"] == log["jax"]
        assert ("BlockExhausted", "injected KV block exhaustion on replica 0", (0, 3)) \
            in log["port"]
        assert ours.fired == theirs.fired and killed == ["port", "jax"]
    finally:
        faults._serve_crash_cbs.clear()
        jax_faults._serve_crash_cbs.pop(1, None)
    with pytest.raises(BlockExhausted):
        faults.ServeEngine(faults.parse_serve_spec("kvexhaust@4:0")).decode_step(4, [0])


def test_serve_install_and_env_activation(monkeypatch):
    faults.serve_clear()
    try:
        monkeypatch.setenv(faults.SERVE_ENV_VAR, "transport@3:1")
        eng = faults.serve_active()
        assert eng is not None and eng.plan.transport_drop == {3: 1}
        assert faults.serve_active() is eng
        assert faults.serve_install("badhealth@0:1").plan.bad_health == {0: 1}
        faults.serve_clear()
        monkeypatch.delenv(faults.SERVE_ENV_VAR)
        assert faults.serve_active() is None
    finally:
        faults.serve_clear()

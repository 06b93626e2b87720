"""The port's SLO watcher (``tensorflow_examples_torch/slo_watch.py``)
against ``tools/slo_watch.py``.

Both run against the same live port router frontend, whose AlertEngine
holds an interactive e2e objective that fires and a batch one that does
not: healthy, then firing. A third case uses an unreachable URL. The
two print the same stdout (and stderr), line for line, and return the
same exit code (0, 1, 2), with ``--once``, with ``--polls N``, with
``--json`` and ``--series``. The "endpoint gone" rule (a loop that
loses its endpoint after a healthy poll exits with the last poll's
verdict) is held on scripted polls. The clock each poll prints is fixed.
"""

import importlib.util
import os
import time

import pytest

from tensorflow_examples_torch import slo_watch
from tensorflow_examples_torch.serving.router import Router, RouterFrontend
from tensorflow_examples_torch.telemetry.slo import AlertEngine, SLOConfig, SLOObjective

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def reference():
    """``tools/slo_watch.py`` as a module of its own name."""
    spec = importlib.util.spec_from_file_location(
        "tools_slo_watch", os.path.join(REPO, "tools", "slo_watch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def fixed_clock(monkeypatch):
    monkeypatch.setattr(time, "strftime", lambda fmt, *a: "12:34:56")


@pytest.fixture
def router():
    """A port router with no probe loop: a hand-probed fake replica, the
    two objectives, and a point in a default series and in another."""
    router = Router(["http://127.0.0.1:9/"])
    router.replicas[0].probed = True
    router.alerts = AlertEngine(
        SLOConfig(objectives=(SLOObjective(slo="interactive", e2e_p95_s=0.01, error_budget=0.01),
                              SLOObjective(slo="batch", e2e_p95_s=10.0)),
                  pending_for_s=0.0),
        registry=router.registry)
    router.series.record("router/e2e.p95", 0.01)
    router.series.record("serving/ttft.p95", 0.02)
    front = RouterFrontend(router, port=0).start()
    yield router, front
    front.close()
    router.close()


def both(capsys, reference, argv) -> list[tuple[int, str, str]]:
    """(exit code, stdout, stderr) of the port's and the reference's main."""
    out = []
    for mod in (slo_watch, reference):
        rc = mod.main(list(argv))
        captured = capsys.readouterr()
        out.append((rc, captured.out, captured.err))
    return out


ARGVS = (["--once"], ["--polls", "2", "--interval", "0.01"], ["--once", "--json"],
         ["--once", "--series", "ttft"])


@pytest.mark.timeout(120)
@pytest.mark.parametrize("argv", ARGVS, ids=lambda a: " ".join(a))
def test_healthy_then_firing_equal_the_reference(capsys, reference, fixed_clock, router, argv):
    router, front = router
    url = f"http://127.0.0.1:{front.port}"
    router.alerts.observe("batch", e2e_s=0.5)
    router.alerts.evaluate()
    ours, theirs = both(capsys, reference, [url, *argv])
    assert ours == theirs
    assert ours[0] == 0 and "FIRING" not in ours[1]
    for _ in range(5):
        router.alerts.observe("interactive", e2e_s=1.0, trace_id="t-worst")
    router.alerts.evaluate()  # ok -> pending
    router.alerts.evaluate()  # pending -> firing (no dwell)
    ours, theirs = both(capsys, reference, [url, *argv])
    assert ours == theirs
    assert ours[0] == 1
    if "--json" not in argv:
        assert "FIRING e2e_interactive" in ours[1] and "--trace-id t-worst" in ours[1]
        assert "ok      e2e_batch" in ours[1]
        assert ours[1].count("-- 12:34:56") == (2 if "--polls" in argv else 1)
        assert ("serving/ttft.p95" in ours[1]) == ("--series" in argv)


@pytest.mark.timeout(120)
@pytest.mark.parametrize("argv", ARGVS[:2], ids=lambda a: " ".join(a))
def test_unreachable_equals_the_reference(capsys, reference, argv):
    ours, theirs = both(capsys, reference, ["127.0.0.1:9", "--timeout", "2", *argv])
    assert ours == theirs
    assert ours == (2, "", "unreachable: http://127.0.0.1:9\n")


@pytest.mark.timeout(60)
@pytest.mark.parametrize("firing", [0, 1])
def test_endpoint_gone_keeps_the_last_verdict(capsys, reference, fixed_clock, monkeypatch,
                                              firing):
    out = []
    for mod in (slo_watch, reference):
        polls = iter([({"alerts_firing": firing}, {"rollups": {}}), (None, None)])
        monkeypatch.setattr(mod, "fetch", lambda base, timeout: next(polls))
        rc = mod.main(["http://x", "--polls", "5", "--interval", "0"])
        captured = capsys.readouterr()
        out.append((rc, captured.out, captured.err))
    assert out[0] == out[1]
    assert out[0][0] == firing and out[0][2] == "endpoint gone: run ended\n"

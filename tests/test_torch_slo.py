"""The port's serving observability against the reference's, on the CPU:
``obs/prometheus.py`` (the same text for the same registry),
``obs/slo.py`` (the same alert transitions for the same observations and
explicit ``evaluate(now=...)`` ticks), ``obs/http.py``, the postmortem
bundle's ``alerts.json`` and ``obs/collector.py`` (the same timeline from
dumps of both packages). Each scenario runs on both packages; exact
equality throughout (no floats are computed apart)."""

import gc
import json
import os
import threading
import time
import urllib.error
import urllib.request

import pytest

from paddlebox_tpu import flags as ref_flags
from paddlebox_tpu.obs import collector as ref_collector
from paddlebox_tpu.obs import postmortem as ref_postmortem
from paddlebox_tpu.obs import prometheus as ref_prometheus
from paddlebox_tpu.obs import slo as ref_slo
from paddlebox_tpu.obs import trace as ref_trace
from paddlebox_tpu.obs.metrics import MetricsRegistry as RefRegistry
from paddlebox_tpu_torch.ckpt import atomic
from paddlebox_tpu_torch.obs import collector, postmortem, prometheus, slo
from paddlebox_tpu_torch.obs import trace
from paddlebox_tpu_torch.obs.http import ObsHttpServer
from paddlebox_tpu_torch.obs.metrics import MetricsRegistry

PKGS = {"ref": (ref_slo, RefRegistry), "port": (slo, MetricsRegistry)}


@pytest.fixture(autouse=True)
def drop_engines():
    """Engines left alive would show in another file's postmortem
    ``alerts.json``."""
    yield
    gc.collect()


def fill(r):
    r.add("ingest.lines_ok", 12)
    r.gauge("trainer.auc").set(0.73)
    r.gauge("serving.replica.r0.child.serve.predict_ms.p99").set(1.25)
    h = r.histogram("serve.request_ms")
    for v in (1.0, 2.0, 500.0, 0.003, 7.5e4):
        h.observe(v)
    r.histogram("empty.ms")
    r.add("a-b/c", 1)


def test_prometheus_render_matches_reference():
    ref, port = RefRegistry(), MetricsRegistry()
    fill(ref)
    fill(port)
    text = prometheus.render(port)
    assert text == ref_prometheus.render(ref)
    lines = text.splitlines()
    assert "pbx_ingest_lines_ok 12" in lines
    assert "pbx_trainer_auc 0.73" in lines
    assert 'pbx_serve_request_ms_bucket{le="+Inf"} 5' in lines
    assert "pbx_serve_request_ms_count 5" in lines
    cums = [int(ln.rsplit(" ", 1)[1]) for ln in lines
            if ln.startswith("pbx_serve_request_ms_bucket")]
    assert cums == sorted(cums) and text.endswith("\n")
    assert prometheus.sanitize("a.b-c/d") == "pbx_a_b_c_d"
    assert prometheus.CONTENT_TYPE == ref_prometheus.CONTENT_TYPE


# -- the SLO engine: scenarios run on both packages --------------------------

def sc_pending(S, r, eng, log):
    """A metric never written keeps its rule pending."""
    eng.add_rule(S.Rule("ghost", metric="no.such", agg="p99", op=">",
                        threshold=1.0))
    eng.add_rule(S.Rule("ghost2", metric="no.gauge", agg="value", op=">",
                        threshold=1.0))
    for t in (0.0, 1.0, 2.0):
        eng.evaluate(now=t)


def sc_hysteresis(S, r, eng, log):
    """A breach shorter than for_seconds never fires; one held past it
    does."""
    eng.add_rule(S.Rule("g", metric="depth", agg="value", op=">=",
                        threshold=5.0, for_seconds=1.0))
    g = r.gauge("depth")
    for t, v in ((0.0, 9.0), (0.5, 0.0), (1.0, 9.0), (1.5, 9.0),
                 (2.1, 9.0)):
        g.set(v)
        eng.evaluate(now=t)
        log.append(("state", t, eng.alerts()[0]["state"]))


def sc_refire(S, r, eng, log):
    eng.add_rule(S.Rule("g", metric="depth", agg="value", op=">",
                        threshold=1.0))
    g = r.gauge("depth")
    for t, v in ((0.0, 5.0), (1.0, 0.0), (2.0, 5.0), (3.0, 5.0)):
        g.set(v)
        eng.evaluate(now=t)


def sc_window(S, r, eng, log):
    """Quantiles over the window: a past breach does not pin the alert;
    two rules on one histogram share one window."""
    eng.add_rule(S.Rule("p99", metric="lat_ms", agg="p99", op=">",
                        threshold=50.0))
    eng.add_rule(S.Rule("p50", metric="lat_ms", agg="p50", op=">",
                        threshold=50.0))
    eng.add_rule(S.Rule("max", metric="lat_ms", agg="max", op=">",
                        threshold=300.0, min_count=5))
    h = r.histogram("lat_ms")
    eng.evaluate(now=0.0)
    for _ in range(100):
        h.observe(200.0)
    eng.evaluate(now=1.0)
    eng.evaluate(now=2.0)
    for i in range(100):
        h.observe(1.0 + i)
    eng.evaluate(now=3.0)


def sc_rate(S, r, eng, log):
    eng.add_rule(S.Rule("to", metric="timeouts", agg="rate", op=">",
                        threshold=2.0))
    eng.add_rule(S.Rule("hrate", metric="h", agg="rate", op=">",
                        threshold=1.0))
    eng.evaluate(now=0.0)
    r.add("timeouts", 10)
    for _ in range(5):
        r.histogram("h").observe(1.0)
    eng.evaluate(now=2.0)
    eng.evaluate(now=4.0)


def sc_callbacks(S, r, eng, log):
    """A raising callback is isolated; a removed one hears nothing."""
    seen = []
    cb = lambda a, o, n: seen.append(n)  # noqa: E731
    eng.add_callback(lambda a, o, n: 1 / 0)
    eng.add_callback(cb)
    eng.add_rule(S.Rule("g", metric="depth", agg="value", op=">",
                        threshold=1.0, labels={"action": "shed"}))
    r.gauge("depth").set(5.0)
    eng.evaluate(now=0.0)
    eng.remove_callback(cb)
    eng.remove_callback(cb)
    r.gauge("depth").set(0.0)
    eng.evaluate(now=1.0)
    log.append(("seen", tuple(seen)))
    log.append(("errors", r.counter("obs.slo.callback_errors").get()))


def sc_defaults(S, r, eng, log):
    eng.add_rules(S.default_rules(serve_p99_ms=10.0, for_seconds=0.0))
    eng.evaluate(now=0.0)
    for v in (50.0, 60.0):
        r.histogram("serve.request_ms").observe(v)
    r.gauge("serving.quarantined_replicas").set(1.0)
    eng.evaluate(now=1.0)
    log.append(("summary", json.dumps(eng.summary(), sort_keys=True)))


SCENARIOS = {f.__name__[3:]: f for f in (sc_pending, sc_hysteresis,
                                         sc_refire, sc_window, sc_rate,
                                         sc_callbacks, sc_defaults)}


def run_scenario(pkg: str, name: str):
    S, reg_cls = PKGS[pkg]
    r = reg_cls()
    eng = S.SloEngine(registry=r, interval=3600.0)
    log = []
    eng.add_callback(lambda a, o, n: log.append(
        ("transition", a.rule.name, o, n, a.value)))
    SCENARIOS[name](S, r, eng, log)
    log.append(("alerts", json.dumps(eng.alerts(), sort_keys=True)))
    log.append(("gauges", sorted(
        (k, m.get()) for k, m in r.items()
        if k.startswith(("alert.firing.", "obs.slo.")))))
    return log


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_slo_transitions_match_reference(name):
    port = run_scenario("port", name)
    assert port == run_scenario("ref", name)
    assert any(e[0] == "alerts" for e in port)


def test_slo_states_and_validation():
    log = run_scenario("port", "hysteresis")
    assert [e[2] for e in log if e[0] == "state"] == [
        slo.PENDING, slo.PENDING, slo.PENDING, slo.PENDING, slo.FIRING]
    log = run_scenario("port", "refire")
    assert [e[2:4] for e in log if e[0] == "transition"] == [
        (slo.PENDING, slo.FIRING), (slo.FIRING, slo.RESOLVED),
        (slo.PENDING, slo.FIRING)]
    with pytest.raises(ValueError):
        slo.Rule("x", metric="m", op="!!", threshold=1.0)
    with pytest.raises(ValueError):
        slo.Rule("x", metric="m", op=">", threshold=1.0, agg="p42")
    eng = slo.SloEngine(registry=MetricsRegistry(), interval=3600.0)
    eng.add_rule(slo.Rule("x", metric="m", op=">", threshold=1.0))
    with pytest.raises(ValueError):
        eng.add_rule(slo.Rule("x", metric="m", op="<", threshold=1.0))
    assert [r.name for r in slo.default_rules()] == \
        [r.name for r in ref_slo.default_rules()]
    assert [r for r in slo.default_rules()
            if r.labels.get("action") == "shed"][0].metric == \
        "serve.request_ms"


def test_slo_thread_zero_rule_noop_and_restart(tmp_path, monkeypatch):
    """Zero rules start no thread; the first rule starts one evaluator
    (the next reuses it); the evaluator fires unattended into the
    engine's registry, the Prometheus page and the heartbeat; a stopped
    engine restarts."""
    hb = str(tmp_path / "hb.jsonl")
    monkeypatch.setenv("PBOX_FLAGS_obs_heartbeat_path", hb)
    r = MetricsRegistry()
    eng = slo.SloEngine(registry=r, interval=0.02)
    eng.start()
    assert eng._thread is None
    eng.evaluate()
    eng.add_rule(slo.Rule("bg_rule", metric="depth", agg="value", op=">",
                          threshold=1.0))
    th = eng._thread
    assert th is not None
    eng.add_rule(slo.Rule("bg2", metric="y", agg="value", op=">",
                          threshold=1.0))
    assert eng._thread is th
    r.gauge("depth").set(5.0)
    for rnd in range(2):
        deadline = time.monotonic() + 5.0
        while not eng.firing() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert eng.firing()
        eng.stop()
        assert r.gauge("alert.firing.bg_rule").get() == 1.0
        if rnd == 0:
            r.gauge("depth").set(0.0)
            eng.evaluate(now=time.monotonic())
            assert not eng.firing()
            r.gauge("depth").set(5.0)
            eng.start()
    assert "pbx_alert_firing_bg_rule 1" in prometheus.render(r)
    recs = [json.loads(ln) for ln in open(hb)]
    assert [x["state"] for x in recs if x["hb"] == "alert"
            and x["rule"] == "bg_rule"][:2] == [slo.FIRING, slo.RESOLVED]


def test_concurrent_evaluate_keeps_window_state():
    r = MetricsRegistry()
    eng = slo.SloEngine(registry=r, interval=3600.0)
    eng.add_rule(slo.Rule("rate", metric="reqs", agg="rate", op=">",
                          threshold=1e12))
    eng.add_rule(slo.Rule("p99", metric="lat", agg="p99", op=">",
                          threshold=1e12))
    c, h = r.counter("reqs"), r.histogram("lat")
    errors = []
    barrier = threading.Barrier(4)

    def tick(base):
        barrier.wait()
        try:
            for i in range(100):
                c.add(3)
                h.observe(0.01 * (i % 7))
                eng.evaluate(now=base + i)
        except Exception as exc:         # pragma: no cover
            errors.append(exc)

    threads = [threading.Thread(target=tick, args=(1000.0 * n,))
               for n in range(1, 5)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    assert set(eng._prev_scalar) == {"reqs"}
    assert set(eng._prev_hist) == {"lat"}


# -- /metrics and /healthz ---------------------------------------------------

def test_http_metrics_healthz_and_lifecycle():
    r = MetricsRegistry()
    r.add("up.requests", 3)
    r.histogram("up.lat_ms").observe(1.5)
    health = {"ok": True}
    srv = ObsHttpServer(registry=r, health_fn=lambda: (
        health["ok"], {"queue_depth": 0}))
    assert srv.address[1] > 0               # bound at construction
    with srv:
        base = f"http://{srv.host}:{srv.port}"
        rep = urllib.request.urlopen(base + "/metrics", timeout=5)
        assert rep.headers["Content-Type"] == prometheus.CONTENT_TYPE
        assert rep.read().decode() == prometheus.render(r)
        rep = urllib.request.urlopen(base + "/healthz", timeout=5)
        doc = json.loads(rep.read())
        assert rep.status == 200 and doc == {"status": "ok",
                                             "queue_depth": 0}
        health["ok"] = False
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(base + "/healthz", timeout=5)
        assert ei.value.code == 503
        assert json.loads(ei.value.read())["status"] == "unhealthy"
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(base + "/nope", timeout=5)
        assert ei.value.code == 404
    srv.stop()                               # idempotent
    ObsHttpServer().stop()                   # without start
    # a new server binds the port the old one released
    srv2 = ObsHttpServer(port=srv.port)
    try:
        assert srv2.start()[1] == srv.port
        assert urllib.request.urlopen(
            f"http://{srv2.host}:{srv2.port}/healthz",
            timeout=5).status == 200
    finally:
        srv2.stop()


# -- the postmortem bundle's alerts.json -------------------------------------

def test_postmortem_writes_firing_alerts(tmp_path, monkeypatch):
    """``alerts.json`` holds every live engine's alerts, the firing one
    among them, as the reference's bundle does for the same engine."""
    monkeypatch.setenv("PBOX_FLAGS_obs_postmortem_dir", str(tmp_path / "p"))
    old = ref_flags.get("obs_postmortem_dir")
    ref_flags.set("obs_postmortem_dir", str(tmp_path / "r"))
    try:
        engines = []
        for S, reg_cls in (PKGS["port"], PKGS["ref"]):
            r = reg_cls()
            eng = S.SloEngine(registry=r, interval=3600.0)
            eng.add_rule(S.Rule("pm_rule", metric="depth", agg="value",
                                op=">", threshold=1.0,
                                labels={"action": "shed"}))
            r.gauge("depth").set(3.0)
            eng.evaluate(now=5.0)
            engines.append(eng)
        port = postmortem.dump_postmortem("drill", exc=RuntimeError("x"))
        ref = ref_postmortem.dump_postmortem("drill", exc=RuntimeError("x"))
        atomic.verify(port, require_manifest=True)
        got = json.load(open(os.path.join(port, "alerts.json")))
        want = json.load(open(os.path.join(ref, "alerts.json")))
        mine = [a for a in got if a["rule"] == "pm_rule"]
        assert mine == [a for a in want if a["rule"] == "pm_rule"]
        assert mine[0]["state"] == slo.FIRING and mine[0]["value"] == 3.0
    finally:
        ref_flags.set("obs_postmortem_dir", old)


# -- the collector -----------------------------------------------------------

def write_dumps(d: str) -> None:
    """One dump from each package's tracer (the same pid, so the second
    gets a synthetic one), spans of one request's two hops."""
    for mod, hop in ((ref_trace, 0), (trace, 1)):
        tr = mod.Tracer()
        tr.enable(d)
        ctx = mod.TraceContext("feedc0de00000001", f"span{hop}", hop)
        with mod.activate(ctx):
            with tr.span(f"hop{hop}.work", rows=3):
                time.sleep(0.001)
            tr.instant(f"hop{hop}.mark")
        with tr.span("unstamped"):
            pass
        tr.dump(os.path.join(d, f"pbx_trace_{os.getpid()}_{mod.__name__}"
                                f".json"))
        tr.disable()
    with open(os.path.join(d, "pbx_trace_9_torn.json"), "w") as f:
        f.write('{"traceEvents": [')


def test_collector_matches_reference(tmp_path):
    d = str(tmp_path)
    write_dumps(d)
    got, want = collector.collect(d), ref_collector.collect(d)
    assert got["otherData"].pop("tool") == collector.TOOL
    assert want["otherData"].pop("tool") == "paddlebox_tpu.obs.collector"
    assert got == want
    assert got["otherData"]["traces"] == ["feedc0de00000001"]
    pids = {s["effective_pid"] for s in got["otherData"]["sources"]}
    assert len(pids) == 2 and len(got["otherData"]["sources"]) == 2
    flows = [e for e in got["traceEvents"] if e["ph"] in ("s", "f")]
    assert [e["ph"] for e in flows] == ["s", "f"]
    assert flows[0]["pid"] != flows[1]["pid"]
    # the written timeline: either collector skips both outputs
    path, doc = collector.write(d)
    assert path.endswith("pbx_trace_merged.json")
    ref_collector.write(d, os.path.join(d, "pbx_trace_merged_ref.json"))
    again = collector.collect(d)
    again["otherData"].pop("tool")
    assert again == got
    assert collector.main([d, "-o", os.path.join(d, "m.json")]) == 0
    assert collector.main([os.path.join(d, "nowhere")]) == 2

"""Spans of the PyTorch port's gap training and merge stage, and the
tracer's clock anchor.

Under the executor's ``train`` span a kernel-route gap opens
``train.layout``, ``train.upload``, ``train.fit`` and
``train.readback``; under ``merge`` the device backend opens
``merge.fetch``, ``kernel.launch``, ``merge.readback`` and
``merge.finish``.  ``DeviceBackend(device="cpu")`` runs the same code
path with the kernels' plain versions.  ``Tracer.unix_ns`` maps a span
onto ``torch.profiler``'s clock.
"""
import json
import threading

import pytest

torch = pytest.importorskip("torch")

from repro_torch.api import (  # noqa: E402
    DeviceBackend,
    Interval,
    MLegoSession,
    QuerySpec,
)
from repro_torch.configs.lda_default import LDAConfig  # noqa: E402
from repro_torch.data.corpus import make_corpus  # noqa: E402
from repro_torch.obs import trace as obs  # noqa: E402
from repro_torch.obs.trace import Tracer  # noqa: E402

CFG = LDAConfig(n_topics=4, vocab_size=80, eta=0.05, max_iters=4,
                e_step_iters=3, gibbs_sweeps=3)
TRAIN_CHILDREN = {"train.layout", "train.upload", "train.fit",
                  "train.readback"}
MERGE_CHILDREN = {"merge.fetch", "kernel.launch", "merge.readback",
                  "merge.finish"}
DEVICE_MS = ("merge_device_ms", "train_device_ms")


@pytest.fixture(scope="module")
def corpus():
    c, _ = make_corpus(160, CFG.vocab_size, CFG.n_topics, mean_doc_len=20,
                       seed=5)
    return c


def _session(corpus, kind, tracer=None):
    return MLegoSession(corpus, CFG, backend=DeviceBackend(device="cpu"),
                        kind=kind, device="cpu", seed=0, tracer=tracer)


def _capital(sess, edges=(0.0, 40.0, 80.0)):
    """Store one model a leaf, each inside a root span (as the
    benchmark's capital window opens one)."""
    for lo, hi in zip(edges, edges[1:]):
        with sess.tracer.span("capital", "test"):
            sess.train_range(lo, hi)


def _children(spans, parent):
    return [s for s in spans if s.parent_id == parent.span_id]


def _assert_nested(spans, parent, names):
    kids = _children(spans, parent)
    assert names <= {s.name for s in kids}, (parent.name, kids)
    for s in kids:
        assert s.trace_id == parent.trace_id
        assert parent.t0 <= s.t0 <= s.t1 <= parent.t1, s.name
    assert sum(s.duration_s for s in kids) <= parent.duration_s
    return kids


@pytest.mark.parametrize("kind", ["vb", "gs"])
def test_train_range_splits_the_train_span(corpus, kind):
    sess = _session(corpus, kind)
    _capital(sess)
    trains = sess.tracer.spans(name="train")
    assert len(trains) == 2
    spans = sess.tracer.spans()
    for tr in trains:
        kids = _assert_nested(spans, tr, TRAIN_CHILDREN)
        assert all(s.attrs.get("bytes", 1) > 0 for s in kids
                   if s.name in ("train.upload", "train.readback"))
        lay = [s for s in kids if s.name == "train.layout"][0]
        assert lay.attrs["tokens"] == tr.attrs["tokens"]
        assert lay.attrs["docs"] > 0
        fit = [s for s in kids if s.name == "train.fit"][0]
        if kind == "vb":
            assert fit.attrs["iters"] == CFG.max_iters
            # one token upload, one CSR build on the card, one fit
            for name in ("train.upload", "train.layout", "train.fit"):
                assert [s.name for s in kids].count(name) == 1, name
            assert 1 <= lay.attrs["nnz"] <= lay.attrs["tokens"]
            assert lay.attrs["max_row"] >= 1
        else:
            assert fit.attrs["sweeps"] == CFG.gibbs_sweeps
            assert lay.attrs["blocks"] >= 1 and lay.attrs["t_max"] >= 1
    if kind == "gs":
        # the first gap trains against an empty store (no prior to
        # upload); the second uploads the stored model's counts too
        ups = [[s for s in _children(spans, tr) if s.name == "train.upload"]
               for tr in trains]
        assert [len(u) for u in ups] == [1, 2]
        assert ups[1][0].attrs["bytes"] == 4 * CFG.n_topics * CFG.vocab_size


@pytest.mark.parametrize("kind", ["vb", "gs"])
def test_submit_splits_the_merge_span(corpus, kind):
    sess = _session(corpus, kind)
    _capital(sess)
    rep = sess.submit(QuerySpec(sigma=Interval(0.0, 80.0), alpha=1.0))
    spans = sess.tracer.spans(trace_id=rep.trace)
    (merge,) = [s for s in spans if s.name == "merge"]
    kids = _assert_nested(spans, merge, MERGE_CHILDREN)
    fetch = [s for s in kids if s.name == "merge.fetch"][0]
    assert fetch.attrs["n_parts"] == 2 and fetch.attrs["volatile"] == 0
    assert fetch.attrs["stacked_bytes"] == 0
    back = [s for s in kids if s.name == "merge.readback"][0]
    assert back.attrs["bytes"] == 4 * CFG.n_topics * CFG.vocab_size
    assert [s for s in kids if s.name == "merge.finish"][0].attrs["rows"] == 1


def test_submit_many_splits_the_ragged_merge_span(corpus):
    sess = _session(corpus, "vb")
    _capital(sess)
    batch = sess.submit_many([QuerySpec(sigma=Interval(0.0, 80.0), alpha=1.0),
                              QuerySpec(sigma=Interval(0.0, 40.0), alpha=1.0)])
    spans = sess.tracer.spans()
    merges = [s for s in spans if s.name == "merge"
              and s.attrs.get("n_plans") == 2]
    assert len(merges) == 1, batch
    kids = _assert_nested(spans, merges[0], MERGE_CHILDREN)
    fetch = [s for s in kids if s.name == "merge.fetch"][0]
    assert fetch.attrs["n_parts"] == 3
    # the parts are read where the LRU holds them: no stacked copy
    assert fetch.attrs["stacked_bytes"] == 0
    (table,) = [s for s in spans if s.name == "merge.table"
                and s.parent_id == fetch.span_id]
    assert (table.attrs["n_parts"], table.attrs["segments"]) == (3, 2)
    launch = [s for s in kids if s.name == "kernel.launch"][0]
    assert launch.attrs["op"] == "merge_topics_ragged"
    assert launch.attrs["pad_rows"] == 0
    assert [s for s in kids if s.name == "merge.finish"][0].attrs["rows"] == 2


def test_volatile_gap_is_uploaded_again_under_merge_fetch(corpus):
    sess = _session(corpus, "gs")
    _capital(sess)
    rep = sess.submit(QuerySpec(sigma=Interval(20.0, 80.0), alpha=0.0,
                                materialize="volatile"))
    spans = sess.tracer.spans(trace_id=rep.trace)
    (fetch,) = [s for s in spans if s.name == "merge.fetch"]
    assert fetch.attrs["volatile"] >= 1
    ups = [s for s in _children(spans, fetch) if s.name == "device.upload"]
    assert any(s.attrs["model_id"] == -1 for s in ups)
    # the gap was read back from the card right before
    assert [s for s in spans if s.name == "train.readback"]


def test_no_span_carries_a_device_ms_attribute(corpus):
    for kind in ("vb", "gs"):
        sess = _session(corpus, kind)
        _capital(sess)
        sess.submit(QuerySpec(sigma=Interval(10.0, 80.0), alpha=0.0,
                              materialize="volatile"))
        sess.submit_many([QuerySpec(sigma=Interval(0.0, 80.0), alpha=1.0),
                          QuerySpec(sigma=Interval(0.0, 40.0), alpha=1.0)])
        spans = sess.tracer.spans()
        assert {"train", "merge", "kernel.launch"} <= {s.name for s in spans}
        for s in spans:
            assert not set(DEVICE_MS) & set(s.attrs), (s.name, s.attrs)


def test_disabled_tracer_records_nothing(corpus):
    tracer = Tracer(enabled=False)
    sess = _session(corpus, "gs", tracer=tracer)
    _capital(sess)
    rep = sess.submit(QuerySpec(sigma=Interval(20.0, 80.0), alpha=0.0,
                                materialize="volatile"))
    assert rep.n_trained_tokens > 0
    assert len(tracer) == 0 and tracer.spans() == []
    assert obs.current_span() is None
    assert tracer.to_chrome()["traceEvents"] == []


def test_a_span_lands_on_the_profilers_clock():
    """A ``record_function`` opened first thing inside a span starts
    within 1 ms of the span's start on ``unix_ns`` (the closest of five
    probes, so one preempted probe does not decide), and none starts
    more than 1 ms before it."""
    tracer = Tracer()
    acts = [torch.profiler.ProfilerActivity.CPU]
    spans = []
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function("mlego.warm"):
            torch.ones(4).add_(1.0)
        for i in range(5):
            with tracer.span(f"probe{i}", "test") as sp:
                with torch.profiler.record_function(f"mlego.probe{i}"):
                    torch.ones(4).add_(1.0)
            spans.append(sp)
    starts = {e.name(): e.start_ns()
              for e in prof.profiler.kineto_results.events()}
    offsets = [starts[f"mlego.probe{i}"] - tracer.unix_ns(sp.t0)
               for i, sp in enumerate(spans)]
    assert min(abs(d) for d in offsets) < 1_000_000, offsets
    assert min(offsets) > -1_000_000, offsets


def test_unix_ns_follows_the_tracers_clock():
    now = [100.0]
    tracer = Tracer(clock=lambda: now[0])
    base = tracer.unix_ns(100.0)
    assert tracer.unix_ns(100.25) - base == 250_000_000
    assert tracer.unix_ns(99.999) - base == -1_000_000


def test_chrome_export_holds_the_anchor_and_thread_names():
    tracer = Tracer()
    with tracer.span("main.work", "test"):
        pass

    def work():
        with tracer.span("worker.work", "test"):
            pass

    th = threading.Thread(target=work, name="mlego-serve-test-0")
    th.start()
    th.join()
    doc = json.loads(json.dumps(tracer.to_chrome()))
    anchor = doc["otherData"]["clock_anchor"]
    assert anchor["epoch_unix_ns"] == tracer.unix_ns(tracer._epoch)
    assert anchor["unix_ns"] == tracer.unix_ns(anchor["clock_s"])
    assert doc["otherData"]["spans"] == 2
    names = {e["tid"]: e["args"]["name"] for e in doc["traceEvents"]
             if e["ph"] == "M" and e["name"] == "thread_name"}
    tids = {e["tid"] for e in doc["traceEvents"] if e["ph"] == "X"}
    assert tids == set(names) and len(tids) == 2
    assert "mlego-serve-test-0" in names.values()
    assert threading.main_thread().name in names.values()
    # a span's ts, shifted by the anchor, is its Unix time in µs
    ev = [e for e in doc["traceEvents"] if e["name"] == "main.work"][0]
    (sp,) = tracer.spans(name="main.work")
    assert abs(round(ev["ts"] * 1e3) + anchor["epoch_unix_ns"]
               - tracer.unix_ns(sp.t0)) < 10


def test_child_span_helpers_are_noops_without_a_tracer():
    assert obs.current_tracer() is None
    with obs.span("train.layout", "train", tokens=1) as sp:
        obs.set_attrs(docs=1)
    assert sp is None

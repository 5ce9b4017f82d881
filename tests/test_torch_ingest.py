"""Streaming ingest and speculation of the PyTorch port against the JAX
package's.

* a deterministic trainer, registered under one name in both packages,
  makes the slice models independent of either package's random
  numbers: the same batches then give equal ``IngestReport`` counters,
  equal slice intervals and equal thetas (a failing slice build counts
  in ``build_errors`` in both);
* compaction of one store written on disk by the JAX package gives the
  same merged models (1e-5) and evictions;
* with the analytic cost model, the speculator over the same query log
  considers, skips and trains the same gaps;
* the pipeline hands its trainer a generator on its own device, and
  asks for CUDA unless told otherwise.
"""
import dataclasses
import time

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import repro.api as japi  # noqa: E402
import repro.ingest as jingest  # noqa: E402
import repro.serve as jserve  # noqa: E402
from repro.api import trainers as jtrainers  # noqa: E402
from repro.configs.lda_default import LDAConfig as JaxCfg  # noqa: E402
from repro.core.store import ModelStore as JaxStore  # noqa: E402
from repro.data.corpus import make_corpus as jax_make_corpus  # noqa: E402
import repro_torch.api as tapi  # noqa: E402
import repro_torch.ingest as tingest  # noqa: E402
import repro_torch.serve as tserve  # noqa: E402
from repro_torch.api import trainers as ttrainers  # noqa: E402
from repro_torch.configs.lda_default import LDAConfig  # noqa: E402
from repro_torch.core.store import ModelStore  # noqa: E402
from repro_torch.data.corpus import make_corpus  # noqa: E402
from repro_torch.kernels.common import DeviceUnavailableError  # noqa: E402

FIELDS = dict(n_topics=6, vocab_size=150, alpha=0.5, eta=0.05, max_iters=8,
              e_step_iters=5, gibbs_sweeps=6)
CFG = LDAConfig(**FIELDS)
JCFG = JaxCfg(**FIELDS)
TOL = dict(rtol=1e-5, atol=1e-5)
TIMEOUT = 60
BASE_HI = 100.0
DET = "det_vb"
FAIL_LO, FAIL_HI = 120.0, 130.0     # the slice whose build raises
REPORT_COUNTERS = ("batches", "docs", "tokens", "slices_built",
                   "slices_pending", "slices_empty", "build_errors",
                   "frontier", "compactions", "evictions", "store_bytes")


def _det_trainer(seen):
    """Θ from the slice's word counts alone; records what it was handed
    (a JAX key or a torch generator) and fails on one slice."""
    def fit(corpus, cfg, rng):
        seen.append(rng)
        if corpus.n_docs and FAIL_LO <= float(corpus.attr[0]) < FAIL_HI:
            raise RuntimeError("planted slice failure")
        counts = np.bincount(corpus.tokens, minlength=cfg.vocab_size)
        lam = np.outer(np.arange(1.0, cfg.n_topics + 1.0), counts) + cfg.eta
        return {"lam": lam.astype(np.float32)}
    return fit


@pytest.fixture
def det_trainers():
    seen = {"jax": [], "port": []}
    japi.register_trainer(DET, _det_trainer(seen["jax"]), merge="vb")
    tapi.register_trainer(DET, _det_trainer(seen["port"]), merge="vb")
    yield seen
    for tr in (jtrainers, ttrainers):
        tr._TRAINERS.pop(DET, None)
        tr._MERGES.pop(DET, None)


def _corpora(n_docs, seed, lo=0.0, width=BASE_HI):
    """The same documents from both packages, attrs in [lo, lo + width)."""
    out = []
    for mk in (jax_make_corpus, make_corpus):
        c, _ = mk(n_docs, CFG.vocab_size, CFG.n_topics, mean_doc_len=30,
                  attr_max=width, seed=seed)
        out.append(dataclasses.replace(c, attr=c.attr + lo))
    np.testing.assert_array_equal(out[0].tokens, out[1].tokens)
    return out


def _models(store):
    return sorted(store.models(), key=lambda m: m.model_id)


def _run_pipeline(ingest, store, base, batches, **kw):
    per = CFG.n_topics * CFG.vocab_size * 4
    comp = ingest.Compactor(store, JCFG if ingest is jingest else CFG,
                            ingest.CompactionPolicy(max_bytes=3 * per,
                                                    merge_width=2,
                                                    min_retained=1),
                            kind=DET)
    pipe = ingest.IngestPipeline(base, store, JCFG if ingest is jingest
                                 else CFG, slice_width=10.0, kind=DET,
                                 compactor=comp, seed=0, **kw)
    try:
        for b in batches:
            pipe.append(b)
        assert pipe.flush(timeout=TIMEOUT)
    finally:
        pipe.close()
    return pipe.report()


def test_same_batches_give_equal_reports_slices_and_thetas(det_trainers):
    jbase, tbase = _corpora(200, 3)
    jb1, tb1 = _corpora(120, 7, lo=BASE_HI, width=50.0)
    jb2, tb2 = _corpora(60, 8, lo=BASE_HI + 50.0, width=25.0)
    jstore, tstore = JaxStore(), ModelStore()
    want = _run_pipeline(jingest, jstore, jbase, [jb1, jb2])
    got = _run_pipeline(tingest, tstore, tbase, [tb1, tb2], device="cpu")
    assert {k: getattr(got, k) for k in REPORT_COUNTERS} == \
        {k: getattr(want, k) for k in REPORT_COUNTERS}
    assert got.build_errors == 1 and got.compactions > 0
    assert got.slices_built == 7, "[100, 175) in slices of 10, one failed"
    jm, tm = _models(jstore), _models(tstore)
    assert [(m.model_id, m.o.lo, m.o.hi, m.n_docs, m.n_tokens, m.kind)
            for m in tm] == \
        [(m.model_id, m.o.lo, m.o.hi, m.n_docs, m.n_tokens, m.kind)
         for m in jm]
    for a, b in zip(tm, jm):
        if a.o.hi - a.o.lo == 10.0:       # a slice as the builder made it
            np.testing.assert_array_equal(a.theta["lam"], b.theta["lam"])
        else:                              # a compacted run of slices
            np.testing.assert_allclose(a.theta["lam"], b.theta["lam"], **TOL)
    assert all(isinstance(g, torch.Generator) and g.device.type == "cpu"
               for g in det_trainers["port"])
    assert len(det_trainers["port"]) == len(det_trainers["jax"]) == 8


def test_compaction_of_one_store_on_disk_matches(tmp_path):
    rng = np.random.default_rng(4)
    src = JaxStore()
    for i in range(7):
        src.add(japi.Interval(25.0 * i, 25.0 * (i + 1)), 10, 100, "vb",
                {"lam": rng.gamma(1.0, 1.0, (6, 150)).astype(np.float32)})
    src.add(japi.Interval(500.0, 525.0), 10, 100, "vb",
            {"lam": rng.gamma(1.0, 1.0, (6, 150)).astype(np.float32)})
    src.save(str(tmp_path))
    per = 6 * 150 * 4
    reps, stores = [], []
    for store_cls, ingest, cfg in ((JaxStore, jingest, JCFG),
                                   (ModelStore, tingest, CFG)):
        store = store_cls.load(str(tmp_path))
        store.get(6)                        # one hot model, the rest cold
        comp = ingest.Compactor(store, cfg, ingest.CompactionPolicy(
            max_bytes=2 * per, merge_width=3, min_retained=1), kind="vb")
        reps.append(comp.run())
        stores.append(store)
    want, got = reps
    assert (got.compacted, got.compacted_into, got.evicted,
            got.bytes_before, got.bytes_after) == \
        (want.compacted, want.compacted_into, want.evicted,
         want.bytes_before, want.bytes_after)
    assert got.compacted and got.evicted
    jm, tm = _models(stores[0]), _models(stores[1])
    assert [(m.model_id, m.o.lo, m.o.hi, m.n_docs, m.n_tokens)
            for m in tm] == \
        [(m.model_id, m.o.lo, m.o.hi, m.n_docs, m.n_tokens) for m in jm]
    for a, b in zip(tm, jm):
        np.testing.assert_allclose(a.theta["lam"], b.theta["lam"], **TOL)


def _speculate(serve, cfg, corpus, store, **kw):
    """Two hot ranges written into the query log: [0, 300) with a
    ~100-document gap and [0, 110) with a ~10-document gap.  The margin
    puts the payoff threshold between the two, far from either."""
    with serve.MLegoService(corpus, cfg, store=store, window_s=0.0,
                            seed=0, **kw) as svc:
        now = time.monotonic()
        for sigma in (((0.0, 300.0),), ((0.0, 110.0),)):
            for t in (now - 1000.0, now - 1.0):
                svc._query_log.append(serve.QueryLogEntry(
                    tenant="ana", sigma=sigma, kind="vb", alpha=1.0,
                    backend=None, t=t))
        cost = svc.cost
        big, small = 100 * 30, 10 * 30       # gap tokens, roughly
        margin = 999.0 / cost.predict_train_seconds((big * small) ** 0.5)
        trainer = svc.attach_speculator(min_count=2, window_s=1e4,
                                        margin=margin, start=False)
        trained = trainer.scan_once()
        rep = trainer.report()
        spans = sorted((svc.store.get(i).o.lo, svc.store.get(i).o.hi)
                       for i in trainer.trained_ids)
    return trained, rep, spans


def test_speculator_considers_and_skips_the_same_gaps(tmp_path):
    rng = np.random.default_rng(9)
    src = JaxStore()
    for lo, hi in ((0.0, 100.0), (200.0, 300.0)):
        src.add(japi.Interval(lo, hi), 100, 3000, "vb",
                {"lam": rng.gamma(1.0, 1.0, (6, 150)).astype(np.float32)})
    src.save(str(tmp_path))
    jc, tc = _corpora(300, 3, width=300.0)
    want = _speculate(jserve, JCFG, jc, JaxStore.load(str(tmp_path)))
    got = _speculate(tserve, CFG, tc, ModelStore.load(str(tmp_path)),
                     device="cpu")
    assert got[0] == want[0] == 1
    assert dataclasses.asdict(got[1]) == dataclasses.asdict(want[1])
    assert (got[1].gaps_considered, got[1].skipped_payoff) == (2, 1)
    assert got[2] == want[2] == [(100.0, 110.0)]


def test_pipeline_trains_slices_with_generators_on_its_device(det_trainers):
    _, base = _corpora(200, 3)
    _, batch = _corpora(40, 7, lo=BASE_HI, width=20.0)
    pipe = tingest.IngestPipeline(base, ModelStore(), CFG, slice_width=10.0,
                                  kind=DET, device="cpu")
    try:
        assert pipe.device == torch.device("cpu")
        pipe.append(batch)
    finally:
        pipe.close()
    assert pipe.report().slices_built == 2
    assert [g.device for g in det_trainers["port"]] == \
        [torch.device("cpu")] * 2
    backend = tapi.DeviceBackend(device="cpu")
    lent = tingest.IngestPipeline(base, ModelStore(), CFG, slice_width=10.0,
                                  backend=backend)
    lent.close()
    assert lent.device == backend.device


def test_pipeline_asks_for_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    _, base = _corpora(50, 3)
    with pytest.raises(DeviceUnavailableError):
        tingest.IngestPipeline(base, ModelStore(), CFG, slice_width=10.0)


def test_service_ingest_builds_slices_the_session_then_reuses():
    _, base = _corpora(200, 3)
    _, batch = _corpora(120, 7, lo=BASE_HI, width=50.0)
    with tserve.MLegoService(base, CFG, backend="device", device="cpu",
                             window_s=0.0) as svc:
        pipe = svc.attach_ingest(slice_width=25.0)
        assert pipe.device == torch.device("cpu")
        svc.ingest(batch)
        assert pipe.flush(timeout=TIMEOUT)
        rep = svc.submit(tapi.QuerySpec(
            sigma=tapi.Interval(BASE_HI, BASE_HI + 25.0)),
            tenant="ana").result(timeout=TIMEOUT)
        assert rep.n_trained_tokens == 0 and rep.model_ids
        assert svc.backend.stats.gap_device_trains == 1, \
            "the slice trained through the device backend's kernel route"
    assert svc.report().ingest.slices_built == 2
    assert svc.report().ingest.build_errors == 0

"""On-disk ``ModelStore`` compatibility between the JAX package and the
PyTorch port: each loads what the other saves (npz blobs plus a JSON
manifest with a sha256 per blob), and ``models_from_numpy`` carries the
JAX package's in-memory models across."""
import json
import os

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.core.plans import Interval as JaxInterval  # noqa: E402
from repro.core.store import ModelStore as JaxStore  # noqa: E402
from repro_torch.core.errors import CorruptModelError  # noqa: E402
from repro_torch.core.plans import Interval  # noqa: E402
from repro_torch.core.store import ModelStore, models_from_numpy  # noqa: E402

RNG = np.random.default_rng(5)


def _theta(kind):
    key = "lam" if kind == "vb" else "delta_nkv"
    return {key: RNG.gamma(1.0, 1.0, (4, 30)).astype(np.float32)}


def _fill(store, interval_cls):
    for i, kind in enumerate(["vb", "vb", "gs"]):
        store.add(interval_cls(10.0 * i, 10.0 * i + 7.5), 5 + i, 50 + i,
                  kind, _theta(kind))
    return store


def _same(models_a, models_b):
    a = sorted(models_a, key=lambda m: m.model_id)
    b = sorted(models_b, key=lambda m: m.model_id)
    assert [(m.model_id, m.o.lo, m.o.hi, m.n_docs, m.n_tokens, m.kind)
            for m in a] == \
        [(m.model_id, m.o.lo, m.o.hi, m.n_docs, m.n_tokens, m.kind)
         for m in b]
    for x, y in zip(a, b):
        assert sorted(x.theta) == sorted(y.theta)
        for k in x.theta:
            np.testing.assert_array_equal(x.theta[k], y.theta[k])


def test_port_loads_a_store_the_jax_package_saved(tmp_path):
    src = _fill(JaxStore(), JaxInterval)
    src.remove(1)
    src.save(str(tmp_path))
    got = ModelStore.load(str(tmp_path))
    _same(src.models(), got.models())
    assert got._next_id == src._next_id
    # the next model the port adds does not reuse a saved id
    assert got.add(Interval(50.0, 60.0), 1, 1, "vb",
                   _theta("vb")).model_id == 3


def test_jax_package_loads_a_store_the_port_saved(tmp_path):
    src = _fill(ModelStore(), Interval)
    src.save(str(tmp_path))
    got = JaxStore.load(str(tmp_path))
    _same(src.models(), got.models())


@pytest.mark.parametrize("first", ["jax", "port"])
def test_manifest_and_blobs_are_byte_compatible(tmp_path, first):
    """Saving the same models from either package writes the same
    manifest fields and the same blob checksums."""
    theta = [_theta("vb") for _ in range(2)]
    stores = {"jax": (JaxStore(), JaxInterval),
              "port": (ModelStore(), Interval)}
    for name, (store, iv) in stores.items():
        for i, th in enumerate(theta):
            store.add(iv(i, i + 1.0), 3, 30, "vb", th)
        store.save(str(tmp_path / name))
    mf = {name: json.load(open(tmp_path / name / "manifest.json"))
          for name in stores}
    assert mf["jax"] == mf["port"]
    for e in mf[first]["models"]:
        assert os.path.exists(tmp_path / "jax" / e["file"])


def test_port_quarantines_a_corrupt_jax_blob(tmp_path):
    src = _fill(JaxStore(), JaxInterval)
    src.save(str(tmp_path))
    with open(tmp_path / "model_0.npz", "r+b") as f:
        f.seek(40)
        f.write(b"\x00garbage\x00")
    with pytest.raises(CorruptModelError):
        ModelStore.load(str(tmp_path))
    got = ModelStore.load(str(tmp_path), on_corrupt="quarantine")
    assert [q.model_id for q in got.quarantined] == [0]
    assert sorted(m.model_id for m in got.models()) == [1, 2]


def test_models_from_numpy_carries_jax_models(tmp_path):
    src = _fill(JaxStore(), JaxInterval)
    got = models_from_numpy(src.models())
    _same(src.models(), got)
    assert all(isinstance(m.o, Interval) for m in got)
    assert all(isinstance(v, np.ndarray) and v.dtype == np.float32
               for m in got for v in m.theta.values())
    # records may also be plain mappings
    rec = {"model_id": 9, "o": Interval(1.0, 2.0), "n_docs": 1,
           "n_tokens": 2, "kind": "vb", "theta": {"lam": [[1.0, 2.0]]}}
    (m,) = models_from_numpy([rec])
    assert m.model_id == 9 and m.lam.shape == (1, 2)

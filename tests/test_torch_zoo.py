"""The port's model zoo against the JAX package's: round trips, the
source-indexed reopen through ``compile_model`` (0 stages compiled), LRU
and byte bounds, sidecar robustness and corruption — the reference's
``tests/test_zoo.py`` on ``repro_torch`` — and zoo directories written by
one package opened by the other under the same keys."""
import os
import threading

import numpy as np
import pytest

from torch_common import port_model, reference_model


@pytest.fixture(scope="module")
def toy():
    g, qm, _ = port_model("toy", 16)
    return g, qm


@pytest.fixture(scope="module")
def toy_artifacts(toy):
    """Three distinct artifacts of the same net (different strategies)."""
    from repro_torch import asm
    from repro_torch.core import pathsearch
    from repro_torch.hw import ZU2

    g, qm = toy
    return g, qm, [asm.compile_strategy(g, s, ZU2, qm=qm)
                   for s in (pathsearch.search(g, ZU2),
                             pathsearch.greedy(g, ZU2),
                             pathsearch.naive(g, ZU2))]


def _stage_misses(reg):
    return {st: reg.get(f"stages.{st}.misses")
            for st in ("lowered", "planned", "compiled")}


def test_put_get_open_round_trip(toy_artifacts, tmp_path):
    from repro_torch import asm
    from repro_torch.zoo import ModelZoo

    g, qm, (art, *_) = toy_artifacts
    zoo = ModelZoo(str(tmp_path / "zoo"))
    key = zoo.put(art, name="toy")
    assert zoo.key_for(art) == key
    art2 = zoo.get(key)
    assert asm.strategy_signature(art2) == asm.strategy_signature(art)
    assert art2.instrs == art.instrs
    co = zoo.open(key)
    assert co.key == key
    [rec] = zoo.list()
    assert rec["name"] == "toy" and rec["key"] == key
    assert rec["size_bytes"] == os.path.getsize(
        os.path.join(zoo.root, key + ".npz"))
    assert zoo.put(art) == key and len(zoo) == 1


def test_compile_model_reopens_from_zoo_without_compiling(toy, tmp_path):
    from repro_torch.hw import ZU2
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.stages import StageCache, compile_model
    from repro_torch.zoo import ModelZoo

    g, qm = toy
    zoo = ModelZoo(str(tmp_path / "zoo"))
    co1 = compile_model(g, qm, ZU2, zoo=zoo, name="toy",
                        cache=StageCache(registry=MetricsRegistry()))
    assert len(zoo) == 1
    reg = MetricsRegistry()
    co2 = compile_model(g, qm, ZU2, zoo=zoo, cache=StageCache(registry=reg))
    assert co2.key == co1.key and co2.stage_keys == co1.stage_keys
    assert _stage_misses(reg) == {"lowered": None, "planned": None,
                                  "compiled": None}
    x = np.random.default_rng(2).integers(-128, 127, g.shape("data"),
                                          np.int8)
    got = co2.session(device="cpu").run(x)
    want = co1.session(device="cpu").run(x)
    for k in want:
        assert bool((got[k] == want[k]).all())


def test_zoo_lru_eviction_and_counters(toy_artifacts, tmp_path):
    from repro_torch.obs.metrics import REGISTRY
    from repro_torch.zoo import ModelZoo

    g, qm, arts = toy_artifacts
    zoo = ModelZoo(str(tmp_path / "zoo"), max_entries=2)
    keys = [zoo.put(a) for a in arts[:2]]
    zoo.get(keys[0])                     # refresh: keys[1] becomes LRU
    before = (REGISTRY.get("zoo.evictions").value
              if REGISTRY.get("zoo.evictions") else 0.0)
    k3 = zoo.put(arts[2])
    assert len(zoo) == 2
    assert zoo.get(keys[1]) is None
    assert zoo.get(keys[0]) is not None and zoo.get(k3) is not None
    assert REGISTRY.get("zoo.evictions").value == before + 1


def test_zoo_max_bytes_bound(toy_artifacts, tmp_path):
    from repro_torch.zoo import ModelZoo

    g, qm, arts = toy_artifacts
    zoo = ModelZoo(str(tmp_path / "zoo"))
    k1 = zoo.put(arts[0])
    size = zoo.list()[0]["size_bytes"]
    zoo.max_bytes = size + size // 2
    zoo.put(arts[1])
    assert len(zoo) == 1 and zoo.get(k1) is None


def test_zoo_tolerates_corrupt_sidecar(toy_artifacts, tmp_path):
    from repro_torch.zoo import ModelZoo

    g, qm, (art, *_) = toy_artifacts
    zoo = ModelZoo(str(tmp_path / "zoo"))
    key = zoo.put(art)
    with open(os.path.join(zoo.root, key + ".json"), "w") as f:
        f.write("{not json")
    assert zoo.list() == []
    assert zoo.get(key) is not None


# ------------------------------------------------------------ corruption
def test_zoo_get_corrupt_npz_raises_artifact_error_with_key(toy_artifacts,
                                                            tmp_path):
    from repro_torch import asm
    from repro_torch.zoo import ModelZoo

    g, qm, (art, *_) = toy_artifacts
    zoo = ModelZoo(str(tmp_path / "zoo"))
    key = zoo.put(art)
    with open(os.path.join(zoo.root, key + ".npz"), "wb") as f:
        f.write(b"\x00" * 64)
    with pytest.raises(asm.ArtifactError, match=key[:16]):
        zoo.get(key)
    assert zoo.remove(key)
    assert zoo.get(key) is None


def test_zoo_get_tampered_sidecar_key_raises_artifact_error(toy_artifacts,
                                                            tmp_path):
    import json

    from repro_torch import asm
    from repro_torch.zoo import ModelZoo

    g, qm, (art, *_) = toy_artifacts
    zoo = ModelZoo(str(tmp_path / "zoo"))
    key = zoo.put(art)
    side = os.path.join(zoo.root, key + ".json")
    with open(side) as f:
        rec = json.load(f)
    rec["key"] = "someone-elses-key"
    with open(side, "w") as f:
        json.dump(rec, f)
    with pytest.raises(asm.ArtifactError, match="tampered"):
        zoo.get(key)


@pytest.mark.parametrize("writer", ["repro", "repro_torch"])
def test_corrupt_entries_raise_alike_in_both_packages(toy_artifacts,
                                                      tmp_path, writer):
    """An entry truncated on disk raises ``ArtifactError`` naming the entry
    in both packages, whichever wrote it."""
    import importlib

    from repro import asm as ref_asm
    from repro.zoo import ModelZoo as RefZoo
    from repro_torch import asm
    from repro_torch.zoo import ModelZoo

    g, qm, (art, *_) = toy_artifacts
    root = str(tmp_path / "zoo")
    zoo_cls = importlib.import_module(f"{writer}.zoo").ModelZoo
    if writer == "repro":
        path = str(tmp_path / "a.npz")
        asm.save_artifact(art, path)
        art = ref_asm.load_artifact(path)
    key = zoo_cls(root).put(art)
    npz = os.path.join(root, key + ".npz")
    with open(npz, "rb") as f:
        blob = f.read()
    with open(npz, "wb") as f:
        f.write(blob[:len(blob) // 2])
    with pytest.raises(ref_asm.ArtifactError, match=key[:16]):
        RefZoo(root).get(key)
    with pytest.raises(asm.ArtifactError, match=key[:16]):
        ModelZoo(root).get(key)


# ----------------------------------------------------- across the packages
@pytest.mark.parametrize("writer,reader", [("repro", "repro_torch"),
                                           ("repro_torch", "repro")])
def test_zoo_directory_crosses_packages(tmp_path, writer, reader):
    """``compile_model(zoo=...)`` in one package shelves the toy model; the
    other package's zoo lists it under the same key and source fingerprint,
    and its ``compile_model`` reopens it with 0 stages compiled, bit-equal
    to the writer's session."""
    import importlib

    g_ref, _, _, qm_ref, xq = reference_model("toy", 16)
    g_port, qm_port, _ = port_model("toy", 16)
    built = {"repro": (g_ref, qm_ref), "repro_torch": (g_port, qm_port)}
    mods = {pkg: (importlib.import_module(f"{pkg}.stages"),
                  importlib.import_module(f"{pkg}.zoo"),
                  importlib.import_module(f"{pkg}.obs.metrics"),
                  importlib.import_module(f"{pkg}.hw").ZU2)
            for pkg in ("repro", "repro_torch")}
    root = str(tmp_path / "zoo")

    stages_w, zoo_w, metrics_w, zu2_w = mods[writer]
    g, qm = built[writer]
    co_w = stages_w.compile_model(
        g, qm, zu2_w, zoo=zoo_w.ModelZoo(root), name="toy",
        cache=stages_w.StageCache(registry=metrics_w.MetricsRegistry()))

    stages_r, zoo_r, metrics_r, zu2_r = mods[reader]
    zoo = zoo_r.ModelZoo(root)
    [rec] = zoo.list()
    assert rec["key"] == co_w.key and rec["name"] == "toy"
    assert zoo.open(co_w.key).key == co_w.key
    reg = metrics_r.MetricsRegistry()
    g, qm = built[reader]
    co_r = stages_r.compile_model(g, qm, zu2_r, zoo=zoo,
                                  cache=stages_r.StageCache(registry=reg))
    assert co_r.key == co_w.key and co_r.stage_keys == co_w.stage_keys
    assert _stage_misses(reg) == {"lowered": None, "planned": None,
                                  "compiled": None}
    ref_co, port_co = ((co_w, co_r) if writer == "repro" else (co_r, co_w))
    want = ref_co.session().run(xq)
    got = port_co.session(device="cpu").run(xq)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k])


def test_zoo_concurrent_writers_keep_index_consistent(toy_artifacts,
                                                      tmp_path):
    from repro_torch.zoo import ModelZoo

    g, qm, arts = toy_artifacts
    zoo = ModelZoo(str(tmp_path / "zoo"), max_entries=2)
    errs = []

    def writer(art, n=6):
        try:
            for _ in range(n):
                key = zoo.put(art, name="hammer")
                zoo.get(key)
                zoo.evict()
        except Exception as e:           # pragma: no cover - failure path
            errs.append(e)

    threads = [threading.Thread(target=writer, args=(a,)) for a in arts
               for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert errs == []
    recs = zoo.list()
    assert len(recs) <= 2
    for rec in recs:
        art = zoo.get(rec["key"])
        assert art is None or art.graph_sig == arts[0].graph_sig

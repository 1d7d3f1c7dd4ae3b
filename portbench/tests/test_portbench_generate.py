"""The traffic generator: deterministic per seed, and the mix and catalog
as the configurations state them."""

import hashlib
import json
from collections import Counter

import pytest

import generate
import harness


def small(name, count=700):
    cell = harness.load_cell(name)
    cell["config"]["pods"]["count"] = count
    spec = cell["config"]["catalog"]
    cell["config"]["catalog"] = generate.module("catalogs", spec["kind"]).small(spec)
    return cell


def test_same_seed_same_rounds_other_seed_other_rounds():
    cell = small("mix7-10k-fresh")
    a = generate.traffic(cell["config"], cell["traffic"], 2**33 + 5)
    b = generate.traffic(cell["config"], cell["traffic"], 2**33 + 5)
    c = generate.traffic(cell["config"], cell["traffic"], 2**33 + 6)
    assert a.records == b.records
    assert a.records != c.records
    assert [a.next() for _ in range(3)] == [b.next() for _ in range(3)]


def test_fresh_rounds_differ_and_keep_the_mix_at_each_position():
    cell = small("mix7-10k-fresh")
    t = generate.traffic(cell["config"], cell["traffic"], 7)
    n, batches = 700, generate.POOL_BATCHES
    assert len(t.records) == n * batches
    rounds = [t.next() for _ in range(6)]
    assert len({tuple(r) for r in rounds}) == 6
    for ids in rounds:
        assert [i % n for i in ids] == list(range(n))
        assert {i // n for i in ids} == set(range(batches))
        kinds = [t.records[i]["kind"] for i in ids]
        assert kinds == [r["kind"] for r in t.records[:n]]


def test_mix7_has_a_seventh_of_each_kind():
    recs = generate.mix7(10000, generate.stream(1, "x"))
    kinds = Counter(r["kind"] for r in recs)
    assert kinds["generic"] == 1428 + 4
    assert all(kinds[k] == 1428 for k in generate.MIX7_KINDS[1:])
    assert {r["cpu_m"] for r in recs} <= set(generate.CPU_M)
    assert {r["mem_mi"] for r in recs} <= set(generate.MEM_MI)
    assert all(r["sel"] == r["labels"]["my-label"] for r in recs if "spread" in r["kind"])


def test_catalog_as_the_upstream_fake():
    linear = generate.catalog({"kind": "linear", "types": 400})
    assert linear[0]["res"] == (1000, 2 * generate.GI, 10)
    assert linear[399]["res"] == (400000, 800 * generate.GI, 4000)
    prices = [t["price"] for t in linear]
    assert prices == sorted(prices)
    json.dumps([dict(t, os=sorted(t["os"])) for t in linear])  # plain data


def digest(obj) -> str:
    return hashlib.sha256(json.dumps(obj, sort_keys=True, default=sorted).encode()).hexdigest()


# sha256 of the records as generated before the catalog and the mix moved to
# catalogs/linear.py and mixes/mix7.py (sets as sorted lists, keys sorted)
FRESH_DIGESTS = {
    1: "859f20e492d4e84d122f948c590c6add44f4b0601a79aa9b2fd49d35604675b3",
    2**40 + 3: "88403bd878d17e8d2a0dff655e3d593b6db63ac0ccca54208d9ea13a50565f4f",
}
CATALOG_DIGEST = "5eb851dfa5924308a2192d6cf327c50c181f1dd4636b5771eda0d59013bbd91f"


@pytest.mark.parametrize("seed", sorted(FRESH_DIGESTS))
def test_the_fresh_records_at_full_size_are_as_before(seed):
    cell = harness.load_cell("mix7-10k-fresh")
    t = generate.traffic(cell["config"], cell["traffic"], seed)
    assert len(t.records) == 10000 * generate.POOL_BATCHES
    assert digest(t.records) == FRESH_DIGESTS[seed]


def test_the_400_type_catalog_is_as_before():
    cell = harness.load_cell("mix7-10k-fresh")
    assert cell["config"]["catalog"] == {"kind": "linear", "types": 400}
    assert digest(generate.catalog(cell["config"]["catalog"])) == CATALOG_DIGEST


@pytest.mark.parametrize("kind,call", [
    ("catalogs", lambda: generate.catalog({"kind": "no-such-catalog"})),
    ("mixes", lambda: generate.pods({"pods": {"mix": "no-such-mix"}}, 7, generate.stream(1, "x"))),
], ids=["catalog", "mix"])
def test_an_unknown_catalog_or_mix_names_the_path_it_looked_for(kind, call):
    with pytest.raises(ValueError, match=f"{generate.HERE / kind}/no-such-"):
        call()


def test_a_file_on_the_search_path_comes_before_the_builtin(tmp_path, monkeypatch):
    (tmp_path / "mixes").mkdir()
    (tmp_path / "mixes" / "mix7.py").write_text("def records(count, rng):\n    return [None] * count\n")
    monkeypatch.setattr(generate, "SEARCH", [tmp_path, *generate.SEARCH])
    assert generate.pods({"pods": {"mix": "mix7"}}, 3, generate.stream(1, "x")) == [None] * 3
    monkeypatch.undo()
    assert generate.pods({"pods": {"mix": "mix7"}}, 3, generate.stream(1, "x"))[0]["kind"] == "generic"

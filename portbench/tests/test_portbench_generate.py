"""The traffic generator: deterministic per seed, and the mix and catalog
as the configurations state them."""

import json
from collections import Counter

import generate
import harness


def small(name, count=700, types=50):
    cell = harness.load_cell(name)
    cell["config"]["pods"]["count"] = count
    cell["config"]["catalog"]["types"] = types
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

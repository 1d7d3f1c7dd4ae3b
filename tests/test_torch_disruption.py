"""The port's disruption budget against the JAX package's.

The reference's ``tests/test_disruption_budget.py`` cases run on both
packages and each result is compared between them: the budget grammar,
the PDB-style percent resolution, the cross-wave ledger, the
interruption-risk tracker, the plan-time PDB screen, and the evict-mode
consolidation controller honoring the budget per wave and across
concurrently settling waves (both packages' controllers on the FFD
solver; the port's on ``device="cpu"``). The ``Options`` flag case waits
for the port's ``options.py``.
"""

import pytest

from torch_parity import PACKAGES, deprov, fleet, fresh_router, on_cpu  # noqa: F401


def both(fn):
    """``fn(M)`` on each package; the port's result, once it equals the
    reference's."""
    ref, out = (fn(deprov(pkg)) for pkg in PACKAGES)
    assert out == ref
    return out


def outcome(fn):
    """What ``fn`` returns, or the type of what it raises."""
    try:
        return fn()
    except Exception as e:  # the comparison is of the exception's type
        return type(e).__name__


@pytest.mark.parametrize("spec,want", [
    ("3", "3"), ("20%", "20%"), (" 20% ", "20%"), ("007", "7"), (None, None), ("", None),
    ("   ", None), ("0", "0"), ("0%", "0%"), ("abc", "ValueError"), ("-1", "ValueError"),
    ("-5%", "ValueError"), ("150%", "ValueError"), ("1.5", "ValueError"), ("3%%", "ValueError"),
])
def test_parse_budget(spec, want):
    assert both(lambda M: outcome(lambda: M.dis.parse_budget(spec))) == want


@pytest.mark.parametrize("spec,total,want", [
    ("3", 10, 3), ("3", 2, 3), ("20%", 10, 2), ("25%", 10, 3), ("50%", 3, 2), ("1%", 3, 1),
    ("10%", 1, 1), ("0", 10, 0), ("0%", 10, 0), ("20%", 0, 0), (None, 10, None),
])
def test_resolve_budget(spec, total, want):
    assert both(lambda M: M.dis.resolve_budget(spec, total)) == want


# each step: (provisioner, "reserve" names allowed | "release" names), and
# what reserve admitted / in_flight after it
LEDGER_STEPS = {
    "prefix": [("p", ["a", "b", "c", "d"], 2)],
    "shared account": [("p", ["a", "b"], 3), ("p", ["c", "d"], 3), ("q", ["x", "y"], 3)],
    "held twice": [("p", ["a"], 2), ("p", ["a", "b"], 2)],
    "release": [("p", ["a", "b"], 2), ("p", ["c"], 2), ("p", ["a"], None), ("p", ["c"], 2),
                ("p", ["b", "c"], None)],
    "release unknown": [("p", ["never-reserved"], None)],
    "zero": [("p", ["a"], 0)],
}


@pytest.mark.parametrize("case", sorted(LEDGER_STEPS))
def test_budget_ledger(case):
    def run(M):
        ledger, out = M.dis.BudgetLedger(), []
        for prov, names, allowed in LEDGER_STEPS[case]:
            if allowed is None:
                ledger.release(prov, names)
                out.append(None)
            else:
                out.append(ledger.reserve(prov, names, allowed))
            out.append((ledger.in_flight("p"), ledger.in_flight("q")))
        return out

    got = both(run)
    if case == "shared account":
        assert got[2] == ["c"] and got[-1] == (3, 2)


def test_risk_tracker_equals_the_reference():
    def run(M):
        t = M.dis.InterruptionRiskTracker()
        out = [t.risk("spot", "z1"), t.risk("on-demand", "z1"), t.risk("", ""), t.risk("odd", "z")]
        for ct, zone, signal in [("spot", "z1", 1.0), ("spot", "z1", 1.0), ("on-demand", "z2", 5.0),
                                 ("spot", "z2", -1.0)]:
            t.observe(ct, zone, signal)
            out.append((t.risk("spot", "z1"), t.risk("on-demand", "z2"), t.risk("spot", "z2")))
        for _ in range(30):
            t.decay()
        out.append((t.risk("spot", "z1"), t.risk("on-demand", "z2"), len(t._ewma)))
        out.append((M.dis.DEFAULT_RISK, M.dis.RISK_FALLBACK, M.dis.RISK_ALPHA,
                    M.dis.risk_tracker() is M.dis.risk_tracker()))
        return out

    got = both(run)
    assert got[0] == 0.15 and got[-2][2] == 0


@pytest.mark.parametrize("pdb,frozen", [
    ({"min_available": 2}, 2), ({"min_available": 1}, 0), ({"max_unavailable": 0}, 2),
    ({"min_available": "100%"}, 2), ({"max_unavailable": "50%"}, 0),
])
def test_pdb_frozen_pod_keys(pdb, frozen):
    def run(M):
        cluster, _, _, _ = fleet(M, 2, owned=True, migration="evict")
        for p in cluster.pods():
            p.metadata.labels["app"] = "db"
        cluster.create("pdbs", M.f.make_pdb(labels={"app": "db"}, **pdb))
        cluster.create("pdbs", M.f.make_pdb(labels={"app": "other"}, min_available=5))
        return sorted(M.dis.pdb_frozen_pod_keys(cluster))

    assert len(both(run)) == frozen


@pytest.mark.parametrize("budget,default,retired,blocked", [
    ("2", None, 2, 3),      # a count below the wave size caps the wave
    ("20%", None, 4, 1),    # 20% of 20 nodes
    (None, "1", 1, 4),      # the controller default when the spec is unset
    ("3", "1", 3, 2),       # the provisioner's spec wins
    (None, None, 5, 0),     # unbudgeted: paced by the wave size alone
])
def test_budget_caps_the_wave(budget, default, retired, blocked):
    def run(M):
        cluster, _, _, ctl = fleet(M, 20, owned=True, migration="evict", budget=budget,
                                   default_budget=default)
        before = {n.metadata.name for n in cluster.nodes()}
        requeue = ctl.reconcile("default")
        gone = sorted(before - {n.metadata.name for n in cluster.nodes()})
        reasons = sorted({e.reason for e in cluster.list("events")})
        return gone, ctl.budget_blocked, requeue, reasons, ctl.ledger.in_flight("default")

    gone, got_blocked, requeue, reasons, in_flight = both(run)
    assert (len(gone), got_blocked, in_flight) == (retired, blocked, retired)
    assert requeue == 10.0
    assert ("ConsolidationBudgetBlocked" in reasons) == bool(blocked)


def test_zero_budget_disables_without_planning():
    def run(M):
        cluster, _, _, ctl = fleet(M, 8, owned=True, migration="evict", budget="0")
        return ctl.reconcile("default"), len(cluster.nodes()), ctl.waves_executed

    assert both(run) == (300.0, 8, 0)


def test_concurrent_waves_draw_from_one_budget():
    def run(M):
        ledger = M.dis.BudgetLedger()
        cluster, provider, _, first = fleet(M, 20, owned=True, migration="evict", budget="3",
                                            ledger=ledger)
        second = M.cons.ConsolidationController(
            cluster, provider, **on_cpu(M, dict(migration="evict", ledger=ledger)))
        first.reconcile("default")
        after_first = sorted(n.metadata.name for n in cluster.nodes())
        second.reconcile("default")
        return after_first, sorted(n.metadata.name for n in cluster.nodes())

    after_first, after_second = both(run)
    assert len(after_first) == 17 and after_second == after_first


def test_settled_wave_releases_the_budget():
    def run(M):
        cluster, _, _, ctl = fleet(M, 6, owned=True, migration="evict", budget="2")
        ctl.reconcile("default")
        held = ctl.ledger.in_flight("default")
        return held, ctl.wave_settled("default"), ctl.ledger.in_flight("default")

    assert both(run) == (2, True, 0)


def test_budget_survives_serde_and_admission():
    def run(M):
        import importlib

        serde = importlib.import_module(f"{M.pkg}.kube.serde")
        api = importlib.import_module(f"{M.pkg}.api.provisioner")
        p = M.f.make_provisioner()
        out = []
        for spec in ("20%", None, "lots"):
            p.spec.disruption_budget = spec
            wire = serde._provisioner_to_wire(p)
            out.append((wire["spec"].get("disruptionBudget"),
                        serde._provisioner_from_wire(wire).spec.disruption_budget,
                        any("disruptionBudget" in e for e in api.validate_provisioner(p))))
        return out

    assert both(run) == [("20%", "20%", False), (None, None, False), ("lots", "lots", True)]

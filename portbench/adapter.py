"""The generated records as the program's objects, and the program's plan
as plain data. The only module of the harness besides ``harness.py`` that
imports the program (``karpenter_tpu_torch``)."""

from __future__ import annotations

from typing import Dict, List, Sequence

from karpenter_tpu_torch.api import labels as lbl
from karpenter_tpu_torch.api.objects import (
    LabelSelector,
    NodeSelectorRequirement,
    ObjectMeta,
    Pod,
    PodAffinityTerm,
    PodSpec,
)
from karpenter_tpu_torch.cloudprovider.fake import new_instance_type
from karpenter_tpu_torch.cloudprovider.types import Offering
from karpenter_tpu_torch.testing.factories import (
    hostname_spread,
    make_pod,
    make_provisioner,
    zone_spread,
)
from karpenter_tpu_torch.utils import resources as res

_TERM_KEYS = {
    "aff_host": lbl.HOSTNAME, "aff_zone": lbl.TOPOLOGY_ZONE,
    "anti_host": lbl.HOSTNAME, "anti_zone": lbl.TOPOLOGY_ZONE,
}
_SPREADS = {"zone_spread": zone_spread, "host_spread": hostname_spread}


def pod(rec: Dict):
    requests = {"cpu": f"{rec['cpu_m']}m"}
    if rec["mem_mi"]:
        requests["memory"] = f"{rec['mem_mi']}Mi"
    kw = {}
    kind = rec["kind"]
    if kind in _SPREADS:
        kw["topology"] = [_SPREADS[kind](max_skew=1, labels={"my-label": rec["sel"]})]
    elif kind in _TERM_KEYS:
        term = PodAffinityTerm(
            label_selector=LabelSelector(match_labels={"my-label": rec["sel"]}),
            topology_key=_TERM_KEYS[kind],
        )
        kw["pod_anti_requirements" if kind.startswith("anti") else "pod_requirements"] = [term]
    if rec.get("node_selector"):
        kw["node_selector"] = dict(rec["node_selector"])
    if rec.get("node_affinity"):
        kw["node_requirements"] = [NodeSelectorRequirement(key, op, list(values))
                                   for key, op, values in rec["node_affinity"]]
    return make_pod(labels=rec["labels"], requests=requests, **kw)


def pods(records: Sequence[Dict]) -> List:
    return [pod(r) for r in records]


def fresh(templates: Sequence, tag: int) -> List:
    """New pod objects with the templates' contents: each pod, its metadata
    and its spec are new objects, with the name and uid suffixed by ``tag``,
    so the program holds no memo of them from an earlier round. The
    templates are never handed to the program themselves."""
    out = []
    suffix = f"-r{tag}"
    for t in templates:
        meta = object.__new__(ObjectMeta)
        meta.__dict__.update(t.metadata.__dict__)
        meta.name += suffix
        meta.uid += suffix
        spec = object.__new__(PodSpec)
        spec.__dict__.update(t.spec.__dict__)
        p = object.__new__(Pod)
        p.__dict__.update(metadata=meta, spec=spec, status=t.status)
        out.append(p)
    return out


def instance_types(catalog: Sequence[Dict]) -> List:
    """The catalog records as the program's instance types, in record order."""
    out = []
    for t in catalog:
        cpu_m, mem_b, n_pods = t["res"]
        o_cpu, o_mem, _ = t["overhead"]
        out.append(new_instance_type(
            t["name"],
            offerings=[Offering(c, z) for c, z in t["offerings"]],
            architecture=t["arch"],
            operating_systems=frozenset(t["os"]),
            resources={res.CPU: cpu_m / 1000, res.MEMORY: float(mem_b), res.PODS: float(n_pods)},
            overhead={res.CPU: o_cpu / 1000, res.MEMORY: float(o_mem)},
        ))
    return out


def provisioner():
    return make_provisioner(solver="tpu")


def plan(nodes, round_pods: Sequence) -> Dict:
    """The program's plan in the reference's form: positions index
    ``round_pods`` (-1 for a pod the round did not hand over); requests in
    millicores, bytes and pods."""
    index = {id(p): i for i, p in enumerate(round_pods)}
    placed = set()
    out = []
    for node in nodes:
        ids = [index.get(id(p), -1) for p in node.pods]
        placed.update(ids)
        r = node.requests
        out.append((
            ids,
            tuple(it.name for it in node.instance_type_options),
            (round(r.get(res.CPU, 0.0) * 1000), round(r.get(res.MEMORY, 0.0)),
             round(r.get(res.PODS, 0.0))),
        ))
    return {"nodes": out, "unschedulable": sorted(set(range(len(round_pods))) - placed - {-1})}

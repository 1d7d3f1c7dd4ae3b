"""Pod predicates (reference: pkg/utils/pod/scheduling.go)."""

from __future__ import annotations

from karpenter_tpu_torch.api.objects import Pod


def failed_to_schedule(pod: Pod) -> bool:
    return any(
        c.type == "PodScheduled" and c.reason == "Unschedulable" for c in pod.status.conditions
    )


def is_scheduled(pod: Pod) -> bool:
    return pod.spec.node_name != ""


def is_preempting(pod: Pod) -> bool:
    return pod.status.nominated_node_name != ""


def is_terminal(pod: Pod) -> bool:
    return pod.status.phase in ("Failed", "Succeeded")


def is_terminating(pod: Pod) -> bool:
    return pod.metadata.deletion_timestamp is not None


def is_owned_by_daemonset(pod: Pod) -> bool:
    return any(
        o.api_version == "apps/v1" and o.kind == "DaemonSet" for o in pod.metadata.owner_references
    )


def is_owned_by_node(pod: Pod) -> bool:
    """Static pods are owned by their node."""
    return any(o.api_version == "v1" and o.kind == "Node" for o in pod.metadata.owner_references)


def is_provisionable(pod: Pod) -> bool:
    """Unscheduled, not preempting, marked unschedulable, and not a
    daemonset/static pod (reference: selection/controller.go:117-123; the
    provisioning worker re-checks it between enqueue and solve,
    provisioner.go:121-134)."""
    return (
        not is_scheduled(pod)
        and not is_preempting(pod)
        and failed_to_schedule(pod)
        and not is_owned_by_daemonset(pod)
        and not is_owned_by_node(pod)
    )


WILDCARD_HOST_IP = "0.0.0.0"


def host_ports(pod: Pod):
    """The (hostIP, hostPort, protocol) triples the pod claims on its node.
    Conflicting claims cannot co-locate (the reference left this unenforced —
    suite_test.go:1758 is skipped 'enable after scheduler is aware of
    hostport usage'; this framework enforces it).

    Memoized on the pod (containers are never mutated by scheduling) — this
    runs for every pod of every solve."""
    containers = pod.spec.containers
    cached = getattr(pod, "_host_ports_memo", None)
    if cached is not None and cached[0] is containers:
        return set(cached[1])
    out = set()
    for container in containers:
        for port in container.ports:
            if port.host_port:
                out.add((port.host_ip or WILDCARD_HOST_IP, port.host_port, port.protocol or "TCP"))
    try:
        pod._host_ports_memo = (containers, frozenset(out))
    except AttributeError:
        pass
    return out


def host_ports_conflict(a, b) -> bool:
    """Kubelet semantics: same (port, protocol) conflicts when either side
    binds the wildcard IP or the IPs are equal."""
    for ip_a, port_a, proto_a in a:
        for ip_b, port_b, proto_b in b:
            if port_a != port_b or proto_a != proto_b:
                continue
            if ip_a == WILDCARD_HOST_IP or ip_b == WILDCARD_HOST_IP or ip_a == ip_b:
                return True
    return False


def has_required_pod_affinity(pod: Pod) -> bool:
    aff = pod.spec.affinity
    return aff is not None and aff.pod_affinity is not None and bool(aff.pod_affinity.required)


def has_required_pod_anti_affinity(pod: Pod) -> bool:
    aff = pod.spec.affinity
    return (
        aff is not None and aff.pod_anti_affinity is not None and bool(aff.pod_anti_affinity.required)
    )


# Priority classing for overload decisions (docs/overload.md): without a
# PriorityClass store to resolve real values, the class NAME maps to a
# coarse ordinal — enough to decide what the batcher sheds first. System
# classes outrank everything; an unnamed class is the default tier; names
# starting "low"/"best-effort" opt workloads into shed-first.
_PRIORITY_BY_CLASS = {
    "system-node-critical": 100,
    "system-cluster-critical": 90,
}


def priority_of(pod: Pod) -> int:
    """Coarse priority ordinal for shed ordering (higher = keep longer)."""
    name = pod.spec.priority_class_name or ""
    if name in _PRIORITY_BY_CLASS:
        return _PRIORITY_BY_CLASS[name]
    if name.startswith("high"):
        return 10
    if name.startswith(("low", "best-effort")):
        return -10
    return 0

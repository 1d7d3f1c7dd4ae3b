"""Fleet-scale horizontal availability (docs/fleet.md).

Provisioners are partitioned across N controller replicas by per-shard
leases (``utils.lease.FileLeaseSet`` / ``kube.leader.KubeLeaseSet``):
each replica heartbeats its membership, claims the shards rendezvous
hashing assigns it among the live members, and renews them on a cadence.
A replica that stops renewing loses every shard within one lease duration
and survivors take them over — losing a replica degrades capacity, never
availability.

``main.build_runtime`` builds the ``ShardManager`` when ``--shard-lease``
is set and hands it to every controller as ``ownership=``; without it
(``ownership=None``) a replica owns everything, and the interruption
controller's ``_shard_for`` and the garbage collector's ``_owns`` still
read ``DEFAULT_SHARD``.
"""

from karpenter_tpu_torch.fleet.ownership import (
    DEFAULT_SHARD,
    ShardManager,
    WatchedShardKeys,
    build_lease_set,
    rendezvous_owner,
)

__all__ = [
    "DEFAULT_SHARD",
    "ShardManager",
    "WatchedShardKeys",
    "build_lease_set",
    "rendezvous_owner",
]

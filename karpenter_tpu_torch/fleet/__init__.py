"""Fleet sharding: only the default shard's name so far. ``ShardManager``
and the rest of the reference's ``fleet/ownership.py`` are not ported yet.

The interruption controller's ``_shard_for`` and the garbage collector's
``_owns`` read ``DEFAULT_SHARD`` even without an owner (``ownership=None``).
"""

# the shard for work with no provisioner attribution (nodes without a
# provisioner label, cluster-scoped chores): always part of the key
# universe so exactly one replica handles it
DEFAULT_SHARD = "__unassigned__"

__all__ = ["DEFAULT_SHARD"]

"""Crash-consistent launch path.

A launch is three writes against three stores — the cloud create, the
Node object, the pod binds — and a process can die between any two of
them. The :mod:`journal` records intent *before* the cloud call and is
resolved only after the bind, so an interrupted launch always leaves a
breadcrumb: recovery re-describes the journal entry's launch token
against ``CloudProvider.list_instances()`` and either **adopts** the
instance (writes the Node object it never got) or confirms it never
launched (drops the entry). The sweep lives in
``controllers/garbage_collection.py``.
"""

from karpenter_tpu_torch.launch.journal import (
    STATE_CREATED,
    STATE_INTENT,
    FileLaunchJournal,
    KubeLaunchJournal,
    LaunchJournal,
    LaunchRecord,
    MemoryLaunchJournal,
    build_journal,
)

__all__ = [
    "STATE_CREATED",
    "STATE_INTENT",
    "FileLaunchJournal",
    "KubeLaunchJournal",
    "LaunchJournal",
    "LaunchRecord",
    "MemoryLaunchJournal",
    "build_journal",
]

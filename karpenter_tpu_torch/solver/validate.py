"""The verdict on a decoded plan in one native pass.

``csrc/validate_native.cpp`` is a CPython module in C++ whose ``validate``
checks ``TorchScheduler._validate_pack``'s invariants in its order, with
placements matched to the batch by object identity once the batch's keys
are shown unique, and each node's totals summed as ``resources.merge`` sums
them. It returns ``PASSED`` (-1) only where the Python loop would return
None; on any other return the loop judges the plan and words the violation.
g++ builds it for this interpreter into
``build/karpenter_tpu_torch/validate-<hash>/`` on a thread started at
import, as the native statics pass is built; until it is loaded, or where
it cannot be built, the Python loop gives every verdict.
"""

from __future__ import annotations

import threading
from pathlib import Path

from karpenter_tpu_torch.api.objects import ObjectMeta, Pod, PodSpec
from karpenter_tpu_torch.utils import native_build
from karpenter_tpu_torch.utils import resources as res

PASSED = -1

NATIVE_EXT = native_build.extension(
    "validate", Path(__file__).resolve().parent / "csrc", "validate_native.cpp", "_validate_native")
NATIVE = native_build.Loader(
    "native validate pass", lambda: native_build.load_extension(NATIVE_EXT), daemon=False)
NATIVE.get()  # starts the build: it overlaps the rest of the process's start

# what the native pass reads: the exact types of a placed pod, its metadata
# and its spec, and the name ``requests_for_pods`` counts a pod under
CTX = (Pod, ObjectMeta, PodSpec, res.PODS)


class _Last(threading.local):
    native = False  # whether this thread's last ``passes`` gave the verdict


last = _Last()


def passes(nodes, pods, daemon) -> bool:
    """True where the native pass proves that ``_validate_pack``'s loop
    would find no violation in the plan; sets ``last.native`` to that."""
    native = NATIVE.get()
    last.native = native is not None and native.validate(nodes, pods, daemon, CTX) == PASSED
    return last.native

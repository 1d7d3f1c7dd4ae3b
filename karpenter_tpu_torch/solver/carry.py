"""Carry an encoded batch's arrays into the port's kernel and fused inputs.

The solve has no weights: its state is the encoded batch. This module
takes that batch as a plain ``dict`` of numpy arrays — the reference
package's ``EncodedBatch`` fields, handed over by whoever holds them — and
returns the port's tensors on a device. With it, the kernel path can be
held against another implementation on identical inputs, independent of
the port's own encode. It imports nothing but numpy and torch.

Expected keys: the ``pack_args()`` ten (``pod_valid``, ``pod_open_sig``,
``pod_core``, ``pod_host``, ``pod_host_in_base``, ``pod_open_host``,
``pod_req``, ``join_table``, ``frontiers``, ``daemon``), plus ``usable``,
``type_mask`` (``type_mask_matrix()``), ``pod_req_id``, ``uniq_req``,
``open_sig_by_core``, ``base_has_hostname``, and the v2 kernel's per-core
tables ``front_j``, ``compat_j`` and ``jvals`` as the reference package's
``_precompute`` returns them.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Dict

import numpy as np
import torch

from karpenter_tpu_torch.solver import fused, pack_kernel_v2

PACK_ARG_DTYPES = (
    ("pod_valid", torch.bool),
    ("pod_open_sig", torch.int32),
    ("pod_core", torch.int32),
    ("pod_host", torch.int32),
    ("pod_host_in_base", torch.bool),
    ("pod_open_host", torch.int32),
    ("pod_req", torch.float32),
    ("join_table", torch.int32),
    ("frontiers", torch.float32),
    ("daemon", torch.float32),
)


def tensors_from_reference(fields: Dict[str, object], device) -> Dict[str, tuple]:
    """``{"pack_args": the ten kernel inputs, "fused": the nine fused_solve
    inputs, "pack_v2_args": the seven pack_first_fit_v2 inputs, "fused_v2":
    the eleven fused_solve_v2 inputs}`` as tensors on ``device``."""
    device = torch.device(device)
    pack_args = tuple(
        torch.tensor(np.asarray(fields[name]), dtype=dtype, device=device)
        for name, dtype in PACK_ARG_DTYPES
    )
    view = SimpleNamespace(
        pod_valid=np.asarray(fields["pod_valid"]),
        pod_host_in_base=np.asarray(fields["pod_host_in_base"]),
        pod_core=np.asarray(fields["pod_core"]),
        pod_host=np.asarray(fields["pod_host"]),
        pod_req_id=np.asarray(fields["pod_req_id"]),
        open_sig_by_core=np.asarray(fields["open_sig_by_core"]),
        base_has_hostname=bool(fields["base_has_hostname"]),
    )
    tab, open_by_core, bhh = fused.pack_pod_table(view)
    uniq = fused.pad_uniq_req(np.asarray(fields["uniq_req"], np.float32))
    fused_args = tuple(
        torch.tensor(a, device=device)
        for a in (
            tab,
            open_by_core,
            bhh,
            uniq,
            np.asarray(fields["join_table"], np.int32),
            np.asarray(fields["frontiers"], np.float32),
            np.asarray(fields["daemon"], np.float32),
            np.asarray(fields["type_mask"], bool),
            np.asarray(fields["usable"], np.float32),
        )
    )
    tables = tuple(
        torch.tensor(np.asarray(fields[k], np.float32), device=device)
        for k in ("front_j", "compat_j", "jvals")
    )
    pack_v2_args = pack_kernel_v2.kernel_inputs(*pack_args[:7], *pack_args[8:], *tables)
    fused_v2 = fused_args[:4] + tables + fused_args[5:]
    return {
        "pack_args": pack_args,
        "fused": fused_args,
        "pack_v2_args": pack_v2_args,
        "fused_v2": fused_v2,
    }

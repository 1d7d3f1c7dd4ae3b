"""Scheduler facade: dispatches a solve to the backend selected by the
provisioner's ``spec.solver`` field — ``tpu`` to the GPU-backed
``TorchScheduler``, anything else to the host FFD scheduler."""

from __future__ import annotations

import random
import time
from typing import List, Optional, Sequence

from karpenter_tpu_torch import metrics, obs
from karpenter_tpu_torch.api.objects import Pod
from karpenter_tpu_torch.api.provisioner import SOLVER_TPU, Provisioner
from karpenter_tpu_torch.cloudprovider.requirements import catalog_requirements
from karpenter_tpu_torch.cloudprovider.types import InstanceType
from karpenter_tpu_torch.kube.client import Cluster
from karpenter_tpu_torch.scheduling.ffd import FFDScheduler, VirtualNode
from karpenter_tpu_torch.utils.device import resolve_device


class Scheduler:
    def __init__(
        self,
        cluster: Cluster,
        rng: Optional[random.Random] = None,
        device="cuda",
        solver_delta: Optional[bool] = None,
        canary_rate: Optional[float] = None,
        solver_service_address: Optional[str] = None,
        pack_checksum: Optional[bool] = None,
        solver_stream: Optional[bool] = None,
        solver_shm_dir: Optional[str] = None,
    ):
        """``device`` is where the ``solver: tpu`` pack runs: ``cuda`` (the
        default) needs a card and raises without one; ``cpu`` runs the
        plain PyTorch version. ``solver_delta`` turns on the resident delta
        path (None = the ``KARPENTER_SOLVER_DELTA`` env twin).
        ``canary_rate`` is the fraction of kernel-served solves the native
        packer re-solves and compares (None = the ``KARPENTER_CANARY_RATE``
        env twin, default 0). ``solver_service_address`` sends the pack to
        a solver sidecar (``python -m karpenter_tpu_torch.solver.service``)
        at that ``host:port``, or to a pool of them for a comma-separated
        list; ``pack_checksum`` turns on the wire's frame checksums toward
        it (None = the ``KARPENTER_PACK_CHECKSUM`` env twin).
        ``solver_stream`` sends the solves over one persistent stream per
        sidecar and ``solver_shm_dir`` passes the pod arrays through a
        shared-memory arena in that directory when the sidecar shares it
        (None = the ``KARPENTER_SOLVER_STREAM`` and
        ``KARPENTER_SOLVER_SHM_DIR`` env twins)."""
        from karpenter_tpu_torch.solver.backend import TorchScheduler

        self.cluster = cluster
        self.device = resolve_device(device)
        self.ffd = FFDScheduler(cluster, rng=rng)
        self.torch = TorchScheduler(
            cluster, rng=rng, device=self.device, solver_delta=solver_delta,
            canary_rate=canary_rate, service_address=solver_service_address,
            pack_checksum=pack_checksum, solver_stream=solver_stream,
            solver_shm_dir=solver_shm_dir,
        )

    def last_stage_profile(self) -> dict:
        """Per-stage timings of the calling thread's most recently completed
        ``solver: tpu`` solve (else the latest of any thread; never one
        still in flight) (sort /
        inject / encode / pack_fetch / decode / validate seconds, each stage
        served from resident state under its ``*_delta_s`` key;
        pack_dispatches; packer_backend, what served — ``sidecar`` for a
        pack the solver sidecar served (with wire_ser_s, wire_deser_s,
        solver_address and solver_transport), on a cpu scheduler
        ``ffd-degraded`` when the FFD floor did, absent when the signature
        closure overflowed (a card scheduler raises instead); pack_route,
        which caller ran it: fused, unfused or the router's native)."""
        return self.torch.completed_profile()

    def last_decision_context(self) -> dict:
        """The calling thread's most recent ``solver: tpu`` solve's decision
        context (encoded batch, assignment read from the host copy the fetch
        made, ``n_max``, route, transport, address, session key) for the
        decision audit log (``obs.decision_log().record_round``), consumed
        on read; {} after an FFD solve, a failed round, or with the
        decision plane disabled."""
        return self.torch.completed_decision()

    def solve(
        self,
        provisioner: Provisioner,
        instance_types: Sequence[InstanceType],
        pods: Sequence[Pod],
    ) -> List[VirtualNode]:
        # layer the live catalog's supported values into the constraints;
        # idempotent, and keeps the facade safe to call standalone
        start = time.perf_counter()
        constraints = provisioner.spec.constraints.clone()
        constraints.requirements = constraints.requirements.merge(
            catalog_requirements(instance_types)
        )
        # the end-to-end solve span: what the flight recorder watches
        # against its budget, and the root the stage spans hang off
        with obs.tracer().span(
            "solver.solve",
            attrs={
                "provisioner": provisioner.name,
                "solver": provisioner.spec.solver,
                "pods": len(pods),
                "types": len(instance_types),
            },
        ) as sp:
            try:
                if provisioner.spec.solver == SOLVER_TPU:
                    nodes = self.torch.solve(constraints, instance_types, pods)
                else:
                    nodes = self.ffd.solve(constraints, instance_types, pods)
                sp.set_attribute("nodes", len(nodes))
                return nodes
            finally:
                metrics.SCHEDULING_DURATION.labels(
                    provisioner=provisioner.name
                ).observe(time.perf_counter() - start)

"""Cloud-provider registry — the build-tag switch analog.

The reference selects its vendor at compile time (``registry/aws.go``
``//go:build aws`` vs ``registry/fake.go``); here the selection is by name at
process start (reference: registry/register.go:24-37). Registering installs
the vendor's Default/Validate hooks, which the webhook and the provisioning
controller both call.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

from karpenter_tpu_torch.cloudprovider.types import CloudProvider

_FACTORIES: Dict[str, Callable[[], CloudProvider]] = {}


def register(name: str, factory: Callable[[], CloudProvider]) -> None:
    _FACTORIES[name] = factory


def new_cloud_provider(name: str = "fake", **kwargs) -> CloudProvider:
    factory = _FACTORIES.get(name)
    if factory is None:
        raise ValueError(f"unknown cloud provider {name!r}; registered: {sorted(_FACTORIES)}")
    return factory(**kwargs) if kwargs else factory()


def _register_builtins() -> None:
    from karpenter_tpu_torch.cloudprovider.fake import FakeCloudProvider
    from karpenter_tpu_torch.cloudprovider.gke import GkeCloudProvider
    from karpenter_tpu_torch.cloudprovider.simulated import SimulatedCloudProvider

    register("fake", FakeCloudProvider)
    register("simulated", SimulatedCloudProvider)
    register("gke", GkeCloudProvider)

    def _resolve_base(url: str, name: str) -> str:
        # control plane over the wire: --cloud-provider=<name>-http with
        # KARPENTER_CLOUD_API_URL (or the url kwarg) pointing at a server
        # speaking the cloudprovider/httpapi.py REST protocol
        import os

        base = url or os.environ.get("KARPENTER_CLOUD_API_URL", "")
        if not base:
            raise ValueError(f"{name} needs KARPENTER_CLOUD_API_URL (or url=...)")
        return base

    def _http_simulated(url: str = "") -> CloudProvider:
        from karpenter_tpu_torch.cloudprovider.httpapi import HttpCloudAPI

        return SimulatedCloudProvider(
            HttpCloudAPI(_resolve_base(url, "simulated-http"))
        )

    def _http_gke(url: str = "") -> CloudProvider:
        from karpenter_tpu_torch.cloudprovider.httpapi import HttpGkeAPI

        return GkeCloudProvider(api=HttpGkeAPI(_resolve_base(url, "gke-http")))

    register("simulated-http", _http_simulated)
    register("gke-http", _http_gke)


_register_builtins()

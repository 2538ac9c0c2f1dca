"""Kind → REST mapping (the analog of controller-runtime's RESTMapper).

The port's copy of ``kubeflow_tpu/cluster/restmapper.py``. API objects
are plain dicts keyed by ``kind``, so the mapping is one static table of
every kind the controllers touch; an unknown kind raises rather than
fabricating a group/version. A kind in the store's
``CLUSTER_SCOPED_KINDS`` maps to a cluster-scoped path
(tests/test_torch_apiserver.py holds the two sets together).

Path shapes (the real wire format):

- core v1, namespaced:    /api/v1/namespaces/{ns}/{plural}[/{name}]
- core v1, cluster:       /api/v1/{plural}[/{name}]
- group, namespaced:      /apis/{group}/{version}/namespaces/{ns}/{plural}[/{name}]
- group, cluster:         /apis/{group}/{version}/{plural}[/{name}]
- all-namespace list:     the namespaced shape minus the namespaces segment
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class RestMapping:
    kind: str
    api_version: str  # "v1" or "group/version"
    plural: str
    namespaced: bool = True

    @property
    def group_version(self) -> tuple[str, str]:
        if "/" in self.api_version:
            group, version = self.api_version.split("/", 1)
            return group, version
        return "", self.api_version

    def path(self, namespace: str | None = None, name: str | None = None,
             subresource: str | None = None) -> str:
        group, version = self.group_version
        parts = ["/api", version] if not group else ["/apis", group, version]
        if self.namespaced and namespace:
            parts += ["namespaces", namespace]
        parts.append(self.plural)
        if name:
            parts.append(name)
            if subresource:
                parts.append(subresource)
        return "/".join(parts)


_MAPPINGS = [
    # core/v1
    RestMapping("Pod", "v1", "pods"),
    RestMapping("Service", "v1", "services"),
    RestMapping("ConfigMap", "v1", "configmaps"),
    RestMapping("Secret", "v1", "secrets"),
    RestMapping("ServiceAccount", "v1", "serviceaccounts"),
    RestMapping("Event", "v1", "events"),
    RestMapping("PersistentVolumeClaim", "v1", "persistentvolumeclaims"),
    RestMapping("Namespace", "v1", "namespaces", namespaced=False),
    RestMapping("Node", "v1", "nodes", namespaced=False),
    # apps/v1
    RestMapping("StatefulSet", "apps/v1", "statefulsets"),
    RestMapping("Deployment", "apps/v1", "deployments"),
    # our CRDs
    RestMapping("Notebook", "kubeflow.org/v1", "notebooks"),
    RestMapping("SlicePool", "tpu.kubeflow.org/v1", "slicepools",
                namespaced=False),
    RestMapping("TPUQuota", "tpu.kubeflow.org/v1", "tpuquotas",
                namespaced=False),
    # networking
    RestMapping("NetworkPolicy", "networking.k8s.io/v1", "networkpolicies"),
    # rbac
    RestMapping("Role", "rbac.authorization.k8s.io/v1", "roles"),
    RestMapping("RoleBinding", "rbac.authorization.k8s.io/v1", "rolebindings"),
    RestMapping("ClusterRole", "rbac.authorization.k8s.io/v1",
                "clusterroles", namespaced=False),
    RestMapping("ClusterRoleBinding", "rbac.authorization.k8s.io/v1",
                "clusterrolebindings", namespaced=False),
    # gateway API
    RestMapping("HTTPRoute", "gateway.networking.k8s.io/v1", "httproutes"),
    RestMapping("Gateway", "gateway.networking.k8s.io/v1", "gateways"),
    RestMapping("ReferenceGrant", "gateway.networking.k8s.io/v1beta1",
                "referencegrants"),
    # coordination
    RestMapping("Lease", "coordination.k8s.io/v1", "leases"),
    # apiextensions
    RestMapping("CustomResourceDefinition", "apiextensions.k8s.io/v1",
                "customresourcedefinitions", namespaced=False),
    # admissionregistration
    RestMapping("MutatingWebhookConfiguration",
                "admissionregistration.k8s.io/v1",
                "mutatingwebhookconfigurations", namespaced=False),
    RestMapping("ValidatingWebhookConfiguration",
                "admissionregistration.k8s.io/v1",
                "validatingwebhookconfigurations", namespaced=False),
    # scheduling
    RestMapping("PriorityClass", "scheduling.k8s.io/v1", "priorityclasses",
                namespaced=False),
    # OpenShift groups the extension controller touches
    RestMapping("APIServer", "config.openshift.io/v1", "apiservers",
                namespaced=False),
    RestMapping("Proxy", "config.openshift.io/v1", "proxies",
                namespaced=False),
    RestMapping("OAuthClient", "oauth.openshift.io/v1", "oauthclients",
                namespaced=False),
    RestMapping("ImageStream", "image.openshift.io/v1", "imagestreams"),
    RestMapping("Route", "route.openshift.io/v1", "routes"),
    # DSPA + Istio
    RestMapping("DataSciencePipelinesApplication",
                "datasciencepipelinesapplications.opendatahub.io/v1alpha1",
                "datasciencepipelinesapplications"),
    RestMapping("VirtualService", "networking.istio.io/v1beta1",
                "virtualservices"),
]

_BY_KIND = {m.kind: m for m in _MAPPINGS}
_BY_ROUTE: dict[tuple[str, str, str], RestMapping] = {}
for _m in _MAPPINGS:
    _g, _v = _m.group_version
    _BY_ROUTE[(_g, _v, _m.plural)] = _m


def register(mapping: RestMapping) -> None:
    """Extend the table at runtime (user-defined CRDs)."""
    _BY_KIND[mapping.kind] = mapping
    group, version = mapping.group_version
    _BY_ROUTE[(group, version, mapping.plural)] = mapping


def mapping_for(kind: str) -> RestMapping:
    mapping = _BY_KIND.get(kind)
    if mapping is None:
        raise KeyError(
            f"no REST mapping for kind {kind!r}; register one with "
            f"restmapper.register(RestMapping(...)) or add it to the table")
    return mapping


def mapping_for_route(group: str, version: str, plural: str) -> RestMapping | None:
    m = _BY_ROUTE.get((group, version, plural))
    if m is not None:
        return m
    # tolerate version drift (e.g. a client speaking v1beta1 for a kind we
    # serve at v1) the way the real apiserver serves multiple versions
    for (g, _v, p), cand in _BY_ROUTE.items():
        if g == group and p == plural:
            return cand
    return None

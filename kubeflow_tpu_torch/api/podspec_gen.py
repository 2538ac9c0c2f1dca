"""Mechanically-generated full core/v1 PodSpec OpenAPI schema.

A copy of ``kubeflow_tpu/api/podspec_gen.py`` (the port imports nothing
of the JAX package).

The reference validates the ENTIRE PodSpec server-side via an 11,650-line
generated expansion (components/notebook-controller/config/crd/bases/
kubeflow.org_notebooks.yaml, produced by controller-gen from the vendored
k8s type definitions). Our analog: this module vendors a declarative
model of the core/v1 type graph (transcribed from the public Kubernetes
API spec — field names, types, requireds, enums) and a tiny generator
assembling it into the same OpenAPI v3 structural form api/schema.py
validates. The hand-typed subset in api/schema.py stays the OVERRIDE
layer for fields the controllers actively consume (tighter patterns:
quantities, DNS-1123 names); everything else — probes, lifecycle,
affinity, topology spread, the volume-source zoo — is typed here, so a
mistyped ``livenessProbe.httpGet.port`` or a malformed ``affinity`` is a
422 at the apiserver, before any controller sees it.

Generation is deterministic pure-Python (no network, no controller-gen):
``pod_spec_schema_full()`` returns the complete schema, which the port's
Notebook CRD carries (``api/types.py`` ``notebook_crd``).
"""

from __future__ import annotations

# ----------------------------------------------------------- leaf helpers
def S(**kw) -> dict:
    return {"type": "string", **kw}


def I(**kw) -> dict:  # noqa: E743 — mirrors the schema vocabulary
    return {"type": "integer", **kw}


def B() -> dict:
    return {"type": "boolean"}


def INT_OR_STR() -> dict:
    return {"type": "string", "x-kubernetes-int-or-string": True}


def ARR(items: dict, **kw) -> dict:
    return {"type": "array", "items": items, **kw}


def OBJ(properties: dict, required: list[str] | None = None, **kw) -> dict:
    out = {"type": "object", "properties": properties, **kw}
    if required:
        out["required"] = required
    return out


def STR_MAP() -> dict:
    return {"type": "object", "additionalProperties": {"type": "string"}}


def QUANTITY() -> dict:
    # the tighter QUANTITY_PATTERN lives in the override layer (schema.py)
    # for the resource maps the webhook validates; here plain int-or-string
    # matches what the apiserver's Quantity unmarshals
    return INT_OR_STR()


# ------------------------------------------------------- shared meta types
def label_selector() -> dict:
    return OBJ({
        "matchExpressions": ARR(OBJ({
            "key": S(),
            "operator": S(enum=["In", "NotIn", "Exists", "DoesNotExist"]),
            "values": ARR(S()),
        }, required=["key", "operator"])),
        "matchLabels": STR_MAP(),
    })


def local_object_reference() -> dict:
    return OBJ({"name": S()})


def key_to_path() -> dict:
    return OBJ({"key": S(), "mode": I(), "path": S()},
               required=["key", "path"])


def object_field_selector() -> dict:
    return OBJ({"apiVersion": S(), "fieldPath": S()}, required=["fieldPath"])


def resource_field_selector() -> dict:
    return OBJ({"containerName": S(), "divisor": QUANTITY(),
                "resource": S()}, required=["resource"])


# -------------------------------------------------------- container pieces
def env_var_source() -> dict:
    return OBJ({
        "configMapKeyRef": OBJ({"key": S(), "name": S(), "optional": B()},
                               required=["key"]),
        "fieldRef": object_field_selector(),
        "resourceFieldRef": resource_field_selector(),
        "secretKeyRef": OBJ({"key": S(), "name": S(), "optional": B()},
                            required=["key"]),
    })


def env_from_source() -> dict:
    return OBJ({
        "configMapRef": OBJ({"name": S(), "optional": B()}),
        "prefix": S(),
        "secretRef": OBJ({"name": S(), "optional": B()}),
    })


def exec_action() -> dict:
    return OBJ({"command": ARR(S())})


def http_get_action() -> dict:
    return OBJ({
        "host": S(),
        "httpHeaders": ARR(OBJ({"name": S(), "value": S()},
                               required=["name", "value"])),
        "path": S(),
        "port": INT_OR_STR(),
        "scheme": S(enum=["HTTP", "HTTPS"]),
    }, required=["port"])


def tcp_socket_action() -> dict:
    return OBJ({"host": S(), "port": INT_OR_STR()}, required=["port"])


def grpc_action() -> dict:
    return OBJ({"port": I(), "service": S()}, required=["port"])


def probe() -> dict:
    return OBJ({
        "exec": exec_action(),
        "failureThreshold": I(),
        "grpc": grpc_action(),
        "httpGet": http_get_action(),
        "initialDelaySeconds": I(),
        "periodSeconds": I(),
        "successThreshold": I(),
        "tcpSocket": tcp_socket_action(),
        "terminationGracePeriodSeconds": I(),
        "timeoutSeconds": I(),
    })


def lifecycle_handler() -> dict:
    return OBJ({
        "exec": exec_action(),
        "httpGet": http_get_action(),
        "sleep": OBJ({"seconds": I()}, required=["seconds"]),
        "tcpSocket": tcp_socket_action(),
    })


def lifecycle() -> dict:
    return OBJ({"postStart": lifecycle_handler(),
                "preStop": lifecycle_handler()})


def se_linux_options() -> dict:
    return OBJ({"level": S(), "role": S(), "type": S(), "user": S()})


def seccomp_profile() -> dict:
    return OBJ({"localhostProfile": S(),
                "type": S(enum=["Localhost", "RuntimeDefault",
                                "Unconfined"])}, required=["type"])


def app_armor_profile() -> dict:
    return OBJ({"localhostProfile": S(),
                "type": S(enum=["Localhost", "RuntimeDefault",
                                "Unconfined"])}, required=["type"])


def windows_options() -> dict:
    return OBJ({"gmsaCredentialSpec": S(), "gmsaCredentialSpecName": S(),
                "hostProcess": B(), "runAsUserName": S()})


def container_security_context() -> dict:
    return OBJ({
        "allowPrivilegeEscalation": B(),
        "appArmorProfile": app_armor_profile(),
        "capabilities": OBJ({"add": ARR(S()), "drop": ARR(S())}),
        "privileged": B(),
        "procMount": S(),
        "readOnlyRootFilesystem": B(),
        "runAsGroup": I(),
        "runAsNonRoot": B(),
        "runAsUser": I(),
        "seLinuxOptions": se_linux_options(),
        "seccompProfile": seccomp_profile(),
        "windowsOptions": windows_options(),
    })


def container_full() -> dict:
    """Full core/v1 Container. The override layer (api/schema.py) tightens
    name/env/ports/resources/volumeMounts on top of this."""
    return OBJ({
        "args": ARR(S()),
        "command": ARR(S()),
        "env": ARR(OBJ({"name": S(), "value": S(),
                        "valueFrom": env_var_source()}, required=["name"])),
        "envFrom": ARR(env_from_source()),
        "image": S(),
        "imagePullPolicy": S(enum=["Always", "IfNotPresent", "Never"]),
        "lifecycle": lifecycle(),
        "livenessProbe": probe(),
        "name": S(),
        "ports": ARR(OBJ({
            "containerPort": I(minimum=1, maximum=65535),
            "hostIP": S(),
            "hostPort": I(),
            "name": S(),
            "protocol": S(enum=["TCP", "UDP", "SCTP"]),
        }, required=["containerPort"])),
        "readinessProbe": probe(),
        "resizePolicy": ARR(OBJ({
            "resourceName": S(),
            "restartPolicy": S(enum=["NotRequired", "RestartContainer"]),
        }, required=["resourceName", "restartPolicy"])),
        "resources": OBJ({
            "claims": ARR(OBJ({"name": S(), "request": S()},
                              required=["name"])),
            "limits": {"type": "object",
                       "additionalProperties": QUANTITY()},
            "requests": {"type": "object",
                         "additionalProperties": QUANTITY()},
        }),
        "restartPolicy": S(),
        "securityContext": container_security_context(),
        "startupProbe": probe(),
        "stdin": B(),
        "stdinOnce": B(),
        "terminationMessagePath": S(),
        "terminationMessagePolicy": S(enum=["File",
                                            "FallbackToLogsOnError"]),
        "tty": B(),
        "volumeDevices": ARR(OBJ({"devicePath": S(), "name": S()},
                                 required=["devicePath", "name"])),
        "volumeMounts": ARR(OBJ({
            "mountPath": S(),
            "mountPropagation": S(),
            "name": S(),
            "readOnly": B(),
            "recursiveReadOnly": S(),
            "subPath": S(),
            "subPathExpr": S(),
        }, required=["mountPath", "name"])),
        "workingDir": S(),
    }, required=["name"])


# ---------------------------------------------------------------- affinity
def node_selector_requirement() -> dict:
    return OBJ({
        "key": S(),
        "operator": S(enum=["In", "NotIn", "Exists", "DoesNotExist",
                            "Gt", "Lt"]),
        "values": ARR(S()),
    }, required=["key", "operator"])


def node_selector_term() -> dict:
    return OBJ({
        "matchExpressions": ARR(node_selector_requirement()),
        "matchFields": ARR(node_selector_requirement()),
    })


def node_selector() -> dict:
    return OBJ({"nodeSelectorTerms": ARR(node_selector_term())},
               required=["nodeSelectorTerms"])


def pod_affinity_term() -> dict:
    return OBJ({
        "labelSelector": label_selector(),
        "matchLabelKeys": ARR(S()),
        "mismatchLabelKeys": ARR(S()),
        "namespaceSelector": label_selector(),
        "namespaces": ARR(S()),
        "topologyKey": S(minLength=1),
    }, required=["topologyKey"])


def weighted_pod_affinity_term() -> dict:
    return OBJ({"podAffinityTerm": pod_affinity_term(), "weight": I()},
               required=["podAffinityTerm", "weight"])


def pod_affinity() -> dict:
    return OBJ({
        "preferredDuringSchedulingIgnoredDuringExecution":
            ARR(weighted_pod_affinity_term()),
        "requiredDuringSchedulingIgnoredDuringExecution":
            ARR(pod_affinity_term()),
    })


def affinity() -> dict:
    return OBJ({
        "nodeAffinity": OBJ({
            "preferredDuringSchedulingIgnoredDuringExecution": ARR(OBJ({
                "preference": node_selector_term(),
                "weight": I(),
            }, required=["preference", "weight"])),
            "requiredDuringSchedulingIgnoredDuringExecution":
                node_selector(),
        }),
        "podAffinity": pod_affinity(),
        "podAntiAffinity": pod_affinity(),
    })


def ephemeral_container() -> dict:
    """core/v1 EphemeralContainer: EphemeralContainerCommon embeds the
    Container field set (the SCHEMA carries probes/lifecycle/ports even
    though admission rejects them on ephemeral containers — same shape the
    reference CRD expansion emits) plus ``targetContainerName``."""
    schema = container_full()
    schema["properties"]["targetContainerName"] = S()
    return schema


# ----------------------------------------------------------------- volumes
def persistent_volume_claim_spec() -> dict:
    """core/v1 PersistentVolumeClaimSpec — the payload of the ``ephemeral``
    volume source's claim template."""
    typed_ref = OBJ({"apiGroup": S(), "kind": S(), "name": S()},
                    required=["kind", "name"])
    return OBJ({
        "accessModes": ARR(S()),
        "dataSource": typed_ref,
        "dataSourceRef": OBJ({"apiGroup": S(), "kind": S(), "name": S(),
                              "namespace": S()},
                             required=["kind", "name"]),
        "resources": OBJ({
            "limits": {"type": "object", "additionalProperties": QUANTITY()},
            "requests": {"type": "object",
                         "additionalProperties": QUANTITY()},
        }),
        "selector": label_selector(),
        "storageClassName": S(),
        "volumeAttributesClassName": S(),
        "volumeMode": S(enum=["Block", "Filesystem"]),
        "volumeName": S(),
    })


def ephemeral_volume_source() -> dict:
    """core/v1 EphemeralVolumeSource: an inline PVC template. The template
    metadata is the restricted embedded form (labels/annotations etc., not
    a full ObjectMeta)."""
    return OBJ({
        "volumeClaimTemplate": OBJ({
            "metadata": OBJ({
                "annotations": STR_MAP(),
                "finalizers": ARR(S()),
                "labels": STR_MAP(),
                "name": S(),
                "namespace": S(),
            }),
            "spec": persistent_volume_claim_spec(),
        }, required=["spec"]),
    })


def cluster_trust_bundle_projection() -> dict:
    """core/v1 ClusterTrustBundleProjection (projected-volume source)."""
    return OBJ({
        "labelSelector": label_selector(),
        "name": S(),
        "optional": B(),
        "path": S(),
        "signerName": S(),
    }, required=["path"])


def downward_api_items() -> dict:
    return ARR(OBJ({
        "fieldRef": object_field_selector(),
        "mode": I(),
        "path": S(),
        "resourceFieldRef": resource_field_selector(),
    }, required=["path"]))


def volume_full() -> dict:
    """Every core/v1 volume source, fully typed — including the legacy
    cloud tail — matching the reference CRD's complete controller-gen
    expansion (kubeflow.org_notebooks.yaml)."""
    typed_sources = {
        "configMap": OBJ({"defaultMode": I(), "items": ARR(key_to_path()),
                          "name": S(), "optional": B()}),
        "secret": OBJ({"defaultMode": I(), "items": ARR(key_to_path()),
                       "optional": B(), "secretName": S()}),
        "emptyDir": OBJ({"medium": S(), "sizeLimit": QUANTITY()}),
        "hostPath": OBJ({"path": S(), "type": S()}, required=["path"]),
        "nfs": OBJ({"path": S(), "readOnly": B(), "server": S()},
                   required=["path", "server"]),
        "persistentVolumeClaim": OBJ({"claimName": S(), "readOnly": B()},
                                     required=["claimName"]),
        "downwardAPI": OBJ({"defaultMode": I(),
                            "items": downward_api_items()}),
        "projected": OBJ({
            "defaultMode": I(),
            "sources": ARR(OBJ({
                "clusterTrustBundle": cluster_trust_bundle_projection(),
                "configMap": OBJ({"items": ARR(key_to_path()), "name": S(),
                                  "optional": B()}),
                "downwardAPI": OBJ({"items": downward_api_items()}),
                "secret": OBJ({"items": ARR(key_to_path()), "name": S(),
                               "optional": B()}),
                "serviceAccountToken": OBJ({"audience": S(),
                                            "expirationSeconds": I(),
                                            "path": S()},
                                           required=["path"]),
            })),
        }),
        "csi": OBJ({"driver": S(), "fsType": S(),
                    "nodePublishSecretRef": local_object_reference(),
                    "readOnly": B(),
                    "volumeAttributes": STR_MAP()}, required=["driver"]),
        "ephemeral": ephemeral_volume_source(),
        "image": OBJ({"pullPolicy": S(enum=["Always", "IfNotPresent",
                                            "Never"]),
                      "reference": S()}),
    }
    # the legacy/out-of-tree cloud sources, typed from the public core/v1
    # spec like everything else (the reference's expansion types all of
    # them; none is consumed by the controllers)
    legacy_sources = {
        "awsElasticBlockStore": OBJ({"fsType": S(), "partition": I(),
                                     "readOnly": B(), "volumeID": S()},
                                    required=["volumeID"]),
        "azureDisk": OBJ({"cachingMode": S(), "diskName": S(),
                          "diskURI": S(), "fsType": S(), "kind": S(),
                          "readOnly": B()},
                         required=["diskName", "diskURI"]),
        "azureFile": OBJ({"readOnly": B(), "secretName": S(),
                          "shareName": S()},
                         required=["secretName", "shareName"]),
        "cephfs": OBJ({"monitors": ARR(S()), "path": S(), "readOnly": B(),
                       "secretFile": S(),
                       "secretRef": local_object_reference(), "user": S()},
                      required=["monitors"]),
        "cinder": OBJ({"fsType": S(), "readOnly": B(),
                       "secretRef": local_object_reference(),
                       "volumeID": S()}, required=["volumeID"]),
        "fc": OBJ({"fsType": S(), "lun": I(), "readOnly": B(),
                   "targetWWNs": ARR(S()), "wwids": ARR(S())}),
        "flexVolume": OBJ({"driver": S(), "fsType": S(),
                           "options": STR_MAP(), "readOnly": B(),
                           "secretRef": local_object_reference()},
                          required=["driver"]),
        "flocker": OBJ({"datasetName": S(), "datasetUUID": S()}),
        "gcePersistentDisk": OBJ({"fsType": S(), "partition": I(),
                                  "pdName": S(), "readOnly": B()},
                                 required=["pdName"]),
        "gitRepo": OBJ({"directory": S(), "repository": S(),
                        "revision": S()}, required=["repository"]),
        "glusterfs": OBJ({"endpoints": S(), "path": S(), "readOnly": B()},
                         required=["endpoints", "path"]),
        "iscsi": OBJ({"chapAuthDiscovery": B(), "chapAuthSession": B(),
                      "fsType": S(), "initiatorName": S(), "iqn": S(),
                      "iscsiInterface": S(), "lun": I(),
                      "portals": ARR(S()), "readOnly": B(),
                      "secretRef": local_object_reference(),
                      "targetPortal": S()},
                     required=["iqn", "lun", "targetPortal"]),
        "photonPersistentDisk": OBJ({"fsType": S(), "pdID": S()},
                                    required=["pdID"]),
        "portworxVolume": OBJ({"fsType": S(), "readOnly": B(),
                               "volumeID": S()}, required=["volumeID"]),
        "quobyte": OBJ({"group": S(), "readOnly": B(), "registry": S(),
                        "tenant": S(), "user": S(), "volume": S()},
                       required=["registry", "volume"]),
        "rbd": OBJ({"fsType": S(), "image": S(), "keyring": S(),
                    "monitors": ARR(S()), "pool": S(), "readOnly": B(),
                    "secretRef": local_object_reference(), "user": S()},
                   required=["image", "monitors"]),
        "scaleIO": OBJ({"fsType": S(), "gateway": S(),
                        "protectionDomain": S(), "readOnly": B(),
                        "secretRef": local_object_reference(),
                        "sslEnabled": B(), "storageMode": S(),
                        "storagePool": S(), "system": S(),
                        "volumeName": S()},
                       required=["gateway", "secretRef", "system"]),
        "storageos": OBJ({"fsType": S(), "readOnly": B(),
                          "secretRef": local_object_reference(),
                          "volumeName": S(), "volumeNamespace": S()}),
        "vsphereVolume": OBJ({"fsType": S(), "storagePolicyID": S(),
                              "storagePolicyName": S(),
                              "volumePath": S()},
                             required=["volumePath"]),
    }
    props = {"name": S(minLength=1)}
    props.update(typed_sources)
    props.update(legacy_sources)
    return OBJ(props, required=["name"])


# ---------------------------------------------------------------- pod spec
def pod_security_context() -> dict:
    return OBJ({
        "appArmorProfile": app_armor_profile(),
        "fsGroup": I(),
        "fsGroupChangePolicy": S(enum=["Always", "OnRootMismatch"]),
        "runAsGroup": I(),
        "runAsNonRoot": B(),
        "runAsUser": I(),
        "seLinuxChangePolicy": S(),
        "seLinuxOptions": se_linux_options(),
        "seccompProfile": seccomp_profile(),
        "supplementalGroups": ARR(I()),
        "supplementalGroupsPolicy": S(),
        "sysctls": ARR(OBJ({"name": S(), "value": S()},
                           required=["name", "value"])),
        "windowsOptions": windows_options(),
    })


def toleration() -> dict:
    return OBJ({
        "effect": S(enum=["NoSchedule", "PreferNoSchedule", "NoExecute"]),
        "key": S(),
        "operator": S(enum=["Exists", "Equal"]),
        "tolerationSeconds": I(),
        "value": S(),
    })


def topology_spread_constraint() -> dict:
    return OBJ({
        "labelSelector": label_selector(),
        "matchLabelKeys": ARR(S()),
        "maxSkew": I(),
        "minDomains": I(),
        "nodeAffinityPolicy": S(),
        "nodeTaintsPolicy": S(),
        "topologyKey": S(),
        "whenUnsatisfiable": S(enum=["DoNotSchedule", "ScheduleAnyway"]),
    }, required=["maxSkew", "topologyKey", "whenUnsatisfiable"])


def pod_spec_schema_full() -> dict:
    """The complete core/v1 PodSpec expansion (generator output). The
    hand-typed subset in api/schema.py deep-merges ON TOP of this."""
    container = container_full()
    return OBJ({
        "activeDeadlineSeconds": I(),
        "affinity": affinity(),
        "automountServiceAccountToken": B(),
        "containers": ARR(container, minItems=1),
        "dnsConfig": OBJ({
            "nameservers": ARR(S()),
            "options": ARR(OBJ({"name": S(), "value": S()})),
            "searches": ARR(S()),
        }),
        "dnsPolicy": S(enum=["ClusterFirst", "ClusterFirstWithHostNet",
                             "Default", "None"]),
        "enableServiceLinks": B(),
        "ephemeralContainers": ARR(ephemeral_container()),
        "hostAliases": ARR(OBJ({"hostnames": ARR(S()), "ip": S()},
                               required=["ip"])),
        "hostIPC": B(),
        "hostNetwork": B(),
        "hostPID": B(),
        "hostUsers": B(),
        "hostname": S(),
        "imagePullSecrets": ARR(local_object_reference()),
        "initContainers": ARR(container),
        "nodeName": S(),
        "nodeSelector": STR_MAP(),
        "os": OBJ({"name": S()}, required=["name"]),
        "overhead": {"type": "object", "additionalProperties": QUANTITY()},
        "preemptionPolicy": S(enum=["Never", "PreemptLowerPriority"]),
        "priority": I(),
        "priorityClassName": S(),
        "readinessGates": ARR(OBJ({"conditionType": S()},
                                  required=["conditionType"])),
        "resourceClaims": ARR(OBJ({
            "name": S(),
            "resourceClaimName": S(),
            "resourceClaimTemplateName": S(),
        }, required=["name"])),
        "restartPolicy": S(enum=["Always", "OnFailure", "Never"]),
        "runtimeClassName": S(),
        "schedulerName": S(),
        "schedulingGates": ARR(OBJ({"name": S()}, required=["name"])),
        "securityContext": pod_security_context(),
        "serviceAccount": S(),
        "serviceAccountName": S(),
        "setHostnameAsFQDN": B(),
        "shareProcessNamespace": B(),
        "subdomain": S(),
        "terminationGracePeriodSeconds": I(),
        "tolerations": ARR(toleration()),
        "topologySpreadConstraints": ARR(topology_spread_constraint()),
        "volumes": ARR(volume_full()),
    }, required=["containers"])


# ------------------------------------------------------------------- merge
def merge_schema(base: dict, override: dict) -> dict:
    """Deep-merge two OpenAPI schemas: ``override`` wins on leaves,
    ``properties``/object subtrees merge recursively, arrays' item
    schemas merge. Everything else from the base survives — this is how
    the hand-typed subset refines the generated expansion without
    re-declaring it."""
    out = dict(base)
    for key, value in override.items():
        if key in ("properties",) and isinstance(value, dict) \
                and isinstance(base.get(key), dict):
            merged = dict(base[key])
            for prop, sub in value.items():
                merged[prop] = merge_schema(merged.get(prop, {}), sub) \
                    if isinstance(sub, dict) else sub
            out[key] = merged
        elif key == "items" and isinstance(value, dict) \
                and isinstance(base.get(key), dict):
            out[key] = merge_schema(base[key], value)
        elif isinstance(value, dict) and isinstance(base.get(key), dict):
            out[key] = merge_schema(base[key], value)
        else:
            out[key] = value
    return out

"""Cluster TLS security profile: fetch, fallback, watch-for-change.

The port's copy of ``kubeflow_tpu/utils/tls_profile.py``. Reference: odh
main.go boots by fetching the cluster APIServer's tlsSecurityProfile with
a bootstrap client (main.go:178-234); on any failure it falls back to a
hardened default (TLS 1.2 minimum + the Mozilla "intermediate" cipher
suite). A SecurityProfileWatcher then watches the
APIServer object and cancels the manager context when the profile changes
(main.go:344-367) — the process restarts and re-reads the profile, the
simplest correct way to re-key every listener (webhook + metrics servers).

Same design here: ``fetch_apiserver_tls_profile`` → ``TLSProfile``;
``SecurityProfileWatcher`` invokes a restart callback on change. The profile
feeds the AdmissionServer's ssl.SSLContext.
"""

from __future__ import annotations

import logging
import ssl
import threading
from dataclasses import dataclass, field

log = logging.getLogger("kubeflow_tpu_torch.tls")

APISERVER_KIND = "APIServer"

# Mozilla "intermediate" compatibility ciphers — the reference's fallback set
# (crypto/tls names translated to OpenSSL names for ssl.SSLContext)
MOZILLA_INTERMEDIATE_CIPHERS = (
    "ECDHE-ECDSA-AES128-GCM-SHA256:ECDHE-RSA-AES128-GCM-SHA256:"
    "ECDHE-ECDSA-AES256-GCM-SHA384:ECDHE-RSA-AES256-GCM-SHA384:"
    "ECDHE-ECDSA-CHACHA20-POLY1305:ECDHE-RSA-CHACHA20-POLY1305"
)

_TLS_VERSIONS = {
    "VersionTLS10": ssl.TLSVersion.TLSv1,
    "VersionTLS11": ssl.TLSVersion.TLSv1_1,
    "VersionTLS12": ssl.TLSVersion.TLSv1_2,
    "VersionTLS13": ssl.TLSVersion.TLSv1_3,
}

# the four profile types of the OpenShift API (config.openshift.io/v1
# TLSSecurityProfile): old / intermediate / modern / custom
_PROFILE_PRESETS = {
    "Old": ("VersionTLS10", None),           # None = library defaults
    "Intermediate": ("VersionTLS12", MOZILLA_INTERMEDIATE_CIPHERS),
    "Modern": ("VersionTLS13", None),        # 1.3 suites are not configurable
}


@dataclass
class TLSProfile:
    min_version: str = "VersionTLS12"
    ciphers: str | None = MOZILLA_INTERMEDIATE_CIPHERS
    source: str = "fallback"
    raw: dict = field(default_factory=dict)

    def apply(self, ctx: ssl.SSLContext) -> None:
        ctx.minimum_version = _TLS_VERSIONS.get(self.min_version,
                                                ssl.TLSVersion.TLSv1_2)
        if self.ciphers and ctx.minimum_version < ssl.TLSVersion.TLSv1_3:
            try:
                ctx.set_ciphers(self.ciphers)
            except ssl.SSLError:
                log.warning("cipher list rejected, keeping defaults: %s",
                            self.ciphers)


def hardened_fallback() -> TLSProfile:
    return TLSProfile()


def fetch_apiserver_tls_profile(client) -> TLSProfile:
    """Read APIServer/cluster .spec.tlsSecurityProfile; ANY failure →
    hardened fallback (the reference logs and proceeds, never crashes boot)."""
    try:
        apiserver = client.get_or_none(APISERVER_KIND, "", "cluster")
    except Exception as exc:  # noqa: BLE001 — unreachable apiserver at boot
        log.warning("could not fetch APIServer config: %s; using fallback",
                    exc)
        return hardened_fallback()
    if apiserver is None:
        return hardened_fallback()
    profile = (apiserver.get("spec") or {}).get("tlsSecurityProfile") or {}
    return parse_profile(profile)


def parse_profile(profile: dict) -> TLSProfile:
    ptype = profile.get("type")
    if ptype in _PROFILE_PRESETS:
        min_v, ciphers = _PROFILE_PRESETS[ptype]
        return TLSProfile(min_version=min_v, ciphers=ciphers,
                          source=ptype.lower(), raw=profile)
    if ptype == "Custom":
        custom = profile.get("custom") or {}
        ciphers = ":".join(custom.get("ciphers") or []) or None
        return TLSProfile(
            min_version=custom.get("minTLSVersion", "VersionTLS12"),
            ciphers=ciphers, source="custom", raw=profile)
    return hardened_fallback()


class SecurityProfileWatcher:
    """Watches the APIServer object; when the effective profile differs from
    the one the process booted with, invokes ``on_change`` (production: a
    graceful-shutdown trigger so the pod restarts with the new profile —
    reference cancels the manager context, main.go:344-367)."""

    def __init__(self, client, booted_profile: TLSProfile,
                 on_change) -> None:
        self.client = client
        self.booted = booted_profile
        self.on_change = on_change
        self._fired = threading.Event()

    def setup(self) -> None:
        self.client.watch(APISERVER_KIND, self._handle)
        # the watch delivers no initial state (store.watch registers a
        # callback only), so self-correct immediately: if boot fetched the
        # fallback because of a transient error while the cluster actually
        # pins a different profile, fire now rather than waiting for the
        # next write to APIServer/cluster
        current = fetch_apiserver_tls_profile(self.client)
        if (current.min_version, current.ciphers) != (
                self.booted.min_version, self.booted.ciphers):
            log.warning("booted TLS profile (%s) does not match cluster "
                        "profile (%s); requesting restart",
                        self.booted.source, current.source)
            self._fired.set()
            self.on_change()

    def _handle(self, event) -> None:
        if self._fired.is_set():
            return
        obj = event.obj
        if (obj.get("metadata") or {}).get("name") != "cluster":
            return
        new = parse_profile((obj.get("spec") or {})
                            .get("tlsSecurityProfile") or {})
        if (new.min_version, new.ciphers) != (self.booted.min_version,
                                              self.booted.ciphers):
            log.warning("cluster TLS profile changed (%s → %s); requesting "
                        "restart", self.booted.source, new.source)
            self._fired.set()
            self.on_change()

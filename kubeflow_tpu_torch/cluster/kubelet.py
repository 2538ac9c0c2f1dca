"""StatefulSet-controller + kubelet + node-lifecycle simulator.

The port's copy of ``kubeflow_tpu/cluster/kubelet.py``. envtest "has no
scheduler/kubelet, so pods never run"; this simulator reconciles
StatefulSets into Pods and marks them Ready after a configurable boot
delay, so the full CR → SliceReady loop runs in-process. It reproduces
the StatefulSet semantics the slice layer leans on:

- pods named ``<sts>-<ordinal>`` with the ``apps.kubernetes.io/pod-index``
  label (the TPU_WORKER_ID source);
- ``spec.subdomain``/``serviceName`` so worker DNS is representable;
- scale-down reaps the highest ordinals first; replicas=0 reaps everything
  (the slice-atomic cull path);
- pod template changes restart pods.

``ready_hook(pod) -> bool`` gates a pod's readiness on what the caller
checks: chip_smoke.py marks worker 0 ready only once ``initialize_slice``
and ``verify_slice`` have formed its NCCL world on the card.

Node lifecycle: every pod is bound to a ``Node`` object
(``spec.nodeName``; one node per worker). A pod on a dead node (NotReady,
NoExecute-tainted, or deleted) flips Ready=False within one reconcile,
and after ``node_grace_s`` it is evicted; the recreate binds a fresh node
and keeps the pod's name and ordinal. A NoSchedule taint (a preemption
notice) leaves running pods Ready but blocks new bindings. Plain
``threading`` locks stand in for the reference's tracked ones.
"""

from __future__ import annotations

import heapq
import threading
import time

from ..controllers.manager import Request, Result, owner_mapper
from ..utils import k8s, names
from . import errors
from .cache import pods_on_node
from .store import ClusterStore


class _BootScheduler:
    """Event-driven pod-boot timer wheel: one thread, one heap of
    (due, ns, pod) entries, batched readiness flips at each deadline.

    The polled alternative — every StatefulSet requeueing at
    boot_delay/4 until its pods turn Ready — costs O(pods × polls)
    reconciles, which at a 100k-pod soak is millions of no-op dispatches.
    Here each booting pod costs exactly ONE timer entry and one status
    write; the Ready flip's watch event drives the STS reconcile that
    observes it (tick → event, not tick → poll)."""

    def __init__(self, mark_ready) -> None:
        self._mark_ready = mark_ready  # fn(ns, pod_name) -> None
        self._heap: list[tuple[float, str, str]] = []
        self._cv = threading.Condition()
        self._thread: threading.Thread | None = None

    #: an empty wheel parks this long before its thread exits — bounds
    #: idle daemon threads (one per simulator) without lifecycle plumbing;
    #: the next schedule() simply restarts the thread
    IDLE_EXIT_S = 5.0

    def schedule(self, due: float, namespace: str, pod_name: str) -> None:
        with self._cv:
            heapq.heappush(self._heap, (due, namespace, pod_name))
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._loop, daemon=True,
                    name="kubelet-boot-scheduler")
                self._thread.start()
            self._cv.notify()

    def _loop(self) -> None:
        while True:  # pump: boot scheduler cv-wait; idle-exit after IDLE_EXIT_S
            due_batch: list[tuple[str, str]] = []
            with self._cv:
                now = time.monotonic()
                while self._heap and self._heap[0][0] <= now:
                    _, ns, pod = heapq.heappop(self._heap)
                    due_batch.append((ns, pod))
                if not due_batch:
                    if self._heap:
                        self._cv.wait(self._heap[0][0] - now)
                        continue
                    self._cv.wait(self.IDLE_EXIT_S)
                    if not self._heap:
                        # idle past the grace: exit rather than pin this
                        # simulator (and its client) via a parked thread
                        # forever; schedule() restarts on demand
                        self._thread = None
                        return
                    continue
            for ns, pod in due_batch:
                try:
                    self._mark_ready(ns, pod)
                except Exception:  # noqa: BLE001 — a single pod's flip
                    pass           # failing must not stall the wheel


def node_doomed(node: dict | None) -> bool:
    """Pods on this node are lost: node gone, NotReady, or NoExecute-tainted
    (the taint manager's eviction trigger). A NoSchedule-only taint — the
    preemption NOTICE — does not doom running pods."""
    if node is None or not k8s.condition_true(node, "Ready"):
        return True
    return any(t.get("effect") == "NoExecute"
               for t in k8s.get_in(node, "spec", "taints", default=[]) or [])


def node_schedulable(node: dict | None) -> bool:
    """New pods may bind here: Ready, untainted, not cordoned."""
    if node is None or not k8s.condition_true(node, "Ready"):
        return False
    if k8s.get_in(node, "spec", "unschedulable"):
        return False
    return not (k8s.get_in(node, "spec", "taints", default=[]) or [])


# ------------------------------------------------------- injection helpers
def set_node_ready(client, node_name: str, ready: bool,
                   reason: str = "KubeletStopped") -> None:
    node = client.get("Node", "", node_name)
    node["status"] = node.get("status") or {}
    node["status"]["conditions"] = [
        {"type": "Ready", "status": "True" if ready else "False",
         "reason": "KubeletReady" if ready else reason,
         "lastTransitionTime": k8s.now_iso()}]
    client.update_status(node)


def taint_node(client, node_name: str,
               key: str = names.PREEMPTION_TAINT_KEY,
               effect: str = "NoSchedule") -> None:
    node = client.get("Node", "", node_name)
    taints = k8s.get_in(node, "spec", "taints", default=[]) or []
    if not any(t.get("key") == key for t in taints):
        taints.append({"key": key, "effect": effect,
                       "timeAdded": k8s.now_iso()})
        node.setdefault("spec", {})["taints"] = taints
        client.update(node)


def preempt_node(client, node_name: str) -> None:
    """GCE/GKE preemption notice: the node keeps serving but termination is
    imminent (ACPI G2 / maintenance event)."""
    taint_node(client, node_name, names.PREEMPTION_TAINT_KEY, "NoSchedule")


def kill_node(client, node_name: str) -> None:
    """The termination itself: kubelet stops posting status (NotReady) and
    the taint manager marks it unreachable/NoExecute."""
    taint_node(client, node_name, names.NODE_UNREACHABLE_TAINT_KEY,
               "NoExecute")
    set_node_ready(client, node_name, False, reason="NodeStatusUnknown")


class StatefulSetSimulator:
    name = "sim-statefulset-controller"

    def __init__(self, client: ClusterStore, boot_delay_s: float = 0.0,
                 ready_hook=None, manage_nodes: bool = True,
                 node_grace_s: float = 0.25,
                 event_driven_boot: bool = False,
                 wall_clock=time.time):
        """``ready_hook(pod) -> bool`` lets tests/bench gate pod readiness on
        e.g. the runtime's slice verification. ``manage_nodes`` binds
        every pod to a simulated Node and runs the node-lifecycle behavior
        described in the module docstring; ``node_grace_s`` is the
        NotReady→eviction window (the pod-eviction-timeout analog,
        wall-clock seconds). ``event_driven_boot`` replaces the
        boot_delay/4 polling requeues with a timer-wheel readiness flip
        (_BootScheduler) — one scheduled event per pod instead of
        O(polls), the 100k-pod soak shape; a ``ready_hook`` keeps the
        polled path (its answer can change between polls)."""
        self.client = client
        self.boot_delay_s = boot_delay_s
        self.ready_hook = ready_hook
        self.manage_nodes = manage_nodes
        self.node_grace_s = node_grace_s
        self.event_driven_boot = event_driven_boot and ready_hook is None
        # injected wall clock for status timestamps (startedAt): logic
        # timing stays monotonic; only the rendered RFC3339 stamps differ
        self.wall_clock = wall_clock
        self._boot_scheduler = _BootScheduler(self._boot_pod_ready) \
            if self.event_driven_boot else None
        self._boot_times: dict[tuple[str, str], float] = {}
        # (ns, pod) → node generation; bumped when the bound node dies so
        # the recreate lands on fresh capacity
        self._node_gen: dict[tuple[str, str], int] = {}
        # (ns, pod) → monotonic time its node was first seen doomed
        self._node_down_since: dict[tuple[str, str], float] = {}

    def setup(self, mgr) -> None:
        mgr.register(self)
        mgr.watch("StatefulSet", self.name)
        mgr.watch("Pod", self.name, mapper=owner_mapper("StatefulSet"))
        if self.manage_nodes:
            mgr.watch("Node", self.name, mapper=self._node_to_sts)

    def _node_to_sts(self, node: dict) -> list[Request]:
        """Node event → the StatefulSets with pods bound to it
        (cache.pods_on_node: the by-field ``spec.nodeName`` index when the
        client carries one, O(pods on this node))."""
        out, seen = [], set()
        for pod in pods_on_node(self.client, k8s.name(node)):
            for ref in k8s.get_in(pod, "metadata", "ownerReferences",
                                  default=[]) or []:
                if ref.get("kind") == "StatefulSet":
                    key = (k8s.namespace(pod), ref.get("name"))
                    if key not in seen:
                        seen.add(key)
                        out.append(Request(*key))
        return out

    def reconcile(self, req: Request) -> Result | None:
        sts = self.client.get_or_none("StatefulSet", req.namespace, req.name)
        if sts is None or k8s.is_deleting(sts):
            return None
        replicas = k8s.get_in(sts, "spec", "replicas", default=1)
        ns, sts_name = req.namespace, req.name
        selector = k8s.get_in(sts, "spec", "template", "metadata", "labels",
                              default={}) or {}
        desired_template = k8s.get_in(sts, "spec", "template", default={})

        # list by spec.selector.matchLabels — IMMUTABLE in real apps/v1,
        # unlike the template labels, which the notebook reconciler
        # rewrites on label edits (copy_statefulset_fields) — so the
        # per-reconcile cost is O(this STS's pods), not O(pods in ns):
        # the informer-index shape of the real STS controller. At a 500-
        # notebook fan-out the unselected list made the simulator O(N²)
        # and dominated the loadtest wall clock. Ownership stays the
        # source of truth; an empty selector falls back to the full list.
        pod_selector = k8s.get_in(sts, "spec", "selector", "matchLabels",
                                  default=None) or None
        requeue: float | None = None
        existing = {k8s.name(p): p
                    for p in self.client.list("Pod", ns,
                                              label_selector=pod_selector)
                    if k8s.is_owned_by(p, k8s.uid(sts))}

        # reap pods beyond replicas (highest ordinals first — STS semantics)
        for pod_name in sorted(existing, reverse=True):
            ordinal = _ordinal_of(pod_name, sts_name)
            if ordinal is None or ordinal >= replicas:
                try:
                    self.client.delete("Pod", ns, pod_name)
                except errors.NotFoundError:
                    pass
                existing.pop(pod_name, None)

        for i in range(replicas):
            pod_name = f"{sts_name}-{i}"
            pod = existing.get(pod_name)
            if pod is None:
                pod = self._make_pod(sts, pod_name, i, selector, desired_template)
                try:
                    self.client.create(pod)
                except errors.AlreadyExistsError:
                    pass
                now = time.monotonic()
                self._boot_times[(ns, pod_name)] = now
                if self._boot_scheduler is not None:
                    # event-driven: ONE timer entry flips this pod Ready
                    # at its boot deadline; the requeue below is only a
                    # lost-event safety net, not the readiness poll
                    self._boot_scheduler.schedule(now + self.boot_delay_s,
                                                  ns, pod_name)
                    requeue = max(self.boot_delay_s * 2, 0.25)
                else:
                    requeue = max(self.boot_delay_s, 0.001)
                continue
            # template drift → restart (delete; next pass recreates)
            if pod.get("spec", {}).get("containers") != \
                    k8s.get_in(desired_template, "spec", "containers"):
                try:
                    self.client.delete("Pod", ns, pod_name)
                except errors.NotFoundError:
                    pass
                requeue = 0.001
                continue
            if self.manage_nodes:
                node_requeue = self._apply_node_health(ns, pod)
                if node_requeue is not None:
                    requeue = min(requeue, node_requeue) \
                        if requeue else node_requeue
                    continue  # doomed node: never (re)mark this pod Ready
            if not _pod_is_ready(pod):
                booted_at = self._boot_times.get((ns, pod_name), 0.0)
                if time.monotonic() - booted_at >= self.boot_delay_s and (
                        self.ready_hook is None or self.ready_hook(pod)):
                    self._mark_ready(pod)
                elif self._boot_scheduler is not None:
                    # scheduler owns the flip; safety-net requeue only
                    requeue = max(self.boot_delay_s * 2, 0.25)
                else:
                    requeue = max(self.boot_delay_s / 4, 0.001)

        ready = sum(1 for p in self.client.list(
                        "Pod", ns, label_selector=pod_selector)
                    if k8s.is_owned_by(p, k8s.uid(sts)) and _pod_is_ready(p))
        if k8s.get_in(sts, "status", "readyReplicas") != ready or \
                k8s.get_in(sts, "status", "replicas") != replicas:
            sts["status"] = {"replicas": replicas, "readyReplicas": ready,
                             "currentReplicas": ready}
            try:
                self.client.update_status(sts)
            except (errors.ConflictError, errors.NotFoundError):
                requeue = 0.001
        return Result(requeue_after=requeue) if requeue else None

    # ------------------------------------------------------ node lifecycle
    def _apply_node_health(self, ns: str, pod: dict) -> float | None:
        """Node-lifecycle-controller behavior for one pod. Returns a
        requeue delay while the pod is riding out its node's death (the
        caller must then skip ready-marking), or None when the node is
        fine."""
        pod_name = k8s.name(pod)
        node_name = k8s.get_in(pod, "spec", "nodeName")
        if not node_name:
            return None  # pre-node-era pod (external creation): no binding
        key = (ns, pod_name)
        node = self.client.get_or_none("Node", "", node_name)
        if not node_doomed(node):
            self._node_down_since.pop(key, None)
            return None
        first = self._node_down_since.setdefault(key, time.monotonic())
        if _pod_is_ready(pod):
            # within one reconcile tick of the node dying
            self._mark_not_ready(pod, "NodeNotReady")
        if time.monotonic() - first >= self.node_grace_s:
            # eviction: the pod object goes away; the recreate pass binds
            # the SAME pod name (ordinal/hostname preserved) to new capacity
            try:
                self.client.delete("Pod", ns, pod_name)
            except errors.NotFoundError:
                pass
            self._node_down_since.pop(key, None)
            return 0.001
        return max(self.node_grace_s / 4, 0.001)

    def _bind_node(self, ns: str, pod_name: str) -> str:
        """Current-generation node for this worker, skipping dead/cordoned
        ones (GKE replaces preempted capacity with fresh nodes; the pod
        name — and with it TPU_WORKER_ID and the stable hostname — never
        changes)."""
        key = (ns, pod_name)
        gen = self._node_gen.get(key, 0)
        while True:  # bounded: gen increments until a fresh node name creates
            node_name = f"sim-node-{ns}-{pod_name}-{gen}"
            node = self.client.get_or_none("Node", "", node_name)
            if node is None:
                try:
                    self.client.create({
                        "apiVersion": "v1",
                        "kind": "Node",
                        "metadata": {
                            "name": node_name,
                            "labels": {names.SIM_NODE_LABEL: "true"},
                        },
                        "spec": {},
                        "status": {"conditions": [
                            {"type": "Ready", "status": "True",
                             "reason": "KubeletReady"}]},
                    })
                except errors.AlreadyExistsError:
                    continue  # raced another worker; re-read next loop
                self._node_gen[key] = gen
                return node_name
            if node_schedulable(node):
                self._node_gen[key] = gen
                return node_name
            gen += 1

    def _make_pod(self, sts: dict, pod_name: str, ordinal: int,
                  selector: dict, template: dict) -> dict:
        pod_labels = dict(selector)
        pod_labels[names.POD_INDEX_LABEL] = str(ordinal)
        pod = {
            "apiVersion": "v1",
            "kind": "Pod",
            "metadata": {
                "name": pod_name,
                "namespace": k8s.namespace(sts),
                "labels": pod_labels,
                "annotations": dict(k8s.get_in(
                    template, "metadata", "annotations", default={}) or {}),
            },
            "spec": k8s.deepcopy(template.get("spec", {})),
            "status": {"phase": "Pending", "conditions": []},
        }
        pod["spec"]["hostname"] = pod_name
        pod["spec"]["subdomain"] = k8s.get_in(sts, "spec", "serviceName",
                                              default="")
        if self.manage_nodes:
            pod["spec"]["nodeName"] = self._bind_node(k8s.namespace(sts),
                                                      pod_name)
        k8s.set_controller_reference(sts, pod)
        return pod

    def _boot_pod_ready(self, ns: str, pod_name: str) -> None:
        """Timer-wheel readiness flip (event-driven boot): re-read the pod
        at its boot deadline and mark it Ready unless it vanished, already
        turned Ready, sits on a doomed node (the node path owns those —
        the STS reconcile keeps its safety-net requeue either way), or was
        RECREATED since this timer was scheduled — a restart re-stamps
        ``_boot_times`` and schedules a fresh timer, and the predecessor's
        stale timer must not flip the replacement Ready mid-boot."""
        pod = self.client.get_or_none("Pod", ns, pod_name)
        if pod is None or _pod_is_ready(pod):
            return
        booted_at = self._boot_times.get((ns, pod_name), 0.0)
        if time.monotonic() < booted_at + self.boot_delay_s:
            return  # a newer incarnation's timer owns this flip
        if self.manage_nodes:
            node_name = k8s.get_in(pod, "spec", "nodeName")
            if node_name and node_doomed(
                    self.client.get_or_none("Node", "", node_name)):
                return
        self._mark_ready(pod)

    def _mark_ready(self, pod: dict) -> None:
        now = time.strftime("%Y-%m-%dT%H:%M:%SZ",
                            time.gmtime(self.wall_clock()))
        container_statuses = [
            {"name": c.get("name", ""), "ready": True, "restartCount": 0,
             "state": {"running": {"startedAt": now}}}
            for c in k8s.get_in(pod, "spec", "containers", default=[]) or []]
        pod["status"] = {
            "phase": "Running",
            "conditions": [
                {"type": "PodScheduled", "status": "True"},
                {"type": "Initialized", "status": "True"},
                {"type": "ContainersReady", "status": "True"},
                {"type": "Ready", "status": "True",
                 "lastTransitionTime": now},
            ],
            "containerStatuses": container_statuses,
        }
        try:
            self.client.update_status(pod)
        except (errors.ConflictError, errors.NotFoundError):
            pass

    def _mark_not_ready(self, pod: dict, reason: str) -> None:
        now = k8s.now_iso()
        pod = k8s.deepcopy(pod)
        conditions = [c for c in k8s.get_in(pod, "status", "conditions",
                                            default=[]) or []
                      if c.get("type") not in ("Ready", "ContainersReady")]
        conditions += [
            {"type": "ContainersReady", "status": "False", "reason": reason},
            {"type": "Ready", "status": "False", "reason": reason,
             "lastTransitionTime": now},
        ]
        pod.setdefault("status", {})["conditions"] = conditions
        try:
            self.client.update_status(pod)
        except (errors.ConflictError, errors.NotFoundError):
            pass


def _ordinal_of(pod_name: str, sts_name: str) -> int | None:
    prefix = sts_name + "-"
    if not pod_name.startswith(prefix):
        return None
    suffix = pod_name[len(prefix):]
    return int(suffix) if suffix.isdigit() else None


def _pod_is_ready(pod: dict) -> bool:
    return k8s.condition_true(pod, "Ready")

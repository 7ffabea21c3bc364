"""Kubernetes pod collector.

Reference parity (monitor_server.js:97-114 ``getK8sPods``): per pod
namespace, name, phase, restart count summed over containerStatuses
(:104), humanized age from status.startTime (:106-110). The reference
shells out ``execSync('kubectl get pods -A -o json')`` on the event loop
(:99) — SURVEY §2.1 flags a hung kubectl freezing the whole server.

tpumon talks to the Kubernetes API directly (in-cluster service-account
auth, or any configured API URL), with an *async subprocess* kubectl
fallback for dev boxes. Parsing is a pure function over the PodList JSON
so golden-input tests (SURVEY §4.1) cover containerStatuses edge cases.

TPU additions: each pod record carries slice/topology metadata when
present (GKE TPU nodeSelectors, JobSet labels) so the alert engine can
map pods -> slices (SURVEY §2.5 "pod-slice topology awareness").
"""

from __future__ import annotations

import asyncio
import datetime as dt
import json
import os
import ssl
import urllib.request
from dataclasses import dataclass

from tpumon_torch.collectors import Sample

SA_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"

# GKE TPU-related pod/node metadata keys (labels & nodeSelector).
TPU_TOPOLOGY_KEY = "cloud.google.com/gke-tpu-topology"
TPU_ACCEL_KEY = "cloud.google.com/gke-tpu-accelerator"
JOBSET_NAME_KEY = "jobset.sigs.k8s.io/jobset-name"
JOB_INDEX_KEY = "batch.kubernetes.io/job-completion-index"


def humanize_age(seconds: float) -> str:
    """Humanize like the reference (monitor_server.js:106-110): days if
    >=1d, hours if >=1h, else minutes."""
    if seconds >= 86400:
        return f"{int(seconds // 86400)}d"
    if seconds >= 3600:
        return f"{int(seconds // 3600)}h"
    return f"{max(0, int(seconds // 60))}m"


def _parse_k8s_time(text: str) -> float | None:
    try:
        return dt.datetime.fromisoformat(text.replace("Z", "+00:00")).timestamp()
    except (ValueError, AttributeError):
        return None


def parse_pod_list(obj: dict, now: float | None = None) -> list[dict]:
    """Pure parser over a K8s PodList JSON document."""
    now = dt.datetime.now(dt.timezone.utc).timestamp() if now is None else now
    pods: list[dict] = []
    for item in obj.get("items", []):
        meta = item.get("metadata", {}) or {}
        status = item.get("status", {}) or {}
        spec = item.get("spec", {}) or {}
        # Restarts summed over containerStatuses (monitor_server.js:104);
        # containerStatuses may be absent for Pending pods.
        restarts = sum(
            cs.get("restartCount", 0) for cs in status.get("containerStatuses") or []
        )
        start = _parse_k8s_time(status.get("startTime"))
        age_s = max(0.0, now - start) if start is not None else None
        labels = meta.get("labels") or {}
        node_selector = spec.get("nodeSelector") or {}
        phase = status.get("phase", "Unknown")
        # TPU chips requested (google.com/tpu), summed over containers —
        # the basis for pod->chip attribution in the accel view.
        tpu_request = 0
        for ctr in spec.get("containers") or []:
            res = ctr.get("resources") or {}
            v = (res.get("requests") or {}).get("google.com/tpu") or (
                res.get("limits") or {}
            ).get("google.com/tpu")
            try:
                tpu_request += int(v)
            except (TypeError, ValueError):
                pass
        # Surface container-level waiting/terminated reasons (CrashLoopBackOff,
        # OOMKilled, ...) the reference can't see — it only looks at phase.
        reason = status.get("reason")
        for cs in status.get("containerStatuses") or []:
            state = cs.get("state") or {}
            last_state = cs.get("lastState") or {}
            waiting = state.get("waiting") or {}
            terminated = state.get("terminated") or last_state.get("terminated") or {}
            if waiting.get("reason"):
                reason = waiting["reason"]
                break
            term_reason = terminated.get("reason")
            if term_reason and term_reason != "Completed":
                reason = term_reason
                break
        pods.append(
            {
                "namespace": meta.get("namespace", ""),
                "name": meta.get("name", ""),
                "status": phase,
                "reason": reason,
                "restarts": restarts,
                "age": humanize_age(age_s) if age_s is not None else "",
                "age_s": age_s,
                "node": spec.get("nodeName"),
                "tpu_request": tpu_request,
                "tpu_topology": node_selector.get(TPU_TOPOLOGY_KEY),
                "tpu_accelerator": node_selector.get(TPU_ACCEL_KEY),
                "jobset": labels.get(JOBSET_NAME_KEY),
                "job_index": labels.get(JOB_INDEX_KEY),
            }
        )
    return pods


# --------------------------------------------------------------------------
# Pod sources
# --------------------------------------------------------------------------


@dataclass
class ApiPodSource:
    """Reads /api/v1/pods from a Kubernetes API server.

    In-cluster: uses the mounted service-account token + CA. Out of
    cluster: any api_url (e.g. a `kubectl proxy` or a test fake) works
    unauthenticated over http.
    """

    api_url: str | None = None
    timeout_s: float = 5.0

    def _resolve(self) -> tuple[str, dict[str, str], ssl.SSLContext | None]:
        if self.api_url:
            return self.api_url, {}, None
        host = os.environ.get("KUBERNETES_SERVICE_HOST")
        port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
        if not host:
            raise RuntimeError("not in-cluster (KUBERNETES_SERVICE_HOST unset)")
        headers = {}
        token_path = os.path.join(SA_DIR, "token")
        if os.path.exists(token_path):
            with open(token_path) as f:
                headers["Authorization"] = f"Bearer {f.read().strip()}"
        ctx = None
        ca_path = os.path.join(SA_DIR, "ca.crt")
        if os.path.exists(ca_path):
            ctx = ssl.create_default_context(cafile=ca_path)
        return f"https://{host}:{port}", headers, ctx

    def _fetch(self) -> dict:
        base, headers, ctx = self._resolve()
        req = urllib.request.Request(f"{base}/api/v1/pods", headers=headers)
        with urllib.request.urlopen(req, timeout=self.timeout_s, context=ctx) as r:
            return json.load(r)

    async def fetch_pod_list(self) -> dict:
        return await asyncio.to_thread(self._fetch)


class PodWatcher:
    """Live pod map via the Kubernetes watch API (chunked event stream).

    Poll-based collection — the reference's model and our ApiPodSource —
    sees only poll-boundary states: a pod that fails and recovers inside
    one sample interval is invisible (SURVEY §2.2 calls this out). The
    watcher holds one long-lived ``?watch=1`` stream, applies
    ADDED/MODIFIED/DELETED events to an in-memory pod map, and records
    every phase a pod passes through between collector samples; the
    collector surfaces those as ``interim_phases`` so the alert engine
    can flag a pod that flapped through Failed even though it is Running
    again by sample time. Reconnects with backoff on stream drop,
    re-listing to resync (last_error says why the previous stream died).
    """

    def __init__(self, api_url: str | None = None,
                 reconnect_delay_s: float = 1.0):
        import threading

        self.api_url = api_url
        self.reconnect_delay_s = reconnect_delay_s
        self._lock = threading.Lock()
        self._pods: dict[str, dict] = {}
        self._interim: dict[str, list[str]] = {}
        self._synced = False
        self.last_error: str | None = None
        self._stop = threading.Event()
        self._thread: "threading.Thread | None" = None
        self.reconnects = 0

    # -- stream plumbing ---------------------------------------------------

    def _resolve(self):
        return ApiPodSource(api_url=self.api_url)._resolve()

    def _list_once(self) -> str:
        # Delegates to the poll source so the /api/v1/pods request path
        # (auth, TLS, timeouts) exists exactly once.
        doc = ApiPodSource(api_url=self.api_url)._fetch()
        with self._lock:
            self._pods = {self._key(p): p for p in doc.get("items", [])}
            self._synced = True
        return doc.get("metadata", {}).get("resourceVersion", "0")

    @staticmethod
    def _key(item: dict) -> str:
        md = item.get("metadata", {})
        return f"{md.get('namespace', 'default')}/{md.get('name', '?')}"

    def _apply(self, event: dict) -> str | None:
        """Apply one watch event; returns its resourceVersion (for
        resume), or raises on ERROR (forces a re-list — the standard
        410 Gone / expired-resourceVersion protocol)."""
        kind = event.get("type")
        item = event.get("object") or {}
        if kind == "ERROR":
            raise RuntimeError(
                f"watch ERROR event: {json.dumps(item)[:120]}")
        if kind not in ("ADDED", "MODIFIED", "DELETED"):
            return None  # BOOKMARK etc.: nothing to apply
        key = self._key(item)
        with self._lock:
            if kind == "DELETED":
                self._pods.pop(key, None)
                self._interim.setdefault(key, []).append("Deleted")
            else:
                prev_phase = (self._pods.get(key) or {}).get(
                    "status", {}).get("phase")
                self._pods[key] = item
                phase = item.get("status", {}).get("phase")
                if phase and phase != prev_phase:
                    self._interim.setdefault(key, []).append(phase)
        return item.get("metadata", {}).get("resourceVersion")

    def _watch_stream(self, rv: str) -> str:
        """One watch connection; returns the last event's rv (resume
        point) on clean server-side timeout."""
        base, headers, ctx = self._resolve()
        # Server-side timeoutSeconds ends quiet streams cleanly so an
        # idle cluster doesn't register as an error; the client timeout
        # is just the backstop for a hung connection.
        url = (f"{base}/api/v1/pods?watch=1&resourceVersion={rv}"
               "&timeoutSeconds=300")
        req = urllib.request.Request(url, headers=headers)
        with urllib.request.urlopen(req, timeout=330, context=ctx) as r:
            for line in r:
                if self._stop.is_set():
                    return rv
                line = line.strip()
                if line:
                    rv = self._apply(json.loads(line)) or rv
        return rv

    def _run(self) -> None:
        rv: str | None = None
        while not self._stop.is_set():
            try:
                if rv is None:
                    rv = self._list_once()
                self.last_error = None
                rv = self._watch_stream(rv)
                # Clean stream end: resume from the last seen rv with
                # no re-list and no error/backoff.
                continue
            except Exception as e:
                self.last_error = f"{type(e).__name__}: {e}"
                rv = None  # full resync on reconnect
            if self._stop.is_set():
                return
            self.reconnects += 1
            self._stop.wait(self.reconnect_delay_s)

    # -- public API --------------------------------------------------------

    def start(self) -> None:
        import threading

        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="tpumon-pod-watch")
        self._thread.start()

    def stop(self) -> None:
        """Stop the watch thread and wait (bounded) for it to exit.
        Terminal: a stopped watcher stays stopped — the collector
        builds a fresh one if watching resumes. The join timeout is
        deliberate: a thread blocked inside the watch read can't be
        interrupted mid-``urlopen`` (it notices the stop event at the
        next line/reconnect), so the wait is bounded and the daemon
        flag guarantees the stragglers can't pin process exit."""
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0)

    @property
    def synced(self) -> bool:
        return self._synced

    def snapshot(self) -> tuple[dict, dict[str, list[str]]]:
        """Current PodList document + drained interim phase excursions
        (phases each pod passed through since the previous snapshot)."""
        with self._lock:
            doc = {"kind": "PodList",
                   "items": [dict(p) for p in self._pods.values()]}
            interim, self._interim = self._interim, {}
        return doc, interim


@dataclass
class KubectlPodSource:
    """Async-subprocess kubectl fallback (never blocks the event loop,
    unlike the reference's execSync at monitor_server.js:99)."""

    timeout_s: float = 10.0

    async def fetch_pod_list(self) -> dict:
        proc = await asyncio.create_subprocess_exec(
            "kubectl",
            "get",
            "pods",
            "-A",
            "-o",
            "json",
            stdout=asyncio.subprocess.PIPE,
            stderr=asyncio.subprocess.PIPE,
        )
        try:
            stdout, stderr = await asyncio.wait_for(
                proc.communicate(), timeout=self.timeout_s
            )
        except asyncio.TimeoutError:
            proc.kill()
            raise RuntimeError(f"kubectl timed out after {self.timeout_s}s")
        if proc.returncode != 0:
            raise RuntimeError(f"kubectl failed: {stderr.decode(errors='replace')[:200]}")
        return json.loads(stdout)


@dataclass
class FakePodSource:
    """Synthetic PodList for demo mode and tests: a JetStream serving set,
    system pods, a perpetually-Pending pod and a slow crash-looper whose
    restart count climbs — enough to exercise every pod alert rule."""

    clock: object = None

    def _start(self, now: float, age_s: float) -> str:
        t = dt.datetime.fromtimestamp(now - age_s, dt.timezone.utc)
        return t.isoformat().replace("+00:00", "Z")

    async def fetch_pod_list(self) -> dict:
        import time as _time

        now = self.clock() if self.clock else _time.time()
        restarts = int(now // 300) % 50  # climbs every 5 min
        crashing = (now % 600) < 120  # crash-looping 2 min of every 10
        items = [
            {
                "metadata": {
                    "namespace": "serving",
                    "name": f"jetstream-llama3-8b-{i}",
                    "labels": {JOBSET_NAME_KEY: "jetstream-llama3"},
                },
                "spec": {
                    "nodeName": f"tpu-host-{i}",
                    "nodeSelector": {
                        TPU_TOPOLOGY_KEY: "2x4",
                        TPU_ACCEL_KEY: "tpu-v5-lite-podslice",
                    },
                    "containers": [
                        {
                            "resources": {
                                "requests": {"google.com/tpu": "8"},
                                "limits": {"google.com/tpu": "8"},
                            }
                        }
                    ],
                },
                "status": {
                    "phase": "Running",
                    "startTime": self._start(now, 86400 * 2 + i * 3600),
                    "containerStatuses": [{"restartCount": 0, "state": {"running": {}}}],
                },
            }
            for i in range(2)
        ]
        items.append(
            {
                "metadata": {"namespace": "kube-system", "name": "kube-dns-7c9", "labels": {}},
                "spec": {"nodeName": "cpu-node-0", "nodeSelector": {}},
                "status": {
                    "phase": "Running",
                    "startTime": self._start(now, 86400 * 14),
                    "containerStatuses": [{"restartCount": 1, "state": {"running": {}}}],
                },
            }
        )
        items.append(
            {
                "metadata": {"namespace": "ml", "name": "maxtext-eval-7b", "labels": {}},
                "spec": {"nodeSelector": {TPU_TOPOLOGY_KEY: "4x4"}},
                "status": {"phase": "Pending", "reason": "Unschedulable"},
            }
        )
        items.append(
            {
                "metadata": {"namespace": "ml", "name": "dataprep-worker", "labels": {}},
                "spec": {"nodeName": "cpu-node-1", "nodeSelector": {}},
                "status": {
                    "phase": "Running",
                    "startTime": self._start(now, 7200),
                    "containerStatuses": [
                        {
                            "restartCount": restarts,
                            "state": (
                                {"waiting": {"reason": "CrashLoopBackOff"}}
                                if crashing
                                else {"running": {}}
                            ),
                        }
                    ],
                },
            }
        )
        return {"kind": "PodList", "items": items}


@dataclass
class K8sCollector:
    name: str = "k8s"
    # "auto" | "api" | "watch" | "kubectl" | "fake" | "none"
    mode: str = "auto"
    api_url: str | None = None

    def __post_init__(self):
        self._watcher: PodWatcher | None = None

    def _sources(self):
        if self.mode == "api":
            return [ApiPodSource(api_url=self.api_url)]
        if self.mode == "kubectl":
            return [KubectlPodSource()]
        if self.mode == "fake":
            return [FakePodSource()]
        if self.mode == "none":
            return []
        return [ApiPodSource(api_url=self.api_url), KubectlPodSource()]

    def stop(self) -> None:
        """Release background resources: the watch mode's PodWatcher
        holds a thread and a live HTTP stream that would otherwise
        outlive the sampler (found by tpulint's stoppable-not-stopped
        pass). Poll modes hold nothing. A later collect() builds
        a fresh watcher, so stop→collect still works."""
        if self._watcher is not None:
            self._watcher.stop()
            self._watcher = None

    def _watch_sample(self) -> Sample | None:
        """Watch mode: serve from the live watcher map, annotating each
        pod with the phases it passed through since the last sample."""
        if self._watcher is None:
            self._watcher = PodWatcher(api_url=self.api_url)
            self._watcher.start()
        w = self._watcher
        if not w.synced:
            return Sample(
                source=self.name, ok=False, data=[],
                error="pod watch not synced yet"
                + (f" ({w.last_error})" if w.last_error else ""),
            )
        doc, interim = w.snapshot()
        pods = parse_pod_list(doc)
        seen = set()
        for p in pods:
            key = f"{p['namespace']}/{p['name']}"
            seen.add(key)
            phases = interim.get(key)
            if phases:
                p["interim_phases"] = phases
        # Pods that vanished between samples still report their final
        # excursions (a Job pod that fails and is deleted inside one
        # interval is exactly the event this mode exists to catch).
        for key, phases in interim.items():
            if key in seen:
                continue
            ns, _, name = key.partition("/")
            pods.append({
                "namespace": ns, "name": name, "status": "Deleted",
                "reason": None, "restarts": 0, "age": "-",
                "interim_phases": phases,
            })
        if w.last_error:
            # The stream is broken: serve the last-synced state but say
            # so — a frozen map must not masquerade as healthy.
            return Sample(
                source=self.name, ok=False, data=pods,
                error=f"pod watch degraded, serving last-synced state "
                f"({w.last_error})",
            )
        return Sample(source=self.name, ok=True, data=pods)

    async def collect(self) -> Sample:
        if self.mode == "watch":
            return await asyncio.to_thread(self._watch_sample)
        errors: list[str] = []
        for source in self._sources():
            try:
                pod_list = await source.fetch_pod_list()
                return Sample(source=self.name, ok=True, data=parse_pod_list(pod_list))
            except Exception as e:
                errors.append(f"{type(source).__name__}: {type(e).__name__}: {e}")
        return Sample(
            source=self.name,
            ok=False,
            data=[],
            error="; ".join(errors) or "k8s collection disabled",
        )

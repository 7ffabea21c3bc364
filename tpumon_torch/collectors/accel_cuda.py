"""In-process GPU collector: NVML through ``ctypes``.

The counterpart of ``tpumon/collectors/accel_jax.py``. Where the
reference enumerates its chips through ``jax.local_devices()`` and reads
their counters from libtpu's SDK, gRPC service and PJRT, this collector
reads NVIDIA's management library, ``libnvidia-ml.so.1``, which the
driver ships. Per chip:

1. **Identity** (NVML): name, UUID and PCI bus id. ``index`` is the
   card's rank by PCI bus id, which is nvidia-smi's numbering and the key
   the workload self-report writes (``tpumon_torch.loadgen.report``);
   CUDA's own order (``FASTEST_FIRST``, ``CUDA_VISIBLE_DEVICES``) may
   differ, so nothing here goes by CUDA's position. A torch device is
   matched to its card by UUID, else by PCI bus id.
2. **Counters**, in preference order:
   a. NVML: SM utilisation -> ``mxu_duty_pct``; framebuffer used and
      total -> ``hbm_*``; GPU temperature -> ``temp_c``; the thermal and
      power clock-event reasons -> ``throttle_score``; NVLink link state
      -> ``ici_link_up`` / ``ici_link_health``.
   b. torch's allocator (``memory_allocated``, ``total_memory``), only in
      a process where ``torch.cuda`` is already initialised (``validate``
      is one): the process-local view, the counterpart of PJRT's
      ``memory_stats`` (the reference's source c).
   c. workload self-reports (``tpumon_torch.collectors.workload``).
   d. nothing: the fields stay None and the sample is degraded.

NVML answering ``NOT_SUPPORTED`` for one field makes that field None; it
does not fail the sample.

The monitor creates no CUDA context to sample the card: a context holds
hundreds of MB of the card and would show in the monitor's own reading.
NVML's init runs once, in a daemon thread under ``init_timeout_s``. No
library, a failing init or one that hangs give ``Sample(ok=False,
error=<the reason>)`` and no chips: there is no fallback to another
backend, so ``validate`` then reports ``chips-visible FAIL``.
"""

from __future__ import annotations

import asyncio
import ctypes
import socket
import sys
import threading
from dataclasses import dataclass, field

from tpumon_torch.collectors import Sample
from tpumon_torch.collectors.gpu import normalize_gpu_kind
from tpumon_torch.collectors.workload import WorkloadFileSource
from tpumon_torch.topology import ChipSample

NVML_LIB = "libnvidia-ml.so.1"

# nvml.h's constants.
NVML_SUCCESS = 0
NVML_ERROR_NOT_SUPPORTED = 3
NVML_TEMPERATURE_GPU = 0
NVML_FEATURE_ENABLED = 1
NVML_NVLINK_MAX_LINKS = 18
NAME_BUFFER = 96  # NVML_DEVICE_NAME_V2_BUFFER_SIZE
UUID_BUFFER = 96  # NVML_DEVICE_UUID_V2_BUFFER_SIZE

# Clock-event (throttle) reasons that slow the card for heat or power, on
# the reference's 0-10 throttle scale (10 = clocks held down outright).
# The others (idle, application clocks, sync boost, display clock) are not
# slowdowns and score 0.
THROTTLE_SCORES = {
    0x0000000000000004: 3,   # software power cap
    0x0000000000000020: 6,   # software thermal slowdown
    0x0000000000000008: 10,  # hardware slowdown
    0x0000000000000040: 10,  # hardware thermal slowdown
    0x0000000000000080: 10,  # hardware power brake
}


class PciInfo(ctypes.Structure):  # nvmlPciInfo_t (v3)
    _fields_ = [
        ("busIdLegacy", ctypes.c_char * 16),
        ("domain", ctypes.c_uint),
        ("bus", ctypes.c_uint),
        ("device", ctypes.c_uint),
        ("pciDeviceId", ctypes.c_uint),
        ("pciSubSystemId", ctypes.c_uint),
        ("busId", ctypes.c_char * 32),
    ]


class Memory(ctypes.Structure):  # nvmlMemory_t
    _fields_ = [
        ("total", ctypes.c_ulonglong),
        ("free", ctypes.c_ulonglong),
        ("used", ctypes.c_ulonglong),
    ]


class MemoryV2(ctypes.Structure):  # nvmlMemory_v2_t
    _fields_ = [
        ("version", ctypes.c_uint),
        ("total", ctypes.c_ulonglong),
        ("reserved", ctypes.c_ulonglong),
        ("free", ctypes.c_ulonglong),
        ("used", ctypes.c_ulonglong),
    ]


# NVML_STRUCT_VERSION(Memory, 2): the struct's size with the version in
# the top byte.
MEMORY_V2_VERSION = ctypes.sizeof(MemoryV2) | (2 << 24)


class Utilization(ctypes.Structure):  # nvmlUtilization_t
    _fields_ = [("gpu", ctypes.c_uint), ("memory", ctypes.c_uint)]


class NvmlError(RuntimeError):
    def __init__(self, call: str, code: int, text: str) -> None:
        super().__init__(f"{call}: {text} (NVML error {code})")
        self.code = code


_HANDLE = ctypes.c_void_p
_UINT_P = ctypes.POINTER(ctypes.c_uint)


class Nvml:
    """The NVML calls the collector makes, each declared with its
    ``argtypes`` and ``restype``. Every method raises ``NvmlError`` on a
    status other than success."""

    def __init__(self, path: str = NVML_LIB) -> None:
        self.lib = lib = ctypes.CDLL(path)
        sigs = {
            "nvmlInit_v2": [],
            "nvmlShutdown": [],
            "nvmlDeviceGetCount_v2": [_UINT_P],
            "nvmlDeviceGetHandleByIndex_v2": [ctypes.c_uint,
                                              ctypes.POINTER(_HANDLE)],
            "nvmlDeviceGetPciInfo_v3": [_HANDLE, ctypes.POINTER(PciInfo)],
            "nvmlDeviceGetName": [_HANDLE, ctypes.c_char_p, ctypes.c_uint],
            "nvmlDeviceGetUUID": [_HANDLE, ctypes.c_char_p, ctypes.c_uint],
            "nvmlDeviceGetMemoryInfo": [_HANDLE, ctypes.POINTER(Memory)],
            "nvmlDeviceGetMemoryInfo_v2": [_HANDLE,
                                           ctypes.POINTER(MemoryV2)],
            "nvmlDeviceGetUtilizationRates": [_HANDLE,
                                              ctypes.POINTER(Utilization)],
            "nvmlDeviceGetTemperature": [_HANDLE, ctypes.c_int, _UINT_P],
            "nvmlDeviceGetNvLinkState": [_HANDLE, ctypes.c_uint,
                                         ctypes.POINTER(ctypes.c_int)],
        }
        # Calls an older driver may lack: reading through one raises
        # NOT_SUPPORTED, which makes its field None.
        optional = ("nvmlDeviceGetMemoryInfo_v2", "nvmlDeviceGetNvLinkState")
        self._fn = {}
        for name, argtypes in sigs.items():
            fn = getattr(lib, name, None) if name in optional else \
                getattr(lib, name)
            if fn is not None:
                fn.argtypes, fn.restype = argtypes, ctypes.c_int
                self._fn[name] = fn
        # The clock-event reasons' current name (drivers from R535 on),
        # else the deprecated throttle-reasons name older drivers export.
        for name in ("nvmlDeviceGetCurrentClocksEventReasons",
                     "nvmlDeviceGetCurrentClocksThrottleReasons"):
            fn = getattr(lib, name, None)
            if fn is not None:
                fn.argtypes = [_HANDLE, ctypes.POINTER(ctypes.c_ulonglong)]
                fn.restype = ctypes.c_int
                self._fn["reasons"] = fn
                break
        lib.nvmlErrorString.argtypes = [ctypes.c_int]
        lib.nvmlErrorString.restype = ctypes.c_char_p

    def _call(self, name: str, *args) -> None:
        fn = self._fn.get(name)
        if fn is None:
            raise NvmlError(name, NVML_ERROR_NOT_SUPPORTED,
                            "not exported by this driver")
        code = fn(*args)
        if code != NVML_SUCCESS:
            text = self.lib.nvmlErrorString(code)
            raise NvmlError(name, code,
                            text.decode("utf-8", "replace") if text else "?")

    def init(self) -> None:
        self._call("nvmlInit_v2")

    def shutdown(self) -> None:
        self._call("nvmlShutdown")

    def count(self) -> int:
        n = ctypes.c_uint()
        self._call("nvmlDeviceGetCount_v2", ctypes.byref(n))
        return n.value

    def handle(self, index: int):
        h = _HANDLE()
        self._call("nvmlDeviceGetHandleByIndex_v2", index, ctypes.byref(h))
        return h

    def pci(self, h) -> PciInfo:
        p = PciInfo()
        self._call("nvmlDeviceGetPciInfo_v3", h, ctypes.byref(p))
        return p

    def _text(self, name: str, h, size: int) -> str:
        buf = ctypes.create_string_buffer(size)
        self._call(name, h, buf, size)
        return buf.value.decode("utf-8", "replace")

    def name(self, h) -> str:
        return self._text("nvmlDeviceGetName", h, NAME_BUFFER)

    def uuid(self, h) -> str:
        return self._text("nvmlDeviceGetUUID", h, UUID_BUFFER)

    def memory_v1(self, h) -> Memory:
        m = Memory()
        self._call("nvmlDeviceGetMemoryInfo", h, ctypes.byref(m))
        return m

    def memory_v2(self, h) -> MemoryV2:
        m = MemoryV2(version=MEMORY_V2_VERSION)
        self._call("nvmlDeviceGetMemoryInfo_v2", h, ctypes.byref(m))
        return m

    def utilization(self, h) -> Utilization:
        u = Utilization()
        self._call("nvmlDeviceGetUtilizationRates", h, ctypes.byref(u))
        return u

    def temperature(self, h) -> int:
        t = ctypes.c_uint()
        self._call("nvmlDeviceGetTemperature", h, NVML_TEMPERATURE_GPU,
                   ctypes.byref(t))
        return t.value

    def clock_event_reasons(self, h) -> int:
        r = ctypes.c_ulonglong()
        self._call("reasons", h, ctypes.byref(r))
        return r.value

    def nvlink_active(self, h, link: int) -> bool:
        s = ctypes.c_int()
        self._call("nvmlDeviceGetNvLinkState", h, link, ctypes.byref(s))
        return s.value == NVML_FEATURE_ENABLED


def throttle_score(reasons: int) -> int:
    """The worst heat or power slowdown among the reason bits, 0-10."""
    return max((s for bit, s in THROTTLE_SCORES.items() if reasons & bit),
               default=0)


def memory_reading(nvml: Nvml, h) -> tuple[int, int]:
    """(used, total) framebuffer bytes as nvidia-smi prints them: the v2
    struct's. Both structs' ``total`` is nvidia-smi's ``memory.total``,
    but v1's ``used`` adds the driver's reserve (480 MiB on an NVIDIA H100
    80GB HBM3 at 700 W, driver 580) where v2's ``used`` and nvidia-smi's
    ``memory.used`` leave it out (chip_smoke phase 20 holds the reading to
    nvidia-smi). A driver without the v2 call gives v1's figures."""
    try:
        m = nvml.memory_v2(h)
    except NvmlError as e:
        if e.code != NVML_ERROR_NOT_SUPPORTED:
            raise
        m = nvml.memory_v1(h)
    return int(m.used), int(m.total)


@dataclass
class Card:
    """One card's identity and the handle its counters are read through."""

    handle: object
    index: int  # nvidia-smi's index (see _init_cards)
    pci: tuple[int, int, int] | None  # (domain, bus, device)
    name: str
    uuid: str
    links: list[int]  # the NVLink links the card answers for


def uuid_key(uuid: str) -> str:
    """NVML's ``GPU-<hex>`` and torch's bare ``<hex>`` as one key."""
    u = uuid.strip().lower()
    return u[4:] if u.startswith("gpu-") else u


def _optional(fn, *args):
    """``fn(*args)``, or None where NVML does not support the call."""
    try:
        return fn(*args)
    except NvmlError as e:
        if e.code != NVML_ERROR_NOT_SUPPORTED:
            raise
        return None


async def _off_loop(fn):
    """``fn()`` in a daemon thread. Not the loop's executor: a call that
    never returns (a wedged driver) must not hold up the interpreter's
    exit or ``asyncio.run``'s executor shutdown."""
    loop = asyncio.get_running_loop()
    fut = loop.create_future()

    def settle(result, error) -> None:
        if fut.done():
            return
        if error is not None:
            fut.set_exception(error)
        else:
            fut.set_result(result)

    def run() -> None:
        try:
            out, err = fn(), None
        except Exception as e:  # handed to the awaiting task
            out, err = None, e
        try:
            loop.call_soon_threadsafe(settle, out, err)
        except RuntimeError:  # the loop closed while fn ran
            pass

    threading.Thread(target=run, name="tpumon-nvml", daemon=True).start()
    return await fut


def torch_memory() -> list[tuple[str, tuple[int, int, int], int, int]]:
    """(uuid key, (domain, bus, device), allocated, total) for each of
    this process's devices, from torch's allocator. Empty unless torch is
    imported and ``torch.cuda`` already initialised: the collector never
    imports torch or creates a context itself."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_initialized():
        return []
    out = []
    for i in range(torch.cuda.device_count()):
        p = torch.cuda.get_device_properties(i)
        out.append((uuid_key(str(getattr(p, "uuid", ""))),
                    (int(getattr(p, "pci_domain_id", 0)),
                     int(getattr(p, "pci_bus_id", -1)),
                     int(getattr(p, "pci_device_id", 0))),
                    int(torch.cuda.memory_allocated(i)),
                    int(p.total_memory)))
    return out


def _torch_match(card: Card, mem: list) -> tuple[int, int] | None:
    """The card's (allocated, total) in ``mem``, matched by UUID, else by
    PCI bus id; never by position."""
    for uuid, pci, used, total in mem:
        if (card.uuid and uuid == uuid_key(card.uuid)) or (
                card.pci is not None and pci == card.pci):
            return used, total
    return None


@dataclass
class CudaGpuCollector:
    name: str = "accel"
    # The GPU family's slice namespace, as NvidiaSmiCollector's.
    slice_id: str = "gpu-0"
    hostname: str | None = None
    nvml_lib: str | None = None  # default: NVML_LIB, the driver's
    # Directory workloads self-report into (tpumon_torch.collectors.
    # workload); None disables the source.
    workload_dir: str | None = None
    # NVML's init can hang on a wedged driver; a monitor must degrade,
    # not hang with it.
    init_timeout_s: float = 60.0

    _nvml: Nvml | None = field(default=None, repr=False)
    _cards: list[Card] | None = field(default=None, repr=False)
    _init_error: str | None = field(default=None, repr=False)

    def __post_init__(self) -> None:
        self.hostname = self.hostname or socket.gethostname()
        self.nvml_lib = self.nvml_lib or NVML_LIB
        self._workload = (
            WorkloadFileSource(directory=self.workload_dir)
            if self.workload_dir
            else None
        )

    def _init_cards(self) -> list[Card]:
        """Blocking NVML load, init and enumeration; run off the loop."""
        try:
            nvml = Nvml(self.nvml_lib)
        except (OSError, AttributeError) as e:
            raise RuntimeError(f"{self.nvml_lib} not loadable: {e}") from e
        nvml.init()
        found = []
        for i in range(nvml.count()):
            h = nvml.handle(i)
            p = _optional(nvml.pci, h)
            links = []
            for link in range(NVML_NVLINK_MAX_LINKS):
                try:
                    nvml.nvlink_active(h, link)
                except NvmlError:
                    continue
                links.append(link)
            found.append(Card(
                handle=h, index=i,
                pci=(None if p is None else
                     (int(p.domain), int(p.bus), int(p.device))),
                name=_optional(nvml.name, h) or "gpu",
                uuid=_optional(nvml.uuid, h) or "", links=links))
        # nvidia-smi and the workload self-report number the cards by PCI
        # bus id: rank by it where NVML reports every card's (a VM may
        # hide it; NVML's own order is then nvidia-smi's).
        if all(c.pci is not None for c in found):
            found.sort(key=lambda c: c.pci)
            for rank, c in enumerate(found):
                c.index = rank
        self._nvml = nvml
        return found

    @property
    def cards(self) -> list[Card]:
        """The cards NVML enumerated, in index order (empty before the
        first collect, or when NVML did not start)."""
        return list(self._cards or [])

    async def _cards_cached(self) -> list[Card]:
        if self._cards is None and self._init_error is None:
            try:
                self._cards = await asyncio.wait_for(
                    _off_loop(self._init_cards), timeout=self.init_timeout_s)
            except asyncio.TimeoutError:
                self._init_error = (
                    f"NVML init hung >{self.init_timeout_s:g}s "
                    "(wedged driver?)")
                self._cards = []
            except Exception as e:
                self._init_error = f"{type(e).__name__}: {e}"
                self._cards = []
        return self._cards or []

    def _read(self, card: Card) -> tuple[dict, list[str]]:
        """One card's NVML counters; a field NVML does not support is
        None, any other error is named in the second value."""
        nvml = self._nvml
        out: dict = {}
        errors: list[str] = []

        def get(key: str, fn, *args):
            try:
                out[key] = fn(*args)
            except NvmlError as e:
                out[key] = None
                if e.code != NVML_ERROR_NOT_SUPPORTED:
                    errors.append(f"chip {card.index}: {e}")

        get("memory", memory_reading, nvml, card.handle)
        get("util", nvml.utilization, card.handle)
        get("temp", nvml.temperature, card.handle)
        get("reasons", nvml.clock_event_reasons, card.handle)
        links = []
        for link in card.links:
            try:
                links.append(nvml.nvlink_active(card.handle, link))
            except NvmlError as e:
                errors.append(f"chip {card.index}: link {link}: {e}")
        out["links"] = links
        return out, errors

    def _read_all(self, cards: list[Card]) -> list[tuple[dict, list[str]]]:
        return [self._read(c) for c in cards]

    async def probe_sources(self) -> dict[str, dict]:
        """Probe every counter source once and report, per source,
        whether it answered and why not (validate's ``source-*`` checks)."""
        out: dict[str, dict] = {}
        cards = await self._cards_cached()
        if not cards:
            out["nvml"] = {"live": False,
                           "detail": self._init_error or "no GPUs"}
        else:
            reads = await _off_loop(lambda: self._read_all(cards))
            live = [c for c, (r, _) in zip(cards, reads)
                    if r["memory"] is not None or r["util"] is not None]
            errs = [e for _, es in reads for e in es]
            out["nvml"] = {
                "live": bool(live),
                "detail": (
                    f"{self.nvml_lib}: {len(cards)} device(s) "
                    f"({', '.join(sorted({c.name for c in cards}))}); "
                    f"{len(live)} answer memory/utilisation"
                    + (f"; {'; '.join(errs)}" if errs else "")),
            }
        mem = torch_memory()
        matched = [c for c in cards if _torch_match(c, mem) is not None]
        out["torch"] = {
            "live": bool(matched),
            "detail": (
                f"torch.cuda allocator: {len(matched)} device(s) matched "
                "by UUID or PCI bus id" if matched else
                "torch.cuda not initialised in this process" if not mem
                else "no torch device matches an NVML device"),
        }
        if self._workload is None:
            out["workload"] = {"live": False,
                               "detail": "disabled (no workload_dir)"}
        else:
            wsnap = await asyncio.to_thread(self._workload.snapshot)
            out["workload"] = {
                "live": bool(wsnap),
                "detail": (
                    f"{self._workload.directory}: {len(wsnap)} device "
                    f"entr{'y' if len(wsnap) == 1 else 'ies'}" if wsnap
                    else f"{self._workload.directory}: no fresh reports"),
            }
        return out

    async def collect(self) -> Sample:
        cards = await self._cards_cached()
        if not cards:
            return Sample(
                source=self.name,
                ok=False,
                data=[],
                error=self._init_error or "no GPUs visible to NVML",
            )
        reads = await _off_loop(lambda: self._read_all(cards))
        mem = torch_memory()

        # Workload self-reports, ranked below NVML and torch: read only if
        # some chip still has a gap, so a healthy NVML keeps the tick
        # free of file IO.
        workload_snap: dict[int, dict] | None = None

        def workload_lookup(idx: int) -> dict | None:
            nonlocal workload_snap
            if self._workload is None:
                return None
            if workload_snap is None:
                workload_snap = self._workload.snapshot()
            return workload_snap.get(idx)

        chips: list[ChipSample] = []
        degraded: list[str] = []
        workload_names: list[str] = []
        for card, (r, errors) in zip(cards, reads):
            degraded += errors
            sources: list[str] = []
            hbm_used = hbm_total = None
            if r["memory"] is not None:
                hbm_used, hbm_total = r["memory"]
            duty = float(r["util"].gpu) if r["util"] is not None else None
            if duty is not None or hbm_used is not None:
                sources.append("nvml")
            from_torch = (_torch_match(card, mem) if hbm_used is None
                          else None)
            if from_torch is not None:
                hbm_used, total = from_torch
                hbm_total = hbm_total or total
                sources.append("torch")
            wl = (
                workload_lookup(card.index)
                if (hbm_used is None or duty is None)
                else None
            )
            if wl is not None:
                wl_used = False
                if hbm_used is None and wl["hbm_used"] is not None:
                    hbm_used = wl["hbm_used"]
                    wl_used = True
                if hbm_total is None and wl["hbm_total"] is not None:
                    hbm_total = wl["hbm_total"]
                if duty is None and wl["busy_frac"] is not None:
                    duty = round(100.0 * wl["busy_frac"], 1)
                    wl_used = True
                if wl_used:
                    sources.append("workload")
                    for name in wl.get("workloads", []):
                        if name not in workload_names:
                            workload_names.append(name)
            if hbm_used is None and duty is None:
                degraded.append(f"chip {card.index}: no counter source")
            links = r["links"]
            # A card with no active link has no NVLink fabric to report.
            # ici_tx/rx_bytes stay None: the H100 answers NVML's NVLink
            # throughput fields NOT_SUPPORTED, and nvml.h gives the byte
            # counters that replace them for NVLink 5 only.
            up = all(links) if any(links) else None
            chips.append(
                ChipSample(
                    chip_id=f"{self.hostname}/gpu-{card.index}",
                    host=self.hostname,
                    slice_id=self.slice_id,
                    index=card.index,
                    kind=normalize_gpu_kind(card.name),
                    mxu_duty_pct=duty,
                    hbm_used=int(hbm_used) if hbm_used is not None else None,
                    hbm_total=int(hbm_total) if hbm_total is not None else None,
                    temp_c=(float(r["temp"]) if r["temp"] is not None
                            else None),
                    ici_link_up=up,
                    # A link down beside active ones: the DCGM parse's
                    # "serious" NVLink score.
                    ici_link_health=None if up is None else (0 if up else 7),
                    throttle_score=(throttle_score(r["reasons"])
                                    if r["reasons"] is not None else None),
                    counter_source="+".join(sources) or None,
                    accel_kind="gpu",
                )
            )
        notes = []
        if workload_names:
            notes.append(
                "duty/HBM include workload self-reports "
                f"(source: workload — {', '.join(sorted(workload_names))}); "
                "no platform counter source covers these fields on this host"
            )
        return Sample(
            source=self.name,
            ok=not degraded,
            data=chips,
            error=("; ".join(degraded) or None),
            notes=notes,
        )

    async def close(self) -> None:
        nvml, self._nvml = self._nvml, None
        self._cards = None
        if nvml is not None:
            try:
                await _off_loop(nvml.shutdown)
            except NvmlError:
                pass


"""Accelerator collector factory (counterpart of ``tpumon/collectors/accel.py``).

Backend selection (Config.accel_backend):
- "auto" and "cuda": the in-process NVML collector
  (tpumon_torch.collectors.accel_cuda.CudaGpuCollector), the counterpart
  of the reference's JaxTpuCollector. With no usable NVML it reports no
  chips and says why (``Sample(ok=False, error=...)``); it does not fall
  back to another backend.
- "jax": refused; the port has no JAX backend, "cuda" is its counterpart.
- "fake:<topology>[@<host_prefix>][+faults]": synthetic TPU chips, as in
  the reference.
- "gpufake:<topology>[@<host_prefix>][+faults]": synthetic GPU nodes
  (dgx-a100-8 / dgx-h100-8 / superpod-32), accel_kind="gpu".
- "nvidia-smi[:<path>]": GPU chips via the nvidia-smi CSV shell-out.
- "dcgm:<url>": GPU chips scraped from a DCGM exporter.
- "none": disabled.

Peer federation (``cfg.peers``) is not yet ported (ROADMAP item 7c).
"""

from __future__ import annotations

from dataclasses import dataclass

from tpumon_torch.collectors import Collector, Sample
from tpumon_torch.collectors.accel_cuda import CudaGpuCollector
from tpumon_torch.collectors.accel_fake import FakeTpuCollector
from tpumon_torch.config import Config


@dataclass
class NullAccelCollector:
    name: str = "accel"
    reason: str = "accel collector disabled"

    async def collect(self) -> Sample:
        return Sample(source=self.name, ok=True, data=[], error=self.reason)


def make_accel_collector(cfg: Config) -> Collector:
    backend = cfg.accel_backend
    if backend == "none":
        local: Collector | None = None
    elif backend.startswith(("fake:", "gpufake:")):
        kind, spec = backend.split(":", 1)
        kw = {}
        if spec.endswith("+faults"):
            spec = spec[: -len("+faults")]
            kw["fault_episodes"] = True
        topology, _, prefix = spec.partition("@")
        if prefix:
            kw["host_prefix"] = prefix
        if kind == "gpufake":
            from tpumon_torch.collectors.gpu_fake import FakeGpuCollector

            local = FakeGpuCollector(topology=topology, **kw)
        else:
            local = FakeTpuCollector(topology=topology, **kw)
    elif backend == "nvidia-smi" or backend.startswith("nvidia-smi:"):
        from tpumon_torch.collectors.gpu import NvidiaSmiCollector

        _, _, smi_path = backend.partition(":")
        local = NvidiaSmiCollector(
            **({"smi_path": smi_path} if smi_path else {})
        )
    elif backend.startswith("dcgm:"):
        from tpumon_torch.collectors.gpu import DcgmCollector

        local = DcgmCollector(url=backend.split(":", 1)[1])
    elif backend in ("auto", "cuda"):
        local = CudaGpuCollector(workload_dir=cfg.workload_dir or None)
    elif backend == "jax":
        raise ValueError(
            "accel backend 'jax' is the JAX package's; the port reads its "
            "GPUs in process through NVML: use 'cuda'")
    else:
        raise ValueError(f"unknown accel backend {backend!r}")
    if cfg.peers:
        raise NotImplementedError(
            "peer federation (cfg.peers) is not yet ported (ROADMAP item 7c)")
    if local is None:
        return NullAccelCollector(reason="accel backend 'none' configured")
    return local

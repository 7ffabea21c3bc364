"""``python -m tpumon_torch.native build`` — compile the native fast paths
(host sampler + TSDB ingest kernel) into build/tpumon_torch/native/."""

import sys

from tpumon_torch.native import build, load, load_tsdb, so_path

if len(sys.argv) > 1 and sys.argv[1] == "build":
    sys.exit(0 if build(quiet=False) else 1)
lib = load()
print(f"native host sampler: {'available' if lib else 'not built'} "
      f"({so_path('host')})")
try:
    load_tsdb(auto_build=False)
    print(f"native tsdb ingest kernel: available ({so_path('tsdb')})")
except RuntimeError as e:
    print(f"native tsdb ingest kernel: {e}")

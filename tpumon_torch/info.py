"""Alias so ``python -m tpumon_torch.info`` works like the tpu-info CLI."""

from tpumon_torch.cli import main

if __name__ == "__main__":
    raise SystemExit(main())

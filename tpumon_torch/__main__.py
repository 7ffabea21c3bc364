from tpumon_torch.app import main

raise SystemExit(main())

"""The writer side of the monitor's channels that a workload feeds
(``workload``: the self-report files the unchanged monitor reads)."""

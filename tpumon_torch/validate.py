"""Validation verdicts: the pure half of ``tpumon/validate.py``.

The reference's ``python -m tpumon.validate`` runs the loadgen workloads
while sampling the accelerator collector and checks that the monitored
counters respond: an HBM fill raises memory in use, a matmul burn raises
the duty cycle, and the serving engine serves. Its verdict logic is pure
functions over sampled values; they are copied here as they are
(``CheckResult``, ``classify_*``, ``summarize``, ``results_json``), and
``chip_smoke.py`` holds the port's burns (``loadgen.burn``) to them with
``nvidia-smi`` readings.

The orchestration is not yet ported: ``validate()`` and ``main()`` raise.
They need the monitor's collectors and config (ROADMAP queue 1 items 7
and 11); the engine modes its serving check runs (dense, speculative,
block and int8 KV) are ported.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass


@dataclass(frozen=True)
class CheckResult:
    check: str
    verdict: str  # PASS | FAIL | SKIP
    detail: str


def _mean(vals: list[float | None]) -> float | None:
    xs = [v for v in vals if v is not None]
    return sum(xs) / len(xs) if xs else None


# ---------------------------------------------------------------------------
# Pure verdict logic (unit-tested without hardware), the reference's as it is.
# ---------------------------------------------------------------------------


def classify_chips_visible(chips: list) -> CheckResult:
    if not chips:
        return CheckResult("chips-visible", "FAIL", "no chips reported")
    srcs = sorted(
        {c.counter_source for c in chips if getattr(c, "counter_source", None)}
    )
    return CheckResult(
        "chips-visible",
        "PASS",
        f"{len(chips)} chip(s), kind {chips[0].kind}"
        + (f", counters: {'/'.join(srcs)}" if srcs else ""),
    )


def classify_hbm_response(
    hbm0: float | None,
    hbm_during: float | None,
    hbm_after: float | None,
    synthetic: bool,
    source: str | None = None,
) -> CheckResult:
    """A ~30% HBM fill must register as a >=1.1x rise while held — that
    is the hard gate. The post-release reading is recorded but does not
    gate: allocator reservation semantics and coarse counter cadences
    legitimately hold the peak briefly, so "didn't fall within a second"
    must not flunk a healthy chip (it is noted for the artifact)."""
    if synthetic:
        return CheckResult("hbm-response", "SKIP", "synthetic backend")
    if hbm0 is None:
        return CheckResult("hbm-response", "SKIP", "no HBM counter source")
    if hbm_during is None or hbm_during <= hbm0 * 1.1:
        return CheckResult(
            "hbm-response",
            "FAIL",
            f"hbm_used {hbm0} -> {hbm_during} did not track a 30% fill",
        )
    detail = f"{hbm0 / 2**30:.1f} -> {hbm_during / 2**30:.1f} GiB during fill"
    if hbm_after is None:
        pass
    elif hbm_after < hbm_during * 0.98:
        detail += f" -> {hbm_after / 2**30:.1f} GiB after release"
    else:
        detail += (
            f"; release not yet visible ({hbm_after / 2**30:.1f} GiB — "
            "allocator retention or coarse counter)"
        )
    if source:
        detail += f" [source: {source}]"
    return CheckResult("hbm-response", "PASS", detail)


def classify_mxu_response(
    duty0: float | None,
    duty_during: list[float | None],
    synthetic: bool,
    source: str | None = None,
) -> CheckResult:
    """An MXU burn must push the duty cycle above both the idle baseline
    and an absolute 5% floor (guards against a counter that reads a
    constant small value)."""
    if synthetic:
        return CheckResult("mxu-response", "SKIP", "synthetic backend")
    if duty0 is None:
        return CheckResult("mxu-response", "SKIP", "no duty-cycle counter source")
    peak = max((d for d in duty_during if d is not None), default=None)
    if peak is not None and peak > max(duty0, 5.0):
        return CheckResult(
            "mxu-response",
            "PASS",
            f"duty {duty0:.1f}% -> peak {peak:.1f}% under burn"
            + (f" [source: {source}]" if source else ""),
        )
    return CheckResult(
        "mxu-response", "FAIL", f"duty {duty0} -> {duty_during} under burn"
    )


def classify_serving(outcome: str | None, error: Exception | None) -> CheckResult:
    if error is None:
        return CheckResult("serving-engine", "PASS", outcome or "")
    if isinstance(error, ImportError):
        return CheckResult("serving-engine", "SKIP", f"unavailable: {error}")
    return CheckResult(
        "serving-engine", "FAIL", f"{type(error).__name__}: {error}"
    )


def summarize(results: list[CheckResult]) -> tuple[str, int]:
    """Render the report table; exit code 1 iff any check FAILED."""
    width = max(len(r.check) for r in results)
    lines = [f"{r.check:<{width}}  {r.verdict:<5} {r.detail}" for r in results]
    failed = any(r.verdict == "FAIL" for r in results)
    return "\n".join(lines), 1 if failed else 0


def results_json(results: list[CheckResult], backend: str, seconds: float) -> dict:
    return {
        "backend": backend,
        "seconds": round(seconds, 1),
        "exit": summarize(results)[1],
        "checks": [asdict(r) for r in results],
    }


def validate(*args, **kwargs):
    """The hardware orchestration: not yet ported (see the module
    docstring)."""
    raise NotImplementedError(
        "tpumon_torch.validate: only the verdict functions are ported; the "
        "orchestration needs the monitor's collectors (ROADMAP queue 1 "
        "items 7 and 11)")


def main(argv: list[str] | None = None) -> int:
    """``python -m tpumon_torch.validate``: not yet ported."""
    return validate(argv)


if __name__ == "__main__":
    raise SystemExit(main())

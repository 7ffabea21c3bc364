"""The port's validation verdicts equal the reference's on the same inputs.

``tpumon_torch.validate`` holds a copy of the reference's pure verdict
functions; each case below runs one function of both packages on the
same arguments and compares the results field for field.
"""

import json
from dataclasses import asdict, astuple, dataclass

import pytest

pytest.importorskip("torch")

from tpumon import validate as ref  # noqa: E402
from tpumon_torch import validate as port  # noqa: E402


@dataclass
class Chip:
    kind: str = "NVIDIA H100 80GB HBM3"
    counter_source: str | None = "nvidia-smi"


GiB = 2**30
RESULTS = [("chips-visible", "PASS", "1 chip(s)"),
           ("hbm-response", "SKIP", "synthetic backend"),
           ("mxu-response", "FAIL", "duty 0.0 -> [1.0] under burn")]
CASES = {
    "chips_none": ("classify_chips_visible", ([],), {}),
    "chips_two": ("classify_chips_visible", ([Chip(), Chip()],), {}),
    "chips_no_source": ("classify_chips_visible", ([Chip(None)],), {}),
    "hbm_rise_and_fall": ("classify_hbm_response",
                          (10 * GiB, 30 * GiB, 11 * GiB, False),
                          {"source": "nvidia-smi"}),
    "hbm_no_rise": ("classify_hbm_response", (10 * GiB, 10.5 * GiB, None,
                                              False), {}),
    "hbm_vanished": ("classify_hbm_response", (10 * GiB, None, None, False),
                     {}),
    "hbm_no_fall": ("classify_hbm_response", (10 * GiB, 30 * GiB, 30 * GiB,
                                              False), {}),
    "hbm_synthetic": ("classify_hbm_response", (None, None, None, True), {}),
    "hbm_no_counter": ("classify_hbm_response", (None, None, None, False),
                       {}),
    "mxu_rise": ("classify_mxu_response", (0.0, [None, 80.0, 95.0], False),
                 {"source": "nvidia-smi"}),
    "mxu_flat": ("classify_mxu_response", (20.0, [19.0, 20.0], False), {}),
    "mxu_floor": ("classify_mxu_response", (0.0, [3.0, 4.0], False), {}),
    "mxu_synthetic": ("classify_mxu_response", (None, [], True), {}),
    "serving_pass": ("classify_serving", ("1 request, 8 tokens", None), {}),
    "serving_skip": ("classify_serving", (None, ImportError("no jax")), {}),
    "serving_fail": ("classify_serving", (None, ValueError("bad")), {}),
    "mean": ("_mean", ([None, 1.0, 2.0],), {}),
    "mean_empty": ("_mean", ([None],), {}),
}


def as_plain(x):
    """A CheckResult as a dict, a tuple of them element-wise."""
    if isinstance(x, tuple):
        return tuple(as_plain(v) for v in x)
    return asdict(x) if hasattr(x, "__dataclass_fields__") else x


@pytest.mark.parametrize("case", sorted(CASES) + ["summarize",
                                                  "results_json"])
def test_verdicts_equal_reference(case):
    if case == "summarize":
        got = port.summarize([port.CheckResult(*r) for r in RESULTS])
        want = ref.summarize([ref.CheckResult(*r) for r in RESULTS])
    elif case == "results_json":
        got = port.results_json([port.CheckResult(*r) for r in RESULTS],
                                "nvidia-smi", 12.34)
        want = ref.results_json([ref.CheckResult(*r) for r in RESULTS],
                                "nvidia-smi", 12.34)
    else:
        name, args, kw = CASES[case]
        got = getattr(port, name)(*args, **kw)
        want = getattr(ref, name)(*args, **kw)
    assert as_plain(got) == as_plain(want)


# ------------------------------------------------------------ orchestration

FAKE_T = 1_753_900_000.0


@pytest.fixture
def quick(monkeypatch, tmp_path):
    """validate() of both packages at test cost: the fake GPU collector's
    clock pinned, the workload channel in tmp_path, the HBM fill and the
    matmul burn small, and the waits between samples cut to nothing."""
    import functools
    import threading

    from tpumon import config as ref_config
    from tpumon.collectors import gpu_fake as ref_gpu_fake
    from tpumon.loadgen import burn as ref_burn
    from tpumon_torch import config as port_config
    from tpumon_torch.collectors import gpu_fake as port_gpu_fake
    from tpumon_torch.loadgen import burn as port_burn

    calls = {"hbm_fill": 0, "mxu_burn": 0}

    def hbm_fill(*args, **kwargs):
        calls["hbm_fill"] += 1
        return [bytearray(16)]

    def mxu_burn(*args, **kwargs):
        calls["mxu_burn"] += 1
        threading.Event().wait(0.01)
        return {"tflops": 0.0}

    real_sleep = port.asyncio.sleep

    async def no_wait(seconds):
        await real_sleep(0)

    for cfg_mod in (ref_config, port_config):
        load = cfg_mod.load_config

        def pinned(path=None, env=None, _load=load):
            return _load(path=path, env={
                **(env or {}), "TPUMON_WORKLOAD_DIR": str(tmp_path / "w")})
        monkeypatch.setattr(cfg_mod, "load_config", pinned)
    for fake_mod in (ref_gpu_fake, port_gpu_fake):
        monkeypatch.setattr(fake_mod, "FakeGpuCollector", functools.partial(
            fake_mod.FakeGpuCollector, clock=lambda: FAKE_T))
    for burn_mod in (ref_burn, port_burn):
        monkeypatch.setattr(burn_mod, "hbm_fill", hbm_fill)
        monkeypatch.setattr(burn_mod, "mxu_burn", mxu_burn)
    monkeypatch.setattr(port.asyncio, "sleep", no_wait)
    return calls


def verdicts(results) -> list:
    return [(r.check, r.verdict) for r in results]


@pytest.mark.parametrize("backend", ["fake:v5e-8", "gpufake:dgx-h100-8"])
def test_validate_gives_the_references_verdicts(quick, backend):
    """Same check names and verdicts as the reference's validate() of the
    same backend: the TPU fake SKIPs its counter checks as synthetic; the
    GPU fake at a pinned clock runs them (the fill and the burn) and its
    constant counters FAIL both. The serving check runs the port's engine
    on the CPU in all five modes and passes."""
    import asyncio

    got = asyncio.run(port.validate(backend, device="cpu"))
    n = dict(quick)
    want = asyncio.run(ref.validate(backend))
    assert verdicts(got) == verdicts(want)
    by = {r.check: r for r in got}
    assert by["serving-engine"].verdict == "PASS", by["serving-engine"]
    assert "dense/spec/paged/block/int8-kv ran" in by[
        "serving-engine"].detail
    assert [r for r in got if r.check != "serving-engine"] == [
        port.CheckResult(*astuple(r)) for r in want
        if r.check != "serving-engine"]
    synthetic = backend.startswith("fake:")
    assert n == ({"hbm_fill": 0, "mxu_burn": 0} if synthetic else
                 {"hbm_fill": 1, "mxu_burn": n["mxu_burn"]})
    assert synthetic or n["mxu_burn"] >= 1
    assert port.summarize(got)[1] == ref.summarize(want)[1] == (
        0 if synthetic else 1)


def test_main_writes_the_references_artifact(quick, tmp_path, capsys):
    path = tmp_path / "validate.json"
    code = port.main(["--json", str(path), "--device", "cpu",
                      "--backend", "fake:v5e-8"])
    art = json.loads(path.read_text())
    assert code == art["exit"] == 0
    assert sorted(art) == sorted(ref.results_json(
        [ref.CheckResult("a", "PASS", "")], "fake:v5e-8", 1.0))
    assert art["backend"] == "fake:v5e-8"
    assert [(c["check"], c["verdict"]) for c in art["checks"]] == [
        ("chips-visible", "PASS"), ("hbm-response", "SKIP"),
        ("mxu-response", "SKIP"), ("serving-engine", "PASS")]
    out = capsys.readouterr().out
    assert f"validate: wrote {path}" in out
    assert "validate: done in" in out and out.rstrip().endswith("exit 0")


@pytest.mark.parametrize("argv", [["--backend"], ["--json"],
                                  ["--json", "x", "--backend"]])
def test_bad_arguments_exit_2_as_the_reference(argv, capsys):
    assert ref.main(argv) == 2
    want = capsys.readouterr().err
    assert port.main(argv) == 2
    assert capsys.readouterr().err == want


@pytest.mark.parametrize("argv", [["--device"], ["--device", "gpu"]])
def test_bad_device_exits_2(argv, capsys):
    assert port.main(argv) == 2
    assert capsys.readouterr().err == "--device requires cuda or cpu\n"


def test_cuda_backend_without_nvml_fails_chips_visible(quick, monkeypatch,
                                                       tmp_path):
    """No libnvidia-ml: the NVML collector sees no chips and says why;
    validate reports chips-visible FAIL and exit 1, with no fallback to
    another backend."""
    from tpumon_torch.collectors import accel_cuda

    missing = str(tmp_path / "libnvidia-ml.so.1")
    monkeypatch.setattr(accel_cuda, "NVML_LIB", missing)
    path = tmp_path / "validate.json"
    assert port.main(["--json", str(path), "--device", "cpu"]) == 1
    art = json.loads(path.read_text())
    assert art["backend"] == "cuda" and art["exit"] == 1
    checks = {c["check"]: c for c in art["checks"]}
    assert [(c["check"], c["verdict"]) for c in art["checks"]] == [
        ("source-nvml", "SKIP"), ("source-torch", "SKIP"),
        ("source-workload", "SKIP"), ("chips-visible", "FAIL"),
        ("hbm-response", "SKIP"), ("mxu-response", "SKIP"),
        ("serving-engine", "PASS")]
    assert checks["source-nvml"]["detail"].startswith(
        f"dark: RuntimeError: {missing} not loadable")
    assert checks["chips-visible"]["detail"] == "no chips reported"
    assert quick == {"hbm_fill": 0, "mxu_burn": 0}

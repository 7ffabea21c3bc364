"""The port's validation verdicts equal the reference's on the same inputs.

``tpumon_torch.validate`` holds a copy of the reference's pure verdict
functions; each case below runs one function of both packages on the
same arguments and compares the results field for field.
"""

from dataclasses import asdict, dataclass

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


def test_orchestration_is_not_yet_ported():
    with pytest.raises(NotImplementedError, match="collectors"):
        port.validate()
    with pytest.raises(NotImplementedError):
        port.main([])

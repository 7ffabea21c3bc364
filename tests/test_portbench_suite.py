"""The benchmark's own tests (``portbench/tests``), collected in this
suite: every test of those modules under its own name, with the fixture
they share. Their card tests skip without a GPU, as they do there."""

from portbench.tests.conftest import tiny  # noqa: F401
from portbench.tests.test_portbench_card import *  # noqa: F401,F403
from portbench.tests.test_portbench_contract import *  # noqa: F401,F403
from portbench.tests.test_portbench_discovery import *  # noqa: F401,F403
from portbench.tests.test_portbench_family import *  # noqa: F401,F403
from portbench.tests.test_portbench_imports import *  # noqa: F401,F403
from portbench.tests.test_portbench_metrics import *  # noqa: F401,F403
from portbench.tests.test_portbench_rehearsal import *  # noqa: F401,F403
from portbench.tests.test_portbench_traffic import *  # noqa: F401,F403

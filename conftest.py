"""Run-wide hooks for the test suite under tests/.

Every test under tests/ runs under a time limit (SIGALRM on the worker's main
thread): TIER1_LIMIT_S for the tier-1 run (`pytest tests/ -m 'not slow'`),
SLOW_LIMIT_S for the tests in SLOW, which are marked `slow` here and run with
`pytest tests/ -m slow`. Tests elsewhere (benchmark/tests) are left alone.
"""

import contextlib
import math
import signal
import time
from pathlib import Path

import pytest

TESTS = Path(__file__).resolve().parent / "tests"

TIER1_LIMIT_S = 240
SLOW_LIMIT_S = 1800

# The JAX package's end-to-end runs on Pallas interpret or on a mesh of
# virtual CPU devices, as (file under tests/, test function). Not tier-1.
SLOW = frozenset({
    ("test_fog_ranking.py", "test_find_all_recovers_in_dense_fog_via_edge_ranking"),
    ("test_fog_ranking.py", "test_raw_tangent_gate_recovers_when_detection_starves"),
    ("test_join_subset.py", "test_find_all_join_subset_matches_full_join"),
    ("test_parallel2d.py", "test_find_all_with_meshes"),
    ("test_recall_fixtures.py", "test_low_edge_model_recall_under_edge_only_ranking"),
    ("test_recall_fixtures.py", "test_big_bucket_lattice_recall"),
})


def _in_tests(path):
    return path == TESTS or TESTS in path.parents


def pytest_configure(config):
    # Build the JAX package's native library once, before pytest-xdist starts
    # its workers: each would otherwise build it while collecting
    # tests/test_native.py, and one may load another's half-written file,
    # collect other tests than the rest, and leave the whole run with nothing run.
    if hasattr(config, "workerinput"):
        return
    args = [(config.invocation_params.dir / a.split("::")[0]).resolve() for a in config.args]
    if any(_in_tests(p) or p in TESTS.parents for p in args):
        from triplet_match_tpu import native

        native.available()


@pytest.hookimpl(tryfirst=True)
def pytest_collection_modifyitems(items):
    # tryfirst: the marks must be on before `-m` deselects by them.
    for item in items:
        if item.path.parent == TESTS and (item.path.name, item.originalname) in SLOW:
            item.add_marker(pytest.mark.slow)


@contextlib.contextmanager
def time_limit(nodeid, seconds):
    """Fail the running test if the body takes longer than `seconds`.

    An alarm already pending outside is set aside and re-armed on exit with
    what is left of it.
    """

    def expire(signum, frame):
        pytest.fail(f"{nodeid} ran over its time limit of {seconds} s", pytrace=False)

    previous = signal.signal(signal.SIGALRM, expire)
    outer = signal.alarm(seconds)
    start = time.monotonic()
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, previous)
        if outer:
            signal.alarm(max(1, math.ceil(outer - (time.monotonic() - start))))


@pytest.fixture(name="time_limit")
def time_limit_fixture():
    return time_limit


@pytest.fixture(name="slow_tests")
def slow_tests_fixture():
    return SLOW


@contextlib.contextmanager
def _guard(item):
    if not _in_tests(item.path):
        yield
        return
    seconds = SLOW_LIMIT_S if item.get_closest_marker("slow") else TIER1_LIMIT_S
    with time_limit(item.nodeid, seconds):
        yield


# Each phase is wrapped, not just the test body: an autouse fixture would arm
# only after the module-scoped fixtures were set up. pytest reports a failure
# raised inside a phase as that phase's outcome.
@pytest.hookimpl(wrapper=True)
def pytest_runtest_setup(item):
    with _guard(item):
        return (yield)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_call(item):
    with _guard(item):
        return (yield)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_teardown(item):
    with _guard(item):
        return (yield)

"""The per-test time limit of the repo's root conftest.py, and its `slow` set."""

import re
import signal
import time
from pathlib import Path

import pytest


def test_overrun_fails_with_node_id_and_disarms(request, time_limit):
    nodeid = request.node.nodeid
    outer_left = signal.alarm(0)  # this phase's own limit, set aside
    handler = signal.getsignal(signal.SIGALRM)
    try:
        start = time.monotonic()
        with pytest.raises(pytest.fail.Exception) as info:
            with time_limit(nodeid, 1):
                time.sleep(2)
        assert time.monotonic() - start < 1.9
        assert str(info.value) == f"{nodeid} ran over its time limit of 1 s"
        assert signal.alarm(0) == 0
        assert signal.getsignal(signal.SIGALRM) is handler
    finally:
        signal.alarm(outer_left)


def test_inner_limit_rearms_the_outer_alarm(time_limit):
    outer_left = signal.alarm(0)
    try:
        signal.alarm(100)
        with time_limit("inner", 5):
            time.sleep(0.1)
        assert 99 <= signal.alarm(0) <= 100
    finally:
        signal.alarm(outer_left)


def test_slow_set_names_existing_tests(slow_tests):
    tests = Path(__file__).resolve().parent
    for fname, name in sorted(slow_tests):
        source = (tests / fname).read_text()
        assert re.search(rf"^def {name}\(", source, re.M), (fname, name)

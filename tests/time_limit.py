"""A time limit for every test, so that a hung test fails alone.

Each phase of a test (setup, call, teardown) gets TIME_LIMIT_S, or the
seconds LONGER_LIMITS_S gives that test.  When a phase runs out,
faulthandler writes every thread's stack to the process's stderr, headed
"Timeout (h:mm:ss)!", and ends the process.  Under xdist that is one
failed test ("worker 'gwN' crashed while running '<test>'"), and a new
worker runs the rest of the file on fixtures built anew, so a cluster the
hang left wedged does not hold up the tests after it; the hung test itself
is not run again.  Nothing in the test can stop it: not an `except` around
the wait, not a wait inside a finalizer or in C code.  Without xdist the
run ends at the hung test.

faulthandler's watchdog is a thread: a child forked mid-phase that ends
through the interpreter's normal shutdown would wait forever for the
thread it did not inherit.  The suite's children are spawned or exec'd.

The conftest.py at the root of the repository loads this module; `-p
time_limit` loads it in a pytest run with tests/ on the path.
"""

import contextlib
import faulthandler
import os

import pytest

TIME_LIMIT_S = 240.0

# the only tests above 90 s on a 6-worker tier-1 run, with their times
# there; a test that reaches its limit is a fault to find, not a limit to
# raise
LONGER_LIMITS_S = {
    "test_rl.py::test_dreamerv3_learns_cartpole_in_imagination": 600.0,  # 186 s
    "test_rl.py::test_td3_learns_pendulum": 300.0,  # 92 s
}

# a copy of the process's stderr, outside pytest's capture
_REAL_STDERR_FD = pytest.StashKey[int]()


def pytest_configure(config):
    capman = config.pluginmanager.getplugin("capturemanager")
    with capman.global_and_fixture_disabled() if capman else contextlib.nullcontext():
        config.stash[_REAL_STDERR_FD] = os.dup(2)


def pytest_unconfigure(config):
    os.close(config.stash[_REAL_STDERR_FD])


@contextlib.contextmanager
def _time_limited(item):
    limit = LONGER_LIMITS_S.get(f"{item.path.name}::{item.name}", TIME_LIMIT_S)
    faulthandler.dump_traceback_later(
        limit, exit=True, file=item.config.stash[_REAL_STDERR_FD]
    )
    try:
        yield
    finally:
        faulthandler.cancel_dump_traceback_later()


@pytest.hookimpl(wrapper=True)
def pytest_runtest_setup(item):
    with _time_limited(item):
        return (yield)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_call(item):
    with _time_limited(item):
        return (yield)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_teardown(item, nextitem):
    with _time_limited(item):
        return (yield)


@pytest.hookimpl(optionalhook=True)
def pytest_handlecrashitem(crashitem, report, sched):
    """xdist's loadfile scheduler puts a crashed test back into its file's
    work unit, so a test that hangs every time would end worker after
    worker: count it done.  (The load scheduler does not put it back.)"""
    workqueue = getattr(sched, "workqueue", {})
    for scope, work_unit in list(workqueue.items()):
        if crashitem in work_unit:
            work_unit[crashitem] = True
            if all(work_unit.values()):
                del workqueue[scope]

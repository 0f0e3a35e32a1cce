"""The per-test time limit (tests/time_limit.py), shown on one inner pytest run.

The inner run holds one small test file for each case.  It runs in a
pytest subprocess with the plugin loaded, one xdist worker, `--dist
loadfile` as tier-1 runs, and the limit lowered to 1 s in the inner
conftest.  Each case reads the outcomes of its file's tests from the run's
short summary and the stack its hang printed from the run's stderr.
"""

import os
import re
import subprocess
import sys
import textwrap

import pytest

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))

_INNER_CONFTEST = """
import time_limit

time_limit.TIME_LIMIT_S = 1.0
"""

_INNER_FILES = {
    "test_call.py": """
        import threading

        def test_waits_forever():
            threading.Event().wait()

        def test_next_in_file():
            assert True
    """,
    "test_except_exception.py": """
        import threading

        def test_swallows_the_limit():
            try:
                threading.Event().wait()
            except Exception:
                pass

        def test_next_in_file():
            assert True
    """,
    # as when a collected ObjectRef's __del__ waits on a lock its thread
    # holds: an exception raised in a finalizer is only printed
    "test_finalizer.py": """
        import threading

        class WaitsWhenCollected:
            def __del__(self):
                threading.Event().wait()

        def test_swallows_the_limit():
            WaitsWhenCollected()

        def test_next_in_file():
            assert True
    """,
    "test_teardown.py": """
        import threading
        import pytest

        @pytest.fixture
        def hangs_on_teardown():
            yield
            threading.Event().wait()

        def test_passes_then_hangs(hangs_on_teardown):
            assert True

        def test_next_in_file():
            assert True
    """,
    # a wait that no signal reaches
    "test_deaf.py": """
        import signal
        import time

        def test_deaf_to_signals():
            signal.pthread_sigmask(signal.SIG_BLOCK, set(signal.Signals))
            time.sleep(50)

        def test_next_in_file():
            assert True
    """,
    # the hang wedges a module-scoped fixture, as a hung test can leave its
    # file's cluster
    "test_wedged_fixture.py": """
        import os
        import threading
        import pytest

        @pytest.fixture(scope="module")
        def shared_lock():
            with open("setups", "a") as f:
                f.write(f"{os.getpid()}\\n")
            return threading.Lock()

        def test_wedges_the_fixture(shared_lock):
            shared_lock.acquire()
            shared_lock.acquire()

        def test_next_in_file(shared_lock):
            assert shared_lock.acquire(timeout=0.5)
            shared_lock.release()

        def test_last_in_file(shared_lock):
            assert shared_lock.acquire(timeout=0.5)
            shared_lock.release()
    """,
}


@pytest.fixture(scope="module")
def inner_run(tmp_path_factory):
    """The inner run's exit code, its output, the outcomes of each test by
    file as its short summary lists them (a test that passed and then
    failed in teardown is listed as both), and faulthandler's dumps."""
    root = tmp_path_factory.mktemp("inner")
    (root / "conftest.py").write_text(_INNER_CONFTEST)
    for name, source in _INNER_FILES.items():
        (root / name).write_text(textwrap.dedent(source))
    env = dict(os.environ, PYTHONPATH=TESTS_DIR, PYTEST_DISABLE_PLUGIN_AUTOLOAD="1")
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-p", "time_limit", "-p", "xdist", "-n", "1",
         "--dist", "loadfile", "--max-worker-restart", str(len(_INNER_FILES)),
         "-p", "no:cacheprovider", "-q", "-rA", *_INNER_FILES],
        cwd=root, env=env, capture_output=True, text=True, timeout=120,
    )
    out = proc.stdout + proc.stderr
    outcomes = {}
    for outcome, file, test in re.findall(r"^(PASSED|FAILED|ERROR) (\w+\.py)::(\w+)", out, re.M):
        outcomes.setdefault(file, {}).setdefault(test, []).append(outcome)
    dumps = proc.stderr.split("Timeout (")[1:]
    return proc.returncode, out, outcomes, dumps, root


def _assert_ended_at_the_limit(inner_run, file, test, hung_in, phase):
    _, out, _, dumps, _ = inner_run
    assert f"crashed while running '{file}::{test}'" in out, out
    # faulthandler's dump: the limit, the frame that hung and its phase
    (dump,) = [d for d in dumps if f'{file}", line' in d and f"in {hung_in}\n" in d]
    assert dump.startswith("0:00:01)!"), dump
    assert f"in pytest_runtest_{phase}\n" in dump, dump


def test_hang_in_call_fails_that_test_alone(inner_run):
    rc, out, outcomes, dumps, _ = inner_run
    # every file's hang, and only those, failed the run
    assert rc == 1 and len(dumps) == len(_INNER_FILES), out
    assert outcomes["test_call.py"] == {"test_waits_forever": ["FAILED"],
                                        "test_next_in_file": ["PASSED"]}, out
    _assert_ended_at_the_limit(inner_run, "test_call.py", "test_waits_forever",
                               "test_waits_forever", "call")


@pytest.mark.parametrize("swallowed_by", ["except_exception", "finalizer"])
def test_swallowed_limit_still_fails_the_test(inner_run, swallowed_by):
    _, out, outcomes, _, _ = inner_run
    file = f"test_{swallowed_by}.py"
    assert outcomes[file] == {"test_swallows_the_limit": ["FAILED"],
                              "test_next_in_file": ["PASSED"]}, out
    hung_in = "__del__" if swallowed_by == "finalizer" else "test_swallows_the_limit"
    _assert_ended_at_the_limit(inner_run, file, "test_swallows_the_limit", hung_in, "call")


def test_hang_in_teardown_fails_at_its_own_limit(inner_run):
    _, out, outcomes, _, _ = inner_run
    # the call passed; the teardown's failure is the test's own
    assert outcomes["test_teardown.py"] == {"test_passes_then_hangs": ["PASSED", "FAILED"],
                                            "test_next_in_file": ["PASSED"]}, out
    _assert_ended_at_the_limit(inner_run, "test_teardown.py", "test_passes_then_hangs",
                               "hangs_on_teardown", "teardown")


def test_hang_deaf_to_signals_fails_that_test_alone(inner_run):
    _, out, outcomes, _, _ = inner_run
    assert outcomes["test_deaf.py"] == {"test_deaf_to_signals": ["FAILED"],
                                        "test_next_in_file": ["PASSED"]}, out
    _assert_ended_at_the_limit(inner_run, "test_deaf.py", "test_deaf_to_signals",
                               "test_deaf_to_signals", "call")


def test_tests_after_a_hang_get_their_module_fixture_built_anew(inner_run):
    _, out, outcomes, _, root = inner_run
    assert outcomes["test_wedged_fixture.py"] == {"test_wedges_the_fixture": ["FAILED"],
                                                  "test_next_in_file": ["PASSED"],
                                                  "test_last_in_file": ["PASSED"]}, out
    _assert_ended_at_the_limit(inner_run, "test_wedged_fixture.py", "test_wedges_the_fixture",
                               "test_wedges_the_fixture", "call")
    # built once in the worker that hung, once in the worker after it
    setups = (root / "setups").read_text().split()
    assert len(setups) == 2 and setups[0] != setups[1], setups

"""The test run's rules in the root ``conftest.py``, each checked in a
fresh pytest process that runs under a copy of it: the per-phase time
limit, the slow tests and ``--runslow``, and the intra-op thread cap
under pytest-xdist."""
import importlib.util
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

pytest_plugins = ["pytester"]

ROOT = Path(__file__).resolve().parent.parent
CONFTEST = (ROOT / "conftest.py").read_text()
# pytester restores sys.modules after each test, and torch cannot be
# imported twice into one process: only the child processes import it
needs_torch = pytest.mark.skipif(importlib.util.find_spec("torch") is None,
                                 reason="torch is not installed")


def _suite(pytester, limit=None):
    """Write the root conftest into the pytester directory, its time
    limit set to `limit` seconds if one is given."""
    text = CONFTEST
    if limit is not None:
        text = text.replace("TIME_LIMIT_S = 330", f"TIME_LIMIT_S = {limit}")
        assert text != CONFTEST
    pytester.makeconftest(text)
    return pytester


def test_time_limit_fails_a_test_that_runs_past_it(pytester):
    suite = _suite(pytester, limit=1)
    suite.makepyfile(test_sleeps="""
        import time

        def test_sleeps():
            time.sleep(30)
    """)
    start = time.monotonic()
    res = suite.runpytest_subprocess("-p", "no:cacheprovider")
    assert time.monotonic() - start < 20
    res.assert_outcomes(failed=1)
    res.stdout.fnmatch_lines(["*call ran past the time limit of 1 s*"])
    # the stacks of every thread, for a worker that hangs on after it
    res.stdout.fnmatch_lines(["*most recent call first*"])


def test_time_limit_covers_fixture_setup(pytester):
    suite = _suite(pytester, limit=1)
    suite.makepyfile(test_slow_fixture="""
        import time
        import pytest

        @pytest.fixture
        def stuck():
            time.sleep(30)

        def test_uses_it(stuck):
            pass
    """)
    res = suite.runpytest_subprocess("-p", "no:cacheprovider")
    res.assert_outcomes(errors=1)
    res.stdout.fnmatch_lines(["*setup ran past the time limit of 1 s*"])


@pytest.mark.parametrize("runslow", [False, True])
def test_slow_runs_only_with_runslow(pytester, runslow):
    suite = _suite(pytester)
    suite.makepyfile(test_marks="""
        import pytest

        @pytest.mark.slow
        def test_slow():
            pass

        @pytest.mark.parametrize("case", [
            "fast", pytest.param("slow", marks=pytest.mark.slow)])
        def test_cases(case):
            pass
    """)
    args = ["-p", "no:cacheprovider", "-rs"] + (["--runslow"] * runslow)
    res = suite.runpytest_subprocess(*args)
    if runslow:
        res.assert_outcomes(passed=3)
    else:
        res.assert_outcomes(passed=1, skipped=2)
        res.stdout.fnmatch_lines(["*slow: runs with --runslow*"])


@pytest.mark.parametrize("runslow", [False, True])
def test_slow_node_ids_skip_only_their_cases(pytester, runslow):
    suite = _suite(pytester)
    tests = suite.mkdir("tests")
    (tests / "test_bitslice_kernels.py").write_text(
        "import pytest\n\n"
        "def test_sha256_pallas_padding_boundaries():\n    pass\n\n"
        "@pytest.mark.parametrize('backend', ['bitsliced', 'xla'])\n"
        "def test_full_restore_byte_identity_per_backend(backend):\n"
        "    pass\n")
    args = ["-p", "no:cacheprovider"] + (["--runslow"] * runslow)
    res = suite.runpytest_subprocess(*args)
    if runslow:
        res.assert_outcomes(passed=3)
    else:
        res.assert_outcomes(passed=1, skipped=2)


@pytest.mark.skipif(importlib.util.find_spec("jax") is None,
                    reason="the slow tests import jax")
def test_every_slow_node_id_names_a_test_of_the_suite():
    spec = importlib.util.spec_from_file_location("root_conftest",
                                                  ROOT / "conftest.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    slow = module.SLOW
    files = sorted({n.split("::")[0] for n in slow})
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "--collect-only", "-q",
         "-p", "no:cacheprovider", *files],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    collected = set(out.stdout.splitlines())
    assert slow <= collected, (sorted(slow - collected), out.stderr[-2000:])


@needs_torch
def test_threads_capped_per_xdist_worker(pytester, monkeypatch):
    suite = _suite(pytester)
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("PYTEST_XDIST_WORKER_COUNT", "6")
    want = max(1, os.cpu_count() // 6)
    suite.makepyfile(test_threads=f"""
        import os
        import torch

        def test_threads():
            assert torch.get_num_threads() == {want}
            assert os.environ["OMP_NUM_THREADS"] == "{want}"
            assert os.environ["MKL_NUM_THREADS"] == "{want}"
    """)
    suite.runpytest_subprocess("-p", "no:cacheprovider").assert_outcomes(
        passed=1)


@needs_torch
def test_caller_thread_count_wins(pytester, monkeypatch):
    suite = _suite(pytester)
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    monkeypatch.delenv("MKL_NUM_THREADS", raising=False)
    monkeypatch.setenv("PYTEST_XDIST_WORKER_COUNT", "64")
    suite.makepyfile(test_threads="""
        import torch

        def test_threads():
            assert torch.get_num_threads() == 2
    """)
    suite.runpytest_subprocess("-p", "no:cacheprovider").assert_outcomes(
        passed=1)

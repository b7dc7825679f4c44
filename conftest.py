"""The test run's rules, for `tests/` and `bench/` alike.

- Under pytest-xdist each worker's intra-op thread pools get
  ``cpu_count // workers`` threads (at least one): ``OMP_NUM_THREADS``
  and ``MKL_NUM_THREADS``, which child processes inherit, and torch's
  own. Six workers on eight cores would otherwise run 48 OpenMP
  threads. A value the caller set wins, and a plain single-process run
  keeps the machine's cores. XLA's thread pool is left alone: the JAX
  results are the oracles.
- Every phase of a test (setup, call, teardown) fails past
  ``TIME_LIMIT_S``, just above the longest subprocess timeout a test
  waits on (300 s), so only a hang reaches it.
- The tests in ``SLOW`` run only with ``--runslow``, as does any test
  marked ``slow``.
"""
import contextlib
import faulthandler
import os
import signal
import sys

import pytest

TIME_LIMIT_S = 330

# minutes each on the CPU: the JAX package's SHA-256 under the Pallas
# interpreter, and its fused SHA-256+AES program jit-compiled for the CPU
SLOW = frozenset(
    [f"tests/test_bitslice_kernels.py::{t}" for t in (
        "test_sha256_pallas_padding_boundaries",
        "test_sha256_pallas_matches_hashlib",
        "test_every_registry_backend_decodes_and_names_tampered_chunk"
        "[bitsliced]",
        "test_every_registry_backend_decodes_and_names_tampered_chunk"
        "[bitsliced-fused]",
        "test_full_restore_byte_identity_per_backend[bitsliced]",
        "test_full_restore_byte_identity_per_backend[bitsliced-fused]")]
    + [f"tests/test_fused_decode.py::{t}" for t in (
        "test_fused_boundary_lengths_match_oracles[jit]",
        "test_fused_boundary_lengths_match_oracles[pallas]",
        "test_fused_decrypt_chunks_matches_two_pass_and_bad_positions",
        "test_fused_tamper_mid_tile_aggregates_across_tiles",
        "test_fused_streamed_restore_poisoned_l1_evicts_and_recovers")])


def _cap_intra_op_threads():
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    if workers <= 1:
        return
    n = str(max(1, (os.cpu_count() or 1) // workers))
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ.setdefault(var, n)
    try:
        import torch
    except ModuleNotFoundError:
        return
    torch.set_num_threads(int(os.environ["OMP_NUM_THREADS"]))


_cap_intra_op_threads()


def pytest_addoption(parser):
    parser.addoption("--runslow", action="store_true",
                     help="also run the slow tests")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: takes minutes on the CPU (runs with --runslow)")


def pytest_collection_modifyitems(config, items):
    for item in items:
        if item.nodeid in SLOW:
            item.add_marker(pytest.mark.slow)
    if config.getoption("--runslow"):
        return
    skip = pytest.mark.skip(reason="slow: runs with --runslow")
    for item in items:
        if item.get_closest_marker("slow"):
            item.add_marker(skip)


@contextlib.contextmanager
def _time_limit(phase):
    # SIGALRM is handled on the main thread, where pytest-xdist runs tests
    def expire(signum, frame):
        faulthandler.dump_traceback(sys.stderr)
        pytest.fail(f"{phase} ran past the time limit of {TIME_LIMIT_S} s; "
                    "threads it started may still run (stacks on stderr)")

    previous = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, TIME_LIMIT_S)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, previous)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_setup(item):
    with _time_limit("setup"):
        return (yield)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_call(item):
    with _time_limit("call"):
        return (yield)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_teardown(item):
    with _time_limit("teardown"):
        return (yield)

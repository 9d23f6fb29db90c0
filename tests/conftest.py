"""Tier-1 collection config: skip triage.

A clean tier-1 run should read ``N passed`` — every line of the skip
column is supposed to be news.  The one environment-dependent module,
``test_properties.py`` (hypothesis example-breadth batteries), is
excluded at *collection* when hypothesis isn't installed instead of
reporting a perennial skip: each invariant it exercises has a
deterministic fixed-seed twin that runs unconditionally
(test_workloads.py, test_fingerprints.py, test_batched_lookup.py —
see its module docstring), so the exclusion loses example breadth,
never coverage.
"""

import importlib.util

collect_ignore = []
if importlib.util.find_spec("hypothesis") is None:
    collect_ignore.append("test_properties.py")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (runs on the card, skips "
        "without one)")

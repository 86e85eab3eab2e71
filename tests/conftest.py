"""Shared test config: marker registration + Hypothesis profiles.

Two Hypothesis profiles keep CI fast without weakening local runs:

- ``ci``  — ``max_examples`` capped (selected automatically when the ``CI``
  env var is set, as GitHub Actions does);
- ``dev`` — the full budget (200 examples), the default everywhere else.

Select explicitly with ``HYPOTHESIS_PROFILE=ci|dev``.
"""

import os

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: multi-device subprocess tests (minutes, not ms)")
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (a kernel with no CPU mode); "
        "skips without one")


try:
    from hypothesis import settings

    settings.register_profile("ci", max_examples=20, deadline=None,
                              stateful_step_count=15)
    settings.register_profile("dev", max_examples=200, deadline=None,
                              stateful_step_count=25)
    settings.load_profile(os.environ.get(
        "HYPOTHESIS_PROFILE", "ci" if os.environ.get("CI") else "dev"))
except ImportError:
    # A CI run that EXPLICITLY selected a hypothesis profile must not
    # silently drop the property/state-machine tests to 0 examples — that
    # is how a broken `pip install` once shipped a suite that "passed"
    # while the differential state machine never ran.  This covers both
    # the PR matrix (HYPOTHESIS_PROFILE=ci) and the nightly deep walk
    # (HYPOTHESIS_PROFILE=dev under CI).  Local containers without
    # hypothesis (no profile requested) still degrade gracefully.
    _profile = os.environ.get("HYPOTHESIS_PROFILE")
    if _profile == "ci" or (_profile and os.environ.get("CI")):
        raise RuntimeError(
            f"HYPOTHESIS_PROFILE={_profile} is set but the 'hypothesis' "
            "package is missing: the CI environment must `pip install -r "
            "requirements.txt` (which pins it). Refusing to skip the "
            "property tests silently.")

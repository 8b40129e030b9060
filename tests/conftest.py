import os
import sys
import types

# Make `repro` importable regardless of how pytest is invoked. Note: we do
# NOT set --xla_force_host_platform_device_count here — smoke tests must see
# one device; SPMD tests spawn subprocesses with their own XLA_FLAGS.
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def _install_hypothesis_stub() -> None:
    """If hypothesis is not installed (it is dev-only, see
    requirements-dev.txt), register a stub so test modules still import and
    their @given tests are skipped instead of killing collection."""
    try:
        import hypothesis  # noqa: F401
        return
    except ImportError:
        pass

    import pytest

    hyp = types.ModuleType("hypothesis")
    strategies = types.ModuleType("hypothesis.strategies")

    def given(*_args, **_kwargs):
        def deco(fn):
            def stub():
                pytest.skip("hypothesis not installed (pip install -r "
                            "requirements-dev.txt)")
            stub.__name__ = fn.__name__
            stub.__doc__ = fn.__doc__
            return stub
        return deco

    def settings(*_args, **_kwargs):
        return lambda fn: fn

    def _strategy(*_args, **_kwargs):
        return None

    hyp.given = given
    hyp.settings = settings
    hyp.strategies = strategies
    strategies.__getattr__ = lambda name: _strategy
    sys.modules["hypothesis"] = hyp
    sys.modules["hypothesis.strategies"] = strategies


_install_hypothesis_stub()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skipped without one (run on "
        "the card: pytest -m cuda tests/test_torch_cuda.py)")

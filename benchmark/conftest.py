"""pytest settings of the benchmark's own tests (``benchmark/tests``):
the ``card`` marker for tests that need an NVIDIA card, which skip on a
machine without one (each decides inside its ``card`` fixture)."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips elsewhere (decided "
        "inside the test's fixture)")

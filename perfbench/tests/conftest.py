"""pytest settings of the benchmark's own tests: the `gpu` marker (tests
that need the card skip here, deciding inside the test)."""


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs an NVIDIA GPU; skipped without one")

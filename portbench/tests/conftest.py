def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")

"""pytest settings for every run from the root of the repository: each
test runs under the time limit of tests/time_limit.py."""

pytest_plugins = ["tests.time_limit"]

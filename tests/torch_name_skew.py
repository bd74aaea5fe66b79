"""A pytest plugin (not collected) that advances the JAX package's symbol
auto-name counters before any test runs, as test files that ran earlier
on the same xdist worker do: every op hint's counter starts at 3 instead
of 0.  A port test that compares the names of unnamed ops (arguments,
outputs) across the two packages fails under it unless it builds them
under a fresh ``NameManager`` in each package.

    PYTHONPATH=tests JAX_PLATFORMS=cpu python -m pytest -p torch_name_skew \\
        tests/test_torch_c8_symbol.py
"""


class _Skewed(dict):
    """A counter in which every hint has been used three times."""

    def __contains__(self, hint):
        self.setdefault(hint, 3)
        return True


def pytest_configure(config):
    import mxnet_tpu as mx
    mx.name.current()._counter = _Skewed()

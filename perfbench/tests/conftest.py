import warnings

import pytest


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    """A checkout copy with the tiny cells added as new files (bf16)."""
    from perfbench.tests.tiny import make_root
    return make_root(tmp_path_factory.mktemp("bf16"))


@pytest.fixture(scope="session")
def tiny_root_f32(tmp_path_factory):
    from perfbench.tests.tiny import make_root
    return make_root(tmp_path_factory.mktemp("f32"), dtype="float32")


@pytest.fixture(autouse=True)
def _quiet():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        yield

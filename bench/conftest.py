"""The benchmark's CPU tests persist their plans in a temporary
directory of the session, never in the user's cache."""
import os

import pytest


@pytest.fixture(scope="session", autouse=True)
def _plans_in_a_temporary_directory(tmp_path_factory):
    old = os.environ.get("REPRO_CACHE_DIR")
    os.environ["REPRO_CACHE_DIR"] = str(tmp_path_factory.mktemp("bench_cache"))
    from repro_torch.core import autotune, graph
    autotune.clear_cache()
    graph.clear_cache()
    yield
    if old is None:
        os.environ.pop("REPRO_CACHE_DIR", None)
    else:
        os.environ["REPRO_CACHE_DIR"] = old

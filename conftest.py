"""Root pytest configuration: build the native host library once, in the
main process, before any test worker starts.

detex_tpu/native.py builds native/libdetex_host.so with g++ on first use,
writing straight to the final path (native.py:31-44). Under pytest-xdist
every worker that imports it while the library is missing (a fresh
checkout: .gitignore lists it) starts its own g++ on that path, and a
worker that loads a half-written file gets no library and skips its native
tests (the module-level skip of tests/test_mseed.py, the per-test skips of
tests/test_native.py). Building it here, in the controller (or the only
process without xdist), leaves the workers a finished file.

native.py is loaded from its path, not imported as detex_tpu.native: the
package's __init__ would import JAX before tests/conftest.py configures it.
"""
import importlib.util
from pathlib import Path


def pytest_configure(config):
    if hasattr(config, "workerinput"):      # an xdist worker
        return
    path = Path(__file__).resolve().parent / "detex_tpu" / "native.py"
    spec = importlib.util.spec_from_file_location("_detex_native_build",
                                                  path)
    native = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(native)
    native.available()

"""A fixture that caps PyTorch's CPU threads at two for a test module and
shares JAX's compilation cache among the run's test processes.

The tier-1 command runs several test processes on the machine's cores at
once; with one OpenMP thread per core in each of them, PyTorch's threads
spin against the other processes' and a test that takes 4 s alone takes
over 100 s. Test modules of the port import :func:`few_torch_threads`,
which is autouse, and so run their CPU tensor work on two threads.

Most of a port test's time is the JAX side's compiles, and the run's
processes compile many of the same programs (the tiny models' inits and
forwards, the same reference under several files). While a port module
runs, JAX's persistent compilation cache is on, in one directory of the
run's temporary directory that every worker of the run shares, for every
compile whatever its length; a program that one process compiled is then
read back by the others. The cache's settings are restored after the
module, so the JAX package's own tests run as they do without it.
"""

import contextlib
import os

import pytest
import torch

CACHE_SETTINGS = {
    "jax_compilation_cache_dir": None,  # set to the run's directory
    "jax_persistent_cache_min_compile_time_secs": 0.0,
    "jax_persistent_cache_min_entry_size_bytes": 0,
}


def _run_dir(tmp_path_factory) -> str:
    """The directory of this test run: the base temporary directory, or
    under pytest-xdist its parent, which the run's workers share."""
    base = tmp_path_factory.getbasetemp()
    return str(base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base)


@contextlib.contextmanager
def jax_compilation_cache(directory: str):
    """JAX's persistent compilation cache in ``directory`` for every
    compile, inside the block; nothing where JAX is absent (the card's runs
    of ``tests/test_torch_cuda.py``)."""
    try:
        import jax
        from jax._src import compilation_cache
    except ImportError:
        yield
        return
    before = {k: getattr(jax.config, k) for k in CACHE_SETTINGS}
    for k, v in {**CACHE_SETTINGS, "jax_compilation_cache_dir": directory}.items():
        jax.config.update(k, v)
    compilation_cache.reset_cache()  # a process that compiled already checked the cache off
    try:
        yield
    finally:
        for k, v in before.items():
            jax.config.update(k, v)
        compilation_cache.reset_cache()


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads(tmp_path_factory):
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    with jax_compilation_cache(os.path.join(_run_dir(tmp_path_factory), "jax_compilation_cache")):
        yield
    torch.set_num_threads(n)

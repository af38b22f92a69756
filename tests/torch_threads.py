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

The JAX package's VGG19 surrogate (``losses/content.py``
``load_vgg19_params``) is built op by op, ~10 s a call, by every JAX
``Trainer`` of a GAN config and every content loss; while a port module
runs, the run builds each node set once (the first process writes it to
the run's directory, the others read it) and hands the later callers a
copy of the same arrays.
"""

import contextlib
import hashlib
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


_vgg19: dict = {}  # (nodes, npz path, $SRGANFD_VGG19_NPZ) -> load_vgg19_params' result, in this process


@contextlib.contextmanager
def vgg19_built_once(directory: str):
    """``srganfd_tpu.losses.content.load_vgg19_params`` memoised inside the
    block: the first call per argument set in this process runs it, later
    ones get a copy of its pytree (the same arrays). The seeded surrogate
    (no weights file) is also written to ``directory`` as an .npz, which the
    run's other processes read instead of building it (the same values: the
    arrays round-trip exactly). Nothing where JAX is absent."""
    try:
        import jax
        import jax.numpy as jnp
        import numpy as np
        from srganfd_tpu.losses import content
    except ImportError:
        yield
        return
    build = content.load_vgg19_params

    def shared(nodes):
        name = hashlib.sha256(repr(tuple(nodes)).encode()).hexdigest()[:16]
        path = os.path.join(directory, f"vgg19_surrogate_{name}.npz")
        if os.path.exists(path):
            tree: dict = {}
            with np.load(path) as data:
                for flat, arr in data.items():
                    *parents, leaf = flat.split("/")
                    node = tree
                    for p_ in parents:
                        node = node.setdefault(p_, {})
                    node[leaf] = jnp.asarray(arr)
            return tree, False
        variables, pretrained = build(nodes, None)
        flat = {"/".join(str(k.key) for k in path_): np.asarray(leaf)
                for path_, leaf in jax.tree_util.tree_flatten_with_path(variables)[0]}
        os.makedirs(directory, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.npz"
        np.savez(tmp, **flat)
        os.replace(tmp, path)  # atomic: a concurrent reader never sees half a file
        return variables, pretrained

    def load(nodes, npz_path=None):
        env = os.environ.get("SRGANFD_VGG19_NPZ", "")
        key = (tuple(nodes), npz_path, env)
        if key not in _vgg19:
            seeded = not (npz_path and os.path.exists(npz_path)) and not (env and os.path.exists(env))
            _vgg19[key] = shared(nodes) if seeded else build(nodes, npz_path)
        variables, pretrained = _vgg19[key]
        return jax.tree_util.tree_map(lambda a: a, variables), pretrained

    content.load_vgg19_params = load
    try:
        yield
    finally:
        content.load_vgg19_params = build


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads(tmp_path_factory):
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    run_dir = _run_dir(tmp_path_factory)
    with jax_compilation_cache(os.path.join(run_dir, "jax_compilation_cache")), \
            vgg19_built_once(os.path.join(run_dir, "vgg19_surrogates")):
        yield
    torch.set_num_threads(n)

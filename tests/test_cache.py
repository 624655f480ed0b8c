"""The compile-cache rule (utils/cache.py): JAX_COMPILATION_CACHE_DIR wins
and no other directory is set; otherwise the fixed <checkout>/.jax_cache,
with a host-keyed subdirectory for CPU runs."""

import os
import subprocess
import sys

from cpprcoder_tpu.utils import cache


def test_env_var_names_the_directory():
    assert cache.cache_dir("cpu", {cache.ENV_VAR: "/some/dir"}) is None
    assert cache.cache_dir("cuda", {cache.ENV_VAR: "/some/dir"}) is None


def test_cpu_default_is_host_keyed():
    path = cache.cache_dir("cpu", {})
    assert os.path.dirname(path) == cache.DEFAULT_DIR
    assert os.path.basename(path).startswith("cpu-")
    assert path == cache.cache_dir("cpu", {cache.ENV_VAR: ""})


def test_device_default_is_the_fixed_directory():
    assert cache.cache_dir("", {}) == cache.DEFAULT_DIR
    assert cache.cache_dir("cuda", {}) == cache.DEFAULT_DIR
    assert cache.DEFAULT_DIR == os.path.abspath(
        os.path.join(os.path.dirname(cache.__file__), "..", "..",
                     ".jax_cache"))


def test_env_var_is_honoured_in_a_fresh_process(tmp_path):
    want = str(tmp_path / "jaxcache")
    code = ("import jax; jax.config.update('jax_platforms', 'cpu');"
            "from cpprcoder_tpu.utils.cache import enable_compilation_cache;"
            "print(enable_compilation_cache())")
    env = dict(os.environ, JAX_COMPILATION_CACHE_DIR=want)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=root,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip().splitlines()[-1] == want

"""Run-time environment: the GPU-only entry points refuse the CPU, the
compile cache's directory, the CLI's device handling and the native
library's build tag."""
import importlib.util
import os

import jax
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("argv", [[], ["--devices", "4"]])
def test_chip_smoke_stops_before_any_phase_on_cpu(argv, capsys):
    cs = _load_chip_smoke()
    with pytest.raises(RuntimeError, match="needs a GPU"):
        cs.main(argv)
    out = capsys.readouterr().out
    assert "platform=cpu" in out
    assert "[" not in out and '"ok"' not in out     # no phase, no result


def test_compile_cache_dir_honours_env(monkeypatch, tmp_path):
    from faspsolver_tpu.utils.runtime import cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cache_dir() == str(tmp_path)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    assert cache_dir() == os.path.join(REPO, ".jax_cache")


def test_cli_runs_on_default_device(monkeypatch, capsys):
    """The CLI solves in f64 on JAX's default device: it never touches
    ``jax_platforms``."""
    from faspsolver_tpu.__main__ import main

    updates = []
    real_update = jax.config.update

    def record(name, value):
        updates.append(name)
        real_update(name, value)

    monkeypatch.setattr(jax.config, "update", record)
    platforms = jax.config.jax_platforms
    rc = main(["-problem", "poisson2d", "-size", "31", "-precond", "2",
               "-tol", "1e-8"])
    assert rc == 0
    assert "jax_platforms" not in updates
    assert jax.config.jax_platforms == platforms
    assert "relative residual" in capsys.readouterr().out


def test_native_lib_tag_tracks_sources_flags_and_host(tmp_path):
    from faspsolver_tpu import native

    src = tmp_path / "k.cpp"
    src.write_text("int f() { return 1; }\n")
    base = native.lib_tag([str(src)], ("-O3",), "host-a")
    assert native.lib_tag([str(src)], ("-O3",), "host-a") == base
    assert native.lib_tag([str(src)], ("-O2",), "host-a") != base
    assert native.lib_tag([str(src)], ("-O3",), "host-b") != base
    src.write_text("int f() { return 2; }\n")
    edited = native.lib_tag([str(src)], ("-O3",), "host-a")
    assert edited != base
    assert native.lib_path(edited) != native.lib_path(base)


def test_native_loads_only_the_library_built_for_this_host():
    """The loaded library is the one named for the current sources, flags
    and CPU — never an untagged or differently tagged file."""
    from faspsolver_tpu import native

    path = native.build()
    assert os.path.basename(path) == f"_fasp_native-{native.lib_tag()}.so"
    assert native.lib_tag() != native.lib_tag(host="another cpu")
    assert native.available()

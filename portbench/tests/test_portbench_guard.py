"""The check for modules the benchmark may not load compares whole
top-level names."""

import sys
import types

import pytest

from portbench import harness


@pytest.mark.parametrize("name,found", [
    ("tpucomp", ["tpucomp"]), ("tpucomp.codecs", ["tpucomp"]),
    ("jax.numpy", ["jax"]), ("jaxlib", ["jaxlib"]), ("flax.linen", ["flax"]),
    ("tpucomp_torch", []), ("tpucomp_torch.api", []), ("jaxtyping", []),
])
def test_top_level_names_compared_whole(name, found, monkeypatch):
    base = harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert harness.forbidden_modules() == sorted(set(base) | set(found))


def test_the_benchmark_loads_none():
    import portbench.control  # noqa: F401
    import portbench.harness  # noqa: F401
    import portbench.ref  # noqa: F401
    import tpucomp_torch  # noqa: F401

    loaded = {m.split(".")[0] for m in sys.modules}
    # the test process may hold what other tests loaded; the benchmark's
    # and the port's own modules add nothing forbidden
    assert "portbench" in loaded and "tpucomp_torch" in loaded
    import subprocess
    code = ("import sys; sys.path.insert(0, '.');"
            "import portbench.harness, portbench.control, tpucomp_torch;"
            "from portbench import harness;"
            "print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         cwd=harness.spec.os.path.dirname(harness.spec.ROOT))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"

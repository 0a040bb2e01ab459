"""Nothing a run loads is JAX or the JAX package, compared by whole
top-level names (the port's ``repro_torch`` begins with ``repro``)."""
import subprocess
import sys

from hrmbench import harness


def test_whole_top_level_names(monkeypatch):
    for name in ("repro_torch", "repro_torch.serve", "jaxtyping",
                 "reproducible"):
        monkeypatch.setitem(sys.modules, name, sys)
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    monkeypatch.delitem(sys.modules, "repro", raising=False)
    for name in list(sys.modules):
        if name.split(".")[0] in harness.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    monkeypatch.setitem(sys.modules, "jaxlib", sys)
    assert harness.forbidden_modules() == ["jaxlib", "repro.core"]


def test_the_harness_and_the_port_load_no_jax():
    code = ("import sys; sys.path[:0] = [sys.argv[1], sys.argv[1] + '/src'];"
            "from hrmbench import harness, run, sweep, calibrate;"
            "from hrmbench.drivers import online, batch, campaign;"
            "import repro_torch.models, repro_torch.core;"
            "print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code, str(harness.ROOT)],
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"

"""The PyTorch port stands alone: importing ``repro_torch`` and every one
of its modules loads no ``jax`` and nothing of the ``repro`` package, and
its entry points that create tensors go to the card unless the caller
passes a device."""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_tiny
from repro_torch.convert import state_from_numpy
from repro_torch.graph import graph_state, powerlaw_graph
from repro_torch.models import init_cache, init_params

SRC = Path(__file__).resolve().parents[1] / "src"


def test_import_loads_no_jax_and_no_reference():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch.")]
        for name in names:
            importlib.import_module(name)
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        assert not bad, bad
        print(len(names))
    """)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20      # every module was imported


def test_graph_import_loads_no_jax_and_no_reference():
    """The graph slice alone: ``repro_torch.graph`` and its kernels pull in
    only torch, numpy and the port."""
    code = textwrap.dedent("""
        import sys
        import repro_torch.graph, repro_torch.kernels.segsum
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        assert not bad, bad
        assert "repro_torch.graph.bfs" in sys.modules
    """)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_entry_points_need_a_device_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    cfg = get_tiny("llama3-8b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_cache(cfg, 1, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        state_from_numpy({"w": np.zeros(3, np.float32)})
    g = powerlaw_graph(64, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        graph_state(g)
    assert init_params(cfg, device="cpu")["embed"].device.type == "cpu"
    assert graph_state(g, device="cpu")["rank"]["rank"].device.type == "cpu"

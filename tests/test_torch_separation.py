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
from repro_torch.data.synthetic import lm_batch
from repro_torch.graph import graph_state, powerlaw_graph
from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.configs.base import TrainConfig
from repro_torch.launch import explore, serve, train
from repro_torch.models import init_cache, init_params
from repro_torch.runtime.steps import init_train_state
from repro_torch.runtime.train_loop import LoopConfig, run_training

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


def test_campaign_slice_loads_no_jax_and_no_reference():
    """The campaign slice alone: the model forward, the synthetic data, the
    campaign, the auto-tuner and the explorer pull in only torch, numpy and
    the port."""
    code = textwrap.dedent("""
        import sys
        import repro_torch.models, repro_torch.data.synthetic
        import repro_torch.core.characterize, repro_torch.core.autopolicy
        import repro_torch.launch.explore
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        assert not bad, bad
        assert "repro_torch.models.attention" in sys.modules
    """)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_serve_and_trace_slice_loads_no_jax_and_no_reference():
    """The serving and trace slice alone: the runtime, the serve launcher
    and the trace engine pull in only torch, numpy and the port, and
    ``python -m repro_torch.launch.serve --device cpu`` runs."""
    code = textwrap.dedent("""
        import sys
        import repro_torch.runtime.steps, repro_torch.runtime.serve_loop
        import repro_torch.launch.serve
        import repro_torch.core.trace, repro_torch.core.tracegen
        import repro_torch.draws
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        assert not bad, bad
        assert "repro_torch.models.attention" in sys.modules
    """)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--batch", "2", "--prompt-len", "8", "--new-tokens", "4",
         "--policy", "typical_server", "--error-rate", "0.5"],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines()[-1].startswith("tokens=8 corrected=")


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
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm_batch(cfg, 1, 4, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        explore.main(["--dry-run"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main([])
    g = powerlaw_graph(64, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        graph_state(g)
    assert init_params(cfg, device="cpu")["embed"].device.type == "cpu"
    assert graph_state(g, device="cpu")["rank"]["rank"].device.type == "cpu"


def test_train_slice_loads_no_jax_and_no_reference(tmp_path):
    """The training slice alone: the train loop, the checkpoint store, the
    optimizer and the train launcher pull in only torch, numpy and the
    port, and ``python -m repro_torch.launch.train --tiny --device cpu``
    runs."""
    code = textwrap.dedent("""
        import sys
        import repro_torch.runtime.train_loop, repro_torch.checkpoint.store
        import repro_torch.optim.adamw, repro_torch.optim.compress
        import repro_torch.launch.train
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        assert not bad, bad
        assert "repro_torch.runtime.steps" in sys.modules
    """)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--tiny",
         "--device", "cpu", "--steps", "4", "--batch", "2", "--seq", "16",
         "--policy", "typical_server", "--error-rate", "1.0",
         "--scrub-interval", "2", "--ckpt-dir", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines()[-1].startswith("injected=")
    assert (tmp_path / "step_00000000" / "meta.json").exists()


def test_train_entry_points_need_a_device_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    cfg = get_tiny("lm-100m")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_train_state(0, cfg, TrainConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CheckpointStore(tmp_path / "a")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_training(cfg, TrainConfig(), LoopConfig(
            steps=1, ckpt_dir=str(tmp_path / "b")), iter(()))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--tiny", "--ckpt-dir", str(tmp_path / "c")])
    assert not (tmp_path / "a").exists() and not (tmp_path / "b").exists()
    state = init_train_state(0, cfg, TrainConfig(), device="cpu")
    assert state["opt"]["count"].device.type == "cpu"
    assert CheckpointStore(tmp_path / "d", device="cpu").device.type == "cpu"


def test_online_serving_slice_loads_no_jax_and_no_reference():
    """The online serving plane alone: ``repro_torch.serve`` and its
    launcher pull in only torch, numpy and the port, and
    ``python -m repro_torch.launch.serve_online --device cpu`` runs."""
    code = textwrap.dedent("""
        import sys
        import repro_torch.serve, repro_torch.launch.serve_online
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        assert not bad, bad
        assert "repro_torch.serve.engine" in sys.modules
    """)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve_online",
         "--device", "cpu", "--requests", "4", "--rate", "40", "--slots",
         "2", "--policy", "detect_recover", "--kv-tier", "parity_r",
         "--storm-errors", "20"],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines()[-1].startswith("availability ")


def test_serve_online_needs_a_device_without_a_card():
    """Without ``--device`` and without a card the launcher exits non-zero
    and names the device to pass; nothing runs on the CPU instead."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    for extra in ([], ["--dry-run"]):
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve_online",
             *extra], env=env, capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert "device='cpu'" in out.stderr
        assert not out.stdout


def test_sharded_and_examples_slice_loads_no_jax_and_no_reference():
    """The sharded domains, the domain mesh and every example entry point
    pull in only torch, numpy and the port, and ``python -m
    repro_torch.examples.sharded_domain --placement virtual --device cpu``
    runs."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import repro_torch.core.sharded, repro_torch.launch.mesh
        import repro_torch.examples
        names = [m.name for m in pkgutil.iter_modules(
            repro_torch.examples.__path__, "repro_torch.examples.")]
        for name in names:
            importlib.import_module(name)
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        assert not bad, bad
        print(" ".join(sorted(n.rsplit(".", 1)[-1] for n in names)))
    """)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert set(out.stdout.split()) >= {
        "quickstart", "serve_kv", "graph_pagerank", "train_hrm",
        "characterize", "sharded_domain"}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.sharded_domain",
         "--placement", "virtual", "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines()[-1] == "SHARDED SMOKE OK"


def test_families_slice_loads_no_jax_and_no_reference():
    """The MoE, hybrid and xLSTM families alone: their configs, mixers and
    the paged engine pull in only torch, numpy and the port, and ``python
    -m repro_torch.launch.serve --arch <family> --device cpu`` runs each
    of them."""
    code = textwrap.dedent("""
        import sys
        import repro_torch.models.mlp, repro_torch.models.gla
        import repro_torch.models.mamba2, repro_torch.models.xlstm
        import repro_torch.serve.engine, repro_torch.serve.paged_kv
        from repro_torch.configs import get_tiny
        for arch in ("granite-moe-3b-a800m", "deepseek-moe-16b",
                     "zamba2-2.7b", "xlstm-350m"):
            get_tiny(arch)
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        assert not bad, bad
        assert "repro_torch.configs.zamba2_2p7b" in sys.modules
    """)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    for arch in ("granite-moe-3b-a800m", "zamba2-2.7b", "xlstm-350m"):
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
             arch, "--device", "cpu", "--batch", "2", "--new-tokens", "4"],
            env=env, capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stderr
        assert out.stdout.splitlines()[-1] == \
            "tokens=8 corrected=0 detected=0 injected=0"


def test_last_slice_loads_no_jax_and_no_reference():
    """The launch tooling, elastic resharding and the legacy per-leaf shims
    alone pull in only torch, numpy and the port, and ``python -m
    repro_torch.launch.dryrun`` runs a full-size cell on a fake mesh."""
    code = textwrap.dedent("""
        import sys
        import repro_torch.launch.specs, repro_torch.launch.modelflops
        import repro_torch.launch.modelbytes, repro_torch.launch.step_cost
        import repro_torch.launch.dryrun, repro_torch.runtime.elastic
        import repro_torch.core.scrubber, repro_torch.core.injection
        import repro_torch.core.sidecar, repro_torch.core.recovery
        import repro_torch.examples.elastic_reshard
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        assert not bad, bad
    """)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr

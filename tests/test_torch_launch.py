"""The port's launch tooling against the JAX reference on the CPU.

* The shape table (``TRAIN_4K`` … ``LONG_500K``, ``SHAPE_BY_NAME``) and
  ``shape_applicability`` equal the reference's for every config and shape.
* ``param_count``, ``active_params``, ``model_flops`` and
  ``analytic_bytes`` (with and without a ``TrainConfig``) equal the
  reference's for all 12 configs x 4 shapes at their full size, to rtol
  1e-12: the port's trees are ``meta`` tensors, the reference's
  ``jax.eval_shape`` structs, and both sums are the same float arithmetic.
* ``step_cost.analyze`` counts every trip of a loop (the counterparts of
  ``tests/test_launch.py``'s scan tests), tiny llama3-8b's ``loss_fn`` and
  ``remat="none"`` train step exactly as the reference's
  ``hlo_cost.analyze`` counts the compiled programs, and a hand-built
  all-reduce's link bytes by the reference's ring factor, which is copied
  exactly.
* The dry-run, in a subprocess (its fake process group is process-wide):
  a train cell of five tiny families on a fake 8-rank (2, 4) mesh, and
  one full-size cell at SINGLE_POD through the CLI, each ``ok`` with
  FLOPs > 0 and the reference's record keys.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import SHAPE_BY_NAME as JSHAPE_BY_NAME
from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.configs import get_tiny as jget_tiny
from repro.configs import shape_applicability as jshape_applicability
from repro.configs.base import TrainConfig as JTrainConfig
from repro.launch import hlo_analysis as jhlo_analysis
from repro.launch import modelbytes as jmodelbytes
from repro.launch import modelflops as jmodelflops
from repro.launch import specs as jspecs
from repro.launch.hlo_cost import analyze as janalyze
from repro.models.transformer import init_params as jinit_params
from repro.models.transformer import loss_fn as jloss_fn
from repro_torch.configs import (SHAPE_BY_NAME, SHAPES, TrainConfig,
                                 get_config, get_tiny, list_archs,
                                 shape_applicability)
from repro_torch.data.synthetic import lm_batch
from repro_torch.launch import modelbytes, modelflops, specs, step_cost
from repro_torch.models import loss_fn
from repro_torch.runtime.steps import init_train_state, make_train_step

SRC = Path(__file__).resolve().parents[1] / "src"
ARCHS = list_archs()
RTOL = 1e-12
# tiny llama3-8b at a batch of 8 x 64: the reference's hlo_cost.analyze of
# its compiled train step with remat="none" (its loss_fn is compiled live
# below)
TRAIN_STEP_FLOPS = 327_155_712
LOSS_FLOPS = 109_051_904


# ------------------------------------------------------------ shape table
def test_shape_table_equals_reference():
    assert [(s.name, s.seq_len, s.global_batch, s.kind) for s in SHAPES] == \
        [(s.name, s.seq_len, s.global_batch, s.kind) for s in JSHAPES]
    assert list(SHAPE_BY_NAME) == list(JSHAPE_BY_NAME)
    for arch in ARCHS:
        for s, js in zip(SHAPES, JSHAPES):
            assert shape_applicability(get_config(arch), s) == \
                jshape_applicability(jget_config(arch), js), (arch, s.name)


# ------------------------------------------------- model FLOPs and bytes
@pytest.mark.parametrize("arch", ARCHS)
def test_counts_flops_and_bytes_equal_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert specs.param_count(cfg) == jspecs.param_count(jcfg)
    np.testing.assert_allclose(modelflops.active_params(cfg),
                               jmodelflops.active_params(jcfg), rtol=RTOL)
    for s, js in zip(SHAPES, JSHAPES):
        assert specs.default_train_config(cfg, s).microbatches == \
            jspecs.default_train_config(jcfg, js).microbatches
        np.testing.assert_allclose(modelflops.model_flops(cfg, s),
                                   jmodelflops.model_flops(jcfg, js),
                                   rtol=RTOL)
        for n_dev in (256, 512):
            for tc, jtc in ((None, None),
                            (TrainConfig(remat="none"),
                             JTrainConfig(remat="none"))):
                np.testing.assert_allclose(
                    modelbytes.analytic_bytes(cfg, s, n_dev, tc),
                    jmodelbytes.analytic_bytes(jcfg, js, n_dev, jtc),
                    rtol=RTOL, err_msg=f"{arch} {s.name} {n_dev} {tc}")


def test_param_counts_match_public_sizes():
    expect = {
        "llama3-8b": (7.5e9, 8.5e9),
        "llama3-405b": (3.9e11, 4.2e11),
        "qwen2-72b": (7.0e10, 7.5e10),
        "nemotron-4-340b": (3.2e11, 3.5e11),
        "deepseek-moe-16b": (1.5e10, 1.8e10),
        "zamba2-2.7b": (2.2e9, 3.2e9),
        "xlstm-350m": (3.0e8, 5.5e8),
        "hubert-xlarge": (8e8, 1.1e9),
        "llava-next-mistral-7b": (6.8e9, 7.8e9),
        "granite-moe-3b-a800m": (2.6e9, 3.9e9),
    }
    for arch, (lo, hi) in expect.items():
        n = specs.param_count(get_config(arch))
        assert lo <= n <= hi, f"{arch}: {n:.3e} not in [{lo:.1e},{hi:.1e}]"


def test_active_params_moe():
    cfg = get_config("deepseek-moe-16b")
    assert 2.0e9 <= modelflops.active_params(cfg) <= 3.5e9
    assert modelflops.model_flops(cfg, SHAPE_BY_NAME["train_4k"]) > 0


def test_specs_are_meta_stand_ins():
    cfg = get_config("llava-next-mistral-7b")
    b = specs.batch_specs(cfg, SHAPE_BY_NAME["prefill_32k"])
    assert {k: tuple(v.shape) for k, v in b.items()} == {
        "tokens": (32, 32768 - cfg.n_patches),
        "patches": (32, cfg.n_patches, cfg.d_model),
        "labels": (32, 32768 - cfg.n_patches)}
    cache, tok, pos = specs.decode_specs(get_config("llama3-405b"),
                                         SHAPE_BY_NAME["decode_32k"])
    assert all(t.is_meta for t in [*b.values(), *cache.values(), tok])
    assert pos == 32767 and tuple(tok.shape) == (128,)


# ------------------------------------------------------------- step cost
def test_analyze_counts_every_loop_trip():
    w, x = torch.zeros(16, 16), torch.zeros(4, 16)

    def looped(w, x):
        for _ in range(12):
            x = torch.tanh(x @ w)
        return x
    cost = step_cost.analyze(looped, w, x)
    assert cost.flops == 2 * 4 * 16 * 16 * 12 and cost.unknown_loops == 0

    w, x = torch.zeros(8, 8), torch.zeros(2, 8)

    def nested(w, x):
        for _ in range(5):
            for _ in range(3):
                x = x @ w
        return x
    assert step_cost.analyze(nested, w, x).flops == 2 * 2 * 8 * 8 * 15


def test_analyze_counts_the_reference_flops_of_tiny_llama():
    cfg = get_tiny("llama3-8b")
    tcfg = TrainConfig(remat="none")
    state = init_train_state(0, cfg, tcfg, device="cpu")
    batch = lm_batch(cfg, 8, 64, 0, device="cpu")
    cost = step_cost.analyze(loss_fn, state["params"], batch, cfg)
    with FlopCounterMode(display=False) as fc:
        loss_fn(state["params"], batch, cfg)
    jcfg = jget_tiny("llama3-8b")
    jp = jax.eval_shape(lambda: jinit_params(jax.random.PRNGKey(0), jcfg))
    jb = {k: jax.ShapeDtypeStruct(tuple(v.shape), jnp.int32)
          for k, v in batch.items()}
    text = jax.jit(lambda p, b: jloss_fn(p, b, jcfg)[0]).lower(
        jp, jb).compile().as_text()
    assert cost.flops == fc.get_total_flops() == janalyze(text).flops \
        == LOSS_FLOPS
    step = make_train_step(cfg, tcfg)
    assert step_cost.analyze(step, state, batch).flops == TRAIN_STEP_FLOPS
    assert cost.hbm_bytes > 0 and cost.coll_ops == {}


def test_ring_factor_is_the_reference():
    for kind in ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                 "collective-permute"):
        for g in range(1, 17):
            assert step_cost._ring_factor(kind, g) == \
                jhlo_analysis._ring_factor(kind, g), (kind, g)


def test_roofline_terms_use_the_card():
    t = step_cost.RooflineTerms(step_cost.PEAK_FLOPS, 2 * step_cost.HBM_BW,
                                step_cost.LINK_BW / 2, 1)
    assert (t.compute_s, t.memory_s, t.collective_s) == (1.0, 2.0, 0.5)
    assert t.dominant == "memory" and t.bound_s == 2.0
    assert set(t.to_dict()) == set(jhlo_analysis.RooflineTerms(
        1.0, 1.0, 1.0, 1).to_dict())


# ---------------------------------------------- dry-run (a subprocess)
DRYRUN = textwrap.dedent("""
    import json, sys
    import torch
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.configs import MeshConfig, TrainConfig, get_tiny
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun, step_cost
    out = {}
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    ar = torch.zeros(1024, 32)
    ag = torch.zeros(64, 128, dtype=torch.bfloat16)
    cost = step_cost.analyze(lambda: (
        funcol.all_reduce(ar, "sum", dist.group.WORLD).wait(),
        funcol.all_gather_tensor(ag, 0, dist.group.WORLD).wait()))
    out["collectives"] = cost.to_dict()
    for arch in ("llama3-8b", "deepseek-moe-16b", "zamba2-2.7b",
                 "xlstm-350m", "hubert-xlarge"):
        rec = dryrun.run_cell(get_tiny(arch), ShapeSpec("t", 16, 8, "train"),
                              MeshConfig((2, 4)), tcfg_override=TrainConfig(
                                  microbatches=2, remat="full"))
        out[arch] = rec
    dryrun.main(["--arch", "llama3-8b", "--shape", "decode_32k",
                 "--out", sys.argv[1]])
    print(json.dumps(out))
""")


def test_dryrun_tiny_mesh_and_a_full_cell_subprocess(tmp_path):
    path = tmp_path / "dryrun.json"
    r = subprocess.run([sys.executable, "-c", DRYRUN, str(path)],
                       capture_output=True, text=True, timeout=600,
                       env=dict(os.environ, PYTHONPATH=str(SRC)))
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    coll = out.pop("collectives")
    ar, ag = 1024 * 32 * 4, 4 * 64 * 128 * 2
    assert coll["coll_ops"] == {"all-reduce": 1, "all-gather": 1}
    assert coll["coll_bytes"] == {"all-reduce": ar, "all-gather": ag}
    assert coll["coll_link_bytes"] == {"all-reduce": ar * 2 * 3 / 4,
                                       "all-gather": ag * 3 / 4}
    for arch, rec in out.items():
        assert rec["status"] == "ok", (arch, rec)
        assert rec["hlo"]["flops"] > 0 and rec["n_devices"] == 8, arch
        assert rec["hlo"]["total_coll_link_bytes"] > 0, arch
        assert rec["tcfg"] == {"microbatches": 2, "remat": "full",
                               "grad_compress": False}
        assert rec["memory"]["argument_size_in_bytes"] > 0
        assert rec["memory"]["temp_size_in_bytes"] is None
    full = json.loads(path.read_text())["llama3-8b|decode_32k|single"]
    assert full["status"] == "ok" and full["n_devices"] == 256
    assert {"tp_only", "memory", "hlo", "model_flops_global",
            "analytic_bytes_per_device"} <= set(full)
    assert full["hlo"]["flops"] > 0 and full["hlo"]["unknown_loops"] == 0

"""The port's CRC-hardened checkpoint store: the cases of
``tests/test_checkpoint_hardened.py`` against ``repro_torch``'s store, the
bytes-on-disk contract shared with the reference (each package verifies
and loads the other's snapshots, bit for bit, and both write the same
``meta.json``), and a ``MemoryDomain`` over the converted train state
whose sidecars and scrub reports equal the reference's.

Everything here is exact: snapshots are raw bytes, sidecars are
bit-math. The reference's store and domain run as its own tests run them
(Pallas in interpret mode on the CPU); the port's on the CPU with its
plain kernel versions."""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.store import CheckpointStore as JStore
from repro.configs import get_tiny as jget_tiny
from repro.configs.base import TrainConfig as JTrainConfig
from repro.core import MemoryDomain as JDomain
from repro.core.policy import DESIGN_POINTS as JDESIGN_POINTS
from repro.runtime.steps import init_train_state as jinit_train_state
from repro_torch.checkpoint.store import (MANIFEST_KEY, CheckpointStore,
                                          SnapshotCorruptError)
from repro_torch.convert import (sidecar_to_numpy, state_from_numpy,
                                 state_to_numpy)
from repro_torch.core import (DESIGN_POINTS, HRMPolicy, MemoryDomain,
                              RestartRequired, Tier, tree)

CPU = "cpu"


def _store(path):
    return CheckpointStore(path, device=CPU)


def _state():
    return {"params": {
        "embed": torch.arange(4096, dtype=torch.float32).reshape(64, 64),
        "mlp": torch.ones((64, 64), dtype=torch.float32) * 0.5}}


def _same_tree(a, b) -> None:
    fa, fb = tree.flatten_with_path(a), tree.flatten_with_path(b)
    assert fa[1] == fb[1]
    for (path, x), (_, y) in zip(fa[0], fb[0]):
        assert x.dtype == y.dtype and x.shape == y.shape, path
        assert torch.equal(x.reshape(-1).view(torch.uint8),
                           y.reshape(-1).view(torch.uint8)), path


def _corrupt_data(store, step, flip_at=0.5):
    p = Path(store.dir) / f"step_{step:08d}" / "data.npz"
    raw = bytearray(p.read_bytes())
    raw[int(len(raw) * flip_at)] ^= 0xFF
    p.write_bytes(bytes(raw))


# ------------------------------------------------ the hardened cases
def test_crc_rejects_corrupt_and_falls_back(tmp_path):
    store = _store(tmp_path)
    state = _state()
    store.save(1, state)
    store.save(2, state)
    assert store.verifies(2)
    _corrupt_data(store, 2)
    assert not store.verifies(2)
    out = store.load(2, state)
    assert store.last_loaded_step == 1           # fell back
    _same_tree(out, state)


def test_manifest_rejects_meta_tamper(tmp_path):
    store = _store(tmp_path)
    state = _state()
    store.save(1, state)
    store.save(2, state)
    mp = Path(store.dir) / "step_00000002" / "meta.json"
    meta = json.loads(mp.read_text())
    key = next(k for k in meta if k != MANIFEST_KEY)
    meta[key]["dtype"] = "float64"               # lie about the dtype
    mp.write_text(json.dumps(meta))
    assert not store.verifies(2)
    store.load(2, state)
    assert store.last_loaded_step == 1


def test_restart_required_when_nothing_verifies(tmp_path):
    store = _store(tmp_path)
    state = _state()
    store.save(1, state)
    store.save(2, state)
    _corrupt_data(store, 1)
    _corrupt_data(store, 2)
    with pytest.raises(RestartRequired):
        store.load(2, state)
    with pytest.raises(SnapshotCorruptError):
        store.load(2, state, fallback=False)


def test_unreadable_snapshot_is_corrupt_not_crash(tmp_path):
    store = _store(tmp_path)
    store.save(1, _state())
    store.save(2, _state())
    (Path(store.dir) / "step_00000002" / "data.npz").write_bytes(
        b"PK\x03\x04 truncated")
    store.load(2, _state())
    assert store.last_loaded_step == 1


def test_legacy_snapshot_without_crcs_still_loads(tmp_path):
    store = _store(tmp_path)
    state = _state()
    store.save(1, state)
    mp = Path(store.dir) / "step_00000001" / "meta.json"
    meta = json.loads(mp.read_text())
    meta.pop(MANIFEST_KEY)
    for m in meta.values():
        m.pop("crc32")
    mp.write_text(json.dumps(meta))
    assert store.verifies(1)                     # vacuous but accepted
    _same_tree(store.load(1, state), state)


def test_crash_mid_write_sweeps_tmp_and_keeps_previous(tmp_path):
    store = _store(tmp_path)
    state = _state()
    store.save(1, state)
    dead = Path(store.dir) / ".tmp_dead123"
    dead.mkdir()
    (dead / "data.npz").write_bytes(b"half a zip")
    store2 = _store(tmp_path)                    # fresh process restarts
    assert not dead.exists()                     # swept on construction
    assert store2.steps() == [1]
    assert store2.latest_step() == 1
    _same_tree(store2.load(1, state), state)


def test_checkpoint_bf16_roundtrip_verified(tmp_path):
    store = _store(tmp_path)
    state = {"w": torch.arange(1024, dtype=torch.bfloat16) * 0.125}
    store.save(0, state)
    assert store.verifies(0)
    out = store.load(0, state)
    assert out["w"].dtype == torch.bfloat16
    _same_tree(out, state)


def test_uint4_snapshot_raises_naming_the_dtype(tmp_path):
    """The reference's ``uint4`` leaf: its snapshot verifies in the port
    (CRCs cover raw bytes), but torch cannot hold the dtype, so loading
    it raises an error that names it; the uint8 leaf beside it loads."""
    nib = np.arange(16, dtype=np.uint8)
    JStore(tmp_path).save(0, {"packed": jnp.asarray((nib << 4) | nib),
                              "u4": jnp.arange(16, dtype=jnp.uint4)})
    store = _store(tmp_path)
    assert store.verifies(0)
    with pytest.raises(TypeError, match="'u4'.*'uint4'"):
        store.load_flat(0)
    with pytest.raises(TypeError, match="uint4"):
        store.load(0, {"packed": torch.zeros(16, dtype=torch.uint8),
                       "u4": torch.zeros(16, dtype=torch.uint8)})


def test_corrupt_snapshot_never_reaches_domain(tmp_path):
    """A Par+R domain under an error storm recovers from its checkpoint
    while the newest snapshot is corrupt: the CRC refuses it, recovery
    falls back to the older verifying snapshot, and the healed payload is
    bit-identical to the clean state."""
    params = _state()["params"]
    domain = MemoryDomain.protect(
        params, HRMPolicy("parr", {}, default=Tier.PARITY_R,
                          scrub_interval=1))
    store = _store(tmp_path)
    store.save(1, {"params": params})
    store.save(2, {"params": params})
    _corrupt_data(store, 2)                      # storm hits the disk too

    rng = np.random.default_rng(0)
    for _ in range(4):                           # the storm
        domain, _ = domain.inject(rng, 1)
    domain, rep = domain.scrub()
    needs = rep.needs_recovery()
    assert needs                                 # parity detected strikes
    clean_copy = store.clean_copy_fn()           # bound to newest (=2)
    domain, events = domain.recover(rep, clean_copy=clean_copy,
                                    needs=needs)
    assert events
    assert store.last_loaded_step == 1           # fell back past corrupt 2
    for s in domain.spec.protectable:
        assert torch.equal(domain.leaf(s.path),
                           tree.leaves(params)[s.pos]), s.path

    _corrupt_data(store, 1)
    domain, _ = domain.inject(rng, 1)
    domain, rep = domain.scrub()
    needs = rep.needs_recovery()
    assert needs
    with pytest.raises(RestartRequired):
        domain.recover(rep, clean_copy=store.clean_copy_fn(), needs=needs)


# --------------------------------------------- one contract, two packages
def _train_state():
    """The reference's tiny lm-100m train state with a bf16 leaf beside it,
    and the same state in the port."""
    js = jinit_train_state(jax.random.PRNGKey(0), jget_tiny("lm-100m"),
                           JTrainConfig())
    js = {**js, "extra": {"bf16": jnp.arange(300, dtype=jnp.bfloat16)
                          * 0.37}}
    js["opt"] = {**js["opt"], "count": jnp.asarray(7, jnp.int32)}
    return js, state_from_numpy(jax.tree.map(np.asarray, js), device=CPU)


def _same_as_reference(jtree, ttree) -> None:
    want = {"/".join(str(getattr(e, "key", e)) for e in p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(jtree)[0]}
    got = dict(zip(("/".join(p) for p, _ in tree.flatten_with_path(
        ttree)[0]), tree.leaves(state_to_numpy(ttree))))
    assert list(want) == list(got)
    for k, w in want.items():
        assert w.shape == got[k].shape, k
        assert w.tobytes() == got[k].tobytes(), k


def test_port_reads_reference_snapshots(tmp_path):
    js, ts = _train_state()
    JStore(tmp_path).save(5, js)
    store = _store(tmp_path)
    assert store.verifies(5) and store.latest_step() == 5
    out = store.load(5, ts)
    _same_tree(out, ts)
    _same_as_reference(js, out)
    assert out["extra"]["bf16"].dtype == torch.bfloat16
    assert out["opt"]["count"].dtype == torch.int32 and \
        out["opt"]["count"].shape == ()
    copy = store.clean_copy_fn()
    assert torch.equal(copy("blocks/mlp/wi"), ts["params"]["blocks"]["mlp"][
        "wi"])                                   # params/{path} fallback
    assert torch.equal(copy("opt/m/embed"), ts["opt"]["m"]["embed"])


def test_reference_reads_port_snapshots(tmp_path):
    js, ts = _train_state()
    _store(tmp_path).save(5, ts)
    jstore = JStore(tmp_path)
    assert jstore.verifies(5)
    out = jstore.load(5, js)
    _same_as_reference(out, ts)


def test_both_packages_write_the_same_meta(tmp_path):
    js, ts = _train_state()
    JStore(tmp_path / "jax").save(3, js)
    _store(tmp_path / "torch").save(3, ts)
    metas = [json.loads((tmp_path / pkg / "step_00000003" / "meta.json")
                        .read_text()) for pkg in ("jax", "torch")]
    assert list(metas[0].items()) == list(metas[1].items())
    assert list(metas[0])[-1] == MANIFEST_KEY
    data = [np.load(tmp_path / pkg / "step_00000003" / "data.npz")
            for pkg in ("jax", "torch")]
    assert data[0].files == data[1].files
    for k in data[0].files:
        assert data[0][k].dtype == data[1][k].dtype == np.uint8
        assert np.array_equal(data[0][k], data[1][k]), k


@pytest.mark.parametrize("policy", ("typical_server", "detect_recover_l"))
def test_domain_over_train_state_equals_reference(policy):
    """``{"params", "opt"}`` of the converted train state under one domain:
    the sidecars are the reference's byte for byte, and after the same
    strikes from the same numpy seed the scrub reports are equal."""
    js, ts = _train_state()
    jsub = {"params": js["params"], "opt": js["opt"]}
    tsub = {"params": ts["params"], "opt": ts["opt"]}
    jdom = JDomain.protect(jsub, JDESIGN_POINTS[policy]())
    tdom = MemoryDomain.protect(tsub, DESIGN_POINTS[policy]())
    assert jdom.paths() == tdom.paths()
    want = jax.tree.map(np.asarray, jdom.sidecar)
    got = sidecar_to_numpy(tdom.sidecar)
    assert set(want) == set(got)
    for t in want:
        for name in want[t]:
            assert want[t][name].tobytes() == got[t][name].tobytes(), \
                (t, name)
    jrng, trng = np.random.default_rng(11), np.random.default_rng(11)
    jdom, jev = jdom.inject(jrng, 24, multi_bit_fraction=0.3)
    tdom, tev = tdom.inject(trng, 24, multi_bit_fraction=0.3)
    assert jev == tev
    jdom, jrep = jdom.scrub()
    tdom, trep = tdom.scrub()

    def counts(d):
        return {k: int(np.asarray(v)) for k, v in d.items()}
    assert counts(jrep.corrected) == counts(trep.corrected)
    assert counts(jrep.detected_uncorrectable) == \
        counts(trep.detected_uncorrectable)
    assert jrep.totals() == trep.totals() and sum(trep.totals()) > 0
    assert jrep.needs_recovery() == trep.needs_recovery()
